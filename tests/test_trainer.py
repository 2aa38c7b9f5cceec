"""Trainer integration tests (SURVEY.md §4.4): early-stopping policy,
checkpoint/resume determinism, metric logging, inductive multi-graph DP."""

import json

import numpy as np
import pytest

from han_jax.datasets.ppi import ppi_synthetic
from han_jax.graph.synthetic import planted_hetero
from han_jax.train.config import Config, preset
from han_jax.train.trainer import EarlyStopState, MetricLogger, Trainer
from han_jax.train.inductive import InductiveTrainer


@pytest.fixture(scope="module")
def small_ds():
    return planted_hetero(n_nodes=120, n_feats=32, n_classes=3, n_metapaths=2,
                          avg_degree=8.0, train_per_class=15, n_val=20, seed=5)


def small_cfg(tmp_path, **over):
    cfg = preset("acm")
    cfg.train.epochs = over.get("epochs", 12)
    cfg.train.patience = over.get("patience", 12)
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.model.hid_units = (8,)
    cfg.model.n_heads = (2, 1)
    cfg.model.attn_drop = 0.3
    cfg.model.ffd_drop = 0.3
    return cfg


def test_early_stop_policy_matches_reference():
    """Exact policy of ex_acm3025.py:225-240: checkpoint iff acc AND loss
    both improve; patience counts epochs where NEITHER improves."""
    es = EarlyStopState()
    ckpt, bad = es.update(1.0, 0.5)       # first epoch: both improve
    assert ckpt and not bad and es.bad_epochs == 0
    ckpt, bad = es.update(1.2, 0.6)       # acc improves, loss worsens
    assert not ckpt and not bad and es.bad_epochs == 0
    assert es.best_val_acc == 0.6 and es.best_val_loss == 1.0
    ckpt, bad = es.update(1.5, 0.4)       # neither improves
    assert not ckpt and bad and es.bad_epochs == 1
    ckpt, bad = es.update(0.9, 0.7)       # both improve again
    assert ckpt and es.bad_epochs == 0


def test_trainer_fit_and_metrics(small_ds, tmp_path):
    cfg = small_cfg(tmp_path)
    cfg.train.log_file = str(tmp_path / "metrics.jsonl")
    t = Trainer(small_ds, cfg, logger=MetricLogger(cfg.train.log_file, echo=False))
    result = t.fit()
    assert np.isfinite(result["test_loss"])
    assert 0.0 <= result["test_acc"] <= 1.0
    assert "macro_f1@0.2" in result and "nmi" in result
    lines = [json.loads(l) for l in open(cfg.train.log_file)]
    epochs = [l for l in lines if "epoch" in l]
    assert len(epochs) >= 5
    assert all("semantic_alphas" in l for l in epochs)
    # semantic attention weights sum to ~1
    np.testing.assert_allclose(sum(epochs[0]["semantic_alphas"]), 1.0, atol=2e-3)


def test_checkpoint_resume_roundtrip(small_ds, tmp_path):
    cfg = small_cfg(tmp_path, epochs=6)
    t = Trainer(small_ds, cfg, logger=MetricLogger(echo=False))
    t.fit()
    restored = t.restore_latest()
    assert restored is not None
    # restored params produce identical eval metrics to the live best
    loss_live, acc_live, _, _ = t.eval_step(t.final_params, t.masks["val"])
    loss_res, acc_res, _, _ = t.eval_step(restored["params"], t.masks["val"])
    np.testing.assert_allclose(float(loss_res), float(loss_live), rtol=1e-6)
    np.testing.assert_allclose(float(acc_res), float(acc_live), rtol=1e-6)
    assert int(restored["epoch"]) >= 0
    assert np.isfinite(float(restored["best_val_loss"]))


def test_seed_determinism(small_ds, tmp_path):
    """Same seed → identical loss curve (doubles as the data-race canary,
    SURVEY.md §5.2)."""
    logs = []
    for run in range(2):
        cfg = small_cfg(tmp_path / f"r{run}", epochs=4)
        records = []

        class Cap(MetricLogger):
            def __init__(self):
                super().__init__(echo=False)

            def log(self, rec):
                records.append(rec)

        Trainer(small_ds, cfg, logger=Cap()).fit()
        logs.append([r["train_loss"] for r in records if "train_loss" in r])
    np.testing.assert_array_equal(logs[0], logs[1])


def test_inductive_ppi_learns():
    ds = ppi_synthetic(n_graphs=10, nodes_per_graph=32, n_feats=12,
                       n_labels=6, seed=2)
    t = InductiveTrainer(ds, hid_units=(16,), n_heads=(2, 2), lr=0.02,
                        batch_size=2)
    res = t.fit(epochs=15, log=lambda r: None)
    first = res["history"][0]["train_loss"]
    last = res["history"][-1]["train_loss"]
    assert last < first * 0.9, (first, last)
    assert 0.0 <= res["test_micro_f1"] <= 1.0


def test_ppi_front_door(tmp_path):
    """PPI goes through the same registry + run() path as every other
    dataset (reference utils/process_ppi.py:85): load_dataset('ppi')
    returns the multi-graph dataset (synthetic fixture when the GraphSAGE
    files are absent) and run() routes it to the InductiveTrainer."""
    from han_jax.datasets.ppi import MultiGraphDataset
    from han_jax.datasets.registry import load_dataset
    from han_jax.train import trainer as train_mod
    from han_jax.train.config import preset

    ds = load_dataset("ppi", n_graphs=8, nodes_per_graph=24, n_feats=10,
                      n_labels=5, seed=3)
    assert isinstance(ds, MultiGraphDataset)
    cfg = preset("ppi")
    cfg.train.epochs = 3
    cfg.train.checkpoint_dir = str(tmp_path)
    cfg.model.hid_units = (8,)
    cfg.model.n_heads = (2, 2)
    res = train_mod.run(cfg, ds=ds)
    assert "test_micro_f1" in res and "history" not in res


class _TripAtEpoch:
    """Quacks like PreemptionGuard; fires after n epoch-boundary polls."""

    def __init__(self, n):
        self.left = n

    @property
    def triggered(self):
        self.left -= 1
        return self.left < 0


def test_inductive_resume_reproduces_trajectory(tmp_path):
    """Preempt inductive PPI training mid-run, resume in a fresh trainer:
    the continued run emits exactly the uninterrupted trajectory and final
    metrics — the resilience contract the other two trainers already carry
   ."""
    ds = ppi_synthetic(n_graphs=8, nodes_per_graph=24, n_feats=10,
                       n_labels=5, seed=5)
    kw = dict(hid_units=(8,), n_heads=(2, 2), lr=0.02, batch_size=2,
              seed=0, patience=100)

    def rows(res):
        return [(h["epoch"], h["train_loss"], h["val_loss"])
                for h in res["history"]]

    a = InductiveTrainer(ds, checkpoint_dir=str(tmp_path / "ref"), **kw)
    res_a = a.fit(epochs=6, log=lambda r: None)

    ck = str(tmp_path / "ck")
    b = InductiveTrainer(ds, checkpoint_dir=ck, checkpoint_every=1,
                         guard=_TripAtEpoch(2), **kw)
    res_b = b.fit(epochs=6, log=lambda r: None)
    assert res_b.get("preempted") is True
    assert len(res_b["history"]) == 3  # epochs 0-2 done, preempted at 2

    c = InductiveTrainer(ds, checkpoint_dir=ck, **kw)
    res_c = c.fit(epochs=6, log=lambda r: None, resume=True)
    ra, rc = rows(res_a), rows(res_c)
    assert [e for e, *_ in rc] == [3, 4, 5]
    for (ea, la, va), (ec, lc, vc) in zip(ra[3:], rc):
        assert ea == ec
        np.testing.assert_allclose(la, lc, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(va, vc, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(res_c["test_micro_f1"], res_a["test_micro_f1"],
                               rtol=1e-6)
    assert res_c["best_epoch"] == res_a["best_epoch"]


def test_inductive_mesh_dp_matches_single_device():
    """DP inductive training on a ('graph',) mesh produces the same loss
    trajectory as the single-device run (psum-of-grads == full batch)."""
    from han_jax.parallel.mesh import make_mesh

    ds = ppi_synthetic(n_graphs=8, nodes_per_graph=24, n_feats=10,
                       n_labels=5, seed=4)

    def losses(mesh, batch_size):
        t = InductiveTrainer(ds, hid_units=(8,), n_heads=(2, 2), lr=0.02,
                             batch_size=batch_size, mesh=mesh, seed=0)
        res = t.fit(epochs=3, log=lambda r: None)
        return [h["train_loss"] for h in res["history"]]

    single = losses(None, 4)
    sharded = losses(make_mesh(graph=4), 4)
    np.testing.assert_allclose(sharded, single, rtol=2e-5, atol=1e-6)


def test_resume_restores_best_not_latest(small_ds, tmp_path):
    """When the latest checkpoint is a *periodic* save made after the best
    epoch, resume must still evaluate on the best-epoch params (reference
    restore-best-then-test policy, ex_acm3025.py:247)."""
    cfg = small_cfg(tmp_path / "d")
    cfg.train.epochs = 8
    cfg.train.patience = 100
    cfg.train.checkpoint_every = 1
    cfg.train.lr = 1.0  # diverges: best epoch lands mid-run, later saves are periodic
    res_a = Trainer(small_ds, cfg, logger=MetricLogger(echo=False)).fit()
    # precondition: the best epoch precedes the last (periodic) save —
    # otherwise this test cannot discriminate best-vs-latest restore
    assert res_a["best_epoch"] < cfg.train.epochs - 1, res_a["best_epoch"]

    # fresh trainer, resume with no further epochs: final eval must come
    # from the recorded best step, not from the latest periodic checkpoint
    cfg2 = small_cfg(tmp_path / "d")
    cfg2.train.epochs = 8
    cfg2.train.patience = 100
    cfg2.train.checkpoint_every = 1
    cfg2.train.lr = 1.0
    res_b = Trainer(small_ds, cfg2, logger=MetricLogger(echo=False)).fit(resume=True)
    assert res_b["best_epoch"] == res_a["best_epoch"]
    np.testing.assert_allclose(res_b["test_loss"], res_a["test_loss"], rtol=1e-6)
    np.testing.assert_allclose(res_b["test_acc"], res_a["test_acc"], rtol=1e-6)


def test_preemption_resume_reproduces_trajectory(small_ds, tmp_path):
    """Fault injection (SURVEY.md §5.3): kill training after 3 epochs, build
    a fresh Trainer, fit(resume=True) — the continued epochs emit exactly
    the val losses of an uninterrupted run."""
    class Capture(MetricLogger):
        def __init__(self):
            super().__init__("", echo=False)
            self.rows = []

        def log(self, rec):
            self.rows.append(rec)

    def losses(logger):
        return {r["epoch"]: r["val_loss"] for r in logger.rows if "val_loss" in r}

    # uninterrupted 6-epoch run
    cap_a = Capture()
    cfg_a = small_cfg(tmp_path / "a")
    cfg_a.train.epochs = 6
    cfg_a.train.patience = 100
    Trainer(small_ds, cfg_a, logger=cap_a).fit()

    # interrupted run: 3 epochs with per-epoch checkpoints, then "crash"
    cap_b = Capture()
    cfg_b = small_cfg(tmp_path / "b")
    cfg_b.train.epochs = 3
    cfg_b.train.patience = 100
    cfg_b.train.checkpoint_every = 1
    Trainer(small_ds, cfg_b, logger=cap_b).fit()

    # fresh process stand-in: new Trainer, resume from latest checkpoint
    cap_c = Capture()
    cfg_c = small_cfg(tmp_path / "b")
    cfg_c.train.epochs = 6
    cfg_c.train.patience = 100
    cfg_c.train.checkpoint_every = 1
    Trainer(small_ds, cfg_c, logger=cap_c).fit(resume=True)

    la, lc = losses(cap_a), losses(cap_c)
    assert sorted(lc) == [3, 4, 5]  # resumed exactly after the crash point
    for e in (3, 4, 5):
        assert np.isclose(la[e], lc[e], rtol=1e-6, atol=1e-7), (e, la[e], lc[e])


def test_sampled_front_door(small_ds, tmp_path):
    """run() routes --set train.sampled=true to the SampledTrainer — the
    >HBM path is reachable from the same front door as every other
    trainer, including the device sampler."""
    from han_jax.train import trainer as train_mod

    for sampler in ("host", "device"):
        cfg = preset("acm")
        cfg.train.sampled = True
        cfg.train.sampler = sampler
        cfg.train.epochs = 3
        cfg.train.batch_size = 16
        cfg.train.fanout = 6
        cfg.train.log_file = ""
        cfg.train.checkpoint_dir = str(tmp_path / sampler)
        cfg.model.hid_units = (8,)
        cfg.model.n_heads = (2, 1)
        res = train_mod.run(cfg, ds=small_ds)
        assert "test_acc" in res and np.isfinite(res["test_loss"])
