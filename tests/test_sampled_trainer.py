"""Sampled mini-batch trainer (train/sampled.py): seed-exactness vs the
full-graph path, static batch shapes (single compile), and learning on a
planted graph — the >HBM scale path of SURVEY.md §2.3 / BASELINE.json."""

import tempfile

import jax
import numpy as np
import pytest

from han_jax.graph import synthetic
from han_jax.train.config import preset
from han_jax.train.sampled import SampledTrainer


@pytest.fixture(scope="module")
def small_ds():
    return synthetic.planted_hetero(
        n_nodes=128, n_feats=24, n_classes=3, n_metapaths=2,
        avg_degree=6.0, train_per_class=16, n_val=24, seed=3)


def make_trainer(ds, **over):
    cfg = preset("acm")
    cfg.model.impl = "ell"
    cfg.train.epochs = over.pop("epochs", 5)
    cfg.train.patience = 50
    cfg.train.log_file = ""
    cfg.train.checkpoint_dir = over.pop("checkpoint_dir", tempfile.mkdtemp())
    cfg.model.hid_units = [8]
    cfg.model.n_heads = [4, 1]
    cfg.model.attn_drop = 0.0
    cfg.model.ffd_drop = 0.0
    return SampledTrainer(ds, cfg, **over)


def test_seed_rows_match_full_graph(small_ds):
    """With fanout >= max degree and hops = #layers, the sampled block gives
    the seeds exactly the full neighborhood → logits equal the full-graph
    ell-backend forward."""
    ds = small_ds
    # +1: the trainer adds self-loops to match the full-graph path
    max_deg = 1 + max(int(np.diff(a.indptr).max()) for a in ds.metapath_adjs)
    t = make_trainer(ds, batch_size=16, fanout=max_deg,
                     block_size=16 * (max_deg + 1))
    seeds = np.arange(16, dtype=np.int32)
    valid = np.ones(16, bool)
    graphs, xs, lbl, mask = t._make_batch(seeds, valid, sample_seed=0)
    params = t._init_params_from(jax.random.PRNGKey(0), graphs, xs)
    block_logits, _ = t._apply(params, graphs, xs, deterministic=True)

    # full-graph forward with the SAME params (shapes differ; params don't)
    from han_jax.graph.build import metapath_to_csr
    from han_jax.graph.containers import ell_from_csr

    full_graphs = [ell_from_csr(metapath_to_csr(a)) for a in ds.metapath_adjs]
    x = np.asarray(ds.features)
    full_logits, _ = t._apply(params, full_graphs, [x, x], deterministic=True)
    np.testing.assert_allclose(
        np.asarray(block_logits)[:16], np.asarray(full_logits)[seeds],
        rtol=1e-4, atol=1e-5)


def test_exact_eval_matches_full_graph(small_ds):
    """evaluate(exact=True) builds full-neighborhood blocks (fanout = max
    degree) → the metric equals full-graph evaluation, independent of the
    trainer's own (small) sampling fanout."""
    ds = small_ds
    t = make_trainer(ds, batch_size=16, fanout=3)  # aggressively sampled
    seeds = np.arange(16, dtype=np.int32)
    valid = np.ones(16, bool)
    graphs, xs, _, _ = t._make_batch(seeds, valid, sample_seed=0)
    params = t._init_params_from(jax.random.PRNGKey(0), graphs, xs)

    val_idx = np.where(ds.val_mask)[0]
    l_s, a_s = t.evaluate(params, val_idx)              # sampled (fanout 3)
    l_e, a_e = t.evaluate(params, val_idx, exact=True)  # full neighborhoods

    # full-graph reference with the SAME params
    from han_jax.graph.build import metapath_to_csr
    from han_jax.graph.containers import ell_from_csr
    import jax.numpy as jnp

    full_graphs = [ell_from_csr(metapath_to_csr(a)) for a in ds.metapath_adjs]
    x = np.asarray(ds.features)
    logits, _ = t._apply(params, full_graphs, [x, x], deterministic=True)
    logp = jax.nn.log_softmax(logits, axis=-1)
    lbl = jnp.asarray(ds.labels[val_idx], jnp.float32)
    ref_l = float(jnp.mean(-jnp.sum(lbl * logp[val_idx], axis=-1)))
    ref_a = float(jnp.mean((jnp.argmax(logits[val_idx], -1)
                            == jnp.argmax(lbl, -1)).astype(jnp.float32)))
    np.testing.assert_allclose(l_e, ref_l, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a_e, ref_a, rtol=1e-6)
    assert abs(l_s - ref_l) > 1e-6  # the sampled metric really is sampled


def test_exact_eval_unavailable_falls_back(small_ds):
    t = make_trainer(small_ds, batch_size=16, fanout=3)
    assert t.exact_eval_plan(max_block=64) is None  # capacity too small
    graphs, xs, _, _ = t._make_batch(np.arange(16, dtype=np.int32),
                                     np.ones(16, bool), sample_seed=0)
    params = t._init_params_from(jax.random.PRNGKey(0), graphs, xs)
    rows = []
    t.logger.log = lambda rec: rows.append(rec)
    t.exact_eval_plan = lambda max_block=64: None
    l, a = t.evaluate(params, np.where(small_ds.val_mask)[0], exact=True)
    assert any("exact_eval_unavailable" in r for r in rows)
    assert np.isfinite(l)


def test_exact_eval_plan_skewed_graph():
    """One hub node must not forfeit exact eval for the whole graph: the
    plan sizes blocks and ELL width from the TRUE per-batch L-hop frontier,
    falling back only when the actual blocks
    overflow. The old batch·deg_max^hops bound returns None here; the
    per-batch bound succeeds AND matches full-graph evaluation."""
    import scipy.sparse as sp

    from han_jax.graph.synthetic import HeteroDataset

    n = 512
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(1, n), 3)
    cols = rng.integers(1, n, rows.shape[0])
    hub_rows = np.zeros(n - 1, np.int64)  # node 0: in-degree n-1 hub
    hub_cols = np.arange(1, n)
    adj = sp.csr_matrix(
        (np.ones(rows.size + n - 1, np.float32),
         (np.concatenate([rows, hub_rows]), np.concatenate([cols, hub_cols]))),
        shape=(n, n))
    feats = rng.standard_normal((n, 8)).astype(np.float32)
    y = rng.integers(0, 3, n)
    labels = np.zeros((n, 3), np.float32)
    labels[np.arange(n), y] = 1.0
    train = np.zeros(n, bool)
    train[1:33] = True
    val = np.zeros(n, bool)
    val[100:140] = True
    ds = HeteroDataset([adj, adj.copy()], feats, labels, train, val,
                       ~(train | val), name="skew")
    t = make_trainer(ds, batch_size=16, fanout=3)
    val_idx = np.where(val)[0]

    max_block = 4000
    # global worst-case bound (no idx): hub degree wipes out exact eval
    assert t.exact_eval_plan(max_block=max_block) is None
    # true per-batch frontier: the hub is not in any val batch's 1-hop set
    plan = t.exact_eval_plan(val_idx, max_block=max_block)
    assert plan is not None
    fanout, block = plan
    assert block <= max_block and fanout < n // 2

    graphs, xs, _, _ = t._make_batch(np.arange(1, 17, dtype=np.int32),
                                     np.ones(16, bool), sample_seed=0)
    params = t._init_params_from(jax.random.PRNGKey(0), graphs, xs)
    l_e, a_e = t.evaluate(params, val_idx, exact=True)

    from han_jax.graph.build import metapath_to_csr
    from han_jax.graph.containers import ell_from_csr
    import jax.numpy as jnp

    full_graphs = [ell_from_csr(metapath_to_csr(a)) for a in ds.metapath_adjs]
    x = np.asarray(ds.features)
    logits, _ = t._apply(params, full_graphs, [x, x], deterministic=True)
    logp = jax.nn.log_softmax(logits, axis=-1)
    lbl = jnp.asarray(ds.labels[val_idx], jnp.float32)
    ref_l = float(jnp.mean(-jnp.sum(lbl * logp[val_idx], axis=-1)))
    ref_a = float(jnp.mean((jnp.argmax(logits[val_idx], -1)
                            == jnp.argmax(lbl, -1)).astype(jnp.float32)))
    np.testing.assert_allclose(l_e, ref_l, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a_e, ref_a, rtol=1e-6)


def test_batches_share_one_treedef(small_ds):
    """Every batch must produce the identical pytree structure + shapes so
    the jitted step compiles exactly once."""
    t = make_trainer(small_ds, batch_size=16, fanout=4)
    b1 = t._make_batch(np.arange(16, dtype=np.int32), np.ones(16, bool), 1)
    b2 = t._make_batch(np.arange(40, 56, dtype=np.int32), np.ones(16, bool), 2)
    s1 = jax.tree_util.tree_structure(b1)
    s2 = jax.tree_util.tree_structure(b2)
    assert s1 == s2
    for l1, l2 in zip(jax.tree_util.tree_leaves(b1), jax.tree_util.tree_leaves(b2)):
        assert l1.shape == l2.shape and l1.dtype == l2.dtype


def test_sampled_training_learns(small_ds):
    t = make_trainer(small_ds, batch_size=24, fanout=6, epochs=25)
    result = t.fit()
    assert result["test_acc"] > 0.55  # 3 classes → chance is 0.33
    # tail-batch padding: eval over an odd-sized index set stays exact
    loss, acc = t.evaluate(t.final_params, np.arange(37), epoch=0)
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0


def test_dp_sampled_matches_single_device(small_ds):
    """An S-way data-parallel sampled step (seed batch sharded over the
    mesh graph axis) produces the same loss and parameter update as the
    single-device step on the same seeds (fanout >= max degree so both
    see full neighborhoods)."""
    from han_jax.parallel.mesh import make_mesh
    from han_jax.train.sampled import DPSampledTrainer

    ds = small_ds
    max_deg = 1 + max(int(np.diff(a.indptr).max()) for a in ds.metapath_adjs)
    single = make_trainer(ds, batch_size=16, fanout=max_deg,
                          block_size=16 * (max_deg + 1))

    cfg = preset("acm")
    cfg.model.impl = "ell"
    cfg.train.log_file = ""
    cfg.model.hid_units = [8]
    cfg.model.n_heads = [4, 1]
    cfg.model.attn_drop = 0.0
    cfg.model.ffd_drop = 0.0
    mesh = make_mesh(graph=4, heads=1)
    dp = DPSampledTrainer(ds, cfg, mesh=mesh, batch_size=16, fanout=max_deg,
                          block_size=4 * (max_deg + 1))

    seeds = np.arange(16, dtype=np.int32)
    valid = np.ones(16, bool)
    b1 = single._make_batch(seeds, valid, 0)
    b2 = dp._make_batch(seeds, valid, 0)

    params = single._init_params_from(jax.random.PRNGKey(0), b1[0], b1[1])
    rng = jax.random.PRNGKey(7)
    p1, o1, _, loss1, acc1 = single._train_step(
        params, single.tx.init(params), rng, *b1)
    p2, o2, _, loss2, acc2 = dp._train_step(
        params, dp.tx.init(params), rng, *b2)

    assert np.isclose(float(loss1), float(loss2), rtol=1e-5)
    assert np.isclose(float(acc1), float(acc2), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=1e-6)


def test_dp_sampled_training_learns(small_ds):
    from han_jax.parallel.mesh import make_mesh
    from han_jax.train.sampled import DPSampledTrainer

    cfg = preset("acm")
    cfg.model.impl = "ell"
    cfg.train.epochs = 20
    cfg.train.patience = 50
    cfg.train.log_file = ""
    cfg.train.checkpoint_dir = tempfile.mkdtemp()
    cfg.model.hid_units = [8]
    cfg.model.n_heads = [4, 1]
    cfg.model.attn_drop = 0.0
    cfg.model.ffd_drop = 0.0
    mesh = make_mesh(graph=2, heads=1)
    t = DPSampledTrainer(small_ds, cfg, mesh=mesh, batch_size=24, fanout=6)
    result = t.fit()
    assert result["test_acc"] > 0.55


def test_two_hop_sampled_exactness(small_ds):
    """Two GAT layers need 2-hop blocks: with exhaustive fanout the seed
    logits must equal the full-graph forward (guards the L-hop frontier
    logic in sample_block / sample_subgraph)."""
    ds = small_ds
    max_deg = 1 + max(int(np.diff(a.indptr).max()) for a in ds.metapath_adjs)
    cfg = preset("acm")
    cfg.model.impl = "ell"
    cfg.train.log_file = ""
    cfg.model.hid_units = [8, 8]   # 2 layers -> hops defaults to 2
    cfg.model.n_heads = [2, 2, 1]
    cfg.model.attn_drop = 0.0
    cfg.model.ffd_drop = 0.0
    from han_jax.train.sampled import SampledTrainer

    t = SampledTrainer(ds, cfg, batch_size=8,
                       fanout=max_deg, block_size=ds.n_nodes + 8)
    assert t.hops == 2
    seeds = np.array([0, 5, 9, 33, 64, 90, 101, 127], np.int32)
    graphs, xs, lbl, mask = t._make_batch(seeds, np.ones(8, bool), 0)
    params = t._init_params_from(jax.random.PRNGKey(1), graphs, xs)
    block_logits, _ = t._apply(params, graphs, xs, deterministic=True)

    from han_jax.graph.build import metapath_to_csr
    from han_jax.graph.containers import ell_from_csr

    full_graphs = [ell_from_csr(metapath_to_csr(a)) for a in ds.metapath_adjs]
    x = np.asarray(ds.features)
    full_logits, _ = t._apply(params, full_graphs, [x, x], deterministic=True)
    np.testing.assert_allclose(
        np.asarray(block_logits)[:8], np.asarray(full_logits)[seeds],
        rtol=2e-4, atol=1e-5)


def test_device_sampler_seed_rows_match_full_graph(small_ds):
    """In-step device sampling (no per-batch host sampling): with
    fanout >= max degree the device sampler takes every in-neighbor
    (take-all branch), so seed logits equal the full-graph ell forward —
    the same exactness contract as the host sampler."""
    ds = small_ds
    max_deg = 1 + max(int(np.diff(a.indptr).max()) for a in ds.metapath_adjs)
    t = make_trainer(ds, batch_size=16, fanout=max_deg,
                     block_size=16 * (max_deg + 1), sampler="device")
    seeds = np.arange(16, dtype=np.int32)
    valid = np.ones(16, bool)
    batch = t._make_batch(seeds, valid, sample_seed=3)
    assert not isinstance(batch[0], (list, tuple))  # tiny packed descriptor
    params = t._init_params_from(jax.random.PRNGKey(0), batch[0], batch[1])
    opt_state = t.tx.init(params)
    rng = jax.random.PRNGKey(7)
    p2, o2, _, loss_dev, acc_dev = t._train_step(params, opt_state, rng,
                                                 *batch)
    assert np.isfinite(float(loss_dev))
    assert t.flush_sampled_edges() > 0

    # the HOST block on the same seeds must produce the same loss: both
    # take full neighborhoods, and the loss masks to seed rows only
    hb = t._make_batch_host(seeds, valid, sample_seed=3)
    p1, o1, _, loss_host, acc_host = t._train_step(params, opt_state, rng,
                                                   *hb)
    np.testing.assert_allclose(float(loss_dev), float(loss_host),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(acc_dev), float(acc_host), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(p1),
                    jax.tree_util.tree_leaves(p2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=1e-6)


def test_device_sampler_training_learns(small_ds):
    t = make_trainer(small_ds, batch_size=24, fanout=6, epochs=25,
                     sampler="device")
    result = t.fit()
    assert result["test_acc"] > 0.55


def test_device_sampler_two_hop_exactness(small_ds):
    """Two GAT layers, device sampling, exhaustive fanout: seed logits
    equal the full-graph forward (the L-hop static-iota block layout
    gives every level its full in-neighborhood when F >= max degree)."""
    ds = small_ds
    max_deg = 1 + max(int(np.diff(a.indptr).max()) for a in ds.metapath_adjs)
    cfg = preset("acm")
    cfg.model.impl = "ell"
    cfg.train.log_file = ""
    cfg.model.hid_units = [8, 8]   # 2 layers -> hops = 2
    cfg.model.n_heads = [2, 2, 1]
    cfg.model.attn_drop = 0.0
    cfg.model.ffd_drop = 0.0
    b = 4
    need = sum(b * max_deg ** h for h in range(3))
    t = SampledTrainer(ds, cfg, batch_size=b, fanout=max_deg,
                       block_size=need, sampler="device")
    assert t.hops == 2
    seeds = np.array([0, 5, 9, 33], np.int32)
    batch = t._make_batch(seeds, np.ones(b, bool), sample_seed=1)
    params = t._init_params_from(jax.random.PRNGKey(1), batch[0], batch[1])
    opt_state = t.tx.init(params)
    # device step loss vs host-block step loss on the same seeds/params
    rng = jax.random.PRNGKey(3)
    _, _, _, loss_dev, acc_dev = t._train_step(params, opt_state, rng, *batch)
    hb = t._make_batch_host(seeds, np.ones(b, bool), sample_seed=1)
    _, _, _, loss_host, acc_host = t._train_step(params, opt_state, rng, *hb)
    np.testing.assert_allclose(float(loss_dev), float(loss_host),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(acc_dev), float(acc_host), rtol=1e-6)


def test_device_sampler_chunked_dispatch_matches(small_ds):
    """steps_per_call > 1 scans C descriptors per jit call — the loss
    trajectory must equal per-step dispatch exactly (same seeds, same
    math, only dispatch granularity changes)."""
    rows = {}
    for spc in (1, 3):
        from han_jax.train.trainer import MetricLogger

        class Cap(MetricLogger):
            def __init__(self):
                super().__init__("", echo=False)
                self.rows = []

            def log(self, rec):
                self.rows.append(rec)

        cap = Cap()
        t = make_trainer(small_ds, batch_size=16, fanout=6, epochs=4,
                         sampler="device", steps_per_call=spc, logger=cap)
        t.fit()
        rows[spc] = [(r["epoch"], r["train_loss"], r["val_loss"])
                     for r in cap.rows if "train_loss" in r]
    assert rows[1] and len(rows[1]) == len(rows[3])
    for (e1, l1, v1), (e3, l3, v3) in zip(rows[1], rows[3]):
        assert e1 == e3
        np.testing.assert_allclose(l1, l3, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(v1, v3, rtol=1e-6, atol=1e-7)


def test_dp_rejects_device_sampler(small_ds):
    from han_jax.parallel.mesh import make_mesh
    from han_jax.train.sampled import DPSampledTrainer

    cfg = preset("acm")
    cfg.model.impl = "ell"
    cfg.train.log_file = ""
    with pytest.raises(NotImplementedError, match="device"):
        DPSampledTrainer(small_ds, cfg, mesh=make_mesh(graph=2, heads=1),
                         batch_size=16, fanout=4, sampler="device")


class _TripAfter:
    """Fault injection: quacks like PreemptionGuard, fires after n polls
    (the trainer polls once per trained batch)."""

    def __init__(self, n):
        self.left = n

    @property
    def triggered(self):
        self.left -= 1
        return self.left < 0


def test_sampled_resume_reproduces_trajectory(small_ds, tmp_path):
    """Kill sampled training MID-EPOCH, resume from the batch cursor in a
    fresh trainer: the continued run emits exactly the uninterrupted
    trajectory and final result (SURVEY.md §5.3-5.4)."""
    from han_jax.train.trainer import MetricLogger

    class Cap(MetricLogger):
        def __init__(self):
            super().__init__("", echo=False)
            self.rows = []

        def log(self, rec):
            self.rows.append(rec)

    def rows(cap):
        return [(r["epoch"], r["train_loss"], r["val_loss"]) for r in cap.rows
                if "train_loss" in r]

    ckpt = str(tmp_path / "ck")
    cap_a = Cap()
    a = make_trainer(small_ds, batch_size=16, fanout=6, epochs=4,
                     checkpoint_dir=str(tmp_path / "ref"), logger=cap_a)
    res_a = a.fit()

    # interrupted run: preempt mid-epoch-1 (epoch 0 has ceil(48/16)=3 batches)
    cap_b = Cap()
    b = make_trainer(small_ds, batch_size=16, fanout=6, epochs=4,
                     checkpoint_dir=ckpt, logger=cap_b,
                     guard=_TripAfter(4))
    res_b = b.fit()
    assert res_b.get("preempted") is True
    assert len(rows(cap_b)) == 1  # finished epoch 0 only

    # fresh-process stand-in: new trainer, resume from the batch cursor
    cap_c = Cap()
    c = make_trainer(small_ds, batch_size=16, fanout=6, epochs=4,
                     checkpoint_dir=ckpt, logger=cap_c)
    res_c = c.fit(resume=True)

    ra, rc = rows(cap_a), rows(cap_c)
    assert [e for e, *_ in rc] == [1, 2, 3]  # resumed inside epoch 1
    for (ea, la, va), (ec, lc, vc) in zip(ra[1:], rc):
        assert ea == ec
        np.testing.assert_allclose(la, lc, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(va, vc, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(res_c["test_loss"], res_a["test_loss"], rtol=1e-6)
    assert res_c["best_epoch"] == res_a["best_epoch"]
