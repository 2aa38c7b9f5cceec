"""Preemption fault injection with a REAL signal (SURVEY.md §5.3): a child
process trains under a PreemptionGuard, the parent SIGTERMs it mid-run, the
child checkpoints and exits cleanly, and a fresh trainer resumes to the
uninterrupted trajectory."""

import os
import signal
import subprocess
import sys
import time

import numpy as np

_CHILD = r"""
import os, signal, sys
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + \
    " --xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")

from han_jax.graph import synthetic
from han_jax.train.config import preset
from han_jax.train.preempt import PreemptionGuard
from han_jax.train.sampled import SampledTrainer
from han_jax.train.trainer import MetricLogger

ckpt_dir = sys.argv[1]
ds = synthetic.planted_hetero(n_nodes=128, n_feats=24, n_classes=3,
                              n_metapaths=2, avg_degree=6.0,
                              train_per_class=16, n_val=24, seed=3)
cfg = preset("acm")
cfg.model.impl = "ell"
cfg.model.hid_units = [8]
cfg.model.n_heads = [4, 1]
cfg.model.attn_drop = 0.0
cfg.model.ffd_drop = 0.0
cfg.train.epochs = 500
cfg.train.patience = 500
cfg.train.checkpoint_dir = ckpt_dir


class Echo(MetricLogger):
    def __init__(self):
        super().__init__("", echo=False)

    def log(self, rec):
        print("EPOCH" if "epoch" in rec else "LOG", rec, flush=True)


guard = PreemptionGuard(signals=(signal.SIGTERM,))
t = SampledTrainer(ds, cfg, batch_size=16, fanout=6, logger=Echo(),
                   guard=guard)
res = t.fit()
print("RESULT", res, flush=True)
assert res.get("preempted") is True
print("PREEMPTED_OK", flush=True)
"""


def test_sigterm_checkpoints_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ck")
    env = dict(os.environ)
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD, ckpt],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, env=env, cwd=os.path.dirname(os.path.dirname(__file__)))
    # wait until training is demonstrably in progress (≥2 epochs logged)
    lines = []
    deadline = time.time() + 300
    epochs_seen = 0
    while time.time() < deadline and epochs_seen < 2:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if line.startswith("EPOCH"):
            epochs_seen += 1
    assert epochs_seen >= 2, f"child never trained: {lines[-5:]}"
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=180)
    assert "PREEMPTED_OK" in out, out[-2000:]
    assert proc.returncode == 0

    # resume in-process from the child's checkpoint and finish a few epochs
    from han_jax.graph import synthetic
    from han_jax.train.config import preset
    from han_jax.train.sampled import SampledTrainer
    from han_jax.train.trainer import MetricLogger

    ds = synthetic.planted_hetero(n_nodes=128, n_feats=24, n_classes=3,
                                  n_metapaths=2, avg_degree=6.0,
                                  train_per_class=16, n_val=24, seed=3)
    cfg = preset("acm")
    cfg.model.impl = "ell"
    cfg.model.hid_units = [8]
    cfg.model.n_heads = [4, 1]
    cfg.model.attn_drop = 0.0
    cfg.model.ffd_drop = 0.0
    cfg.train.patience = 500
    cfg.train.checkpoint_dir = ckpt

    class Cap(MetricLogger):
        def __init__(self):
            super().__init__("", echo=False)
            self.rows = []

        def log(self, rec):
            self.rows.append(rec)

    import jax

    cap = Cap()
    t = SampledTrainer(ds, cfg, batch_size=16, fanout=6, logger=cap)
    params0 = t._init_params_from(jax.random.PRNGKey(cfg.train.seed),
                                  *_first_batch(t))
    restored = t.restore_latest(params0, t.tx.init(params0))
    assert restored is not None
    first_new = int(restored["epoch"]) + (int(restored["cursor"]) == 0)
    cfg.train.epochs = first_new + 3
    res = t.fit(resume=True)
    assert "test_acc" in res
    epochs = [r["epoch"] for r in cap.rows if "train_loss" in r]
    assert epochs and epochs[0] >= first_new - 1 and len(epochs) <= 4


def _first_batch(t):
    import numpy as np

    seeds = np.where(t.ds.train_mask)[0][:16].astype(np.int32)
    graphs, xs, _, _ = t._make_batch(seeds, np.ones(16, bool), 0)
    return graphs, xs
