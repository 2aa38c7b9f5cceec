"""The main path needs no flax, orbax or scikit-learn: a fresh process with
those packages blocked runs full-graph HAN training through the CLI's
``trainer.run`` (embedding evaluation included), device-sampled training,
a checkpoint resume, and imports chip_smoke.py."""

import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import sys
for name in ("flax", "orbax", "orbax.checkpoint", "sklearn"):
    sys.modules[name] = None  # any import of these now raises ImportError

import runpy
import numpy as np
from han_jax.graph.synthetic import planted_hetero
from han_jax.train import trainer
from han_jax.train.config import preset
from han_jax.train.sampled import SampledTrainer
import chip_smoke  # noqa: F401

ckpt = sys.argv[1]
sys.argv = ["train.py", "--dataset", "acm", "--set", "train.epochs=2",
            "--set", "data.graph_format=csr", "--set", "model.n_heads=2,1",
            "--set", f"train.checkpoint_dir={ckpt}"]
runpy.run_path("scripts/train.py", run_name="__main__")

ds = planted_hetero(n_nodes=120, n_feats=16, n_classes=3, n_metapaths=2,
                    avg_degree=5.0, train_per_class=10, n_val=20, seed=1)
cfg = preset("acm")
cfg.model.n_heads = (2, 1)
cfg.train.epochs = 2
cfg.train.checkpoint_dir = ckpt
res = trainer.Trainer(ds, cfg).fit()
assert "nmi" in res and np.isfinite(res["test_loss"])
cfg.train.epochs = 3
res = trainer.Trainer(ds, cfg).fit(resume=True)
assert np.isfinite(res["test_loss"])
st = SampledTrainer(ds, cfg, batch_size=16, fanout=4, sampler="device")
assert np.isfinite(st.fit()["test_loss"])
print("BLOCKED_IMPORTS_OK")
"""


def test_main_path_runs_without_flax_orbax_sklearn(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path / "ck")],
                         env=env, cwd=_ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    assert "BLOCKED_IMPORTS_OK" in out.stdout
