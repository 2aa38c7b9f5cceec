"""Child worker for tests/test_mp_trainer.py — NOT a test module.

Joins a 2-process jax.distributed system (2 CPU devices each) and trains
the full-graph Trainer on a graph=4 mesh with a checkpoint every epoch,
into a directory both processes share: once uninterrupted for 4 epochs,
and once for 2 epochs followed by a fresh Trainer that resumes from the
checkpoints and runs to epoch 4. Asserts that the resumed run repeats the
uninterrupted losses and that every step directory is whole. Prints
MPT_OK on success.
"""

import os
import sys

pid = int(sys.argv[1])
port = sys.argv[2]
root = sys.argv[3]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
os.environ["HAN_COORDINATOR"] = f"localhost:{port}"
os.environ["HAN_NUM_PROCESSES"] = "2"
os.environ["HAN_PROCESS_ID"] = str(pid)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")

from han_jax.parallel import launch  # noqa: E402

launch.init_distributed()

import numpy as np  # noqa: E402

from han_jax.graph.synthetic import planted_hetero  # noqa: E402
from han_jax.train.config import preset  # noqa: E402
from han_jax.train.trainer import Trainer  # noqa: E402


class Rows:
    def __init__(self):
        self.rows = []

    def log(self, rec):
        self.rows.append(rec)


ds = planted_hetero(n_nodes=200, n_feats=16, n_classes=3, n_metapaths=2,
                    avg_degree=6.0, train_per_class=12, n_val=24, seed=7)


def fit(tag, epochs, resume=False):
    cfg = preset("acm")
    cfg.data.graph_format = "csr"
    cfg.model.hid_units = (8,)
    cfg.model.n_heads = (4, 1)
    cfg.train.epochs = epochs
    cfg.train.patience = 100
    cfg.train.checkpoint_every = 1
    cfg.train.checkpoint_dir = os.path.join(root, tag)
    cfg.mesh.graph_axis = 4
    rows = Rows()
    result = Trainer(ds, cfg, logger=rows).fit(resume=resume)
    losses = [(r["epoch"], r["train_loss"], r["val_loss"]) for r in rows.rows
              if "train_loss" in r]
    return losses, result


full, full_res = fit("full", 4)
first, _ = fit("resumed", 2)
rest, rest_res = fit("resumed", 4, resume=True)
print(f"FULL {full}", flush=True)
print(f"RESUMED {first} + {rest}", flush=True)
assert [e for e, *_ in rest] == [2, 3], rest
np.testing.assert_array_equal(np.asarray(first + rest), np.asarray(full))
assert rest_res["test_loss"] == full_res["test_loss"], (rest_res, full_res)
for tag in ("full", "resumed"):
    names = sorted(os.listdir(os.path.join(root, tag, ds.name)))
    assert names == ["0", "1", "2", "3"], (tag, names)
print("MPT_OK", flush=True)
