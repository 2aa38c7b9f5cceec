"""Child worker for tests/test_multiprocess.py — NOT a test module.

Joins a 2-process jax.distributed system (via the HAN_* env resolution
in parallel/launch.py), runs edge-partitioned attention over the 4-device
global mesh, and asserts equality with the locally-computed single-process
reference. Prints MP_OK on success.
"""

import os
import sys

pid = int(sys.argv[1])
port = sys.argv[2]

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

info = launch.init_distributed()
assert info["num_processes"] == 2, info
assert info["global_devices"] == 4, info
assert launch.is_coordinator() == (pid == 0)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

from han_jax.graph.containers import csr_from_dense  # noqa: E402
from han_jax.graph.synthetic import planted_hetero  # noqa: E402
from han_jax.graph.build import metapath_to_csr  # noqa: E402
from han_jax.ops.attention import csr_attention  # noqa: E402
from han_jax.parallel.edge_partition import partition_csr  # noqa: E402
from han_jax.parallel.mesh import make_mesh  # noqa: E402
from han_jax.parallel.shard_attn import partitioned_attention  # noqa: E402

ds = planted_hetero(n_nodes=200, n_feats=16, n_classes=3, n_metapaths=1,
                    avg_degree=6.0, train_per_class=10, n_val=10, seed=7)
csr = metapath_to_csr(ds.metapath_adjs[0], edge_pad_to=32)
part = partition_csr(csr, 4, edge_pad_to=32)

rng = np.random.default_rng(0)
k, d = 2, 8
fts = jnp.asarray(rng.standard_normal((200, k, d)).astype(np.float32))
ld = jnp.asarray(rng.standard_normal((200, k)).astype(np.float32))
ls = jnp.asarray(rng.standard_normal((200, k)).astype(np.float32))

# single-process reference, computed locally on every process
ref = np.asarray(csr_attention(csr, fts, ld, ls))

mesh = make_mesh(graph=4, heads=1)  # spans both processes (4 global devices)
with jax.set_mesh(mesh):
    out = jax.jit(
        lambda g, f, a, b: partitioned_attention(g, f, a, b, mesh=mesh)
    )(part, fts, ld, ls)
got = np.asarray(multihost_utils.process_allgather(out, tiled=True))
# replicated output comes back as-is; a tiled gather would stack the two
# (identical) process copies
for piece in got.reshape(-1, *ref.shape):
    np.testing.assert_allclose(piece, ref, atol=2e-5, rtol=2e-5)

print("MP_OK", flush=True)
