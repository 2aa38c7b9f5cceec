"""Child worker for tests/test_multiprocess.py kill-a-host test — NOT a
test module.

Runs a small distributed training loop (edge-partitioned attention over a
2-process / 4-device global mesh, Adam on the logit parameters), with the
coordinator checkpointing the full state to <ckpt>/step_<i>.npz every step.
Argv: pid, port, ckpt_dir, total_steps, start_step. On restart the loop
reloads the latest step_<i>.npz, so killing a host and relaunching both
workers continues the exact trajectory (restart-based elastic recovery,
SURVEY.md §5.3)."""

import glob
import os
import sys

pid = int(sys.argv[1])
port = sys.argv[2]
ckpt_dir = sys.argv[3]
total_steps = int(sys.argv[4])

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

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from han_jax.graph.build import metapath_to_csr  # noqa: E402
from han_jax.graph.synthetic import planted_hetero  # noqa: E402
from han_jax.parallel.edge_partition import partition_csr  # noqa: E402
from han_jax.parallel.mesh import make_mesh  # noqa: E402
from han_jax.parallel.shard_attn import partitioned_attention  # noqa: E402

ds = planted_hetero(n_nodes=120, n_feats=8, n_classes=3, n_metapaths=1,
                    avg_degree=5.0, train_per_class=8, n_val=8, seed=5)
csr = metapath_to_csr(ds.metapath_adjs[0], edge_pad_to=32)
part = partition_csr(csr, 4, edge_pad_to=32)
n, k, d = 120, 2, 4
rng = np.random.default_rng(0)
fts = jnp.asarray(rng.standard_normal((n, k, d)).astype(np.float32))
target = jnp.asarray(rng.standard_normal((n, k, d)).astype(np.float32))

mesh = make_mesh(graph=4, heads=1)
tx = optax.adam(0.05)


def loss_fn(params):
    out = partitioned_attention(part, fts, params["ld"], params["ls"],
                                mesh=mesh)
    return jnp.mean((out - target) ** 2)


@jax.jit
def step(params, opt_state):
    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt_state = tx.update(grads, opt_state)
    return optax.apply_updates(params, updates), opt_state, loss


params = {"ld": jnp.zeros((n, k)), "ls": jnp.zeros((n, k))}
opt_state = tx.init(params)
start = 0
saves = sorted(glob.glob(os.path.join(ckpt_dir, "step_*.npz")),
               key=lambda p: int(p.rsplit("_", 1)[1][:-4]))
if saves:  # resume from the coordinator's latest save (both processes read)
    blob = np.load(saves[-1])
    start = int(blob["step"]) + 1
    params = {"ld": jnp.asarray(blob["ld"]), "ls": jnp.asarray(blob["ls"])}
    opt_state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(opt_state),
        [jnp.asarray(blob[f"opt_{i}"]) for i in range(
            len(jax.tree_util.tree_leaves(opt_state)))])

with jax.set_mesh(mesh):
    for i in range(start, total_steps):
        params, opt_state, loss = step(params, opt_state)
        print(f"STEP {i} {float(loss):.6f}", flush=True)
        if pid == 0:
            np.savez(os.path.join(ckpt_dir, f"step_{i}.npz"),
                     step=i, ld=np.asarray(params["ld"]),
                     ls=np.asarray(params["ls"]),
                     **{f"opt_{j}": np.asarray(l) for j, l in enumerate(
                         jax.tree_util.tree_leaves(opt_state))})

print(f"FINAL {float(loss):.8f}", flush=True)
print("KH_DONE", flush=True)
