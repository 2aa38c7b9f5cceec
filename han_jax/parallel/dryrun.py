"""Multi-device dry run: jit the FULL sharded HAN training step over an
n-device mesh and execute one step on tiny shapes.

Exercises, on a real ``jax.sharding.Mesh``, both distributed attention
backends:
- ``PartitionedCSR`` + shard_map XLA segment ops (parallel/shard_attn.py);
- ``PartitionedCSR2D`` + the ring halo exchange with sharded features
  (parallel/ring_attn.py);
- heads-axis model parallelism (attention heads sharded);
- replicated-parameter data flow with psum'd gradients (generated by AD
  through the shard_map collectives);
- Adam update + masked loss — i.e. the complete training step, not just a
  forward pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax

from han_jax.graph.build import metapath_to_csr
from han_jax.graph.synthetic import planted_hetero
from han_jax.nn.losses import l2_regularizer, masked_softmax_cross_entropy
from han_jax.nn.models import HAN
from han_jax.parallel.edge_partition import partition_csr
from han_jax.parallel.mesh import make_mesh
from han_jax.parallel.ring_attn import partition_csr_2d


def run_dryrun(n_devices: int) -> None:
    devices = jax.devices()
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
    # split the mesh over both axes when possible (graph × heads)
    heads_axis = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    graph_axis = n_devices // heads_axis
    mesh = make_mesh(graph=graph_axis, heads=heads_axis,
                     devices=np.asarray(devices[:n_devices]))

    n_heads = max(heads_axis * 2, 4)  # K divisible by heads axis
    ds = planted_hetero(n_nodes=128 * max(graph_axis, 2), n_feats=16,
                        n_classes=3, n_metapaths=2, avg_degree=5.0,
                        train_per_class=8, n_val=8, seed=3)
    csrs = [metapath_to_csr(a, edge_pad_to=32) for a in ds.metapath_adjs]
    backends = {
        "csr": [partition_csr(c, graph_axis, edge_pad_to=32) for c in csrs],
        "ring": [partition_csr_2d(c, graph_axis, pad_to=32) for c in csrs],
    }

    model = HAN(n_classes=ds.n_classes, hid_units=(8,), n_heads=(n_heads, 1),
                semantic_dim=16, attn_drop=0.3, ffd_drop=0.3)
    x = jnp.asarray(ds.features)
    labels = jnp.asarray(ds.labels)
    mask = jnp.asarray(ds.train_mask)

    losses = {}
    det_losses = {}
    shared_params = None
    with jax.set_mesh(mesh):
        for name, graphs in backends.items():
            xs = [x for _ in graphs]
            params = model.init(jax.random.PRNGKey(0), graphs, xs)
            # cross-backend equivalence: with dropout off the distributed
            # backends compute the SAME masked softmax aggregate, so their
            # losses must agree to fp tolerance — assert it with one set of
            # params shared across backends (init is backend-independent:
            # same shapes, same PRNG).
            if shared_params is None:
                shared_params = params

            @jax.jit
            def det_loss(params, graphs, xs):
                logits, _, _ = model.apply(params, graphs, xs,
                                           deterministic=True)
                return masked_softmax_cross_entropy(logits, labels, mask)

            det_losses[name] = float(det_loss(shared_params, graphs, xs))
            tx = optax.adam(5e-3)
            opt_state = tx.init(params)

            @jax.jit
            def train_step(params, opt_state, rng, graphs, xs):
                def loss_fn(p):
                    logits, _, _ = model.apply(
                        p, graphs, xs, deterministic=False,
                        rngs={"dropout": rng})
                    return masked_softmax_cross_entropy(logits, labels, mask) + \
                        l2_regularizer(p, 1e-3)

                loss, grads = jax.value_and_grad(loss_fn)(params)
                updates, opt_state = tx.update(grads, opt_state)
                return optax.apply_updates(params, updates), opt_state, loss

            params, opt_state, loss = train_step(params, opt_state,
                                                 jax.random.PRNGKey(1),
                                                 graphs, xs)
            losses[name] = float(loss)
            assert np.isfinite(losses[name]), f"non-finite {name} loss"
    vals = list(det_losses.values())
    max_dev = max(abs(v - vals[0]) for v in vals)
    assert max_dev < 1e-4, (
        f"deterministic losses disagree across backends: {det_losses} "
        f"(max deviation {max_dev:.2e})")
    print(f"dryrun_multidevice ok: mesh={dict(zip(mesh.axis_names, mesh.devices.shape))} "
          + " ".join(f"{k}_loss={v:.4f}" for k, v in losses.items())
          + f" det_max_dev={max_dev:.2e}")
