"""Full HAN model on the csr edge-domain backend: eval-mode equivalence
with the dense oracle, train-mode gradient sanity with coefficient
dropout, prof utils."""

import jax
import jax.numpy as jnp
import numpy as np

from han_jax.graph.build import metapath_to_csr, metapath_to_dense
from han_jax.graph.synthetic import planted_hetero
from han_jax.nn.losses import masked_softmax_cross_entropy
from han_jax.nn.models import HAN


def setup():
    ds = planted_hetero(n_nodes=100, n_feats=24, n_classes=3, n_metapaths=2,
                        avg_degree=7.0, train_per_class=10, n_val=16, seed=21)
    graphs = [metapath_to_dense(a) for a in ds.metapath_adjs]
    csrs = [metapath_to_csr(a) for a in ds.metapath_adjs]
    x = jnp.asarray(ds.features)
    return ds, graphs, csrs, [x, x]


def test_flash_model_matches_dense_eval():
    ds, graphs, csrs, xs = setup()
    m_csr = HAN(n_classes=3, hid_units=(8,), n_heads=(2, 1), impl="csr")
    m_dense = HAN(n_classes=3, hid_units=(8,), n_heads=(2, 1), impl="dense")
    params = m_dense.init(jax.random.PRNGKey(0), graphs, xs)
    out_d = m_dense.apply(params, graphs, xs)
    out_f = m_csr.apply(params, csrs, xs)
    for a, b in zip(out_d, out_f):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=1e-4, rtol=1e-3)


def test_flash_model_train_step_with_dropout():
    ds, graphs, csrs, xs = setup()
    graphs = csrs
    model = HAN(n_classes=3, hid_units=(8,), n_heads=(2, 1), impl="csr",
                attn_drop=0.4, ffd_drop=0.4)
    params = model.init(jax.random.PRNGKey(0), graphs, xs)
    labels = jnp.asarray(ds.labels)
    mask = jnp.asarray(ds.train_mask)

    def loss_fn(p, key):
        logits, _, _ = model.apply(p, graphs, xs, deterministic=False,
                                   rngs={"dropout": key})
        return masked_softmax_cross_entropy(logits, labels, mask)

    loss, grads = jax.value_and_grad(loss_fn)(params, jax.random.PRNGKey(1))
    assert np.isfinite(float(loss))
    leaves = jax.tree_util.tree_leaves(grads)
    assert all(np.isfinite(np.asarray(g)).all() for g in leaves)
    assert sum(float(jnp.abs(g).sum()) for g in leaves) > 0.0
    # different dropout keys → different losses
    loss2 = loss_fn(params, jax.random.PRNGKey(2))
    assert float(loss) != float(loss2)


def test_prof_utils():
    from han_jax.utils.prof import StepTimer, checked, device_memory_stats, edges_per_sec

    assert edges_per_sec(1000, 8, 0.5) == 16000.0
    stats = device_memory_stats()
    assert len(stats) == len(jax.devices())

    t = StepTimer()
    x = jnp.ones((4,))
    with t.step(lambda: x.sum()):
        pass
    assert t.median >= 0

    def f(v):
        return jnp.log(v)

    cf = checked(f)
    out = cf(jnp.asarray([1.0]))
    assert np.isfinite(np.asarray(out)).all()
    try:
        cf(jnp.asarray([-1.0]))
        raised = False
    except Exception:
        raised = True
    assert raised, "checkify should flag NaN from log(-1)"
