"""The plain-JAX modules: parameter names, shapes and initialisers, the
train/eval (``deterministic``) flag and its dropout keys, and the vmapped
tower stack against the sequential towers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from han_jax.graph.build import metapath_to_csr, metapath_to_dense
from han_jax.graph.stack import stack_graphs
from han_jax.nn.layers import ConstAttention, GATConv, SemanticAttention
from han_jax.nn.models import GAT, HAN, HANShared


def _inputs(ds, kind="csr"):
    build = metapath_to_csr if kind == "csr" else metapath_to_dense
    graphs = [build(a) for a in ds.metapath_adjs]
    x = jnp.asarray(ds.features)
    return graphs, [x for _ in graphs]


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


def test_gatconv_param_names_and_shapes(tiny_ds):
    graphs, xs = _inputs(tiny_ds)
    f = xs[0].shape[1]
    v = GATConv(out_dim=5, num_heads=3).init(jax.random.PRNGKey(0),
                                             graphs[0], xs[0])
    assert _shapes(v) == {"params": {
        "kernel": (f, 3, 5), "attn_dst_kernel": (3, 5), "attn_dst_bias": (3,),
        "attn_src_kernel": (3, 5), "attn_src_bias": (3,), "bias": (3, 5)}}
    # a residual connection across a width change adds its projection
    res = GATConv(out_dim=5, num_heads=3, residual=True).init(
        jax.random.PRNGKey(0), graphs[0], xs[0])
    assert _shapes(res)["params"]["res_kernel"] == (f, 3, 5)


@pytest.mark.parametrize("arch", ["han", "han_shared", "han_vmap", "gat"])
def test_model_param_tree(tiny_ds, arch):
    graphs, xs = _inputs(tiny_ds)
    f, c, p = xs[0].shape[1], tiny_ds.n_classes, len(graphs)
    tower = {"GATConv_0": {"kernel": (f, 4, 8), "attn_dst_kernel": (4, 8),
                           "attn_dst_bias": (4,), "attn_src_kernel": (4, 8),
                           "attn_src_bias": (4,), "bias": (4, 8)}}
    head = {"SemanticAttention_0": {"w_omega": (32, 16), "b_omega": (16,),
                                    "u_omega": (16,)},
            "classifier_0": {"kernel": (32, c), "bias": (c,)},
            "classifier_1": {"kernel": (32, c), "bias": (c,)}}
    kw = dict(n_classes=c, hid_units=(8,), n_heads=(4, 2), semantic_dim=16)
    key = jax.random.PRNGKey(0)
    if arch == "han":
        got = HAN(**kw).init(key, graphs, xs)
        want = {**{f"tower_{i}": tower for i in range(p)}, **head}
    elif arch == "han_shared":
        got = HANShared(**kw).init(key, graphs, xs[0])
        want = {**{f"tower_{i}": tower for i in range(p)}, **head}
    elif arch == "han_vmap":
        got = HAN(vmap_towers=True, **kw).init(key, stack_graphs(graphs),
                                               jnp.stack(xs))
        want = {"towers": jax.tree_util.tree_map(
            lambda s: (p,) + s, tower, is_leaf=lambda s: isinstance(s, tuple)),
            **head}
    else:
        got = GAT(n_classes=c, hid_units=(8,), n_heads=(4, 2)).init(
            key, graphs[0], xs[0])
        want = {"GATConv_0": tower["GATConv_0"],
                "GATConv_1": {"kernel": (32, 2, c), "attn_dst_kernel": (2, c),
                              "attn_dst_bias": (2,), "attn_src_kernel": (2, c),
                              "attn_src_bias": (2,), "bias": (2, c)}}
    assert _shapes(got) == {"params": want}


def test_initialisers():
    """glorot-uniform kernels inside their bound, zero biases, normal(0.1)
    semantic-attention params (flax's initialisers, reference inits)."""
    f, k, d = 300, 8, 8
    p = GATConv(out_dim=d, num_heads=k).init_params(jax.random.PRNGKey(1), f)
    w = np.asarray(p["kernel"])
    bound = np.sqrt(6.0 / (f * k + f * d))  # fan_in = f·k, fan_out = f·d
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound
    assert abs(w.std() - bound / np.sqrt(3.0)) < 0.05 * bound
    for b in ("attn_dst_bias", "attn_src_bias", "bias"):
        np.testing.assert_array_equal(np.asarray(p[b]), 0.0)
    s = SemanticAttention(attention_dim=512).init_params(jax.random.PRNGKey(2), 256)
    assert abs(float(np.asarray(s["w_omega"]).std()) - 0.1) < 0.005
    # distinct params draw distinct values
    assert not np.allclose(np.asarray(p["attn_dst_kernel"]),
                           np.asarray(p["attn_src_kernel"]))


def test_deterministic_flag_and_dropout_keys(tiny_ds):
    graphs, xs = _inputs(tiny_ds)
    model = HAN(n_classes=tiny_ds.n_classes, hid_units=(8,), n_heads=(2, 1),
                attn_drop=0.5, ffd_drop=0.5)
    v = model.init(jax.random.PRNGKey(0), graphs, xs)
    ev = model.apply(v, graphs, xs)
    # eval mode ignores any key it is given
    ev_key = model.apply(v, graphs, xs, rngs={"dropout": jax.random.PRNGKey(3)})
    np.testing.assert_array_equal(np.asarray(ev[0]), np.asarray(ev_key[0]))
    key = {"dropout": jax.random.PRNGKey(4)}
    tr1 = model.apply(v, graphs, xs, deterministic=False, rngs=key)
    tr2 = model.apply(v, graphs, xs, deterministic=False, rngs=key)
    np.testing.assert_array_equal(np.asarray(tr1[0]), np.asarray(tr2[0]))
    assert not np.allclose(np.asarray(tr1[0]), np.asarray(ev[0]))
    with pytest.raises(ValueError, match="dropout"):
        model.apply(v, graphs, xs, deterministic=False)


def test_const_attention_is_uniform_over_neighbors(tiny_ds):
    graphs, xs = _inputs(tiny_ds, "dense")
    g, x = graphs[0], xs[0]
    layer = ConstAttention(out_dim=4, num_heads=2, activation=lambda v: v)
    v = layer.init(jax.random.PRNGKey(0), g, x)
    out = np.asarray(layer.apply(v, g, x)).reshape(x.shape[0], 2, 4)
    adj = np.asarray(g.adj, np.float64)
    fts = np.einsum("nf,fkd->nkd", np.asarray(x), np.asarray(v["params"]["kernel"]))
    want = np.einsum("nm,mkd->nkd", adj / adj.sum(1, keepdims=True), fts)
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("deterministic", [True, False])
def test_vmap_towers_equal_sequential_towers(tiny_ds, deterministic):
    """Tower p draws init and dropout keys from fold_in(key, p) in both
    layouts, so the vmapped stack reproduces the sequential towers exactly —
    parameters and, in training mode, dropout masks."""
    graphs, xs = _inputs(tiny_ds)
    kw = dict(n_classes=tiny_ds.n_classes, hid_units=(8,), n_heads=(2, 1),
              attn_drop=0.4, ffd_drop=0.4)
    seq, ep = HAN(**kw), HAN(vmap_towers=True, **kw)
    stacked, xs_st = stack_graphs(graphs), jnp.stack(xs)
    v_seq = seq.init(jax.random.PRNGKey(0), graphs, xs)
    v_ep = ep.init(jax.random.PRNGKey(0), stacked, xs_st)
    for p in range(len(graphs)):
        for a, b in zip(jax.tree_util.tree_leaves(v_seq["params"][f"tower_{p}"]),
                        jax.tree_util.tree_leaves(v_ep["params"]["towers"])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b)[p])
    rngs = None if deterministic else {"dropout": jax.random.PRNGKey(9)}
    o_seq = seq.apply(v_seq, graphs, xs, deterministic=deterministic, rngs=rngs)
    o_ep = ep.apply(v_ep, stacked, xs_st, deterministic=deterministic, rngs=rngs)
    for a, b in zip(o_seq, o_ep):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=2e-5, atol=2e-5)
