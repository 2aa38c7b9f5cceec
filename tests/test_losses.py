"""Loss/metric semantics vs independent numpy/sklearn references
(SURVEY.md §4.6), including the reference's mask mean-normalization."""

import jax
import jax.numpy as jnp
import numpy as np
from sklearn.metrics import f1_score

from han_jax.nn.losses import (
    class_weighted_cross_entropy, l2_regularizer, masked_accuracy,
    masked_sigmoid_cross_entropy, masked_softmax_cross_entropy, micro_f1,
)


def _case(seed=0, n=50, c=4):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, c)).astype(np.float32)
    y = rng.integers(0, c, n)
    labels = np.eye(c, dtype=np.float32)[y]
    mask = rng.random(n) < 0.4
    if not mask.any():
        mask[0] = True
    return logits, labels, mask


def test_masked_softmax_ce_equals_mean_over_masked():
    logits, labels, mask = _case()
    got = float(masked_softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)))
    # mask/mean(mask) then global mean == plain mean over masked nodes
    z = logits - logits.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    per_node = -(labels * logp).sum(axis=1)
    expected = per_node[mask].mean()
    np.testing.assert_allclose(got, expected, rtol=1e-5)


def test_masked_accuracy():
    logits, labels, mask = _case(1)
    got = float(masked_accuracy(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)))
    expected = (logits.argmax(1) == labels.argmax(1))[mask].mean()
    np.testing.assert_allclose(got, expected, rtol=1e-5)


def test_masked_sigmoid_ce():
    rng = np.random.default_rng(2)
    n, c = 30, 7
    logits = rng.standard_normal((n, c)).astype(np.float32)
    labels = (rng.random((n, c)) < 0.3).astype(np.float32)
    mask = rng.random(n) < 0.5
    mask[0] = True
    got = float(masked_sigmoid_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)))
    bce = np.maximum(logits, 0) - logits * labels + np.log1p(np.exp(-np.abs(logits)))
    expected = bce.mean(axis=1)[mask].mean()
    np.testing.assert_allclose(got, expected, rtol=1e-5)


def test_micro_f1_matches_sklearn():
    rng = np.random.default_rng(3)
    n, c = 40, 9
    logits = rng.standard_normal((n, c)).astype(np.float32)
    labels = (rng.random((n, c)) < 0.4).astype(np.int32)
    mask = np.ones(n, bool)
    got = float(micro_f1(jnp.asarray(logits), jnp.asarray(labels),
                         jnp.asarray(mask)))
    pred = (1 / (1 + np.exp(-logits)) >= 0.5).astype(np.int32)
    expected = f1_score(labels.ravel(), pred.ravel(), average="binary")
    np.testing.assert_allclose(got, expected, rtol=1e-5)


def test_l2_regularizer_covers_all_params():
    params = {"a": {"kernel": jnp.ones((2, 3)), "bias": jnp.full((3,), 2.0)}}
    got = float(l2_regularizer(params, 0.1))
    expected = 0.1 * 0.5 * (6 * 1.0 + 3 * 4.0)  # biases included (see docstring)
    np.testing.assert_allclose(got, expected, rtol=1e-6)


def test_class_weighted_ce():
    rng = np.random.default_rng(5)
    n, c = 20, 3
    logits = rng.standard_normal((n, c)).astype(np.float32)
    y = rng.integers(0, c, n)
    w = np.array([1.0, 2.0, 0.5], np.float32)
    got = float(class_weighted_cross_entropy(
        jnp.asarray(logits), jnp.asarray(y), c, jnp.asarray(w)))
    z = logits - logits.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    expected = (-logp[np.arange(n), y] * w[y]).mean()
    np.testing.assert_allclose(got, expected, rtol=1e-5)
