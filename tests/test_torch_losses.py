"""The port's 15 loss functions against the JAX package's, on the CPU.

Each loss is held on the same numpy inputs (from a seed) in two ways: its
per-example ``score_array`` on a pre-output, and its gradient through an
``OutputLayer``'s ``pre_output`` (W and b) with the labels mask and the
example weights that the padded pipeline folds into every output's loss
(``sum(w * loss) / max(sum(w), 1)``, one row weighted 0). The JAX side runs
under ``jax_enable_x64`` as its package sets it, on float32 arrays.

Tolerance: 1e-5 relative to each quantity's largest magnitude, plus 1e-7
(float32 sums run in another order in the two frameworks; ``logsumexp``,
the norms and the softmax are each computed by their own library).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import losses as jl
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.multilayer import _fold_weights as jfold
from deeplearning4j_tpu_torch.nn import losses as tl
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.multilayer import _fold_weights as tfold

B, F = 6, 5
RTOL, ATOL = 1e-5, 1e-7

# name: (constructor kwargs, activation, n_out, label kind)
CASES = {
    "LossMCXENT": ({}, "softmax", 4, "onehot"),
    "LossSparseMCXENT": ({}, "softmax", 4, "index"),
    "LossBinaryXENT": ({}, "sigmoid", 4, "binary"),
    "LossMSE": ({}, "identity", 4, "real"),
    "LossL2": ({}, "tanh", 4, "real"),
    "LossMAE": ({}, "identity", 4, "real"),
    "LossL1": ({}, "identity", 4, "real"),
    "LossHinge": ({}, "identity", 4, "binary"),
    "LossSquaredHinge": ({}, "identity", 4, "binary"),
    "LossKLD": ({}, "softmax", 4, "onehot"),
    "LossPoisson": ({}, "softplus", 4, "count"),
    "LossCosineProximity": ({}, "identity", 4, "real"),
    "LossWasserstein": ({}, "identity", 4, "real"),
    "LossFMeasure": ({"beta": 2.0}, "sigmoid", 2, "onehot"),
    "LossMixtureDensity": ({"mixtures": 2, "labels_width": 3}, "identity",
                           2 + 2 + 2 * 3, "real3"),
}


def _labels(kind, rng, n_out):
    if kind == "onehot":
        return np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, B)]
    if kind == "index":
        return rng.integers(0, n_out, (B, 1)).astype(np.float32)
    if kind == "binary":
        return rng.integers(0, 2, (B, n_out)).astype(np.float32)
    if kind == "count":
        return rng.integers(0, 4, (B, n_out)).astype(np.float32)
    if kind == "real3":
        return rng.normal(size=(B, 3)).astype(np.float32)
    return rng.normal(size=(B, n_out)).astype(np.float32)


def _inputs(name):
    kwargs, act, n_out, kind = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    x = rng.normal(size=(B, F)).astype(np.float32)
    W = (rng.normal(size=(F, n_out)) * 0.5).astype(np.float32)
    b = (rng.normal(size=(n_out,)) * 0.1).astype(np.float32)
    pre = rng.normal(size=(B, n_out)).astype(np.float32)
    mask = (rng.random(B) < 0.8).astype(np.float32)
    mask[0] = 1.0
    w = np.ones(B, np.float32)
    w[-1] = 0.0                                     # a padded row
    return kwargs, act, n_out, _labels(kind, rng, n_out), x, W, b, pre, \
        mask, w


def _close(got, want):
    want = np.asarray(want, np.float64)
    tol = RTOL * float(np.abs(want).max()) + ATOL
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol)


def test_every_loss_is_ported():
    want = {n for n, c in vars(jl).items() if isinstance(c, type)
            and issubclass(c, jl.ILossFunction) and c is not jl.ILossFunction}
    got = {n for n, c in vars(tl).items() if isinstance(c, type)
           and issubclass(c, tl.ILossFunction) and c is not tl.ILossFunction}
    assert want == got == set(CASES)
    assert sorted(jl._BY_NAME) == sorted(tl._BY_NAME)
    for name in jl._BY_NAME:
        kw = CASES[type(jl.loss_from_name(name)).__name__][0] \
            if name != "mixture_density" else {}
        assert type(tl.loss_from_name(name, **kw)).__name__ == \
            type(jl.loss_from_name(name, **kw)).__name__


@pytest.mark.parametrize("name", sorted(CASES))
def test_score_array_matches_jax(name):
    kwargs, act, _, labels, _, _, _, pre, mask, _ = _inputs(name)
    want = getattr(jl, name)(**kwargs).score_array(
        jnp.asarray(labels), jnp.asarray(pre), act, jnp.asarray(mask))
    got = getattr(tl, name)(**kwargs).score_array(
        torch.from_numpy(labels), torch.from_numpy(pre), act,
        torch.from_numpy(mask))
    assert got.shape == (B,)
    _close(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_weighted_gradient_through_an_output_layer_matches_jax(name):
    kwargs, act, n_out, labels, x, W, b, _, mask, w = _inputs(name)
    jlayer = JL.OutputLayer(n_in=F, n_out=n_out, activation=act,
                            loss=getattr(jl, name)(**kwargs))
    tlayer = TL.OutputLayer(n_in=F, n_out=n_out, activation=act,
                            loss=getattr(tl, name)(**kwargs))

    def jloss(p):
        pre = jlayer.pre_output(p, jnp.asarray(x))
        s = jlayer.loss.compute_score(
            jnp.asarray(labels), pre, act,
            jfold(jnp.asarray(mask), jnp.asarray(w)), average=False)
        return s / jnp.maximum(jnp.sum(jnp.asarray(w)), 1.0)

    jp = {"W": jnp.asarray(W), "b": jnp.asarray(b)}
    jv, jg = jax.value_and_grad(jloss)(jp)
    tp = {"W": torch.from_numpy(W).requires_grad_(),
          "b": torch.from_numpy(b).requires_grad_()}
    pre = tlayer.pre_output(tp, torch.from_numpy(x))
    tw = torch.from_numpy(w)
    s = tlayer.loss.compute_score(
        torch.from_numpy(labels), pre, act,
        tfold(torch.from_numpy(mask), tw), average=False)
    tv = s / torch.clamp_min(tw.sum(), 1.0)
    gW, gb = torch.autograd.grad(tv, [tp["W"], tp["b"]])
    _close(tv.detach().numpy(), jv)
    _close(gW.numpy(), jg["W"])
    _close(gb.numpy(), jg["b"])
