"""The port's random ops (``deeplearning4j_tpu_torch/ops/random.py``)
against the JAX package's.

Streams cannot agree bit for bit (PyTorch's Philox against threefry), so:

- every op's draws have the JAX op's shape and dtype, and their mean and
  variance lie within 6 standard errors of the distribution's
  (``scipy.stats`` moments; the truncated normal's variance at two
  standard deviations is about 0.7737), for 2^18 draws;
- where the JAX op is a function of its draws, the JAX op's own draws are
  given to the port: ``dropout_bp``'s keep mask, ``random_shuffle``'s
  permutation, ``random_crop``'s offsets; the results are equal;
- ``random_multinomial`` draws row ``i`` from logits row ``i`` for any
  batch. The JAX op broadcasts its batch against the samples axis: it
  raises for a batch of 3 and 5 samples, and with 4 rows and 4 samples it
  draws column ``j`` from row ``j`` (ROADMAP.md §C); for one row the two
  agree in distribution.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from deeplearning4j_tpu.ops import random as JR
from deeplearning4j_tpu_torch.ops import random as R
from deeplearning4j_tpu_torch.ops import registry as treg

N = 1 << 18
SHAPE = (1 << 9, 1 << 9)


def gen(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def within_six_se(x: np.ndarray, dist) -> None:
    """Mean and variance of ``x`` within 6 standard errors of ``dist``'s."""
    m, v, _, k = (float(a) for a in dist.stats(moments="mvsk"))
    n = x.size
    x = x.astype(np.float64).ravel()
    assert abs(x.mean() - m) < 6 * np.sqrt(v / n), (x.mean(), m)
    mu4 = (k + 3.0) * v * v
    assert abs(x.var() - v) < 6 * np.sqrt((mu4 - v * v) / n), (x.var(), v)


_T = stats.truncnorm(-2.0, 2.0)
MOMENTS = {
    "random_uniform": ((SHAPE,), {"low": -1.0, "high": 2.0},
                       stats.uniform(-1.0, 3.0)),
    "random_normal": ((SHAPE,), {"mean": 1.0, "stddev": 2.0},
                      stats.norm(1.0, 2.0)),
    "random_truncated_normal": ((SHAPE,), {"mean": 0.5, "stddev": 3.0},
                                stats.truncnorm(-2.0, 2.0, 0.5, 3.0)),
    "random_lognormal": ((SHAPE,), {"mean": 0.0, "stddev": 0.5},
                         stats.lognorm(0.5)),
    "random_bernoulli": ((SHAPE,), {"p": 0.3}, stats.bernoulli(0.3)),
    "random_binomial": ((SHAPE, 5, 0.3), {}, stats.binom(5, 0.3)),
    "random_exponential": ((SHAPE,), {"lam": 2.0}, stats.expon(0, 0.5)),
    "random_gamma": ((SHAPE, 2.5), {"beta": 2.0}, stats.gamma(2.5, 0, 0.5)),
    "random_poisson": ((SHAPE, 3.0), {}, stats.poisson(3.0)),
}


@pytest.mark.parametrize("name", sorted(MOMENTS))
def test_moments_shape_and_dtype(name):
    args, kwargs, dist = MOMENTS[name]
    t = treg.exec_op(name, gen(1), *args, **kwargs)
    small = tuple(args[0][:1]) + (3,)
    j = np.asarray(getattr(JR, name)(jax.random.PRNGKey(0), small,
                                     *args[1:], **kwargs))
    assert tuple(t.shape) == SHAPE
    assert str(t.dtype).split(".")[-1] == str(j.dtype)
    within_six_se(t.numpy(), dist)


def test_truncated_normal_bounds_and_variance():
    t = R.random_truncated_normal(gen(2), SHAPE).numpy()
    assert t.min() > -2.0 and t.max() < 2.0
    assert abs(_T.var() - 0.7737413) < 1e-6
    within_six_se(t, _T)


def test_gamma_below_one_and_float64():
    t = R.random_gamma(gen(3), SHAPE, 0.4, dtype="float64")
    assert t.dtype == torch.float64
    within_six_se(t.numpy(), stats.gamma(0.4))


def test_same_seed_same_draws_and_generator_device():
    a = R.random_normal(gen(5), (4, 3))
    b = R.random_normal(gen(5), (4, 3))
    assert torch.equal(a, b) and a.device.type == "cpu"
    g = gen(5)
    assert not torch.equal(R.random_normal(g, (4, 3)),
                           R.random_normal(g, (4, 3)))


# --- the JAX op's draws given to the port ----------------------------------------


def test_dropout_bp_with_the_jax_mask():
    key = jax.random.PRNGKey(7)
    g = np.random.default_rng(0).standard_normal((64, 32)).astype(np.float32)
    want = np.asarray(JR.dropout_bp(key, jnp.asarray(g), 0.3))
    mask = np.asarray(jax.random.bernoulli(key, 0.7, g.shape))
    got = R.dropout_bp_with(torch.from_numpy(g), torch.from_numpy(mask), 0.3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dropout_bp_rate_of_zeros():
    g = torch.ones(SHAPE)
    out = R.dropout_bp(gen(8), g, 0.25).numpy()
    within_six_se((out == 0).astype(np.float64), stats.bernoulli(0.25))
    assert set(np.unique(out)) == {0.0, np.float32(1.0 / 0.75)}


@pytest.mark.parametrize("axis", [0, 1])
def test_shuffle_with_the_jax_permutation(axis):
    key = jax.random.PRNGKey(11)
    x = np.arange(42, dtype=np.float32).reshape(6, 7)
    want = np.asarray(JR.random_shuffle(key, jnp.asarray(x), axis=axis))
    perm = np.asarray(jax.random.permutation(key, x.shape[axis]))
    got = R.shuffle_with(torch.from_numpy(x), torch.from_numpy(perm), axis)
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = R.random_shuffle(gen(1), torch.from_numpy(x), axis=axis).numpy()
    np.testing.assert_array_equal(np.sort(drawn, axis=axis),
                                  np.sort(x, axis=axis))


def test_crop_with_the_jax_offsets():
    key = jax.random.PRNGKey(13)
    x = np.arange(60, dtype=np.float32).reshape(6, 10)
    want = np.asarray(JR.random_crop(key, jnp.asarray(x), (3, 4)))
    starts = [int(jax.random.randint(k, (), 0, d - c + 1)) for k, d, c in
              zip(jax.random.split(key, 2), x.shape, (3, 4))]
    got = R.crop_with(torch.from_numpy(x), torch.tensor(starts), (3, 4))
    np.testing.assert_array_equal(got.numpy(), want)


def test_crop_offsets_cover_every_window():
    x = torch.arange(20.0).reshape(4, 5)
    g = gen(4)
    seen = {tuple(R.random_crop(g, x, (2, 3))[0, :1].long().tolist())
            for _ in range(400)}
    # 3 row offsets and 3 column offsets: 9 windows, first elements
    assert seen == {(r * 5 + c,) for r in range(3) for c in range(3)}


# --- multinomial ------------------------------------------------------------------------


def test_multinomial_rows_follow_their_logits():
    p = np.array([[0.1, 0.2, 0.3, 0.4], [0.7, 0.1, 0.1, 0.1],
                  [0.25, 0.25, 0.25, 0.25]])
    out = R.random_multinomial(gen(6), torch.from_numpy(np.log(p)), 1 << 16)
    assert out.shape == (3, 1 << 16) and out.dtype == torch.int64
    for i in range(3):
        for c in range(4):
            within_six_se((out[i].numpy() == c).astype(np.float64),
                          stats.bernoulli(p[i, c]))


def test_multinomial_one_row_agrees_with_jax_in_distribution():
    p = np.array([[0.1, 0.2, 0.3, 0.4]])
    logits = np.log(p).astype(np.float32)
    j = np.asarray(JR.random_multinomial(jax.random.PRNGKey(0),
                                         jnp.asarray(logits), 1 << 14))
    t = R.random_multinomial(gen(0), torch.from_numpy(logits), 1 << 14)
    assert t.shape == j.shape and str(t.dtype).split(".")[-1] == str(j.dtype)
    for c in range(4):
        within_six_se((t.numpy() == c).astype(np.float64),
                      stats.bernoulli(p[0, c]))
        within_six_se((j == c).astype(np.float64), stats.bernoulli(p[0, c]))


def test_jax_multinomial_fault_beside_the_port():
    """The JAX op's batch broadcasts against the samples axis: B = 3 with
    5 samples raises; B = 4 with 4 samples draws column j from row j. The
    port draws row i from row i."""
    three = jnp.zeros((3, 4))
    with pytest.raises(ValueError, match="Incompatible shapes"):
        JR.random_multinomial(jax.random.PRNGKey(0), three, 5)
    assert R.random_multinomial(gen(0), torch.zeros(3, 4), 5).shape == (3, 5)
    # row r puts all its mass on class r
    logits = np.full((4, 4), -1e9, np.float32)
    np.fill_diagonal(logits, 0.0)
    j = np.asarray(JR.random_multinomial(jax.random.PRNGKey(1),
                                         jnp.asarray(logits), 4))
    np.testing.assert_array_equal(j, np.tile(np.arange(4), (4, 1)))
    t = R.random_multinomial(gen(1), torch.from_numpy(logits), 4).numpy()
    np.testing.assert_array_equal(t, np.repeat(np.arange(4)[:, None], 4, 1))


# --- through SameDiff -----------------------------------------------------------------


def test_samediff_random_ops_draw_from_the_graph_generator():
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff

    sd = SameDiff(device="cpu")
    u = sd.random_ops.random_uniform((1 << 14,), low=2.0, high=3.0)
    p = sd.random_ops.random_poisson((1 << 14,), 4.0)
    a = sd.output({}, [u.name, p.name])
    b = sd.output({}, [u.name, p.name])
    assert not torch.equal(a[u.name], b[u.name])
    assert a[p.name].dtype == torch.int32
    within_six_se(a[u.name].numpy(), stats.uniform(2.0, 1.0))
    within_six_se(a[p.name].numpy(), stats.poisson(4.0))
