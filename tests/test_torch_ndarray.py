"""The port's NDArray, factory and random stream
(``deeplearning4j_tpu_torch/ndarray``) against the JAX package's.

A counterpart of each of the 32 cases of ``tests/test_ndarray.py``, on the
CPU (every creator is given ``device="cpu"``; the card is the default), each
held to the JAX package's result where the case computes one; the view
contract (writes through slices, views of views, fancy indices and TADs
reach the base; ``reshape``/``permute``/``T`` are fresh arrays whose writes
do not); and ``factory.write``/``read`` files read by the other package.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import deeplearning4j_tpu as J
import deeplearning4j_tpu_torch as d4t
from deeplearning4j_tpu import factory as jnd
from deeplearning4j_tpu_torch import factory as nd

CPU = "cpu"


class TestBasics:
    def test_create_shape_dtype(self):
        a = nd.create([[1.0, 2.0], [3.0, 4.0]], device=CPU)
        assert a.shape == (2, 2)
        assert a.data_type() == d4t.DataType.FLOAT
        assert a.shape == jnd.create([[1.0, 2.0], [3.0, 4.0]]).shape

    def test_zeros_ones(self):
        assert nd.zeros(3, 4, device=CPU).to_numpy().sum() == 0
        assert nd.ones(3, 4, device=CPU).to_numpy().sum() == 12
        assert nd.ones((3, 4), device=CPU).shape == (3, 4)

    def test_dtype_zoo(self):
        for dt in (d4t.DataType.FLOAT, d4t.DataType.DOUBLE,
                   d4t.DataType.BFLOAT16, d4t.DataType.INT32,
                   d4t.DataType.INT64, d4t.DataType.UINT8,
                   d4t.DataType.BOOL):
            a = nd.zeros(2, 2, dtype=dt, device=CPU)
            assert a.data_type() == dt, dt
            assert a.data_type().value == \
                jnd.zeros(2, 2, dtype=J.DataType(dt.value)).data_type().value

    def test_cast(self):
        a = nd.create([1.5, 2.5], device=CPU)
        b = a.cast(d4t.DataType.INT32)
        assert b.data_type() == d4t.DataType.INT32
        assert b.to_numpy().tolist() == [1, 2] == jnd.create(
            [1.5, 2.5]).cast(J.DataType.INT32).to_numpy().tolist()

    def test_arange_linspace_eye(self):
        assert nd.arange(5, device=CPU).to_numpy().tolist() == [0, 1, 2, 3, 4]
        assert nd.arange(5, device=CPU).to_numpy().dtype == \
            jnd.arange(5).to_numpy().dtype
        np.testing.assert_allclose(nd.linspace(0, 1, 5, device=CPU)
                                   .to_numpy(), [0, 0.25, 0.5, 0.75, 1])
        np.testing.assert_allclose(nd.eye(3, device=CPU).to_numpy(),
                                   np.eye(3))


class TestInPlace:
    def test_addi_muli(self):
        a = nd.create([1.0, 2.0, 3.0], device=CPU)
        a.addi(1.0).muli(2.0)
        assert a.to_numpy().tolist() == [4.0, 6.0, 8.0]

    def test_assign(self):
        a = nd.zeros(2, 3, device=CPU)
        a.assign(7.0)
        assert (a.to_numpy() == 7).all()

    def test_put_scalar(self):
        a = nd.zeros(2, 2, device=CPU)
        a.put_scalar((0, 1), 5.0)
        assert a.get_double(0, 1) == 5.0
        assert a.to_numpy().sum() == 5.0


class TestViews:
    def test_view_read(self):
        a = nd.create(np.arange(12).reshape(3, 4), dtype=d4t.DataType.FLOAT,
                      device=CPU)
        assert a[1].to_numpy().tolist() == [4, 5, 6, 7]

    def test_view_write_aliases_base(self):
        """addi on a slice updates the base."""
        a = nd.create(np.zeros((3, 4)), dtype=d4t.DataType.FLOAT,
                      device=CPU)
        a[1].addi(5.0)
        expected = np.zeros((3, 4))
        expected[1] = 5.0
        np.testing.assert_allclose(a.to_numpy(), expected)
        ja = jnd.create(np.zeros((3, 4)), dtype=J.DataType.FLOAT)
        ja[1].addi(5.0)
        np.testing.assert_array_equal(a.to_numpy(), ja.to_numpy())

    def test_view_of_view_write(self):
        a = nd.create(np.zeros((3, 4)), dtype=d4t.DataType.FLOAT,
                      device=CPU)
        a[2][1:3].assign(9.0)
        assert a.to_numpy()[2, 1] == 9.0 and a.to_numpy()[2, 2] == 9.0
        assert a.to_numpy().sum() == 18.0

    def test_setitem(self):
        a = nd.zeros(3, 3, device=CPU)
        a[0, :] = nd.ones(3, device=CPU)
        assert a.to_numpy()[0].sum() == 3

    def test_tensor_along_dimension(self):
        a = nd.create(np.arange(24).reshape(2, 3, 4),
                      dtype=d4t.DataType.FLOAT, device=CPU)
        tad = a.tensor_along_dimension(1, 2)
        assert tad.to_numpy().tolist() == [4, 5, 6, 7]
        tad.muli(0.0)
        assert a.to_numpy()[0, 1].sum() == 0 and a.to_numpy().sum() == 254

    def test_dup_detaches(self):
        a = nd.create([1.0, 2.0], device=CPU)
        b = a.dup()
        b.addi(10)
        assert a.to_numpy().tolist() == [1.0, 2.0]


class TestShapeOps:
    def test_reshape_permute(self):
        a = nd.arange(6, dtype=d4t.DataType.FLOAT, device=CPU).reshape(2, 3)
        assert a.shape == (2, 3)
        assert a.permute(1, 0).shape == (3, 2)
        assert a.T.shape == (3, 2)
        np.testing.assert_array_equal(a.T.to_numpy(), a.to_numpy().T)

    def test_broadcast(self):
        assert nd.ones(1, 3, device=CPU).broadcast(4, 3).shape == (4, 3)

    def test_concat_stack(self):
        a, b = nd.ones(2, 3, device=CPU), nd.zeros(2, 3, device=CPU)
        assert nd.concat(0, a, b).shape == (4, 3)
        assert nd.concat(1, a, b).shape == (2, 6)
        assert nd.stack(0, a, b).shape == (2, 2, 3)


class TestArithmetic:
    def test_ops(self):
        a = nd.create([1.0, 2.0], device=CPU)
        b = nd.create([3.0, 4.0], device=CPU)
        assert (a + b).to_numpy().tolist() == [4.0, 6.0]
        assert (a - b).to_numpy().tolist() == [-2.0, -2.0]
        assert (a * b).to_numpy().tolist() == [3.0, 8.0]
        assert (b / a).to_numpy().tolist() == [3.0, 2.0]
        assert a.rsub(1.0).to_numpy().tolist() == [0.0, -1.0]
        assert a.rdiv(2.0).to_numpy().tolist() == [2.0, 1.0]

    def test_mmul_rides_dot(self):
        a = nd.create([[1.0, 2.0], [3.0, 4.0]], device=CPU)
        np.testing.assert_allclose(a.mmul(nd.eye(2, device=CPU)).to_numpy(),
                                   a.to_numpy())

    def test_gemm(self):
        rng = np.random.default_rng(0)
        x, c = rng.standard_normal((3, 4)), rng.standard_normal((3, 3))
        a, cc = nd.create(x, device=CPU), nd.create(c, device=CPU)
        out = nd.gemm(a, a, transpose_b=True, alpha=2.0, beta=0.5, c=cc)
        want = jnd.gemm(jnd.create(x), jnd.create(x), transpose_b=True,
                        alpha=2.0, beta=0.5, c=jnd.create(c))
        np.testing.assert_allclose(out.to_numpy(), want.to_numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            out.to_numpy(), 2.0 * (a.to_numpy() @ a.to_numpy().T)
            + 0.5 * cc.to_numpy(), rtol=1e-5)


class TestReductions:
    def test_reductions(self):
        a = nd.create([[1.0, 2.0], [3.0, 4.0]], device=CPU)
        assert a.sum().get_double() == 10.0
        assert a.mean().get_double() == 2.5
        assert a.max().get_double() == 4.0
        assert a.min().get_double() == 1.0
        assert a.sum(0).to_numpy().tolist() == [4.0, 6.0]
        assert a.sum(1).to_numpy().tolist() == [3.0, 7.0]
        assert a.argmax(1).to_numpy().tolist() == [1, 1]
        assert abs(a.norm2().get_double() - np.sqrt(30.0)) < 1e-5
        ja = jnd.create([[1.0, 2.0], [3.0, 4.0]])
        for name in ("norm1", "norm2", "norm_max", "prod"):
            np.testing.assert_allclose(getattr(a, name)(0).to_numpy(),
                                       getattr(ja, name)(0).to_numpy())

    def test_std_bias_correction(self):
        a = nd.create([1.0, 2.0, 3.0, 4.0], device=CPU)
        assert abs(a.std().get_double()
                   - np.std(a.to_numpy(), ddof=1)) < 1e-6
        assert abs(a.std(bias_corrected=False).get_double()
                   - np.std(a.to_numpy())) < 1e-6


class TestRng:
    def test_reproducible(self):
        r = d4t.get_random()
        r.set_seed(42)
        a = r.uniform((100,), device=CPU)
        r.set_seed(42)
        b = r.uniform((100,), device=CPU)
        np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())

    def test_streams_differ(self):
        r = d4t.get_random()
        a = r.uniform((100,), device=CPU)
        b = r.uniform((100,), device=CPU)
        assert not np.allclose(a.to_numpy(), b.to_numpy())

    def test_gaussian_moments(self):
        g = d4t.get_random().gaussian((20000,), mean=1.0, std=2.0,
                                      device=CPU).to_numpy()
        assert abs(g.mean() - 1.0) < 0.1
        assert abs(g.std() - 2.0) < 0.1

    def test_bernoulli(self):
        b = d4t.get_random().bernoulli((10000,), p=0.3,
                                       device=CPU).to_numpy()
        assert abs(b.mean() - 0.3) < 0.05


class TestEnvironment:
    def test_singleton_flags(self):
        env = d4t.Environment.get()
        assert env is d4t.Environment.get()
        env.set_tf32(True)
        assert all(env.tf32_flags().values())
        env.set_tf32(False)
        assert not any(env.tf32_flags().values())
        assert env.resolve_device(CPU).type == "cpu"


class TestReviewRegressions:
    def test_wide_dtypes_without_conftest_help(self):
        a = nd.create([2 ** 40], dtype=d4t.DataType.INT64, device=CPU)
        assert a.to_numpy()[0] == 2 ** 40
        assert nd.zeros(2, dtype=d4t.DataType.DOUBLE,
                        device=CPU).data_type() == d4t.DataType.DOUBLE

    def test_fancy_index_view(self):
        base = nd.create([10.0, 20.0, 30.0], device=CPU)
        sel = base[nd.create([0, 2], dtype=d4t.DataType.INT64, device=CPU)]
        assert sel.to_numpy().tolist() == [10.0, 30.0]
        sel.addi(1.0)
        assert base.to_numpy().tolist() == [11.0, 20.0, 31.0]

    def test_tad_negative_dim(self):
        t = nd.create(np.arange(6).reshape(2, 3), dtype=d4t.DataType.FLOAT,
                      device=CPU)
        assert t.tensor_along_dimension(0, -1).to_numpy().tolist() == \
            [0, 1, 2]

    def test_elementwise_eq(self):
        a = nd.create([1.0, 2.0], device=CPU)
        b = nd.create([1.0, 5.0], device=CPU)
        assert (a == b).to_numpy().tolist() == [True, False]
        assert (a != b).to_numpy().tolist() == [False, True]

    def test_equals_to_f64_precision(self):
        a = nd.create([16777216.0], dtype=d4t.DataType.DOUBLE, device=CPU)
        b = nd.create([16777217.0], dtype=d4t.DataType.DOUBLE, device=CPU)
        assert not a.equals_to(b)
        assert a.equals_to(a.dup())


# --- the contract beyond the JAX cases --------------------------------------------------


@pytest.mark.parametrize("op", ["reshape", "permute", "T", "ravel"])
def test_shape_ops_are_fresh_arrays(op):
    """A write to a reshaped or permuted array never reaches its source
    (PyTorch would alias it; the JAX contract copies)."""
    a = nd.create(np.arange(6.0).reshape(2, 3), device=CPU)
    b = {"reshape": lambda: a.reshape(3, 2), "permute": lambda: a.permute(1, 0),
         "T": lambda: a.T, "ravel": a.ravel}[op]()
    assert not b.is_view
    b.muli(0.0)
    np.testing.assert_array_equal(a.to_numpy(), np.arange(6.0).reshape(2, 3))
    assert b.value.data_ptr() != a.value.data_ptr()


def test_values_handed_out_do_not_change():
    """Writes are functional: a tensor read before a write keeps its
    values."""
    a = nd.create([1.0, 2.0], device=CPU)
    before = a.value
    a.addi(1.0)
    a[0] = 9.0
    assert before.tolist() == [1.0, 2.0]
    assert a.to_numpy().tolist() == [9.0, 3.0]


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert nd.zeros(2).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nd.zeros(2)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_write_read_across_packages(writer, tmp_path):
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    path = str(tmp_path / "a.npy")
    if writer == "port":
        nd.write(nd.create(x, device=CPU), path)
    else:
        jnd.write(jnd.create(x), path)
    with open(path, "rb") as fh:
        data = fh.read()
    other = str(tmp_path / "b.npy")
    (jnd.write(jnd.create(x), other) if writer == "port"
     else nd.write(nd.create(x, device=CPU), other))
    with open(other, "rb") as fh:
        assert fh.read() == data           # the same bytes from both
    np.testing.assert_array_equal(nd.read(path, device=CPU).to_numpy(), x)
    np.testing.assert_array_equal(jnd.read(path).to_numpy(), x)


def test_exports_match_the_jax_package():
    for name in ("NDArray", "factory", "get_random", "set_default_seed"):
        assert name in d4t.__all__ and name in J.__all__
    d4t.set_default_seed(7)
    assert d4t.get_random().get_seed() == 7
    d4t.set_default_seed(119)
