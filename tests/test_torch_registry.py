"""The port's op registry (``deeplearning4j_tpu_torch/ops``) against the JAX
package's, op by op.

One parametrised case per registered op (the recurrent family has its own,
``test_torch_recurrent.py``): the same seeded numpy inputs, taken from the
shapes and values of ``tests/test_op_validation.py``, go through JAX
``exec_op`` and port ``exec_op`` (on the CPU). Tolerances:

- float32 results within ``atol = rtol = 1e-5`` unless a case says more
  (special functions and iterative ones: 1e-4 .. 1e-3, stated per case);
- integer, boolean and shape results exactly;
- decompositions as the JAX suite checks them: reconstructions, absolute
  values of sign-ambiguous vectors, sorted eigenvalues;
- the dropout and noise ops with one injected draw shared by both packages
  (``torch_parity.inject_draws``), since threefry and PyTorch's generator
  cannot agree bit for bit.

The JAX package runs with x64 on, so ops that JAX computes in float64 on a
Python scalar (``linspace``, float ``range``, ``eye``) are compared by
value; the port returns float32 there.

The ledger tests: the port's registry is the JAX registry (331 ops), each
of the 13 ``random`` ops runs from a generator to the JAX op's shape and
dtype (their distributions are ``test_torch_random_ops.py``'s), and every
other op has a case here or in the recurrent suite.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import torch

from deeplearning4j_tpu.ops import registry as jreg
from deeplearning4j_tpu_torch.ops import registry as treg

from torch_parity import inject_draws

KEY = object()          # stands for jax.random.PRNGKey(0) / seed 0


def r(*shape, dtype=np.float32, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def pos(*shape, seed=0):
    return (np.abs(r(*shape, seed=seed)) + 0.1).astype(np.float32)


def ri(*shape, lo=0, hi=5, seed=0, dtype=np.int32):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(dtype)


def unit(*shape, seed=0):
    return np.random.RandomState(seed).uniform(-0.9, 0.9, shape).astype(
        np.float32)


def spd(n, seed=0):
    a = r(n, n, seed=seed).astype(np.float64)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


CASES = {}


def case(name, *args, atol=1e-5, rtol=1e-5, check=None, inject=None,
         **kwargs):
    """Register the parity case of op ``name``: ``check(j, t, args)``
    replaces the default comparison; ``inject`` is the ``(masks,
    normals)`` both packages draw."""
    assert name not in CASES, name
    CASES[name] = dict(args=args, kwargs=kwargs, atol=atol, rtol=rtol,
                       check=check, inject=inject)


# --- broadcastable ------------------------------------------------------------

X34, Y34 = r(3, 4), r(3, 4, seed=1)
for _n in ("add", "subtract", "multiply", "divide", "reversesubtract",
           "reversedivide", "squaredsubtract", "maximum", "minimum",
           "atan2"):
    case(_n, X34, Y34)
case("pow", np.abs(X34), Y34, atol=1e-4)
_IX = np.array([7, -7, 9, -9, 6], dtype=np.int32)
_IY = np.array([3, 3, -4, -4, -4], dtype=np.int32)
for _n in ("mod", "floormod", "floordiv", "truncatediv"):
    case(_n, _IX, _IY)
_A = np.array([True, True, False, False])
_B = np.array([True, False, True, False])
for _n in ("boolean_and", "boolean_or", "boolean_xor"):
    case(_n, _A, _B)
case("boolean_not", _A)
_CX, _CY = ri(5, 4, hi=3), ri(5, 4, hi=3, seed=1)
for _n in ("equals", "not_equals", "less", "less_equal", "greater",
           "greater_equal"):
    case(_n, _CX.astype(np.float32), _CY.astype(np.float32))

# --- transforms ---------------------------------------------------------------

X45 = r(4, 5)
P45 = np.abs(X45) + 0.1
for _n in ("abs", "neg", "sign", "ceil", "floor", "square", "cube", "exp",
           "expm1", "sin", "cos", "tan", "atan", "sinh", "cosh", "tanh",
           "asinh", "erf", "erfc", "relu", "relu6", "selu", "gelu",
           "gelu_exact", "mish", "swish", "sigmoid", "hardsigmoid",
           "hardtanh", "rationaltanh", "rectifiedtanh", "softplus",
           "softsign", "identity", "step", "isnan", "isinf", "isfinite",
           "stop_gradient", "cbrt"):
    case(_n, X45 * 2.0, atol=2e-5)
case("round", np.array([0.5, 1.5, 2.5, -0.5, -1.5, 1.2, -2.7], np.float32))
case("rint", np.array([0.5, 1.5, 2.5, -0.5, -1.5, 1.2, -2.7], np.float32))
for _n in ("reciprocal", "sqrt", "rsqrt", "log", "log1p", "log2", "log10",
           "lgamma", "digamma"):
    case(_n, P45, atol=1e-4, rtol=1e-4)
for _n in ("asin", "acos", "atanh", "erfinv"):
    case(_n, unit(4, 5), atol=1e-5)
case("acosh", P45 + 1.0)
case("clip_by_value", X45, clip_min=-0.5, clip_max=0.7)
case("clip_by_norm", X45, clip_norm=1.5)
case("clip_by_global_norm", X45, r(3, seed=2), clip_norm=1.0)
case("leakyrelu", X45, alpha=0.2)
case("prelu", r(2, 3, 4), r(3, 1, seed=1))
case("thresholdedrelu", X45, theta=0.5)
case("elu", X45, alpha=0.7)
case("softmax", X45, axis=0)
case("log_softmax", X45, axis=-1)
case("cast", X45 * 3, dtype="int32")
case("einsum", r(2, 3), r(3, 4, seed=1), equation="ij,jk->ik")
case("tf_strided_slice", r(4, 6, 5),
     spec=[["slice", 1, None, 2], ["ellipsis"], ["slice", None, None, -1]])
case("polygamma", np.float32(1), P45, atol=1e-3, rtol=1e-4)
case("zeta", np.array([2.0, 3.0, 4.5], np.float32),
     np.array([1.0, 2.5, 0.7], np.float32), atol=1e-4, rtol=1e-4)
case("igamma", np.array([0.5, 1.0, 3.0], np.float32),
     np.array([0.3, 1.7, 2.0], np.float32), atol=1e-5)
case("igammac", np.array([0.5, 1.0, 3.0], np.float32),
     np.array([0.3, 1.7, 2.0], np.float32), atol=1e-5)
case("betainc", np.array([0.5, 2.0, 5.0, 1.5], np.float32),
     np.array([0.5, 3.0, 1.0, 7.0], np.float32),
     np.array([0.2, 0.5, 0.9, 0.1], np.float32), atol=1e-5)
case("roll", r(3, 4), 2, axis=1)
case("standardize", r(3, 6), dims=(-1,), atol=1e-5)

# --- reduce -------------------------------------------------------------------

X345 = r(3, 4, 5)
for _n in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
           "reduce_norm1", "reduce_norm2", "reduce_norm_max",
           "reduce_sqnorm", "reduce_logsumexp", "reduce_amean",
           "reduce_amax", "reduce_amin"):
    case(_n, X345, dims=(0, 2), keep_dims=True)
case("reduce_prod", X345 * 0.5 + 1, dims=(1,))
case("reduce_variance", X345, dims=(1, 2), bias_corrected=True)
case("reduce_stdev", X345, dims=(0,), bias_corrected=False)
case("count_nonzero", ri(4, 5, hi=3), dims=(1,))
case("count_zero", ri(4, 5, hi=3), dims=None)
case("all", ri(4, 5, hi=2).astype(bool), dims=(0,))
case("any", ri(4, 5, hi=2).astype(bool), dims=(1,), keep_dims=True)
_TIES = np.array([[1.0, 3.0, 3.0, -4.0], [2.0, 2.0, -2.0, 0.5]],
                 np.float32)
case("argmax", _TIES, dims=(1,))
case("argmin", _TIES, dims=(0,))
case("argamax", _TIES, dims=(1,))
case("argamin", _TIES, dims=(1,))
case("cumsum", X345, axis=1, exclusive=True, reverse=True)
case("cumprod", X345 * 0.5 + 1, axis=2, exclusive=False, reverse=True)
case("dot", X34, Y34, dims=(1,))
case("cosine_similarity", X34, Y34, dims=(1,))
case("cosine_distance", X34, Y34, dims=(1,))
case("euclidean_distance", X34, Y34, dims=(1,))
case("manhattan_distance", X34, Y34)
case("hamming_distance", ri(3, 4, hi=2), ri(3, 4, hi=2, seed=1), dims=(1,))
case("jaccard_distance", np.abs(X34), np.abs(Y34), dims=(1,))
case("moments", X345, dims=(0, 1))
case("normalize_moments", np.float32(4.0), r(3), pos(3, seed=1),
     shift=0.5)
case("zero_fraction", ri(4, 5, hi=3).astype(np.float32))
case("percentile", r(20), 30.0, interpolation="linear")

# --- shape --------------------------------------------------------------------

case("reshape", X345, (4, 15))
case("permute", X345, (2, 0, 1))
case("transpose", X345)
case("expand_dims", X34, axis=1)
case("squeeze", r(3, 1, 4, 1), axis=(1, 3))
case("concat", X34, Y34, axis=1)
case("split", r(4, 6), 3, axis=1)
case("split_v", r(4, 6), (1, 2, 3), axis=1)
case("stack", X34, Y34, axis=1)
case("unstack", X345, axis=1)
case("tile", X34, (2, 3))
case("repeat", X34, 2, axis=0)
case("reverse", X345, (0, 2))
case("pad", X34, ((1, 2), (2, 1)), mode="reflect")
case("gather", r(5, 3), ri(2, 3, hi=5), axis=0)
case("gather_nd", X345, ri(4, 2, hi=3))
_REF = r(6, 3)
_IDX = np.array([4, 1, 1, 3], np.int64)
_UPD = r(4, 3, seed=3)
for _n in ("scatter_add", "scatter_sub", "scatter_mul", "scatter_max",
           "scatter_min"):
    case(_n, _REF, _IDX, _UPD)
case("scatter_div", _REF, _IDX, np.abs(_UPD) + 0.5)
case("scatter_update", _REF, np.array([4, 1, 0], np.int64), r(3, 3, seed=4))
case("slice", r(5, 6), (1, 4), (3, 3))
case("strided_slice", r(6, 7), (5, 1), (0, 7), (-2, 3))
case("size", X345)
case("shape_of", X345)
case("rank", X345)
case("fill", (2, 3), 1.5)
case("zeros_as", X34)
case("ones_as", X34)
case("linspace", 0.0, 1.0, 7)
case("range", 2, 11, 3)
case("eye", 3, 5)
case("diag", r(2, 2))
case("diag_part", r(4, 4))
case("matrix_diag", r(2, 3))
case("matrix_diag_part", r(2, 3, 3))
case("matrix_set_diag", r(2, 3, 4), r(2, 3, seed=1))
case("broadcast_to", r(3, 1), (2, 3, 4))
case("meshgrid", r(3), r(4, seed=1), indexing="ij")
case("where", ri(3, 4, hi=2).astype(bool), X34, Y34)
case("select", ri(3, 4, hi=2).astype(bool), X34, Y34)
case("boolean_mask", r(5, 2), np.array([True, False, True, True, False]))
case("one_hot", np.array([0, 2, -1, 5, 1]), 4, on_value=2.0,
     off_value=-1.0, axis=0)
case("flatten_2d", X345, axis=2)
case("top_k", np.array([[1.0, 3.0, 3.0, -4.0, 3.0], [2.0, 2.0, -2.0, 0.5,
                                                       9.0]], np.float32), 3)
case("in_top_k", r(4, 6), np.array([0, 5, 2, 3]), 2)
case("unique", np.array([3, 1, 3, 7, 1, 0], np.int32))
case("sequence_mask", np.array([1, 3, 0, 4]), 5)
case("confusion_matrix", np.array([0, 1, 2, 2, 1]),
     np.array([0, 2, 2, 1, 1]), 3)
case("dynamic_partition", r(6), np.array([0, 1, 2, 1, 0, 2]), 3)
case("dynamic_stitch", [np.array([0, 2]), np.array([1, 3])],
     [r(2, 3), r(2, 3, seed=1)])
_SEG = np.array([0, 0, 1, 3, 3, 3], np.int32)
_USEG = np.array([3, 0, 1, 0, 3, 1], np.int32)
_DATA = r(6, 2)
for _n in ("segment_sum", "segment_mean", "segment_max", "segment_min",
           "segment_prod"):
    case(_n, _DATA, _SEG, 4)
for _n in ("unsorted_segment_sum", "unsorted_segment_mean",
           "unsorted_segment_max", "unsorted_segment_min",
           "unsorted_segment_prod", "unsorted_segment_sqrt_n"):
    case(_n, _DATA, _USEG, 5)
case("space_to_depth", r(2, 4, 6, 3), 2, data_format="NHWC")
case("depth_to_space", r(2, 8, 3, 2), 2, data_format="NCHW")
case("batch_to_space", r(8, 2, 3, 2), (2, 2), ((0, 1), (1, 0)))
case("space_to_batch", r(2, 3, 5, 2), (2, 2), ((1, 0), (0, 1)))
case("mirror_pad", X34, ((1, 2), (3, 2)), mode="symmetric")
case("searchsorted", np.array([1.0, 2.0, 2.0, 5.0], np.float32),
     np.array([0.5, 2.0, 4.0, 6.0], np.float32), side="right")
case("bincount", np.array([1, 1, 3, 7, -2, 0]), length=5)
case("histogram_fixed_width", r(30), np.array([-1.0, 1.0], np.float32),
     nbins=6)
case("nth_element", r(3, 7), 2, reverse=True)

# --- linalg -------------------------------------------------------------------


def _abs_close(j, t, args, atol=1e-4):
    for a, b in zip(j, t):
        np.testing.assert_allclose(np.abs(a), np.abs(b), atol=atol)


def _check_svd(j, t, args):
    s, u, v = t
    np.testing.assert_allclose(s, j[0], atol=1e-4)
    np.testing.assert_allclose((u * s) @ v.T, args[0], atol=1e-4)
    _abs_close(j[1:], t[1:], args)


def _check_qr(j, t, args):
    q, rr = t
    np.testing.assert_allclose(q @ rr, args[0], atol=1e-4)
    _abs_close(j, t, args)


def _check_lu(j, t, args):
    lu, piv = t
    n = lu.shape[0]
    low = np.tril(lu, -1) + np.eye(n)
    up = np.triu(lu)
    perm = np.arange(n)
    for i, p in enumerate(piv):
        perm[[i, p]] = perm[[p, i]]
    np.testing.assert_allclose((low @ up), args[0][perm], atol=1e-4)
    np.testing.assert_array_equal(piv, j[1])
    np.testing.assert_allclose(lu, j[0], atol=1e-4)


def _check_eig(j, t, args):
    w, v = t
    np.testing.assert_allclose(np.sort(w), np.sort(j[0]), atol=1e-4)
    np.testing.assert_allclose(v @ np.diag(w) @ v.T, args[0], atol=1e-4)
    _abs_close(j[1:], t[1:], args)


M44 = r(4, 4) + 4 * np.eye(4, dtype=np.float32)
case("matmul", r(3, 4), r(5, 4, seed=1), transpose_y=True)
case("batched_gemm", r(2, 4, 3), r(2, 4, 5, seed=1), transpose_x=True,
     alpha=0.5)
case("tensormmul", r(2, 3, 4), r(4, 3, 5, seed=1), (1, 2), (1, 0),
     atol=1e-4)
case("outer", r(3), r(4, seed=1))
case("svd", r(5, 3), check=_check_svd)
case("qr", r(5, 3), check=_check_qr)
case("cholesky", spd(4), atol=1e-4)
case("lu", M44, check=_check_lu)
case("triangular_solve", np.tril(M44), r(4, 2, seed=1), lower=True,
     adjoint=True, atol=1e-4)
case("solve", M44, r(4, 2, seed=1), atol=1e-4)
case("lstsq", r(6, 3), r(6, 2, seed=1), l2_regularizer=0.1, atol=1e-4)
case("matrix_inverse", M44, atol=1e-4)
case("pinv", r(4, 3), atol=1e-4)
case("matrix_determinant", M44, atol=1e-3, rtol=1e-4)
case("log_matrix_determinant", M44, atol=1e-4)
case("trace", r(2, 3, 3))
case("cross", r(4, 3), r(4, 3, seed=1))
case("self_adjoint_eig", spd(4), check=_check_eig)
case("norm", r(3, 4), ord="fro", axis=(0, 1))
case("matrix_band_part", r(2, 4, 5), 1, 2)
case("sufficient_statistics", X345, (0, 2), np.float32(0.5))

# --- loss ---------------------------------------------------------------------

_PRED = np.random.RandomState(5).uniform(0.05, 0.95, (4, 3)).astype(
    np.float32)
_LAB = ri(4, 3, hi=2).astype(np.float32)
_W = np.array([1.0, 0.0, 2.0, 0.5], np.float32)
case("log_loss", _PRED, _LAB, _W[:, None], reduction="mean_by_weight")
case("sigmoid_cross_entropy", r(4, 3), _LAB, label_smoothing=0.1)
case("softmax_cross_entropy", r(4, 3),
     np.eye(3, dtype=np.float32)[[0, 2, 1, 1]], reduction="sum")
case("sparse_softmax_cross_entropy", r(4, 3), np.array([0, 2, 1, 1]),
     _W, reduction="mean_by_nonzero_weight")
case("mean_sqerr_loss", r(4, 3), r(4, 3, seed=1), reduction="none")
case("mean_pairwssqerr_loss", r(4, 3), r(4, 3, seed=1))
case("absolute_difference_loss", r(4, 3), r(4, 3, seed=1), _W)
case("hinge_loss", r(4, 3), _LAB, reduction="sum")
case("huber_loss", r(4, 3) * 2, r(4, 3, seed=1), delta=0.7)
case("cosine_distance_loss", r(4, 3), r(4, 3, seed=1), reduction="none")
case("kld_loss", _PRED, _PRED[::-1].copy())
case("poisson_loss", np.abs(r(4, 3)) + 0.2, _LAB, log_input=False)
_LP = np.log(np.random.RandomState(6).dirichlet(np.ones(5), (2, 7))
             ).astype(np.float32)
case("ctc_loss", _LP, np.array([[1, 2, 2], [3, 1, 0]]), np.array([7, 6]),
     np.array([3, 2]), atol=1e-4)

# --- nn -----------------------------------------------------------------------

XI = r(2, 3, 8, 8)
case("conv2d", XI, r(4, 3, 3, 3, seed=1), r(4, seed=2), strides=(2, 1),
     padding="SAME", atol=1e-4)
case("conv1d", r(2, 3, 9), r(4, 3, 3, seed=1), None, stride=2, padding=1,
     atol=1e-4)
case("conv3d", r(1, 2, 5, 5, 5), r(3, 2, 2, 3, 3, seed=1), padding="SAME",
     atol=1e-4)
case("deconv2d", r(2, 3, 4, 4), r(3, 2, 3, 3, seed=1), r(2, seed=2),
     strides=(2, 2), padding="SAME", atol=1e-4)
case("depthwise_conv2d", XI.transpose(0, 2, 3, 1).copy(),
     r(2, 3, 3, 3, seed=1), strides=(1, 2), padding=(1, 1),
     data_format="NHWC", atol=1e-4)
case("sconv2d", XI, r(2, 3, 3, 3, seed=1), r(5, 6, 1, 1, seed=2),
     r(5, seed=3), padding="SAME", atol=1e-4)
case("maxpool2d", XI, kernel=(3, 3), strides=(2, 2), padding="SAME")
case("avgpool2d", XI.transpose(0, 2, 3, 1).copy(), kernel=(2, 3),
     strides=(2, 2), padding=(1, 1), data_format="NHWC")
case("pnormpool2d", XI, kernel=(2, 2), strides=(2, 2), pnorm=3, atol=1e-4)
case("maxpool3d", r(1, 2, 4, 4, 4), kernel=(2, 2, 2), strides=(2, 2, 2))
case("avgpool3d", r(1, 2, 4, 4, 4), kernel=(2, 2, 2), strides=(1, 2, 2),
     padding=(1, 0, 1))
case("global_avgpool", XI, data_format="NCHW")
case("upsampling2d", r(1, 3, 2, 4), factor=(2, 3), data_format="NHWC")
case("upsampling3d", r(1, 1, 2, 2, 2), factor=(2, 1, 3))
case("im2col", r(1, 2, 5, 5), kernel=(2, 3), strides=(2, 1),
     padding=(1, 0), dilation=(1, 2))
case("batchnorm", XI, r(3, seed=1), pos(3, seed=2), r(3, seed=3),
     r(3, seed=4), epsilon=1e-3, axis=1, atol=1e-4)
case("batchnorm_train", XI, r(3, seed=1), r(3, seed=2), epsilon=1e-5,
     axis=1, atol=1e-4)
case("layer_norm", r(4, 6), r(6, seed=1), r(6, seed=2), atol=1e-4)
case("lrn", XI, depth=3, bias=1.0, alpha=0.1, beta=0.75, atol=1e-5)
_MASK = np.random.RandomState(9).rand(4, 5) < 0.6
case("dropout", r(4, 5), KEY, 0.4, inject=([_MASK], []))
case("alpha_dropout", r(4, 5), KEY, 0.3, inject=([_MASK], []))
_NOISE = r(4, 5, seed=11)
case("gaussian_dropout", r(4, 5), KEY, 0.3, inject=([], [_NOISE]))
case("gaussian_noise", r(4, 5), KEY, 0.2, inject=([], [_NOISE]))
case("linear", r(4, 3), r(3, 5, seed=1), r(5, seed=2))
case("bias_add", r(2, 4, 4, 3), r(3, seed=1), data_format="NHWC")
case("embedding_lookup", r(7, 3), ri(2, 4, hi=7))
case("dot_product_attention", r(2, 5, 4), r(2, 6, 4, seed=1),
     r(2, 6, 3, seed=2), (np.random.RandomState(3).rand(2, 5, 6) < 0.7),
     atol=1e-5)
_MH = r(2, 6, 8)
case("multi_head_dot_product_attention", _MH, _MH, _MH,
     r(8, 8, seed=1) * 0.3, r(8, 8, seed=2) * 0.3, r(8, 8, seed=3) * 0.3,
     r(8, 5, seed=4) * 0.3,
     np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], np.float32),
     num_heads=2, atol=1e-5)
case("xw_plus_b", r(4, 3), r(3, 5, seed=1), r(5, seed=2))
case("relu_layer", r(4, 3), r(3, 5, seed=1), r(5, seed=2))
case("log_sigmoid", X45)
case("softmax_bp", X45, r(4, 5, seed=1), axis=-1)
_FQ = r(1, 2, 128, 8)
case("flash_attention", _FQ, r(1, 2, 128, 8, seed=1), r(1, 2, 128, 8, seed=2),
     causal=True, atol=2e-5)

# --- image --------------------------------------------------------------------

IMG = np.random.RandomState(4).uniform(0, 1, (2, 5, 7, 3)).astype(
    np.float32)
case("resize_nearest", IMG, 8, 4, half_pixel_centers=True)
case("resize_bilinear", IMG, 9, 5, align_corners=True)
case("resize_bicubic", IMG, 9, 4, atol=1e-5)
case("resize_lanczos3", IMG, 3, 11, atol=1e-5)
case("resize_lanczos5", IMG, 8, 3, antialias=False, atol=1e-5)
case("resize_mitchellcubic", IMG, 7, 9, atol=1e-5)
case("resize_area", IMG, 3, 4, atol=1e-5)
case("adjust_gamma", IMG, gamma=1.7, gain=0.9)
case("rgb_to_hsv", IMG)
case("hsv_to_rgb", IMG)
case("adjust_hue", IMG, 0.3, atol=1e-5)
case("adjust_saturation", IMG, 0.6, atol=1e-5)
case("adjust_contrast", IMG, 1.8)
case("rgb_to_grayscale", IMG)
case("rgb_to_yuv", IMG)
case("yuv_to_rgb", IMG)
case("image_flip", IMG, horizontal=False)
case("crop_and_resize", IMG, np.array([[0.1, 0.2, 0.8, 0.9],
                                       [0.0, 0.0, 1.0, 0.5]], np.float32),
     np.array([1, 0]), (4, 3))
_BOXES = np.array([[0, 0, 1, 1], [0, 0.1, 1, 1.1], [0, -0.1, 1, 0.9],
                   [0, 10, 1, 11], [0, 10.1, 1, 11.1], [0, 100, 1, 101]],
                  np.float32)
case("non_max_suppression", _BOXES,
     np.array([0.9, 0.75, 0.6, 0.95, 0.5, 0.3], np.float32), 4,
     iou_threshold=0.5, score_threshold=0.4)
case("extract_image_patches", IMG, (2, 3), (2, 1), (1, 2), padding="SAME")

# --- bitwise ------------------------------------------------------------------

_BX = np.array([5, -7, 1 << 30, 123456, -1], np.int32)
_BY = np.array([3, 12, -9, 77, 2], np.int32)
for _n in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    case(_n, _BX, _BY)
case("bitwise_not", _BX)
case("shift_left", _BX, np.array([1, 2, 0, 3, 4], np.int32))
case("shift_right", _BX, np.array([1, 2, 0, 3, 4], np.int32))
case("cyclic_shift_left", _BX, np.array([1, 5, 0, 31, 33], np.int32))
case("cyclic_shift_right", _BX, np.array([1, 5, 0, 31, 33], np.int32))
case("bits_hamming_distance", _BX, _BY)

# --- nlp ----------------------------------------------------------------------

_V, _D = 11, 4
_SYN0, _SYN1 = r(_V, _D) * 0.3, r(_V, _D, seed=1) * 0.3
_CTX = ri(5, 3, hi=_V, seed=2)
_CMASK = np.array([[1, 1, 0], [1, 1, 1], [1, 0, 0], [0, 0, 0], [1, 1, 1]],
                  np.float32)
case("embedding_bag", _SYN0, _CTX, _CMASK, mode="mean")
_CEN = ri(5, hi=_V, seed=3)
_TGT = ri(5, 3, hi=_V, seed=4)
_LBL = np.array([[1, 0, 0]] * 5, np.float32)
_PM = np.array([1, 1, 1, 0, 1], np.float32)
_PTS = ri(5, 3, hi=_V, seed=5)
_CODES = ri(5, 3, hi=2, seed=6).astype(np.float32)
_PATHM = np.array([[1, 1, 0]] * 5, np.float32)
case("skipgram", _SYN0, _SYN1, _CEN, _TGT, _LBL, 0.05, _PM)
case("skipgram_hs", _SYN0, _SYN1, _CEN, _PTS, _CODES, _PATHM, 0.05, _PM)
case("cbow", _SYN0, _SYN1, _CTX, _CMASK, _TGT, _LBL, 0.05, _PM)
case("cbow_hs", _SYN0, _SYN1, _CTX, _CMASK, _PTS, _CODES, _PATHM, 0.05, _PM)

RECURRENT = {"lstm_cell", "lstm_layer", "gru_cell", "gru_layer",
             "gru_layer_ra", "simple_rnn_layer", "sru_layer",
             "bidirectional_lstm"}
RANDOM = {"dropout_bp", "random_bernoulli", "random_binomial", "random_crop",
          "random_exponential", "random_gamma", "random_lognormal",
          "random_multinomial", "random_normal", "random_poisson",
          "random_shuffle", "random_truncated_normal", "random_uniform"}


# --- the runner -----------------------------------------------------------------


def _np(v):
    if isinstance(v, (tuple, list)):
        return [_np(e) for e in v]
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _torch_arg(a):
    if a is KEY:
        return 0
    if isinstance(a, list):
        return [_torch_arg(e) for e in a]
    if isinstance(a, np.ndarray):
        return torch.from_numpy(a.copy())
    return a


def _jax_arg(a):
    if a is KEY:
        return jax.random.PRNGKey(0)
    return a


def _compare(j, t, atol, rtol, name):
    if isinstance(j, list):
        assert isinstance(t, list) and len(j) == len(t), name
        for a, b in zip(j, t):
            _compare(a, b, atol, rtol, name)
        return
    if j is None:
        assert t is None, name
        return
    assert tuple(np.shape(j)) == tuple(np.shape(t)), \
        f"{name}: shape {np.shape(t)} != JAX {np.shape(j)}"
    if j.dtype.kind in "biu" or t.dtype.kind in "biu":
        assert t.dtype.kind in "biu" and j.dtype.kind in "biu", \
            f"{name}: dtype {t.dtype} against JAX {j.dtype}"
        np.testing.assert_array_equal(t, j, err_msg=name)
        return
    np.testing.assert_allclose(t.astype(np.float64), j.astype(np.float64),
                               atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_parity(name, monkeypatch):
    c = CASES[name]
    if c["inject"] is not None:
        masks, normals = c["inject"]
        inject_draws(monkeypatch, masks, normals)
    args = c["args"]
    j = _np(jreg.exec_op(name, *[_jax_arg(a) for a in args], **c["kwargs"]))
    t = _np(treg.exec_op(name, *[_torch_arg(a) for a in args],
                         **c["kwargs"]))
    if c["check"] is not None:
        c["check"](j, t, args)
    else:
        _compare(j, t, c["atol"], c["rtol"], name)


# --- the ledger -------------------------------------------------------------------


def test_registry_is_jax_registry_but_random():
    """The whole JAX registry: the 318 ops with parity cases and the 13
    random ops, with the JAX families and differentiability."""
    ported = set(treg.all_ops())
    assert len(ported) == 331
    assert ported == set(jreg.all_ops()) == treg.JAX_OPS
    assert RANDOM <= ported and len(ported - RANDOM) == 318
    for name in ported:
        jd, td = jreg.get_op(name), treg.get_op(name)
        assert (td.family, td.differentiable) == (jd.family,
                                                  jd.differentiable), name
    assert {n for n in ported if treg.get_op(n).family == "random"} == RANDOM


_LOGITS = np.log(np.array([[0.1, 0.2, 0.3, 0.4, 0.0001]], np.float32))
#: arguments after the key (the generator) of each random op
RANDOM_ARGS = {
    "random_uniform": (((3, 4),), {"low": -1.0, "high": 2.0}),
    "random_normal": (((3, 4),), {"mean": 1.0, "stddev": 2.0}),
    "random_truncated_normal": (((3, 4),), {}),
    "random_lognormal": (((3, 4),), {}),
    "random_bernoulli": (((3, 4),), {"p": 0.3}),
    "random_binomial": (((3, 4), 5, 0.3), {}),
    "random_exponential": (((3, 4),), {"lam": 2.0}),
    "random_gamma": (((3, 4), 2.0), {"beta": 2.0}),
    "random_poisson": (((3, 4), 3.0), {}),
    "random_multinomial": ((_LOGITS, 7), {}),
    "random_shuffle": ((r(4, 5, 3, seed=4),), {"axis": 1}),
    "random_crop": ((r(4, 5, seed=5), (2, 3)), {}),
    "dropout_bp": ((r(4, 5, seed=6), 0.3), {}),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_ops_refuse_naming_roadmap(name):
    """Each random op runs through ``exec_op`` from a generator (where it
    once refused, naming ROADMAP A5) to the JAX op's shape and dtype."""
    args, kwargs = RANDOM_ARGS[name]
    j = np.asarray(jreg.exec_op(name, jax.random.PRNGKey(0), *args,
                                **kwargs))
    g = torch.Generator().manual_seed(0)
    t = treg.exec_op(name, g, *args, **kwargs)
    assert tuple(t.shape) == j.shape, name
    assert np.dtype(str(t.dtype).split(".")[-1]) == j.dtype, (t.dtype,
                                                              j.dtype)
    assert torch.isfinite(t.to(torch.float64)).all()
    assert name in treg.validated_ops()


def test_unknown_op_is_a_key_error():
    with pytest.raises(KeyError):
        treg.get_op("no_such_op")


def test_every_ported_op_has_a_case():
    assert set(treg.all_ops()) - RECURRENT - RANDOM == set(CASES)
