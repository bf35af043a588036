"""The port's op registry and SameDiff against the JAX package's.

Each registered op runs in both registries on the same seeded numpy
inputs: forward, and the gradient of ``sum(out * cotangent)`` with respect
to each float input (``jax.grad`` against autograd). Tolerance: float32,
``rtol 1e-5, atol 1e-6`` (elementwise ops agree to an ulp or two; the
products and reductions sum in another order).

Then a small SameDiff graph built in both packages from the same values:
``var``/``constant``/``convert_to_variables``/``output``/
``calculate_gradients``/``fit`` (Adam, dict batches and a ``(features,
labels)`` tuple), and the parts not ported yet, which raise by name
(``save``/``load`` are ported: tests/test_torch_checkpoint.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import samediff as jsd
from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.ops import registry as jreg
from deeplearning4j_tpu_torch.autodiff import samediff as psd
from deeplearning4j_tpu_torch.learning.updaters import Adam as PAdam
from deeplearning4j_tpu_torch.ops import registry as preg
from deeplearning4j_tpu_torch.util import samediff_state_from_numpy

RTOL, ATOL = 1e-5, 1e-6


def _r(seed, *shape, lo=None, hi=None):
    rs = np.random.RandomState(seed)
    if lo is not None:
        return rs.uniform(lo, hi, shape).astype(np.float32)
    return rs.normal(size=shape).astype(np.float32)


def _onehot(seed, n, k):
    return np.eye(k, dtype=np.float32)[np.random.RandomState(seed).randint(
        0, k, n)]


# (op, positional inputs (arrays or static values), kwargs)
CASES = {
    "add": ("add", [_r(1, 3, 4), _r(2, 4)], {}),
    "subtract": ("subtract", [_r(1, 3, 4), _r(2, 3, 1)], {}),
    "multiply": ("multiply", [_r(1, 2, 3, 4), _r(2, 4)], {}),
    "divide": ("divide", [_r(1, 3, 4), _r(2, 3, 4, lo=0.5, hi=2.0)], {}),
    "divide_scalar": ("divide", [_r(1, 2, 4, 5), np.float32(2.8284271)], {}),
    "squaredsubtract": ("squaredsubtract", [_r(1, 2, 5, 8), _r(2, 2, 5, 1)],
                        {}),
    "matmul": ("matmul", [_r(1, 2, 3, 5), _r(2, 5, 4)], {}),
    "matmul_transposed": ("matmul", [_r(1, 5, 3), _r(2, 4, 5)],
                          {"transpose_x": True, "transpose_y": True}),
    "batched_gemm": ("batched_gemm", [_r(1, 2, 3, 4, 5), _r(2, 2, 3, 6, 5)],
                     {"transpose_y": True}),
    "batched_gemm_alpha": ("batched_gemm", [_r(1, 2, 4, 5), _r(2, 2, 5, 3)],
                           {"alpha": 0.5}),
    "reduce_mean_last": ("reduce_mean", [_r(1, 2, 3, 8)],
                         {"dims": (-1,), "keep_dims": True}),
    "reduce_mean_all": ("reduce_mean", [_r(1, 2, 3, 4)], {"dims": None}),
    "reshape": ("reshape", [_r(1, 2, 3, 4), (4, 6)], {}),
    "permute": ("permute", [_r(1, 2, 3, 4, 5), (0, 2, 1, 3)], {}),
    "gather_rows": ("gather", [_r(1, 10, 4), np.random.RandomState(2)
                               .randint(0, 10, (2, 3)).astype(np.int32)],
                    {"axis": 0}),
    "gather_axis1": ("gather", [_r(1, 3, 6, 2), np.array([5, 0, 5],
                                                         np.int32)],
                     {"axis": 1}),
    "sqrt": ("sqrt", [_r(1, 3, 4, lo=0.1, hi=4.0)], {}),
    "rsqrt": ("rsqrt", [_r(1, 3, 4, lo=0.1, hi=4.0)], {}),
    "tanh": ("tanh", [_r(1, 3, 4)], {}),
    "erf": ("erf", [_r(1, 3, 4)], {}),
    "identity": ("identity", [_r(1, 3, 4)], {}),
    "softmax": ("softmax", [_r(1, 2, 3, 7)], {"axis": -1}),
    "softmax_axis1": ("softmax", [_r(1, 2, 5, 3)], {"axis": 1}),
    "cast_int_to_float": ("cast", [np.array([[0, 1], [3, -2]], np.int32)],
                          {"dtype": "float32"}),
    "cast_float_to_int": ("cast", [_r(1, 3, 4) * 4], {"dtype": "int32"}),
    "strided_slice_shrink": ("tf_strided_slice", [_r(1, 3, 5, 4)], {
        "spec": [["slice", None, None, 1], ["idx", 0]]}),
    "strided_slice_rows": ("tf_strided_slice", [_r(1, 8, 4)], {
        "spec": [["slice", None, 5, 1]]}),
    "strided_slice_mixed": ("tf_strided_slice", [_r(1, 4, 5, 6)], {
        "spec": [["slice", -1, None, -2], ["ellipsis"], ["newaxis"],
                 ["idx", -1]]}),
    "softmax_cross_entropy": ("softmax_cross_entropy",
                              [_r(1, 6, 3), _onehot(2, 6, 3)], {}),
    "softmax_cross_entropy_weighted": (
        "softmax_cross_entropy", [_r(1, 6, 4), _onehot(2, 6, 4),
                                  np.array([1, 0, 2, 1, 0, 3], np.float32)],
        {"reduction": "mean_by_weight", "label_smoothing": 0.1}),
    "softmax_cross_entropy_sum": ("softmax_cross_entropy",
                                  [_r(1, 5, 3), _onehot(2, 5, 3)],
                                  {"reduction": "sum"}),
    "softmax_cross_entropy_none": ("softmax_cross_entropy",
                                   [_r(1, 5, 3), _onehot(2, 5, 3)],
                                   {"reduction": "none"}),
    # the recurrent ops return (outputs, carry): the outputs are compared
    # here, everything in tests/test_torch_recurrent.py
    "lstm_cell": ("lstm_cell", [_r(1, 2, 3), _r(2, 2, 4), _r(3, 2, 4),
                                _r(4, 7, 16) * 0.5, _r(5, 16)], {}),
    "lstm_layer": ("lstm_layer", [_r(1, 2, 5, 3), _r(4, 7, 16) * 0.5,
                                  _r(5, 16)], {}),
    "gru_cell": ("gru_cell", [_r(1, 2, 3), _r(2, 2, 4), _r(3, 7, 8) * 0.5,
                              _r(4, 7, 4) * 0.5, _r(5, 8), _r(6, 4)], {}),
    "gru_layer": ("gru_layer", [_r(1, 2, 5, 3), _r(3, 7, 8) * 0.5,
                                _r(4, 7, 4) * 0.5, _r(5, 8), _r(6, 4)], {}),
    "gru_layer_ra": ("gru_layer_ra", [
        _r(1, 2, 5, 3), _r(3, 7, 8) * 0.5, _r(4, 3, 4) * 0.5,
        _r(5, 4, 4) * 0.5, _r(6, 8), _r(7, 4), _r(8, 4)], {}),
    "simple_rnn_layer": ("simple_rnn_layer", [
        _r(1, 2, 5, 3), _r(2, 3, 4) * 0.5, _r(3, 4, 4) * 0.5, _r(4, 4)], {}),
    "sru_layer": ("sru_layer", [_r(1, 2, 5, 3), _r(2, 3, 9) * 0.5,
                                _r(3, 6)], {}),
    "bidirectional_lstm": ("bidirectional_lstm", [
        _r(1, 2, 5, 3), _r(2, 7, 16) * 0.5, _r(3, 16), _r(4, 7, 16) * 0.5,
        _r(5, 16)], {"mode": "concat"}),
    "space_to_batch": ("space_to_batch", [_r(1, 2, 4, 6, 3), (2, 2),
                                          ((0, 0), (1, 1))], {}),
}


def _float_args(args):
    return [i for i, a in enumerate(args) if isinstance(a, np.ndarray)
            and a.dtype == np.float32 and a.ndim > 0]


def _main(out):
    """An op's main output: a recurrent op's outputs, not its carry."""
    return out[0] if isinstance(out, tuple) else out


def _jax_run(name, args, kwargs):
    fn = jreg.get_op(name).fn
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args]
    return _main(fn(*jargs, **kwargs))


def _torch_run(name, args, kwargs, requires_grad=()):
    targs = [torch.from_numpy(np.array(a)).requires_grad_(i in requires_grad)
             if isinstance(a, np.ndarray) else
             (torch.tensor(a) if isinstance(a, np.generic) else a)
             for i, a in enumerate(args)]
    return _main(preg.exec_op(name, *targs, **kwargs)), targs


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_forward_and_gradient_match_jax(case):
    name, args, kwargs = CASES[case]
    want = np.asarray(_jax_run(name, args, kwargs))
    got, _ = _torch_run(name, args, kwargs)
    got = got.detach().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    fl = _float_args(args)
    if not fl or not np.issubdtype(want.dtype, np.floating):
        return
    ct = _r(99, *want.shape)

    def jloss(*xs):
        a = list(args)
        for i, x in zip(fl, xs):
            a[i] = x
        return jnp.sum(_jax_run(name, a, kwargs) * ct)

    jgrads = jax.grad(jloss, argnums=tuple(range(len(fl))))(
        *[jnp.asarray(args[i]) for i in fl])
    out, targs = _torch_run(name, args, kwargs, requires_grad=fl)
    tgrads = torch.autograd.grad(torch.sum(out * torch.from_numpy(ct)),
                                 [targs[i] for i in fl])
    for jg, tg in zip(jgrads, tgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL,
                                   atol=ATOL)


def test_registry_names_every_jax_op_and_ports_a_subset():
    jax_ops = jreg.all_ops()
    assert preg.JAX_OPS == frozenset(jax_ops)
    ported = preg.all_ops()
    assert set(ported) <= preg.JAX_OPS and len(ported) == 29
    for n, d in ported.items():
        assert d.family == jax_ops[n].family, n
        assert d.differentiable == jax_ops[n].differentiable, n
    assert preg.has_op("batched_gemm") and not preg.has_op("relu")
    # every ported op ran through exec_op in the parity cases above (or
    # here, when this test runs alone)
    for name, args, kwargs in CASES.values():
        _torch_run(name, args, kwargs)
    assert preg.validated_ops() >= set(ported)
    report = preg.coverage_report()
    assert report["missing"] == []
    assert report["registered"] == 29
    assert report["not_ported"] == len(jax_ops) - 29


# --- SameDiff ------------------------------------------------------------

X = _r(10, 6, 5)
Y = _onehot(11, 6, 3)
W0 = _r(12, 5, 3) * 0.5
B0 = _r(13, 3) * 0.1
SCALE = _r(14, 3, lo=0.5, hi=1.5)


def _graph(pkg):
    """x @ w + b, times a constant vector that convert_to_variables
    promotes, through tanh, then softmax cross-entropy, in either package's
    SameDiff."""
    sd = jsd.SameDiff() if pkg == "jax" else psd.SameDiff(device="cpu")
    x = sd.placeholder("x", shape=(6, 5))
    y = sd.placeholder("y", shape=(6, 3))
    w = sd.var("w", init=W0)
    b = sd.var("b", init=B0)
    scale = sd.constant("scale", SCALE)
    sd.constant("eps", 1e-3)            # a scalar: never promoted
    h = x.mmul(w).add(b).mul(scale)
    logits = sd.math.tanh(h).mul(2.0).rename("logits")
    sd.ops.softmax_cross_entropy(logits, y, name="loss")
    sd.set_loss_variables("loss")
    return sd


def _np(t):
    return np.asarray(t.to_numpy() if hasattr(t, "to_numpy") else
                      t.detach().cpu().numpy())


def test_samediff_graph_output_gradients_and_fit_match_jax():
    sds = {pkg: _graph(pkg) for pkg in ("jax", "torch")}
    for sd in sds.values():
        assert sd.variables() == ["w", "b"]
        assert sd.convert_to_variables() == ["scale"]
        assert sd.variables() == ["w", "b", "scale"]
    ph = {"x": X, "y": Y}
    out = {k: {n: _np(v) for n, v in sd.output(ph, ["logits", "loss"])
               .items()} for k, sd in sds.items()}
    for n in ("logits", "loss"):
        np.testing.assert_allclose(out["torch"][n], out["jax"][n],
                                   rtol=RTOL, atol=ATOL)
    grads = {k: sd.calculate_gradients(ph, "loss") for k, sd in sds.items()}
    assert list(grads["torch"]) == ["w", "b", "scale"]
    for n in grads["jax"]:
        np.testing.assert_allclose(_np(grads["torch"][n]),
                                   _np(grads["jax"][n]), rtol=RTOL,
                                   atol=ATOL)
    sds["jax"].set_training_config(jsd.TrainingConfig(
        updater=JAdam(0.05), loss_name="loss", l2=1e-3))
    sds["torch"].set_training_config(psd.TrainingConfig(
        updater=PAdam(0.05), loss_name="loss", l2=1e-3))
    hist = {}
    for k, sd in sds.items():
        # 3 dict batches, then 2 epochs of a (features, labels) tuple
        h1 = sd.fit([ph] * 3)
        h2 = sd.fit((X, Y), epochs=2)
        hist[k] = h1.loss_curve() + h2.loss_curve()
        assert sd._iteration == 5
    np.testing.assert_allclose(hist["torch"], hist["jax"], rtol=1e-5)
    for n in ("w", "b", "scale"):
        np.testing.assert_allclose(
            sds["torch"]._vars[n].value.numpy(),
            np.asarray(sds["jax"]._vars[n].value), rtol=1e-5, atol=1e-6)


def test_state_carry_over_resumes_the_jax_fit():
    """samediff_state_from_numpy copies the JAX graph's values and Adam
    moments; the next steps then agree."""
    j, t = _graph("jax"), _graph("torch")
    for sd, tc, adam in ((j, jsd.TrainingConfig, JAdam),
                         (t, psd.TrainingConfig, PAdam)):
        sd.convert_to_variables()
        sd.set_training_config(tc(updater=adam(0.05), loss_name="loss",
                                  grad_clip_value=0.2))
    ph = {"x": X, "y": Y}
    j.fit([ph] * 2)
    params = {n: np.asarray(v) for n, v in j._params().items()}
    state = jax.tree.map(np.asarray, j._updater_state)
    samediff_state_from_numpy(t, params, state)
    t._iteration = j._iteration
    lj, lt = j.fit([ph] * 2).final_loss(), t.fit([ph] * 2).final_loss()
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    with pytest.raises(ValueError, match="shape"):
        samediff_state_from_numpy(t, {**params, "w": params["w"].T})
    with pytest.raises(ValueError, match="node names|entries"):
        samediff_state_from_numpy(t, {"w": params["w"]})


def test_unported_parts_raise_by_name():
    sd = _graph("torch")
    x = sd.get_variable("x")
    for call, what in ((lambda: sd.cond(x, None, None), "cond"),
                       (lambda: sd.while_loop(None, None, x), "while_loop")):
        with pytest.raises(NotImplementedError, match=what):
            call()
    for call, op in ((lambda: -x, "neg"), (lambda: x ** 2, "pow"),
                     (lambda: x.sum(), "reduce_sum"),
                     (lambda: sd.math.relu(x), "relu"),
                     (lambda: sd.random_ops.random_normal, "random_normal"),
                     (lambda: sd.nn.dropout(x, 0.5), "dropout")):
        with pytest.raises(NotImplementedError, match=f"'{op}'"):
            call()
    with pytest.raises(KeyError, match="no_such_op"):
        preg.get_op("no_such_op")
    with pytest.raises(ValueError, match="not fed"):
        sd.output({"x": X}, ["loss"])


def test_samediff_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        assert psd.SameDiff().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        psd.SameDiff()
    assert psd.SameDiff.create(device="cpu").device.type == "cpu"
