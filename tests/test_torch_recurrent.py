"""The port's recurrent ops (``ops/recurrent.py``) against the JAX package's.

Each op runs in both registries on the same seeded numpy inputs: every
output (the sequence and the final carry), and the gradient of
``sum(outputs * r) + sum(carry * s)`` with respect to every float input
(``jax.grad`` against autograd through the port's Python time loop).
Tolerance: float32, 1e-5 of each array's largest magnitude (the products
sum in another order; the loop adds nothing of its own).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import registry as jreg
from deeplearning4j_tpu_torch.ops import recurrent as prec
from deeplearning4j_tpu_torch.ops import registry as preg
from torch_parity import assert_scaled_close

B, T, NIN, N = 3, 6, 4, 5


def _r(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _flat(out):
    """An op's result as a flat list of arrays (outputs, then carry)."""
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flat(o)]
    return [out]


def _lstm_w(seed, nin=NIN, n=N):
    return _r(seed, nin + n, 4 * n, scale=0.5), _r(seed + 1, 4 * n)


# (op, positional inputs, static kwargs)
CASES = {
    "lstm_cell": ("lstm_cell", [_r(1, B, NIN), _r(2, B, N), _r(3, B, N),
                                *_lstm_w(4)], {}),
    "lstm_layer": ("lstm_layer", [_r(1, B, T, NIN), *_lstm_w(4)], {}),
    "lstm_layer_carry": ("lstm_layer", [_r(1, B, T, NIN), *_lstm_w(4),
                                        _r(6, B, N), _r(7, B, N)], {}),
    "lstm_layer_time_major": ("lstm_layer", [_r(1, T, B, NIN), *_lstm_w(4)],
                              {"time_major": True}),
    "lstm_layer_last": ("lstm_layer", [_r(1, B, T, NIN), *_lstm_w(4)],
                        {"return_sequences": False}),
    "lstm_layer_last_time_major": ("lstm_layer",
                                   [_r(1, T, B, NIN), *_lstm_w(4)],
                                   {"time_major": True,
                                    "return_sequences": False}),
    "gru_cell": ("gru_cell", [_r(1, B, NIN), _r(2, B, N),
                              _r(3, NIN + N, 2 * N, scale=0.5),
                              _r(4, NIN + N, N, scale=0.5), _r(5, 2 * N),
                              _r(6, N)], {}),
    "gru_layer": ("gru_layer", [_r(1, B, T, NIN),
                                _r(3, NIN + N, 2 * N, scale=0.5),
                                _r(4, NIN + N, N, scale=0.5), _r(5, 2 * N),
                                _r(6, N)], {}),
    "gru_layer_carry": ("gru_layer", [_r(1, B, T, NIN),
                                      _r(3, NIN + N, 2 * N, scale=0.5),
                                      _r(4, NIN + N, N, scale=0.5),
                                      _r(5, 2 * N), _r(6, N), _r(7, B, N)],
                        {}),
    "gru_layer_time_major": ("gru_layer", [
        _r(1, T, B, NIN), _r(3, NIN + N, 2 * N, scale=0.5),
        _r(4, NIN + N, N, scale=0.5), _r(5, 2 * N), _r(6, N)],
        {"time_major": True}),
    "gru_layer_ra": ("gru_layer_ra", [
        _r(1, B, T, NIN), _r(3, NIN + N, 2 * N, scale=0.5),
        _r(4, NIN, N, scale=0.5), _r(5, N, N, scale=0.5), _r(6, 2 * N),
        _r(7, N), _r(8, N)], {}),
    "gru_layer_ra_carry": ("gru_layer_ra", [
        _r(1, B, T, NIN), _r(3, NIN + N, 2 * N, scale=0.5),
        _r(4, NIN, N, scale=0.5), _r(5, N, N, scale=0.5), _r(6, 2 * N),
        _r(7, N), _r(8, N), _r(9, B, N)], {}),
    "simple_rnn_layer": ("simple_rnn_layer", [
        _r(1, B, T, NIN), _r(2, NIN, N, scale=0.5), _r(3, N, N, scale=0.5),
        _r(4, N)], {}),
    "simple_rnn_layer_carry": ("simple_rnn_layer", [
        _r(1, B, T, NIN), _r(2, NIN, N, scale=0.5), _r(3, N, N, scale=0.5),
        _r(4, N), _r(5, B, N)], {}),
    "simple_rnn_layer_time_major": ("simple_rnn_layer", [
        _r(1, T, B, NIN), _r(2, NIN, N, scale=0.5), _r(3, N, N, scale=0.5),
        _r(4, N)], {"time_major": True}),
    "sru_layer": ("sru_layer", [_r(1, B, T, NIN),
                                _r(2, NIN, 3 * NIN, scale=0.5),
                                _r(3, 2 * NIN)], {}),
    "sru_layer_carry": ("sru_layer", [_r(1, B, T, NIN),
                                      _r(2, NIN, 3 * NIN, scale=0.5),
                                      _r(3, 2 * NIN), _r(4, B, NIN)], {}),
    "sru_layer_time_major": ("sru_layer", [_r(1, T, B, NIN),
                                           _r(2, NIN, 3 * NIN, scale=0.5),
                                           _r(3, 2 * NIN)],
                             {"time_major": True}),
    **{f"bidirectional_lstm_{mode}": (
        "bidirectional_lstm", [_r(1, B, T, NIN), *_lstm_w(4), *_lstm_w(8)],
        {"mode": mode}) for mode in ("concat", "add", "mul", "average",
                                     "CONCAT")},
}


def _run_jax(name, args, kwargs):
    jargs = [jnp.asarray(a) for a in args]
    return jreg.get_op(name).fn(*jargs, **kwargs)


@pytest.mark.parametrize("case", sorted(CASES))
def test_recurrent_op_matches_jax(case):
    name, args, kwargs = CASES[case]
    want = _flat(_run_jax(name, args, kwargs))
    targs = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    out = _flat(preg.exec_op(name, *targs, **kwargs))
    assert len(out) == len(want)
    for i, (g, w) in enumerate(zip(out, want)):
        assert_scaled_close(g.detach().numpy(), w, f"{case} output {i}")
    cts = [_r(100 + i, *np.shape(w)) for i, w in enumerate(want)]

    def jloss(*xs):
        outs = _flat(_run_jax(name, xs, kwargs))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cts))

    jgrads = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    tloss = sum(torch.sum(o * torch.from_numpy(c)) for o, c in zip(out, cts))
    tgrads = torch.autograd.grad(tloss, targs)
    for i, (tg, jg) in enumerate(zip(tgrads, jgrads)):
        assert_scaled_close(tg.numpy(), jg, f"{case} grad of input {i}")


@pytest.mark.parametrize("act", ["relu", "identity", "sigmoid"])
def test_simple_rnn_activation_applies_inside_the_recurrence(act):
    from deeplearning4j_tpu.nn.activations import activation_fn as jact
    from deeplearning4j_tpu_torch.nn.activations import activation_fn as tact

    args = [_r(1, B, T, NIN), _r(2, NIN, N, scale=0.5),
            _r(3, N, N, scale=0.5), _r(4, N)]
    want, wh = jreg.get_op("simple_rnn_layer").fn(
        *[jnp.asarray(a) for a in args], activation=jact(act))
    got, gh = prec.simple_rnn_layer(*[torch.from_numpy(a) for a in args],
                                    activation=tact(act))
    assert_scaled_close(got.numpy(), want, f"{act} outputs")
    assert_scaled_close(gh.numpy(), wh, f"{act} carry")


def test_unknown_bidirectional_mode_raises():
    x = torch.from_numpy(_r(1, B, T, NIN))
    w, b = (torch.from_numpy(a) for a in _lstm_w(4))
    with pytest.raises(ValueError, match="mode"):
        prec.bidirectional_lstm(x, w, b, w, b, mode="max")


def test_layer_from_carry_continues_the_sequence():
    """The LSTM over a sequence equals the LSTM over its first part and
    then, from that carry, over the rest: what truncated BPTT and
    rnn_time_step rely on."""
    x = torch.from_numpy(_r(1, B, T, NIN))
    w, b = (torch.from_numpy(a) for a in _lstm_w(4))
    whole, (h, c) = prec.lstm_layer(x, w, b)
    first, (h1, c1) = prec.lstm_layer(x[:, :2], w, b)
    rest, (h2, c2) = prec.lstm_layer(x[:, 2:], w, b, h0=h1, c0=c1)
    assert torch.equal(torch.cat([first, rest], dim=1), whole)
    assert torch.equal(h2, h) and torch.equal(c2, c)


def test_recurrent_ops_registered_under_the_jax_names():
    names = {"lstm_cell", "lstm_layer", "gru_cell", "gru_layer",
             "gru_layer_ra", "simple_rnn_layer", "sru_layer",
             "bidirectional_lstm"}
    jops = jreg.all_ops()
    for n in names:
        d = preg.get_op(n)
        assert d.family == jops[n].family == "recurrent", n
        assert d.differentiable == jops[n].differentiable, n
