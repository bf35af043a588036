"""Recurrent ops: LSTM, GRU, SimpleRnn and SRU layers and their cells.

Counterpart of ``deeplearning4j_tpu/ops/recurrent.py``, registered under the
same names. The JAX package runs each time loop as a ``lax.scan`` (no Pallas
kernel); here it is a Python loop over the steps, with autograd taking the
backward through every step, and no library recurrent kernel (cuDNN's RNN,
``torch.nn.LSTM``) stands in. Each step keeps the JAX form and order: one
``[x, h] @ W`` product over the concatenated input and carry, then the
bias, so the products sum in the same order. Gate order is IFOG (input,
forget, output, cell candidate), DL4J's recurrent weight layout.

Sequences are ``[B, T, F]`` (``time_major``: ``[T, B, F]``). A layer
returns ``(outputs, final carry)``: ``(h, c)`` for the LSTM, ``h`` for the
GRU and SimpleRnn, ``c`` for the SRU.
"""

from __future__ import annotations

import torch

from .registry import op


def _steps(x: torch.Tensor, time_major: bool):
    """The steps of ``x`` as ``[B, F]`` slices, in time order."""
    return x.unbind(0 if time_major else 1)


def _stack(ys, time_major: bool) -> torch.Tensor:
    return torch.stack(ys, 0 if time_major else 1)


def _zeros(x: torch.Tensor, time_major: bool, n: int) -> torch.Tensor:
    bsz = x.shape[1 if time_major else 0]
    return x.new_zeros((bsz, n))


@op("lstm_cell", "recurrent")
def lstm_cell(x, h_prev, c_prev, w, b):
    """One LSTM step. x: [B, nIn]; w: [nIn+nOut, 4*nOut] (IFOG);
    b: [4*nOut]."""
    z = torch.cat([x, h_prev], dim=-1) @ w + b
    i, f, o, g = z.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c = f * c_prev + i * g
    h = o * torch.tanh(c)
    return h, c


@op("lstm_layer", "recurrent")
def lstm_layer(x, w, b, h0=None, c0=None, time_major: bool = False,
               return_sequences: bool = True):
    """The LSTM over a sequence: ``(outputs [B, T, nOut], (hT, cT))``; with
    ``return_sequences=False`` the outputs are the last step's."""
    n_out = w.shape[1] // 4
    h = h0 if h0 is not None else _zeros(x, time_major, n_out)
    c = c0 if c0 is not None else _zeros(x, time_major, n_out)
    ys = []
    for xt in _steps(x, time_major):
        h, c = lstm_cell(xt, h, c, w, b)
        ys.append(h)
    out = _stack(ys, time_major)
    if not return_sequences:
        out = out[-1] if time_major else out[:, -1]
    return out, (h, c)


@op("gru_cell", "recurrent")
def gru_cell(x, h_prev, w_ru, w_c, b_ru, b_c):
    """One GRU step (reference gruCell): w_ru: [nIn+nOut, 2*nOut] (reset,
    update), w_c: [nIn+nOut, nOut]."""
    xa = torch.cat([x, h_prev], dim=-1)
    ru = torch.sigmoid(xa @ w_ru + b_ru)
    r, u = ru.chunk(2, dim=-1)
    xc = torch.cat([x, r * h_prev], dim=-1)
    c = torch.tanh(xc @ w_c + b_c)
    return u * h_prev + (1.0 - u) * c


@op("gru_layer", "recurrent")
def gru_layer(x, w_ru, w_c, b_ru, b_c, h0=None, time_major: bool = False):
    h = h0 if h0 is not None else _zeros(x, time_major, w_c.shape[1])
    ys = []
    for xt in _steps(x, time_major):
        h = gru_cell(xt, h, w_ru, w_c, b_ru, b_c)
        ys.append(h)
    return _stack(ys, time_major), h


@op("gru_layer_ra", "recurrent")
def gru_layer_ra(x, w_ru, w_cx, w_ch, b_ru, b_cx, b_ch, h0=None,
                 time_major: bool = False):
    """The GRU's reset-after form (CuDNN/Keras ``reset_after=True``):
    ``r, u = sigmoid([x, h] w_ru + b_ru)``,
    ``c = tanh(x w_cx + b_cx + r * (h w_ch + b_ch))``,
    ``h' = u * h + (1 - u) * c``."""
    h = h0 if h0 is not None else _zeros(x, time_major, w_cx.shape[1])
    ys = []
    for xt in _steps(x, time_major):
        ru = torch.sigmoid(torch.cat([xt, h], dim=-1) @ w_ru + b_ru)
        r, u = ru.chunk(2, dim=-1)
        c = torch.tanh(xt @ w_cx + b_cx + r * (h @ w_ch + b_ch))
        h = u * h + (1.0 - u) * c
        ys.append(h)
    return _stack(ys, time_major), h


@op("simple_rnn_layer", "recurrent")
def simple_rnn_layer(x, w, rw, b, h0=None, time_major: bool = False,
                     activation=torch.tanh):
    """``h_t = act(x_t W + h_{t-1} R + b)``; the layer passes its configured
    activation, which applies inside the recurrence."""
    h = h0 if h0 is not None else _zeros(x, time_major, w.shape[1])
    ys = []
    for xt in _steps(x, time_major):
        h = activation(xt @ w + h @ rw + b)
        ys.append(h)
    return _stack(ys, time_major), h


@op("sru_layer", "recurrent")
def sru_layer(x, w, b, c0=None, time_major: bool = False):
    """Simple Recurrent Unit. w: [nIn, 3*nIn]; the product runs over the
    whole sequence at once, only the light recurrence steps."""
    xs = x if time_major else x.transpose(0, 1)
    n = xs.shape[-1]
    z = xs @ w
    xt_, f_, r_ = z.chunk(3, dim=-1)
    bf, br = b.chunk(2)
    f = torch.sigmoid(f_ + bf)
    r = torch.sigmoid(r_ + br)
    c = c0 if c0 is not None else xs.new_zeros((xs.shape[1], n))
    ys = []
    for t in range(xs.shape[0]):
        c = f[t] * c + (1.0 - f[t]) * xt_[t]
        ys.append(r[t] * torch.tanh(c) + (1.0 - r[t]) * xs[t])
    return _stack(ys, time_major), c


def merge_directions(fwd: torch.Tensor, bwd: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """The Bidirectional wrapper's merge of the two directions' outputs."""
    mode = mode.lower()
    if mode == "concat":
        return torch.cat([fwd, bwd], dim=-1)
    if mode == "add":
        return fwd + bwd
    if mode == "mul":
        return fwd * bwd
    if mode == "average":
        return 0.5 * (fwd + bwd)
    raise ValueError(f"unknown bidirectional mode {mode!r}")


@op("bidirectional_lstm", "recurrent")
def bidirectional_lstm(x, w_fwd, b_fwd, w_bwd, b_bwd, mode: str = "concat"):
    """The LSTM over ``x`` and over ``x`` reversed in time, merged by
    ``mode``: concat, add, mul or average."""
    fwd, _ = lstm_layer(x, w_fwd, b_fwd)
    bwd, _ = lstm_layer(torch.flip(x, dims=(1,)), w_bwd, b_bwd)
    return merge_directions(fwd, torch.flip(bwd, dims=(1,)), mode)
