"""NAN_PANIC: raise at the first operation whose output holds a NaN.

Counterpart of the JAX package's ``Environment.set_check_nan``, which turns
on ``jax_debug_nans``. Turned on (``Environment.get().set_check_nan(True)``
or :func:`set_enabled`), the first operation on any device whose
floating-point output holds a NaN raises ``FloatingPointError`` naming it:

- the dispatcher's operations, through :class:`NanPanicMode`, a
  ``TorchDispatchMode`` that checks every floating output
  (``torch.isnan(t).any()``, a sync with the card for each). The autograd
  engine carries a thread's dispatch modes to its own device threads, so
  the backward pass is checked too;
- the hand-written kernels, which launch through ``ctypes`` and so pass no
  dispatcher: each ``*_cuda`` launcher calls :func:`check_kernel` on what
  its kernel wrote;
- threads: a dispatch mode holds on one thread. :func:`set_enabled` enters
  it on the calling thread, and the port's worker threads (the inference
  and serving workers and the inference pool's resurrection probe, the
  background prefetch that the record iterator and the fit loops'
  ``host_prefetch`` use, the async RL learners) wrap each unit of device
  work in
  :func:`scope`, which enters it there while the flag is on. Each surfaces
  the error as it surfaces any failure: a failed future, or the fit's
  exception.

Off (the default), no mode is pushed and :func:`scope` and
:func:`check_kernel` return after one read of a module flag: no path
carries a check.

Skipped: outputs that alias an input without writing it (views: their
values were checked where they were made), and the ``empty`` family, whose
memory is not initialised until an operation writes it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves

_ON = False
_NULL = contextlib.nullcontext()
_LOCAL = threading.local()
_UNINITIALISED = frozenset({
    "empty", "empty_like", "empty_strided", "empty_permuted", "new_empty",
    "new_empty_strided", "resize_", "resize_as_", "set_"})


def enabled() -> bool:
    return _ON


def _has_nan(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.layout is torch.strided
            and (t.is_floating_point() or t.is_complex())
            and t.device.type != "meta" and t.numel() > 0
            and bool(torch.isnan(t).any()))


class NanPanicMode(TorchDispatchMode):
    """Checks every floating output of the dispatcher's operations while
    NAN_PANIC is on."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _ON or func.overloadpacket.__name__ in _UNINITIALISED:
            return out
        returns = getattr(getattr(func, "_schema", None), "returns", ())
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for i, o in enumerate(outs):
            alias = returns[i].alias_info if i < len(returns) else None
            if alias is not None and not alias.is_write:
                continue                       # a view of a checked value
            if any(_has_nan(t) for t in tree_leaves(o)):
                raise FloatingPointError(
                    f"NAN_PANIC: NaN in the output of {func} "
                    f"(on {_device_of(o)})")
        return out


def _device_of(o) -> Optional[torch.device]:
    for t in tree_leaves(o):
        if isinstance(t, torch.Tensor):
            return t.device
    return None


def _on_this_thread() -> bool:
    return any(isinstance(m, NanPanicMode)
               for m in _get_current_dispatch_mode_stack())


def set_enabled(on: bool) -> None:
    """Turn NAN_PANIC on or off for the process. On, the mode is entered on
    the calling thread (the port's worker threads enter it through
    :func:`scope`); off, the calling thread leaves the mode it entered, and
    a mode left on another thread checks nothing."""
    global _ON
    mode = getattr(_LOCAL, "mode", None)
    if not on and mode is not None:
        stack = _get_current_dispatch_mode_stack()
        if not stack or stack[-1] is not mode:
            raise RuntimeError(
                "NAN_PANIC is turned off inside a dispatch mode entered "
                "after it was turned on: leave that mode first")
        _LOCAL.mode = None
        mode.__exit__(None, None, None)
    _ON = bool(on)
    if on and mode is None and not _on_this_thread():
        mode = NanPanicMode()
        mode.__enter__()
        _LOCAL.mode = mode


def scope():
    """A context for one unit of device work on a thread the port started:
    it enters :class:`NanPanicMode` there while NAN_PANIC is on and the
    thread is not in it yet; otherwise it does nothing."""
    if not _ON or _on_this_thread():
        return _NULL
    return NanPanicMode()


def check_kernel(name: str, *tensors) -> None:
    """Raise ``FloatingPointError`` naming the kernel ``name`` when NAN_PANIC
    is on and one of ``tensors`` (what the kernel wrote) holds a NaN. Every
    ``*_cuda`` launcher calls it after its launch."""
    if not _ON:
        return
    for t in tensors:
        if t is not None and _has_nan(t):
            raise FloatingPointError(
                f"NAN_PANIC: NaN in the output of the {name} kernel "
                f"(on {t.device})")
