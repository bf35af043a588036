"""Pipeline parallelism: microbatched stage execution over a mesh axis.

Counterpart of ``deeplearning4j_tpu/parallel/pipeline.py``. There the
stages are the shards of one ``shard_map`` program along a ``stage`` mesh
axis, a ``lax.scan`` runs the ticks and ``ppermute`` moves activations to
the next stage. Here each stage is its own set of tensors on its slot's
device (``parallel/mesh.make_pipeline_mesh``): a tick runs, in stage
order, the op the schedule gives each stage, and an activation reaches the
next stage (a cotangent the previous one) by ``Tensor.to``, to be used at
the next tick, as a ``ppermute`` delivers it.

- :func:`pipeline_apply` / :class:`PipelineParallel`: the GPipe forward of
  S same-shape stages over M microbatches; differentiable under autograd,
  so ``train_step`` trains every stage.
- :class:`HeterogeneousPipeline`: stages with different programs, trees
  and activation shapes (``pipeline_from_mln(cuts=...)``). The JAX class
  packs activations into a padded float32 payload so that one
  ``lax.switch`` serves every stage; the port needs no payload, because
  each stage runs its own program on its own slot. Parameters are held in
  float32, as the JAX class documents.
- :class:`PipelineTrainer`: N-stage GPipe and 1F1B training on a ``(data,
  stage)`` mesh behind the fit surface. One dispatch runs the tick tables
  of :func:`schedule_meta` (the JAX tables, the same numpy code): on a busy
  tick a stage runs its forward (stashing its input) or its backward, which
  recomputes the stage under autograd from the stashed input, as the JAX
  step does with ``jax.vjp``. Per-layer gradients accumulate in ascending
  microbatch order, the data rows' sums add in row order, and then the
  model's per-leaf updater runs, so the loss and parameter sequence is
  bitwise the same across schedules, stage counts and a single-slot
  microbatched fit. A stage on the card runs its layers as they run
  anywhere: a ``SelfAttentionLayer`` there launches
  ``csrc/flash_attention.cu`` in the forward and again in the recompute.
  The step honours the configuration's ``compute_dtype`` (parameters and
  activations cast inside each stage, the loss in float32); the JAX block
  runs in the parameters' dtype.
- Self-healing: :meth:`PipelineTrainer.remap` re-cuts the layers over the
  surviving slots between dispatches, and the fit continues from the
  cursor; ``parallel/distributed.TrainingSupervisor``'s
  ``remap_and_continue`` policy calls it on a lost stage, and falls back
  to checkpoint-restart when fewer than 2 stages would survive.

Nothing compiles here: "one compile per (stage count, schedule)" is one
*build* per (stage count, schedule) of the step (its tick tables, layer
runs and slots), counted by ``trace/pipeline_fit_step``. The steps and
forwards run under the executable census (``common/xprof.py``) with the
JAX names: ``pipeline/fit_step`` (one generation per (stage count,
schedule) and batch shape), ``pipeline/legacy_fwd`` / ``legacy_step`` and
``pipeline/hetero_fwd`` / ``hetero_step``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..common import faultinject, flightrec, xprof
from ..common.dtypes import tensor_from_numpy, torch_dtype
from ..common.profiler import OpProfiler
from ..learning.precision import apply_updater, cast_floating
from .mesh import Mesh, axis_slots, device_pool, as_slots

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _tmap(fn, *trees):
    """``fn`` over the leaves of matching nested dicts."""
    if isinstance(trees[0], dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _unleaves(tree, it):
    """A tree shaped as ``tree`` from the iterator of leaves ``it``
    (:func:`_leaves`' order)."""
    if isinstance(tree, dict):
        return {k: _unleaves(tree[k], it) for k in sorted(tree)}
    return next(it)


def _as_tensor(a, device=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else tensor_from_numpy(
        np.asarray(a))
    return t if device is None else t.to(device)


def stack_stage_params(params_list):
    """[per-stage tree, ...] to one tree with a leading stage axis."""
    return _tmap(lambda *xs: torch.stack([_as_tensor(x) for x in xs]),
                 *params_list)


def _stage_devices(mesh: Mesh, axis: str) -> List[torch.device]:
    return [s.device for s in axis_slots(mesh, axis)]


def _gpipe(fns, trees, x: torch.Tensor, devs, n_micro: int,
           out_dtype=None) -> torch.Tensor:
    """The GPipe forward: microbatch ``m`` enters stage ``s`` at tick
    ``s + m`` and moves to the next stage's device for the next tick;
    the last stage's outputs are joined on the first stage's device."""
    S = len(devs)
    x = x.to(devs[0])
    B = x.shape[0]
    assert B % n_micro == 0, "batch must divide into microbatches"
    micro = x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))
    held: List[Optional[torch.Tensor]] = [None] * S
    outs: List[Optional[torch.Tensor]] = [None] * n_micro
    for t in range(n_micro + S - 1):
        sent: List[Optional[torch.Tensor]] = [None] * S
        for s in range(S):
            m = t - s
            if not 0 <= m < n_micro:
                continue          # a fill or drain bubble
            y = fns[s](trees[s], micro[m] if s == 0 else held[s])
            if out_dtype is not None:
                y = y.to(out_dtype)
            if s == S - 1:
                outs[m] = y.to(devs[0])
            else:
                sent[s + 1] = y.to(devs[s + 1])
        held = sent
    return torch.cat(outs)


def pipeline_apply(stage_fn: Callable, stacked_params, x, mesh: Mesh,
                   n_micro: int, axis: str = "stage"):
    """Run ``stage_fn(params, x) -> y`` (same shape in and out) as an
    S-stage GPipe pipeline over ``axis``: stage ``s`` holds row ``s`` of
    ``stacked_params`` on its slot's device. ``x`` ``[B, ...]`` with B
    divisible by ``n_micro``; returns ``[B, ...]`` on the first stage's
    device. Differentiable with respect to ``stacked_params``."""
    devs = _stage_devices(mesh, axis)
    trees = [_tmap(lambda a, _s=s: a[_s].to(devs[_s]), stacked_params)
             for s in range(len(devs))]
    return _gpipe([stage_fn] * len(devs), trees, _as_tensor(x), devs,
                  n_micro)


def _sgd_(trees, grads, lr: float) -> list:
    """``p - lr * g`` over lists of matching trees, ``lr`` a float32
    scalar as the JAX step's ``jnp.float32(lr)``."""
    out = []
    for t, g in zip(trees, grads):
        out.append(_tmap(lambda p, gg: (p - torch.tensor(
            lr, dtype=torch.float32, device=p.device) * gg).detach(), t, g))
    return out


def _grad_trees(loss, trees) -> list:
    """``d loss / d tree`` for each tree of ``trees`` (leaves that require
    grad)."""
    leaves = [x for t in trees for x in _leaves(t)]
    gs = torch.autograd.grad(loss, leaves)
    it = iter(gs)
    return [_unleaves(t, it) for t in trees]


def _requiring_grad(tree):
    return _tmap(lambda a: a.detach().requires_grad_(a.is_floating_point()),
                 tree)


class _ModelCheckpoint:
    """The checkpoint surface of a pipeline built from a model: the live
    stage parameters written back onto the model's per-layer tree, then
    the standard snapshot; a restore re-places them."""

    model = None

    def _require_model(self) -> None:
        if self.model is None:
            raise ValueError("this pipeline was not built from a model "
                             "(pipeline_from_mln); no checkpoint surface")

    def snapshot(self, listeners=None):
        """Host snapshot through the standard checkpoint machinery
        (``util/checkpoint.snapshot_training_state``)."""
        from ..util.checkpoint import snapshot_training_state

        self.sync_to_model()
        return snapshot_training_state(self.model, listeners)

    def restore(self, path: str, listeners=None):
        """Restore a committed checkpoint into the source model and the
        live stage parameters; returns the cursor."""
        from ..util.checkpoint import restore_training_state

        self._require_model()
        cursor = restore_training_state(self.model, path,
                                        listeners=listeners)
        self.sync_from_model()
        return cursor


class PipelineParallel(_ModelCheckpoint):
    """S same-shape stages on a mesh axis: ``stage_params`` holds stage
    ``s``'s tree on its slot's device, ``forward`` and ``train_step`` run
    :func:`pipeline_apply`. Built by :func:`pipeline_from_mln` (the
    homogeneous form), the source model rides along and
    :meth:`snapshot`/:meth:`restore` route the parameters through the
    ordinary per-layer checkpoint tree."""

    def __init__(self, stage_fn: Callable, params_list, mesh: Mesh,
                 n_micro: int, axis: str = "stage"):
        self.stage_fn = stage_fn
        self.mesh = mesh
        self.axis = axis
        self.n_micro = n_micro
        self._devs = _stage_devices(mesh, axis)
        if len(params_list) != len(self._devs):
            raise ValueError(f"{len(params_list)} stages but mesh axis "
                             f"{axis!r} has {len(self._devs)} slots")
        self._place(params_list)

    def _place(self, params_list) -> None:
        self.stage_params = [
            _tmap(lambda a, _d=d: _as_tensor(a).detach().to(_d, copy=True),
                  p) for p, d in zip(params_list, self._devs)]

    @property
    def params(self):
        """The stage trees stacked ``[S, ...]`` on the first stage's
        device."""
        d0 = self._devs[0]
        return _tmap(lambda *xs: torch.stack([a.to(d0) for a in xs]),
                     *self.stage_params)

    def _run(self, trees, x):
        return _gpipe([self.stage_fn] * len(trees), trees, _as_tensor(x),
                      self._devs, self.n_micro)

    def forward(self, x) -> torch.Tensor:
        return xprof.censused(self, "pipeline/legacy_fwd", self._forward)(x)

    def _forward(self, x) -> torch.Tensor:
        with torch.no_grad():
            return self._run(self.stage_params, x)

    def train_step(self, x, y, lr: float = 1e-2) -> torch.Tensor:
        """One SGD step of the mean squared error through the pipeline;
        returns the loss (a 0-dim tensor)."""
        return xprof.censused(self, "pipeline/legacy_step",
                              self._train_step)(x, y, lr)

    def _train_step(self, x, y, lr: float) -> torch.Tensor:
        trees = [_requiring_grad(p) for p in self.stage_params]
        with torch.enable_grad():
            out = self._run(trees, x)
            y = _as_tensor(y, out.device)
            loss = torch.mean(torch.square(out - y))
            grads = _grad_trees(loss, trees)
        self.stage_params = _sgd_(self.stage_params, grads, lr)
        return loss.detach()

    # --- checkpoint routing (state lives on the source model) -------------
    def sync_to_model(self) -> None:
        """The live stage parameters onto the source model as owning
        per-layer copies."""
        self._require_model()
        model = self.model
        for i, key in enumerate(model._keys):
            model._params[key] = _tmap(
                lambda a: a.detach().to(model.device, copy=True),
                self.stage_params[i])

    def sync_from_model(self) -> None:
        """Re-place the stage parameters from the source model's per-layer
        trees (after a checkpoint restore)."""
        self._require_model()
        self._place([self.model._params[k] for k in self.model._keys])


class HeterogeneousPipeline(_ModelCheckpoint):
    """GPipe over stages with different programs, parameter trees and
    activation shapes: stage ``s`` runs ``stage_fns[s](params, x)`` with
    its tree on its slot's device, and its output goes to the next stage's
    slot. Parameters are held in float32. Differentiable end to end, so
    :meth:`train_step` trains every stage. Built by
    :func:`pipeline_from_mln` with ``cuts``, the source model rides along
    (``model``, ``_runs``) for :meth:`snapshot`/:meth:`restore`."""

    _runs: Optional[List[tuple]] = None

    def __init__(self, stage_fns, params_list, in_shapes, out_shapes,
                 mesh: Mesh, n_micro: int, axis: str = "stage",
                 loss_fn: Optional[Callable] = None):
        S = len(stage_fns)
        self._devs = _stage_devices(mesh, axis)
        if len(self._devs) != S:
            raise ValueError(f"{S} stages but mesh axis {axis!r} has "
                             f"{len(self._devs)} devices")
        for s in range(S - 1):
            if tuple(out_shapes[s]) != tuple(in_shapes[s + 1]):
                raise ValueError(
                    f"stage {s} outputs {out_shapes[s]} but stage {s + 1} "
                    f"expects {in_shapes[s + 1]}")
        self.mesh, self.axis, self.n_micro = mesh, axis, n_micro
        self.in_shapes = [tuple(s) for s in in_shapes]
        self.out_shapes = [tuple(s) for s in out_shapes]
        self._loss_fn = loss_fn or (
            lambda out, y: torch.mean(torch.square(out - y)))
        self._stage_fns = list(stage_fns)
        self._place(params_list)

    def _place(self, params_list) -> None:
        self.params = [
            _tmap(lambda a, _d=d: _as_tensor(a).detach().to(
                _d, torch.float32, copy=True), p)
            for p, d in zip(params_list, self._devs)]

    def _run(self, trees, x) -> torch.Tensor:
        return _gpipe(self._stage_fns, trees,
                      _as_tensor(x).to(torch.float32), self._devs,
                      self.n_micro, out_dtype=torch.float32)

    def forward(self, x) -> torch.Tensor:
        return xprof.censused(self, "pipeline/hetero_fwd", self._forward)(x)

    def _forward(self, x) -> torch.Tensor:
        with torch.no_grad():
            return self._run(self.params, x)

    def train_step(self, x, y, lr: float = 1e-2) -> torch.Tensor:
        return xprof.censused(self, "pipeline/hetero_step",
                              self._train_step)(x, y, lr)

    def _train_step(self, x, y, lr: float) -> torch.Tensor:
        trees = [_requiring_grad(p) for p in self.params]
        with torch.enable_grad():
            out = self._run(trees, x)
            loss = self._loss_fn(out, _as_tensor(y, out.device))
            grads = _grad_trees(loss, trees)
        self.params = _sgd_(self.params, grads, lr)
        return loss.detach()

    def stage_params(self, s: int):
        """Stage ``s``'s tree as owning numpy copies (never views of the
        live tensors)."""
        return _tmap(lambda a: a.detach().cpu().numpy().copy(),
                     self.params[s])

    # --- checkpoint routing (state lives on the source model) -------------
    def sync_to_model(self) -> None:
        self._require_model()
        model = self.model
        for s, (lo, hi) in enumerate(self._runs):
            for i in range(lo, hi):
                key = model._keys[i]
                model._params[key] = _tmap(
                    lambda a: a.detach().to(model.device, copy=True),
                    self.params[s][str(i)])

    def sync_from_model(self) -> None:
        self._require_model()
        model = self.model
        self._place([{str(i): model._params[model._keys[i]]
                      for i in range(lo, hi)} for lo, hi in self._runs])


def _layer_runner(model, i: int):
    """Layer ``i``'s inference program: its preprocessor, then ``apply``
    without training semantics (no dropout)."""
    layer = model.conf.layers[i]
    pre = model.conf.preprocessors.get(i)

    def run(p, x):
        if pre is not None:
            x = pre(x)
        return layer.apply(p, x, {}, False)[0]

    return run


def _check_stateless(model) -> None:
    for i, key in enumerate(model._keys):
        if model._states[key]:
            raise ValueError(
                f"layer {i} carries state ({list(model._states[key])}) — "
                "stateful layers (BatchNorm) cannot ride this pipeline")


def pipeline_from_mln(model, mesh: Mesh, n_micro: int, axis: str = "stage",
                      cuts=None, example_input=None):
    """A ``MultiLayerNetwork`` as a pipeline.

    Without ``cuts``: S identical same-shape blocks, one per stage
    (:class:`PipelineParallel`; every stage runs layer 0's program).

    With ``cuts`` (the first layer index of each stage after the first,
    e.g. ``cuts=[3]`` for layers 0-2 | 3-end): any contiguous layer runs
    as a :class:`HeterogeneousPipeline`; ``example_input`` (an array or a
    shape tuple) gives the inter-stage shapes, read off a one-row forward
    of each stage. Stages run without training semantics (no dropout);
    stateful layers (BatchNorm's running statistics) are refused."""
    if cuts is not None:
        return _pipeline_from_mln_het(model, mesh, n_micro, axis, cuts,
                                      example_input)
    return _pipeline_from_mln_homogeneous(model, mesh, n_micro, axis)


def _pipeline_from_mln_het(model, mesh, n_micro, axis, cuts, example_input):
    if example_input is None:
        raise ValueError("cuts=... needs example_input to derive "
                         "inter-stage activation shapes")
    layers = model.conf.layers
    cut_list = sorted(int(c) for c in cuts)
    if (len(set(cut_list)) != len(cut_list)
            or any(c <= 0 or c >= len(layers) for c in cut_list)):
        raise ValueError(
            f"bad cuts {cuts} for {len(layers)} layers: cut indices must "
            f"be unique and in (0, {len(layers)})")
    bounds = [0] + cut_list + [len(layers)]
    runs = list(zip(bounds[:-1], bounds[1:]))
    S = mesh.shape[axis]
    if len(runs) != S:
        raise ValueError(f"cuts give {len(runs)} stages but mesh axis "
                         f"{axis!r} has {S} devices")
    _check_stateless(model)
    runners = [_layer_runner(model, i) for i in range(len(layers))]

    def make_stage(lo, hi):
        def fn(params, x):
            for i in range(lo, hi):
                x = runners[i](params[str(i)], x)
            return x

        return fn

    stage_fns = [make_stage(lo, hi) for lo, hi in runs]
    params_list = [{str(i): model._params[model._keys[i]]
                    for i in range(lo, hi)} for lo, hi in runs]
    shape = (tuple(example_input)
             if isinstance(example_input, (tuple, list))
             else tuple(np.shape(example_input)))
    cur = torch.zeros((1,) + shape[1:], dtype=torch.float32,
                      device=model.device)
    in_shapes, out_shapes = [], []
    with torch.no_grad():
        for s, fn in enumerate(stage_fns):
            in_shapes.append(tuple(cur.shape[1:]))
            p = _tmap(lambda a: a.to(torch.float32), params_list[s])
            cur = fn(p, cur).to(torch.float32)
            out_shapes.append(tuple(cur.shape[1:]))
    pp = HeterogeneousPipeline(stage_fns, params_list, in_shapes,
                               out_shapes, mesh, n_micro, axis)
    pp.model = model
    pp._runs = runs
    return pp


def _pipeline_from_mln_homogeneous(model, mesh: Mesh, n_micro: int,
                                   axis: str = "stage") -> PipelineParallel:
    """S repeated same-shape blocks, one per stage. Every layer must be the
    same class with the same configuration and parameter shapes, stateless
    and without a preprocessor, since every stage runs layer 0's program;
    unlike models go through ``cuts=...``."""
    layers = model.conf.layers
    S = mesh.shape[axis]
    if len(layers) != S:
        raise ValueError(f"model has {len(layers)} layers but the "
                         f"{axis!r} mesh axis has {S} stages")
    _check_identical_blocks(model)
    block = _layer_runner(model, 0)
    pp = PipelineParallel(block, [model._params[k] for k in model._keys],
                          mesh, n_micro, axis)
    pp.model = model
    return pp


# --------------------------------------------------------------------------
# N-stage GPipe / 1F1B schedules and the self-healing trainer
# --------------------------------------------------------------------------

SCHEDULES = ("1f1b", "gpipe")


def stage_partition(n_layers: int, stages: int) -> List[tuple]:
    """Contiguous, re-cuttable layer partition: stage ``s`` owns layers
    ``[runs[s][0], runs[s][1])``, earlier stages taking the remainder. A
    remap from S to S' stages is a re-cut of the same layer order, so the
    arithmetic (and the per-layer checkpoint layout) does not depend on
    the stage count."""
    if stages < 1 or n_layers < stages:
        raise ValueError(
            f"cannot cut {n_layers} layers into {stages} stages "
            "(every stage needs at least one layer)")
    base, rem = divmod(n_layers, stages)
    runs, lo = [], 0
    for s in range(stages):
        hi = lo + base + (1 if s < rem else 0)
        runs.append((lo, hi))
        lo = hi
    return runs


def schedule_meta(schedule: str, stages: int, n_micro: int) -> dict:
    """The microbatch schedule as tables over the (tick, stage) grid, the
    JAX package's tables line for line: one source for the step, the
    profiler ledger and the flight-recorder stage lanes.

    Both schedules run T = 2(M+S-1) ticks with one forward or one
    backward per stage per busy tick (bubble (S-1)/(M+S-1) for both).
    ``gpipe``: all M forwards (stage s, microbatch m at tick s+m), then all
    M backwards; M microbatches stashed per stage. ``1f1b``: stage s fwd(m)
    at tick s+2m, bwd(m) at tick 2S-1-s+2m; at most min(S, M) stashed."""
    S, M = int(stages), int(n_micro)
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; pick one of "
                         f"{SCHEDULES}")
    T = 2 * (M + S - 1)
    t = np.arange(T)[:, None]
    s = np.arange(S)[None, :]
    if schedule == "1f1b":
        df = t - s
        fwd = (df >= 0) & (df % 2 == 0) & (df < 2 * M)
        m_f = np.clip(df // 2, 0, M - 1)
        db = t - (2 * S - 1 - s)
        bwd = (db >= 0) & (db % 2 == 0) & (db < 2 * M)
        m_b = np.clip(db // 2, 0, M - 1)
        stash = min(S, M)
    else:
        df = t - s
        fwd = (df >= 0) & (df < M)
        m_f = np.clip(df, 0, M - 1)
        db = t - (M + 2 * S - 2 - s)
        bwd = (db >= 0) & (db < M)
        m_b = np.clip(db, 0, M - 1)
        stash = M
    assert not (fwd & bwd).any(), "schedule bug: fwd/bwd tick collision"
    assert fwd.sum() == bwd.sum() == M * S, "schedule bug: dropped op"
    lanes = []
    for k in range(S):
        ft = np.where(fwd[:, k])[0]
        bt = np.where(bwd[:, k])[0]
        lanes.append({"fwd": (int(ft[0]), int(ft[-1]) + 1),
                      "bwd": (int(bt[0]), int(bt[-1]) + 1)})
    busy = int(fwd.sum() + bwd.sum())
    return {"schedule": schedule, "T": T, "stash": stash,
            "fwd": fwd, "m_f": m_f, "bwd": bwd, "m_b": m_b,
            "busy_ticks": busy, "tick_slots": T * S,
            "bubble_fraction": 1.0 - busy / float(T * S),
            "lanes": lanes}


def _check_identical_blocks(model) -> int:
    """The homogeneous-pipeline contract: every layer the same class,
    configuration and parameter shapes (one block program serves every
    layer), stateless, no preprocessors. Returns the layer count."""
    layers = model.conf.layers

    def conf_sig(layer):
        d = dataclasses.asdict(layer)
        d.pop("name", None)
        return d

    def shapes(tree):
        return _tmap(lambda a: (tuple(a.shape), str(a.dtype)), tree)

    sig0 = shapes(model._params[model._keys[0]])
    conf0 = conf_sig(layers[0])
    for i, key in enumerate(model._keys):
        if i and (shapes(model._params[key]) != sig0
                  or type(layers[i]) is not type(layers[0])
                  or conf_sig(layers[i]) != conf0):
            raise ValueError(
                f"layer {i} ({type(layers[i]).__name__}) does not match "
                f"layer 0 ({type(layers[0]).__name__}) — pipeline stages "
                "must be identical same-shape, same-config blocks")
        if model._states[key]:
            raise ValueError(
                f"layer {i} carries state ({list(model._states[key])}) — "
                "stateful layers (BatchNorm) cannot ride this pipeline")
        if model.conf.preprocessors.get(i) is not None:
            raise ValueError(
                f"layer {i} has an input preprocessor — preprocessors "
                "break the identical-blocks contract")
    return len(layers)


def _weighted_mse(out: torch.Tensor, y: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """The default pipeline loss: per-example MSE weighted by the pad mask,
    summed (the step divides by the global count of real rows, so padded
    rows contribute nothing)."""
    per = torch.mean(torch.square(out - y), dim=tuple(range(1, out.ndim)))
    return torch.sum(per * w)


class _Step:
    """One (stage count, schedule) build of the trainer's dispatch: the
    tick tables, the layer runs and the slots they run on."""

    def __init__(self, trainer: "PipelineTrainer", meta: dict):
        self.meta = meta
        self.runs = list(trainer._runs)
        self.devs = [[slot.device for slot in row]
                     for row in trainer.mesh.devices]       # [data][stage]
        self.keys = list(trainer.model._keys)
        self.block = trainer._block
        self.loss_fn = trainer._loss_fn
        self.n_micro = trainer.n_micro
        gc = trainer.model.conf.global_conf
        self.ct = torch_dtype(gc.compute_dtype) if gc.compute_dtype else None

    def _stage(self, s: int, trees, x):
        """Stage ``s``'s run of layers (``trees``: its layers' parameter
        trees in order) on ``x``."""
        if self.ct is not None:
            trees = [cast_floating(t, self.ct) for t in trees]
            if x.is_floating_point():
                x = x.to(self.ct)
        for t in trees:
            x = self.block(t, x)
        return x

    def row(self, d: int, params: dict, x, y, w, denom):
        """Data row ``d``'s schedule: its summed per-layer gradients (by
        layer key, on its stage devices) and its loss sum."""
        meta, M = self.meta, self.n_micro
        S, K = len(self.runs), meta["stash"]
        devs = self.devs[d]
        fwd, bwd, m_f, m_b = meta["fwd"], meta["bwd"], meta["m_f"], \
            meta["m_b"]
        mb = x.shape[0] // M
        micro_x = x.reshape((M, mb) + tuple(x.shape[1:]))
        y = y.to(devs[-1])
        w = w.to(devs[-1])
        micro_y = y.reshape((M, mb) + tuple(y.shape[1:]))
        micro_w = w.reshape(M, mb)
        denom = denom.to(devs[-1])
        stage_keys = [self.keys[lo:hi] for lo, hi in self.runs]
        # this row's copies of the stage parameters (row 0: the tensors)
        local = [[_tmap(lambda a, _d=devs[s]: a.to(_d), params[k])
                  for k in ks] for s, ks in enumerate(stage_keys)]
        stash: List[List[Optional[torch.Tensor]]] = [[None] * K
                                                     for _ in range(S)]
        fwd_in: List[Optional[torch.Tensor]] = [None] * S
        cot: List[Optional[torch.Tensor]] = [None] * S
        dp: List[Optional[List[dict]]] = [None] * S
        loss_sum = None
        for t in range(meta["T"]):
            nxt_in: List[Optional[torch.Tensor]] = [None] * S
            nxt_cot: List[Optional[torch.Tensor]] = [None] * S
            for s in range(S):
                if fwd[t, s]:
                    m = int(m_f[t, s])
                    x_in = micro_x[m] if s == 0 else fwd_in[s]
                    with torch.no_grad():
                        y_out = self._stage(s, local[s], x_in)
                    stash[s][m % K] = x_in
                    if s < S - 1:
                        nxt_in[s + 1] = y_out.to(devs[s + 1])
                if bwd[t, s]:
                    m = int(m_b[t, s])
                    x_sv = stash[s][m % K]
                    ps = [_requiring_grad(tr) for tr in local[s]]
                    leaves = [a for tr in ps for a in _leaves(tr)]
                    with torch.enable_grad():
                        xg = x_sv.detach().requires_grad_(
                            s > 0 and x_sv.is_floating_point())
                        y_sv = self._stage(s, ps, xg)
                        wrt = leaves + ([xg] if xg.requires_grad else [])
                        if s == S - 1:
                            l_m = self.loss_fn(y_sv.to(torch.float32),
                                               micro_y[m], micro_w[m]) / denom
                            gs = torch.autograd.grad(l_m, wrt)
                            loss_sum = (l_m.detach() if loss_sum is None
                                        else loss_sum + l_m.detach())
                        else:
                            gs = torch.autograd.grad(y_sv, wrt,
                                                     grad_outputs=cot[s])
                    it = iter(gs[:len(leaves)])
                    g_trees = [_unleaves(tr, it) for tr in ps]
                    # ascending-m accumulation: the same additions in every
                    # schedule and at every stage count
                    dp[s] = g_trees if dp[s] is None else [
                        _tmap(torch.add, a, b) for a, b in zip(dp[s], g_trees)]
                    if xg.requires_grad:
                        nxt_cot[s - 1] = gs[-1].to(devs[s - 1])
            fwd_in = nxt_in
            for s in range(S):
                if nxt_cot[s] is not None:
                    cot[s] = nxt_cot[s]
        grads = {}
        for s, ks in enumerate(stage_keys):
            for k, g in zip(ks, dp[s]):
                grads[k] = g
        return grads, loss_sum


class PipelineTrainer:
    """N-stage pipeline-parallel training with GPipe or 1F1B schedules on a
    ``(data, stage)`` mesh, behind the fit surface, self-healing by remap.

    Model contract: a ``MultiLayerNetwork`` of L >= ``stages`` identical
    stateless blocks (:func:`_check_identical_blocks`); the loss is
    ``loss_fn(out, y, w)``, a weighted sum over the microbatch (default
    :func:`_weighted_mse`) divided by the global count of real rows, so the
    input pipeline's pad rows are inert.

    Mechanics: the L layers are cut into contiguous runs
    (:func:`stage_partition`); stage ``s`` of data row ``d`` runs on slot
    ``(d, s)``, where its layers' parameters (and the updater state of
    row 0) live. One dispatch runs the whole M-microbatch schedule and the
    update; the model's per-layer parameters and updater state are
    republished after it, on their stage devices, before the listeners
    hear of the step (a checkpoint sees the ordinary per-layer tree). The
    step is built once per (stage count, schedule) and cached, through
    remaps and back.

    Self-healing: :meth:`remap` re-cuts the partition over the surviving
    slots between dispatches and the fit continues with
    ``fit(resume_cursor=...)``; every once-lost slot is re-probed before a
    later remap lets it back."""

    def __init__(self, model, stages: int, n_micro: int,
                 schedule: str = "1f1b", data: int = 1,
                 loss_fn: Optional[Callable] = None,
                 devices: Optional[List[Any]] = None):
        from .mesh import make_pipeline_mesh

        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}; pick one of "
                             f"{SCHEDULES}")
        if stages < 2:
            raise ValueError("a pipeline needs >= 2 stages; a 1-stage "
                             "'pipeline' is a plain fit")
        model._check_init()
        n_layers = _check_identical_blocks(model)
        if n_layers < stages:
            raise ValueError(f"model has {n_layers} layers but the "
                             f"pipeline wants {stages} stages")
        if int(n_micro) < 1:
            raise ValueError("n_micro must be >= 1")
        self.model = model
        self.schedule = schedule
        self.n_micro = int(n_micro)
        self.data_axis = int(data)
        self.stages_count = int(stages)
        self._pool = (as_slots(devices) if devices is not None
                      else device_pool(model.device))
        self.mesh = make_pipeline_mesh(self.data_axis, self.stages_count,
                                       devices=self._pool)
        self._block = _layer_runner(model, 0)
        self._loss_fn = loss_fn or _weighted_mse
        self._listeners: List[Any] = []
        self._telemetry = None
        #: per-(stage count, schedule) artifacts: step, meta, mesh, runs
        self._exec_cache: Dict[tuple, dict] = {}
        self._lost_devices: set = set()
        self._step: Optional[_Step] = None
        self._meta: Optional[dict] = None
        self._params: Optional[dict] = None
        self._upd: Optional[dict] = None
        self._pub_params = None
        self._set_partition(self.stages_count)

    # --- partition / state layout -----------------------------------------
    def _set_partition(self, stages: int) -> None:
        self._runs = stage_partition(len(self.model.conf.layers), stages)
        self._stage_of = {}
        for s, (lo, hi) in enumerate(self._runs):
            for i in range(lo, hi):
                self._stage_of[self.model._keys[i]] = s

    def _layer_device(self, key: str) -> torch.device:
        return self.mesh.devices[0, self._stage_of[key]].device

    def _place_state(self, params: dict, upd) -> None:
        """Per-layer state as owning copies on each layer's stage device
        (row 0's slot): the one placement path (first fit, restore,
        remap)."""
        with torch.no_grad():
            self._params = {
                k: _tmap(lambda a, _d=self._layer_device(k): a.detach().to(
                    _d, copy=True), params[k]) for k in self.model._keys}
            if isinstance(upd, dict) and upd:
                self._upd = {}
                for name, v in upd.items():
                    if not (isinstance(v, dict)
                            and set(v) == set(self.model._keys)):
                        raise ValueError(
                            f"updater state entry {name!r} does not mirror "
                            "the parameters; the pipeline places updater "
                            "state per layer")
                    self._upd[name] = {
                        k: _tmap(lambda a, _d=self._layer_device(k):
                                 a.detach().to(_d, copy=True), v[k])
                        for k in self.model._keys}
            else:
                self._upd = {}
        self._publish()

    def _publish(self) -> None:
        """The live per-layer state onto the model, before the listeners
        hear of the step."""
        model = self.model
        model._params = dict(self._params)
        model._updater_state = ({n: dict(v) for n, v in self._upd.items()}
                                if self._upd else {})
        model._flat = None
        model._cast_cache = None
        self._pub_params = model._params
        model._live_stages = self.stages_count

    def _ensure_state(self) -> None:
        """The model's state in this trainer's placement: first fit, or
        after a checkpoint restore replaced the parameters (seen by
        identity against the last published dict)."""
        model = self.model
        if self._params is not None and model._params is self._pub_params:
            return
        if model._updater_state is None:
            model._updater_state = \
                model.conf.global_conf.updater.init(model._params)
        self._place_state(model._params, model._updater_state)
        OpProfiler.get().gauge("pipeline/stages", self.stages_count)

    # --- the step ------------------------------------------------------------
    def _ensure_step(self) -> None:
        key = (self.stages_count, self.schedule)
        ent = self._exec_cache.setdefault(key, {})
        ent.update(mesh=self.mesh, runs=self._runs)
        if ent.get("step") is None:
            ent["meta"] = schedule_meta(self.schedule, self.stages_count,
                                        self.n_micro)
            ent["step"] = _Step(self, ent["meta"])
            OpProfiler.get().count("trace/pipeline_fit_step")
        self._step = ent["step"]
        self._meta = ent["meta"]

    def _device_groups(self) -> Dict[str, List[str]]:
        """Layer keys by the device their state lives on, in layer order
        (the updater runs once per device)."""
        out: Dict[str, List[str]] = {}
        for k in self.model._keys:
            out.setdefault(str(self._layer_device(k)), []).append(k)
        return out

    def _run_step(self, xs, ys, ws, build=None):
        """The schedule on every data row, the row sums, the update;
        returns (loss, aux). ``build``: the (stage count, schedule) the
        step was built for, a static argument of the census entry."""
        step, model = self._step, self.model
        D = self.data_axis
        dev0 = step.devs[0][0]
        denom = ws[0].sum().to(dev0)
        for d in range(1, D):
            denom = denom + ws[d].sum().to(dev0)
        denom = torch.clamp_min(denom, 1.0)
        rows = [step.row(d, self._params, xs[d], ys[d], ws[d], denom)
                for d in range(D)]
        grads = {}
        for k in model._keys:
            dev = self._layer_device(k)
            g = _tmap(lambda a: a.to(dev), rows[0][0][k])
            for d in range(1, D):
                g = _tmap(lambda a, b: a + b.to(dev), g, rows[d][0][k])
            grads[k] = g
        loss = rows[0][1].to(dev0)
        for d in range(1, D):
            loss = loss + rows[d][1].to(dev0)
        updater = model.conf.global_conf.updater
        it = int(model._iteration)
        old = self._params
        new_params = dict(old)
        new_upd = {n: dict(v) for n, v in self._upd.items()}
        with torch.no_grad():
            for _dev, keys in self._device_groups().items():
                p = {k: old[k] for k in keys}
                g = {k: grads[k] for k in keys}
                u = {n: {k: v[k] for k in keys} for n, v in self._upd.items()}
                np_, nu = apply_updater(updater, g, u, p, it,
                                        model.generator())
                new_params.update(np_)
                for n in new_upd:
                    new_upd[n].update(nu[n])
        self._params, self._upd = new_params, new_upd
        aux = None
        if self._telemetry is not None:
            aux = self._aux(loss, grads, old, new_params, dev0)
        return loss, aux

    def _aux(self, loss, grads, old, new, dev0) -> dict:
        """The telemetry aux: per-layer norms of the gradient, the update
        and the parameters, and non-finite counts (the JAX step's keys)."""
        keys = self.model._keys

        def sumsq(tree):
            return sum(torch.sum(torch.square(a.to(torch.float32))).to(dev0)
                       for a in _leaves(tree))

        g2 = torch.stack([sumsq(grads[k]) for k in keys])
        u2 = torch.stack([sumsq(_tmap(torch.sub, new[k], old[k]))
                          for k in keys])
        p2 = torch.stack([sumsq(new[k]) for k in keys])
        nf = torch.stack([
            sum((~torch.isfinite(a)).sum().to(dev0) for a in
                _leaves(grads[k])).to(torch.int32) for k in keys])
        grad_norm, update_norm, param_norm = (torch.sqrt(g2),
                                              torch.sqrt(u2),
                                              torch.sqrt(p2))
        return {
            "loss": loss,
            "grad_norm": grad_norm,
            "update_norm": update_norm,
            "param_norm": param_norm,
            "update_ratio": update_norm / torch.clamp_min(param_norm, 1e-12),
            "nonfinite": nf,
            "nonfinite_total": (nf.sum().to(torch.int32)
                                + (~torch.isfinite(loss)).to(torch.int32)),
        }

    # --- fit surface -----------------------------------------------------
    def set_listeners(self, *ls) -> None:
        from ..optimize.telemetry import config_for

        self._listeners = list(ls)
        for lst in self._listeners:
            bind = getattr(lst, "bind_group", None)
            if callable(bind):
                bind(self._listeners)
        cfg = config_for(self._listeners)
        if cfg != self._telemetry:
            # the aux is a property of the build: drop every cached step
            self._telemetry = cfg
            for ent in self._exec_cache.values():
                ent.pop("step", None)
            self._step = None

    def _bind_batch(self, ds, w):
        if ds.labels_mask is not None:
            raise ValueError(
                "labels masks do not ride the pipeline trainer; the "
                "example-weight vector carries the pad discipline")
        self.model._last_batch_size = int(ds.num_examples())
        return (ds.features, ds.labels,
                np.asarray(w, np.float32) if w is not None
                else np.ones((ds.num_examples(),), np.float32))

    def _pre_dispatch(self, ordinal: int) -> None:
        # the pipeline's drill site, on the fit call's dispatch ordinal:
        # device_loss names a stage (the remap drill), slow is a straggler
        # stage, wedge a hung schedule
        faultinject.fault_point("pipeline/stage", ordinal)

    def _emit_stage_lanes(self, meta: dict, t0: float, t1: float) -> None:
        """Per-stage Chrome-trace lanes: the dispatch's wall time split
        over the tick grid, one forward window and one backward window per
        stage on their own sub-lanes; the fill and drain bubbles are the
        gaps."""
        tick = max(t1 - t0, 1e-9) / meta["T"]
        stride = 2 if meta["schedule"] == "1f1b" else 1
        for s, lane in enumerate(meta["lanes"]):
            flo, fhi = lane["fwd"]
            blo, bhi = lane["bwd"]
            flightrec.event("pipeline/stage_fwd", stage=s,
                            micro=self.n_micro, tick_stride=stride,
                            lane=f"pipeline/stage{s}/fwd",
                            dur_s=(fhi - flo) * tick,
                            ts_mono=t0 + fhi * tick)
            flightrec.event("pipeline/stage_bwd", stage=s,
                            micro=self.n_micro, tick_stride=stride,
                            lane=f"pipeline/stage{s}/bwd",
                            dur_s=(bhi - blo) * tick,
                            ts_mono=t0 + bhi * tick)

    def _dispatch(self, group, prof) -> None:
        from ..data import pipeline as _pipe

        model = self.model
        for b in group:
            xs, ys, ws = b
            meta = self._meta
            t0 = time.monotonic()
            with prof.time_section("pipeline/dispatch"):
                loss, aux = xprof.censused(
                    self, "pipeline/fit_step", self._run_step,
                    static_argnames=("build",))(
                    xs, ys, ws, build=(self.stages_count, self.schedule))
            self._publish()
            prof.count("pipeline/microbatches", self.n_micro)
            prof.count("pipeline/busy_ticks", meta["busy_ticks"])
            prof.count("pipeline/tick_slots", meta["tick_slots"])
            if flightrec.enabled():
                self._emit_stage_lanes(meta, t0, time.monotonic())
            _pipe.note_steps(model, self._listeners, [loss],
                             [aux] if aux is not None else None)

    def fit(self, data, epochs: int = 1, batch_size: Optional[int] = None,
            *, pad_partial: Optional[bool] = None,
            drop_remainder: bool = False, prefetch: int = 2,
            host_prefetch: int = 0, resume_from: Optional[str] = None,
            resume_cursor: Optional[tuple] = None) -> None:
        """Pipeline-parallel training on the shared input pipeline:
        batches pad to a multiple of data x n_micro, each data row's slice
        goes to its first stage's slot, and each dispatch runs the whole
        schedule and the update. ``resume_from``: exact checkpoint resume
        (the per-layer layout does not depend on the stage count).
        ``resume_cursor=(epochs_done, steps_in_epoch)``: continue in memory
        from the live state at a dispatch boundary (after :meth:`remap`)."""
        from ..data import pipeline as _pipe
        from ..util.checkpoint import begin_fit_cursor
        from .mesh import shard_batch

        model = self.model
        model._check_init()
        if not self._listeners and getattr(model, "_listeners", None):
            self.set_listeners(*model._listeners)
        if resume_cursor is not None:
            if resume_from is not None:
                raise ValueError(
                    "resume_from and resume_cursor are mutually exclusive")
            skip = (int(resume_cursor[0]), int(resume_cursor[1]))
            model._fit_epoch0 = model._epoch - skip[0]
            model._steps_in_epoch = skip[1]
        else:
            skip = begin_fit_cursor(model, resume_from,
                                    listeners=self._listeners)
        self._ensure_state()
        self._ensure_step()
        # per-fit metadata, cleared by begin_fit_cursor
        model._live_stages = self.stages_count
        prof = OpProfiler.get()
        prof.gauge("pipeline/stages", self.stages_count)

        def on_epoch():
            model._epoch += 1
            model._steps_in_epoch = 0
            for lst in self._listeners:
                if hasattr(lst, "epoch_done"):
                    lst.epoch_done(model, model._epoch)

        _pipe.run_epochs(
            data, epochs, batch_size,
            pad_partial=True if pad_partial is None else pad_partial,
            drop_remainder=drop_remainder, prefetch=prefetch,
            steps_per_dispatch=1, bind=self._bind_batch,
            place=lambda b: shard_batch(self.mesh, *b),
            dispatch=lambda g: self._dispatch(g, prof), on_epoch=on_epoch,
            skip=skip, host_prefetch=host_prefetch,
            round_to_multiple_of=self.data_axis * self.n_micro,
            pre_dispatch=self._pre_dispatch)

    # --- elastic remap (shrink or grow the stage axis, no restart) --------
    def remap(self, stages: int, *, lost_stages=None) -> List[Any]:
        """Re-cut the layer partition over ``stages`` stage columns of
        surviving slots, between dispatches, in memory. The per-layer state
        is copied onto the new stage devices (owning copies), and the
        arithmetic does not depend on the stage count, so the losses after
        a remap are bitwise a fresh run's at the surviving count from the
        same state and cursor. ``lost_stages``: stage indices whose slots
        are gone; they stay out (across calls) until a probe finds them
        healthy. Returns the slots removed."""
        from .mesh import elastic_pool, make_pipeline_mesh, probe_device

        S_new = int(stages)
        old = self.stages_count
        if S_new < 2:
            raise ValueError(
                "a pipeline needs >= 2 stages; shrinking below that is "
                "the remap gate's refusal case (checkpoint-restart owns "
                "it)")
        if S_new > len(self.model.conf.layers):
            raise ValueError(
                f"model has {len(self.model.conf.layers)} layers; cannot "
                f"cut into {S_new} stages")
        lost = sorted({int(s) for s in (lost_stages or ())})
        if any(s < 0 or s >= old for s in lost):
            raise ValueError(f"lost_stages {lost} out of range for "
                             f"{old} stages")
        if S_new == old and not lost:
            return []
        prof = OpProfiler.get()
        with flightrec.span("pipeline/remap", severity="warn",
                            stages_from=old, stages_to=S_new, lost=lost), \
                prof.time_section("pipeline/remap"):
            model = self.model
            self._ensure_state()
            params = self._params
            upd = self._upd
            ent = self._exec_cache.setdefault((old, self.schedule), {})
            ent.update(mesh=self.mesh, runs=self._runs)
            old_devs = list(self.mesh.devices.flat)
            lost_devs = [d for s in lost
                         for d in self.mesh.devices[:, s].tolist()]
            self._lost_devices = {d for d in self._lost_devices
                                  if not probe_device(d)}
            self._lost_devices |= set(lost_devs)
            cached = self._exec_cache.get((S_new, self.schedule))
            if cached is not None and cached.get("mesh") is not None \
                    and not (self._lost_devices
                             & set(cached["mesh"].devices.flat)):
                self.mesh = cached["mesh"]
                self._set_partition(S_new)
            else:
                pool = elastic_pool(self.mesh, exclude=self._lost_devices,
                                    devices=self._pool)
                need = self.data_axis * S_new
                if need > len(pool):
                    raise ValueError(
                        f"remap to {S_new} stages needs {need} devices; "
                        f"only {len(pool)} are available")
                self.mesh = make_pipeline_mesh(self.data_axis, S_new,
                                               devices=pool[:need])
                self._set_partition(S_new)
                if cached is not None:
                    cached.pop("step", None)
            self.stages_count = S_new
            new_devs = set(self.mesh.devices.flat)
            removed = [d for d in old_devs if d not in new_devs]
            self._place_state(params, upd)
            self._step = None
            self._meta = None
            prof.gauge("pipeline/stages", S_new)
        prof.count("pipeline/remaps")
        logger.warning("pipeline remap: %d -> %d stages%s", old, S_new,
                       f" (lost stages {lost})" if lost else "")
        return removed

    def resize(self, stages: int, *, lost_replicas=None) -> List[Any]:
        """The supervisor-facing alias: for a pipeline, an elastic target
        is a stage count."""
        return self.remap(stages, lost_stages=lost_replicas)

    def probe_stages(self) -> List[int]:
        """Stage indices with a slot failing the round-trip probe."""
        from .mesh import probe_device

        cols = self.mesh.devices
        return [s for s in range(self.stages_count)
                if any(not probe_device(d) for d in cols[:, s].tolist())]

    def shutdown(self) -> None:
        self._step = None
        self._exec_cache.clear()
