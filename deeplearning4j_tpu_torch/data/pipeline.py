"""The input pipeline of the fit loops: shape-stable batches, a staged feed
to the device, multi-step dispatch.

Counterpart of the part of ``deeplearning4j_tpu/data/pipeline.py`` that
``MultiLayerNetwork.fit`` and ``ComputationGraph.fit`` run (one pipeline
for both networks; the graph's batches may be ``MultiDataSet``s,
``allow_multi=True``):

- **shape-stable batches** (:func:`stable_batches`): the final partial batch
  is padded to the target size by wrapping real rows (``row[i % n]``), with
  an example-weight vector ``w`` (1 = real, 0 = pad) that the loss folds in
  as ``sum(w * loss) / max(sum(w), 1)``, so pad rows contribute exactly
  nothing; ``drop_remainder=True`` skips the partial batch instead. The JAX
  package does this to compile one step; eager PyTorch compiles nothing,
  and keeps it for the same loss and the same batch shapes.
- **the staged feed** (:func:`device_feed`): ``place`` (the network's move
  to its device: pinned host memory and ``non_blocking`` copies on the card)
  runs ``depth`` batches ahead of the step that consumes them, so the copy
  of batch n+1 is queued before step n. With ``host_prefetch=N`` the batch
  assembly (the source's reads, padding, binding) runs on a worker thread
  through an N-deep queue (``common/background.staged_iter``); ``place``
  stays on the consumer's thread, as in the JAX package.
- **multi-step dispatch** (:func:`chunked`): K batches per dispatch; the
  network runs them back to back and tells its listeners once per step
  afterwards (:func:`note_steps`), as the JAX package's ``lax.scan`` chunk
  does.

- **resume** (``run_epochs(skip=(epochs_done, steps_in_epoch))``): the
  host side of a killed run is replayed, so the continuation sees the same
  batches: completed epochs are drawn from the source and dropped, and the
  resume epoch's first ``steps_in_epoch`` stable batches are drawn and
  discarded. :func:`note_steps` keeps the cursor (``_steps_in_epoch``)
  that a checkpoint records.

:func:`pad_rows` is the same wrap for one array (numpy, or a tensor on
its device): the serving tier pads a request up to its bucket with it.

**Fault sites and events** (``common/faultinject.py``, as in the JAX
package's ``run_epochs``, ``pipeline.py:324-405``): ``bind`` and ``place``
run under ``retry_call`` (transient faults retry with backoff, counted
under ``pipeline/retries``) behind the sites ``pipeline/bind`` (indexed by
the fit call's batch ordinal; a ``nan`` spec poisons the bound batch's
features) and ``pipeline/place``; before each dispatch the sites
``train/step``, ``train/wedge`` and ``device/loss`` fire at every step's
dispatch ordinal (a ``device_loss`` spec raises ``DeviceLostError`` naming
the replica), then the ``pipeline/dispatch`` flight-recorder event
(``ordinal``, and ``steps`` under ``steps_per_dispatch`` > 1). Each epoch
is a ``pipeline/epoch`` span.

Counters (``common/profiler.OpProfiler``): ``pipeline/padded_batches``,
``pipeline/dropped_batches``, ``pipeline/retries``.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, List, Optional, Tuple

import logging

import numpy as np
import torch

from ..common import faultinject, flightrec, xprof
from ..common.background import staged_iter
from ..common.profiler import OpProfiler
from .dataset import DataSet, MultiDataSet

logger = logging.getLogger("deeplearning4j_tpu_torch")


def resolve_batch_size(data: Any, batch_size: Optional[int]) -> Optional[int]:
    """The target (padded) batch size: an iterator's own ``batch()``, else
    the explicit ``batch_size`` (which re-batches a DataSet or a tuple),
    else None (batches pass through unpadded)."""
    b = getattr(data, "batch", None)
    if callable(b):
        try:
            n = b()
            if n and n > 0:
                return int(n)
        except NotImplementedError:
            pass
    return int(batch_size) if batch_size else None


def iter_datasets(data: Any, batch_size: Optional[int] = None,
                  allow_multi: bool = False) -> Iterator[Any]:
    """The batch sources every fit loop takes: an iterator (reset, then
    iterated), a DataSet (re-batched by ``batch_size`` when given), a
    ``(features, labels)`` tuple, a list of DataSets, and, for the graph
    (``allow_multi``), a MultiDataSet, which is never re-batched."""
    if isinstance(data, MultiDataSet):
        if not allow_multi:
            raise TypeError("MultiDataSet requires ComputationGraph.fit")
        if batch_size is not None:
            raise TypeError(
                "a MultiDataSet cannot be re-batched by batch_size; slice it "
                "upstream (e.g. an iterator of MultiDataSets) or pass "
                "batch_size=None")
        yield data
        return
    if isinstance(data, DataSet):
        if batch_size is None:
            yield data
        else:
            yield from data.batch_by(batch_size)
        return
    if hasattr(data, "reset") and hasattr(data, "__iter__"):
        data.reset()
        yield from data
        return
    if isinstance(data, list):
        for ds in data:
            yield from iter_datasets(ds, batch_size, allow_multi)
        return
    if isinstance(data, tuple) and len(data) == 2:
        yield from iter_datasets(DataSet(data[0], data[1]), batch_size)
        return
    raise TypeError(f"cannot iterate data of type {type(data)}")


def _wrap_rows(a, idx: np.ndarray):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(idx, device=a.device)]
    return np.asarray(a)[idx]


def pad_rows(arr, target: int, axis: int = 0):
    """``arr`` padded to ``target`` entries along ``axis`` by wrapping real
    rows (``row[i % n]``), the rule :func:`pad_dataset` applies to training
    batches; the serving tier's bucket padding. Returns ``(padded, w)``,
    ``w`` the [target] float32 example-weight vector (1 = real, 0 = pad).
    A numpy array stays numpy; a tensor is gathered on its own device (no
    copy to the host). A full ``arr`` is returned as it is."""
    n = arr.shape[axis]
    if n > target:
        raise ValueError(f"{n} rows exceed the pad target {target}")
    w = (np.arange(target) < n).astype(np.float32)
    if n == target:
        return arr, w
    idx = np.arange(target) % n
    if isinstance(arr, torch.Tensor):
        return arr.index_select(
            axis, torch.as_tensor(idx, device=arr.device)), w
    return np.take(np.asarray(arr), idx, axis=axis), w


def pad_dataset(ds: Any, target: int) -> Tuple[Any, np.ndarray]:
    """``ds`` (DataSet or MultiDataSet) padded to ``target`` examples by
    wrapping real rows, with the example-weight vector ``w`` ([target]
    float32, 1 = real row)."""
    n = ds.num_examples()
    if n > target:
        raise ValueError(f"batch of {n} examples exceeds the pipeline "
                         f"target batch size {target}")
    idx = np.arange(target) % n
    w = (np.arange(target) < n).astype(np.float32)
    if isinstance(ds, MultiDataSet):
        def wrap(arrays):
            return [_wrap_rows(a, idx) for a in arrays] if arrays else None

        return MultiDataSet(wrap(ds.features), wrap(ds.labels),
                            wrap(ds.features_masks),
                            wrap(ds.labels_masks)), w
    return DataSet(_wrap_rows(ds.features, idx), _wrap_rows(ds.labels, idx),
                   _wrap_rows(ds.features_mask, idx),
                   _wrap_rows(ds.labels_mask, idx)), w


def stable_batches(data: Any, batch_size: Optional[int] = None,
                   pad_partial: bool = True, drop_remainder: bool = False,
                   allow_multi: bool = False, round_to_multiple_of: int = 1
                   ) -> Iterator[Tuple[Any, np.ndarray, int]]:
    """``(dataset, w, n_real)`` with one leading size: the target of
    :func:`resolve_batch_size` (else the first batch's size), rounded up to
    a multiple of ``round_to_multiple_of`` (a data-parallel fit's replica
    count). Smaller batches are dropped (``drop_remainder``, against the
    unrounded target) or padded with zero-weight wrapped rows; larger ones,
    or all with ``pad_partial=False``, pass through with ones, padded only
    to the multiple (``pipeline.py:173-221`` of the JAX package)."""
    target = resolve_batch_size(data, batch_size)
    prof = OpProfiler.get()
    m = max(1, int(round_to_multiple_of))
    for ds in iter_datasets(data, batch_size, allow_multi):
        n = ds.num_examples()
        if target is None:
            target = n
        tgt = -(-target // m) * m
        if n == tgt:
            yield ds, np.ones((n,), np.float32), n
        elif drop_remainder and n < target:
            prof.count("pipeline/dropped_batches")
        elif n > tgt or not pad_partial:
            tgt_n = -(-n // m) * m
            if tgt_n == n:
                yield ds, np.ones((n,), np.float32), n
            else:
                prof.count("pipeline/padded_batches")
                padded, w = pad_dataset(ds, tgt_n)
                yield padded, w, n
        else:
            prof.count("pipeline/padded_batches")
            padded, w = pad_dataset(ds, tgt)
            yield padded, w, n


def device_feed(batches: Iterable, place, depth: int = 2,
                host_prefetch: int = 0) -> Iterator:
    """``place(batch)`` issued ``depth`` batches ahead of the consumer
    (``depth=0``: placed as consumed); ``host_prefetch > 0`` draws
    ``batches`` on a worker thread through a queue of that size."""
    return staged_iter(batches, stage=place, depth=depth,
                       host_prefetch=host_prefetch)


def chunked(it: Iterable, k: int) -> Iterator[List]:
    """Groups of ``k`` items; the last group may be shorter."""
    if k < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
    group: List = []
    for item in it:
        group.append(item)
        if len(group) == k:
            yield group
            group = []
    if group:
        yield group


def run_epochs(data: Any, epochs: int, batch_size: Optional[int],
               pad_partial: bool, drop_remainder: bool, prefetch: int,
               steps_per_dispatch: int, bind, place, dispatch,
               on_epoch, allow_multi: bool = False,
               skip: Optional[Tuple[int, int]] = None,
               host_prefetch: int = 0, round_to_multiple_of: int = 1,
               pre_dispatch=None) -> None:
    """The loop skeleton: per epoch, stable batches are bound
    (``bind(ds, w)``), placed ``prefetch`` ahead, and dispatched
    (``dispatch(group)``) in groups of ``steps_per_dispatch`` (the short
    tail group one by one, as the JAX package runs it); ``on_epoch()``
    after each epoch; ``host_prefetch``: see :func:`device_feed`.
    ``skip=(epochs_done, steps_in_epoch)`` replays the
    host side up to a checkpoint's cursor (see the module docstring):
    completed epochs are drawn and dropped without ``on_epoch`` (its
    effects are in the restored state), then the resume epoch's first
    ``steps_in_epoch`` stable batches. ``round_to_multiple_of``: see
    :func:`stable_batches`. ``pre_dispatch(ordinal)``: a hook run before
    each step's dispatch, after the fit loop's fault sites (the pipeline
    trainer's ``pipeline/stage`` site)."""
    k = max(1, int(steps_per_dispatch))
    skip_epochs, skip_steps = skip if skip is not None else (0, 0)
    n_bound = [0]       # batch ordinal within this fit call
    n_placed = [0]
    n_dispatched = 0    # dispatch ordinal within this fit call

    def guarded_bind(ds, w):
        ordinal = n_bound[0]
        n_bound[0] += 1

        def attempt():
            advisory = faultinject.fault_point("pipeline/bind", ordinal)
            b = bind(ds, w)
            for spec in advisory:
                if spec["kind"] == "nan":
                    b = poison_nan(b)
            return b

        return faultinject.retry_call(attempt, "pipeline/bind")

    def guarded_place(b):
        ordinal = n_placed[0]
        n_placed[0] += 1

        def attempt():
            faultinject.fault_point("pipeline/place", ordinal)
            return place(b)

        return faultinject.retry_call(attempt, "pipeline/place")

    for e in range(max(1, epochs)):
        if e < skip_epochs:
            for _ in iter_datasets(data, batch_size, allow_multi):
                pass
            continue
        with flightrec.span("pipeline/epoch", epoch=e):
            gen = stable_batches(data, batch_size, pad_partial=pad_partial,
                                 drop_remainder=drop_remainder,
                                 allow_multi=allow_multi,
                                 round_to_multiple_of=round_to_multiple_of)
            if e == skip_epochs and skip_steps:
                skipped = sum(1 for _ in zip(range(skip_steps), gen))
                if skipped < skip_steps:
                    logger.warning(
                        "resume cursor wants %d steps into the epoch but "
                        "the source produced %d batches; did the data "
                        "change since the checkpoint?", skip_steps, skipped)
            feed = device_feed((guarded_bind(ds, w) for ds, w, _n in gen),
                               guarded_place, depth=max(0, int(prefetch)),
                               host_prefetch=max(0, int(host_prefetch)))
            for group in chunked(feed, k):
                for j in range(len(group)):
                    faultinject.fault_point("train/step", n_dispatched + j)
                    # a wedge here is a hung dispatch; a device_loss a
                    # replica dying between dispatches, the holder's
                    # state at a step boundary
                    faultinject.fault_point("train/wedge", n_dispatched + j)
                    faultinject.fault_point("device/loss", n_dispatched + j)
                    if pre_dispatch is not None:
                        pre_dispatch(n_dispatched + j)
                if k == 1:
                    flightrec.event("pipeline/dispatch", ordinal=n_dispatched)
                else:
                    flightrec.event("pipeline/dispatch", ordinal=n_dispatched,
                                    steps=len(group))
                n_dispatched += len(group)
                for g in ([group] if len(group) == k
                          else [[b] for b in group]):
                    dispatch(g)
            on_epoch()
            # one memory census per epoch (the walk /api/health serves)
            # feeds the per-phase peak gauges: epoch cadence, never per step
            xprof.memory_watermark("fit")


def poison_nan(batch):
    """An injected ``nan`` fault: every floating array of the bound batch's
    first element (the features: an array, or a list of them) multiplied by
    NaN, which makes the step's loss and gradients non-finite as a corrupt
    record would."""
    def nanify(a):
        if isinstance(a, torch.Tensor):
            return a * float("nan") if a.is_floating_point() else a
        if isinstance(a, np.ndarray) and np.issubdtype(a.dtype, np.floating):
            return a * np.float32("nan")
        return a

    first = batch[0]
    if isinstance(first, (list, tuple)):
        first = type(first)(nanify(a) for a in first)
    else:
        first = nanify(first)
    return (first,) + tuple(batch[1:])


def note_steps(holder: Any, listeners: Iterable, losses,
               auxes: Optional[List] = None) -> None:
    """After a dispatch of ``len(losses)`` steps: per step, advance the
    holder's iteration counter and its resume cursor (``_steps_in_epoch``,
    reset by the fit loops at each epoch's end), say whether its parameters
    are this step's (``_at_dispatch_boundary``: inside a multi-step
    dispatch only the last step's are, so a checkpoint waits for it),
    publish the step's loss (a device scalar: listeners convert it, and so
    wait for the card, only when they need the number) and tell every
    listener; ``auxes`` (aligned with ``losses``) are the steps' telemetry
    trees, handed unread to the listeners' ``telemetry_done``."""
    last = len(losses) - 1
    for i, loss in enumerate(losses):
        holder._iteration += 1
        holder._steps_in_epoch = getattr(holder, "_steps_in_epoch", 0) + 1
        holder._at_dispatch_boundary = i == last
        holder._score = loss
        aux = auxes[i] if auxes is not None else None
        for lst in listeners:
            lst.iteration_done(holder, holder._iteration, loss)
            if aux is not None:
                cb = getattr(lst, "telemetry_done", None)
                if cb is not None:
                    cb(holder, holder._iteration, aux)
