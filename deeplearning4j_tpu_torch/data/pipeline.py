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

Counters (``common/profiler.OpProfiler``): ``pipeline/padded_batches``,
``pipeline/dropped_batches``. Not ported: fault injection and the flight
recorder.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, List, Optional, Tuple

import logging

import numpy as np
import torch

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
                   allow_multi: bool = False
                   ) -> Iterator[Tuple[Any, np.ndarray, int]]:
    """``(dataset, w, n_real)`` with one leading size: the target of
    :func:`resolve_batch_size` (else the first batch's size). Smaller
    batches are dropped (``drop_remainder``) or padded with zero-weight
    wrapped rows; larger ones, or all with ``pad_partial=False``, pass
    through with ones."""
    target = resolve_batch_size(data, batch_size)
    prof = OpProfiler.get()
    for ds in iter_datasets(data, batch_size, allow_multi):
        n = ds.num_examples()
        if target is None:
            target = n
        if n == target:
            yield ds, np.ones((n,), np.float32), n
        elif drop_remainder and n < target:
            prof.count("pipeline/dropped_batches")
        elif n > target or not pad_partial:
            yield ds, np.ones((n,), np.float32), n
        else:
            prof.count("pipeline/padded_batches")
            padded, w = pad_dataset(ds, target)
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
               host_prefetch: int = 0) -> None:
    """The loop skeleton: per epoch, stable batches are bound
    (``bind(ds, w)``), placed ``prefetch`` ahead, and dispatched
    (``dispatch(group)``) in groups of ``steps_per_dispatch`` (the short
    tail group one by one, as the JAX package runs it); ``on_epoch()``
    after each epoch; ``host_prefetch``: see :func:`device_feed`.
    ``skip=(epochs_done, steps_in_epoch)`` replays the
    host side up to a checkpoint's cursor (see the module docstring):
    completed epochs are drawn and dropped without ``on_epoch`` (its
    effects are in the restored state), then the resume epoch's first
    ``steps_in_epoch`` stable batches."""
    k = max(1, int(steps_per_dispatch))
    skip_epochs, skip_steps = skip if skip is not None else (0, 0)
    for e in range(max(1, epochs)):
        if e < skip_epochs:
            for _ in iter_datasets(data, batch_size, allow_multi):
                pass
            continue
        gen = stable_batches(data, batch_size, pad_partial=pad_partial,
                             drop_remainder=drop_remainder,
                             allow_multi=allow_multi)
        if e == skip_epochs and skip_steps:
            skipped = sum(1 for _ in zip(range(skip_steps), gen))
            if skipped < skip_steps:
                logger.warning(
                    "resume cursor wants %d steps into the epoch but the "
                    "source produced %d batches; did the data change since "
                    "the checkpoint?", skip_steps, skipped)
        feed = device_feed((bind(ds, w) for ds, w, _n in gen), place,
                           depth=max(0, int(prefetch)),
                           host_prefetch=max(0, int(host_prefetch)))
        for group in chunked(feed, k):
            for g in ([group] if len(group) == k else [[b] for b in group]):
                dispatch(g)
        on_epoch()


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
