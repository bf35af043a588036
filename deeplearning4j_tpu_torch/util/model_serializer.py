"""ModelSerializer: the model zip, in the JAX package's format.

Counterpart of ``deeplearning4j_tpu/util/model_serializer.py`` (reference
dl4j-nn ``org.deeplearning4j.util.ModelSerializer``). One writer and one
restorer serve ``MultiLayerNetwork`` and ``ComputationGraph``. The zip
holds:

- ``configuration.json``: the network's ``conf.to_json()``;
- ``coefficients.npz``, ``states.npz`` and ``updaterState.npz`` (with
  ``save_updater``): the leaves of the parameter, layer-state and
  updater-state trees in ``jax.tree.flatten`` order (dict keys sorted at
  every level; the port's layer keys ``"0000"``, ``"0001"``, ... keep a
  ``MultiLayerNetwork``'s list order), entry ``"<i>"`` for leaf ``i``.
  A bfloat16 leaf travels as its ``u2`` bit pattern under the name
  ``"<i>::bfloat16"``, as the JAX package writes it (numpy has no
  bfloat16, and the port does not depend on ``ml_dtypes``), and is read back
  through ``torch.int16`` to ``torch.bfloat16``: bit for bit;
- ``meta.json``: iteration, epoch, the network's class, ``format_version``;
- ``normalizer.json`` (``write_model(normalizer=)``): the data
  normalizer's ``to_json()``, read back by :func:`restore_normalizer`.

So the JAX package reads the port's files and the other way round, every
array bitwise. On disk the updater state is always the dense tree that
mirrors the parameters: on the fused path the port keeps it in flat buckets
(``nn/_fused.FlatStore``) whose dense views are what the network holds, so
it writes those views; a flat-layout state is unflattened first
(``parallel/sharding.unflatten_updater_state``). A restore installs new
tensors and drops the flat buckets and the cast cache: the next fit builds
its buckets from them (``TrainableNetwork._flat_store``).

The updater-state dtype is part of the training numerics: a file whose
stored moments disagree with the configured ``state_dtype`` is refused
unless ``convert_state_dtype=True`` (one round-to-nearest cast, logged), as
the JAX package's ``load_state_entries`` refuses it.
"""

from __future__ import annotations

import io
import json
import logging
import os
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.dtypes import dtype_name, tensor_from_numpy
from ..common.environment import resolve_device
from ..common.tree import tree_map
from ..parallel.sharding import unflatten_updater_state

logger = logging.getLogger("deeplearning4j_tpu_torch")

CONF_ENTRY = "configuration.json"
COEFF_ENTRY = "coefficients.npz"
STATES_ENTRY = "states.npz"
UPDATER_ENTRY = "updaterState.npz"
META_ENTRY = "meta.json"
NORMALIZER_ENTRY = "normalizer.json"


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of a nested dict in ``jax.tree.flatten`` order
    (keys sorted at every level)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree] if isinstance(tree, torch.Tensor) else []


def savez_leaves(leaves: List[torch.Tensor]) -> bytes:
    """Leaves (CPU or device tensors) → npz bytes in the JAX package's
    layout: ``"<i>"``, or ``"<i>::bfloat16"`` holding the ``u2`` bits."""
    entries = {}
    for i, t in enumerate(leaves):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            entries[f"{i}::bfloat16"] = t.view(torch.int16).numpy().view(
                np.uint16)
        else:
            entries[str(i)] = t.numpy()
    buf = io.BytesIO()
    np.savez(buf, **entries)
    return buf.getvalue()


def load_leaves(data: bytes, what: str, count: int) -> List[torch.Tensor]:
    """npz bytes → CPU tensors in leaf order (``"<i>::bfloat16"`` entries
    back to bfloat16 bit for bit); raises when the count is not
    ``count``."""
    arrays = np.load(io.BytesIO(data))
    names: Dict[int, Tuple[str, Optional[str]]] = {}
    for n in arrays.files:
        idx, _, tag = n.partition("::")
        names[int(idx)] = (n, tag or None)
    if len(names) != count:
        raise ValueError(f"{what} count mismatch: archive has {len(names)}, "
                         f"configuration implies {count}")
    out = []
    for i in range(count):
        n, tag = names[i]
        a = np.asarray(arrays[n])
        if tag is None:
            out.append(tensor_from_numpy(a))
        elif tag == "bfloat16":
            out.append(torch.from_numpy(np.ascontiguousarray(a).view(
                np.int16)).view(torch.bfloat16))
        else:
            raise ValueError(f"{what} entry {n!r}: dtype {tag} is not one "
                             f"the port reads")
    return out


def _unflatten(template, leaves: List[torch.Tensor]):
    """``leaves`` in ``template``'s nested-dict shape (leaf order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(template)


def dense_updater_state(model):
    """The network's updater state as the dense params-mirroring tree (its
    flat buckets' views, or a flat layout unflattened), or None."""
    return unflatten_updater_state(model._updater_state, model._params)


def write_model(model, path: str, save_updater: bool = False,
                normalizer=None) -> None:
    """The shared writer of both networks (with ``normalizer``: its JSON as
    ``normalizer.json``). The zip is staged to ``<path>.tmp`` and renamed
    into place, so a crash mid-save never leaves a torn file at the target
    name."""
    tmp = path + ".tmp"
    try:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr(CONF_ENTRY, model.conf.to_json())
            zf.writestr(COEFF_ENTRY, savez_leaves(tree_leaves(model._params)))
            zf.writestr(STATES_ENTRY, savez_leaves(tree_leaves(model._states)))
            zf.writestr(META_ENTRY, json.dumps({
                "iteration": model._iteration, "epoch": model._epoch,
                "kind": type(model).__name__, "format_version": 1,
            }))
            if save_updater and model._updater_state is not None:
                zf.writestr(UPDATER_ENTRY, savez_leaves(
                    tree_leaves(dense_updater_state(model))))
            if normalizer is not None:
                zf.writestr(NORMALIZER_ENTRY,
                            json.dumps(normalizer.to_json()))
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _checked(what: str, got: List[torch.Tensor], want: List[torch.Tensor],
             cast: bool) -> List[torch.Tensor]:
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        if tuple(g.shape) != tuple(w.shape):
            raise ValueError(f"{what} leaf {i}: shape {tuple(g.shape)} != "
                             f"{tuple(w.shape)}")
        out.append(g.to(w.dtype) if cast else g)
    return out


def load_state_entries(zf: zipfile.ZipFile, model, load_updater: bool = True,
                       convert_state_dtype: bool = False) -> None:
    """Load the container's coefficient, state, meta and (with
    ``load_updater``) updater entries into an initialized ``model``, as new
    tensors on its device. Shared by the restorers below and
    ``util/checkpoint.restore_training_state``."""
    names = zf.namelist()
    dev = model.device
    params = _checked("coefficient", load_leaves(
        zf.read(COEFF_ENTRY), "coefficient", len(tree_leaves(model._params))),
        tree_leaves(model._params), cast=True)
    model._params = _unflatten(model._params, [t.to(dev) for t in params])
    if STATES_ENTRY in names:
        states = _checked("state", load_leaves(
            zf.read(STATES_ENTRY), "state", len(tree_leaves(model._states))),
            tree_leaves(model._states), cast=False)
        model._states = _unflatten(model._states, [t.to(dev) for t in states])
    meta = json.loads(zf.read(META_ENTRY))
    model._iteration = meta.get("iteration", 0)
    model._epoch = meta.get("epoch", 0)
    # the old buckets (and casts) belong to the old tensors
    model._flat = None
    model._cast_cache = None
    if not load_updater:
        return
    if UPDATER_ENTRY not in names:
        model._updater_state = None
        return
    template = model.conf.global_conf.updater.init(
        tree_map(lambda t: t.to("meta"), model._params))
    want = tree_leaves(template)
    got = _checked("updater state", load_leaves(
        zf.read(UPDATER_ENTRY), "updater state", len(want)), want,
        cast=False)
    mismatch = sorted({f"{dtype_name(g.dtype)}->{dtype_name(w.dtype)}"
                       for g, w in zip(got, want)
                       if g.dtype != w.dtype and w.is_floating_point()})
    if mismatch:
        if not convert_state_dtype:
            sd = getattr(model.conf.global_conf.updater, "state_dtype", None)
            raise ValueError(
                f"updater state dtype mismatch ({', '.join(mismatch)}): the "
                f"checkpoint's stored moments do not match the configured "
                f"state_dtype={sd!r}. A silent cast would change training "
                f"numerics: pass convert_state_dtype=True to convert "
                f"explicitly, or match the updater's state_dtype to the "
                f"checkpoint.")
        logger.info("converting updater state dtype (%s) to the configured "
                    "state_dtype", ", ".join(mismatch))
        got = [g.to(w.dtype) if w.is_floating_point() else g
               for g, w in zip(got, want)]
    model._updater_state = _unflatten(template, [t.to(dev) for t in got])


def _restore(path: str, model_cls, conf_cls, load_updater: bool, device):
    with zipfile.ZipFile(path) as zf:
        conf = conf_cls.from_json(zf.read(CONF_ENTRY).decode())
        model = model_cls(conf).init(device=resolve_device(device))
        load_state_entries(zf, model, load_updater=load_updater)
    return model


def restore_multi_layer_network(path: str, load_updater: bool = False,
                                device=None):
    from ..nn.conf.builder import MultiLayerConfiguration
    from ..nn.multilayer import MultiLayerNetwork

    return _restore(path, MultiLayerNetwork, MultiLayerConfiguration,
                    load_updater, device)


def restore_computation_graph(path: str, load_updater: bool = False,
                              device=None):
    from ..nn.graph import ComputationGraph, ComputationGraphConfiguration

    return _restore(path, ComputationGraph, ComputationGraphConfiguration,
                    load_updater, device)


def restore_model(path: str, load_updater: bool = False, device=None):
    """Either network, by the ``kind`` that ``meta.json`` records."""
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read(META_ENTRY))
    if meta.get("kind") == "ComputationGraph":
        return restore_computation_graph(path, load_updater, device)
    return restore_multi_layer_network(path, load_updater, device)


def restore_normalizer(path: str):
    """The normalizer a model zip holds (either package's), or None."""
    from ..data.normalizers import normalizer_from_json

    with zipfile.ZipFile(path) as zf:
        if NORMALIZER_ENTRY not in zf.namelist():
            return None
        return normalizer_from_json(json.loads(zf.read(NORMALIZER_ENTRY)))
