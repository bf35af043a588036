"""Transfer learning: freeze, re-head and fine-tune a trained network.

Counterpart of ``deeplearning4j_tpu/nn/transfer.py`` (reference dl4j-nn
``transferlearning.{TransferLearning, FineTuneConfiguration,
TransferLearningHelper}``), with its API:

- :class:`FineTuneConfiguration` (and its ``builder()``): overrides of the
  copied network's global configuration (updater, seed, l1, l2, dropout,
  activation);
- ``TransferLearning.builder(model)``: ``fine_tune_configuration``,
  ``set_feature_extractor(i)`` (layers ``0..i`` wrapped in
  ``FrozenLayer``), ``n_out_replace``, ``remove_output_layer``,
  ``remove_layers_from_output``, ``add_layer``/``addLayer``, ``build()``.
  ``build`` deep-copies the kept layers, re-infers every ``n_in`` through
  ``set_input_type``, initializes the new network on the source's device
  and carries over the parameters *and* the layer states (BN statistics)
  of every kept layer that is not re-initialized, as copies, raising on a
  shape mismatch;
- :class:`TransferLearningHelper`: ``featurize`` runs the frozen bottom
  once in inference mode, ``fit_featurized`` trains a network of the
  unfrozen top alone on those features and writes its parameters and
  states back into the full model (in place), ``unfrozen_mln`` is that
  top network.

A frozen layer's parameters stay bitwise unchanged in ``fit`` (see
``FrozenLayer`` and ``nn/_train.py``), whatever the updater.
"""

from __future__ import annotations

import copy
from typing import List, Optional

import torch

from ..common.tree import get_path, leaf_paths, tree_map
from ..data.dataset import DataSet
from .conf import layers as L
from .conf.builder import (GlobalConf, MultiLayerConfiguration,
                           apply_layer_defaults)
from .multilayer import MultiLayerNetwork


class FineTuneConfiguration:
    """Overrides applied to the copied network's global configuration."""

    class Builder:
        def __init__(self) -> None:
            self._over = {}

        def updater(self, u):
            self._over["updater"] = u
            return self

        def seed(self, s: int):
            self._over["seed"] = s
            return self

        def l1(self, v: float):
            self._over["l1"] = v
            return self

        def l2(self, v: float):
            self._over["l2"] = v
            return self

        def dropout(self, v: float):
            self._over["dropout"] = v
            return self

        def activation(self, a: str):
            self._over["activation"] = a
            return self

        def build(self) -> "FineTuneConfiguration":
            return FineTuneConfiguration(self._over)

    @staticmethod
    def builder() -> "FineTuneConfiguration.Builder":
        return FineTuneConfiguration.Builder()

    def __init__(self, overrides: dict):
        self.overrides = dict(overrides)

    def apply_to(self, gc: GlobalConf) -> None:
        for k, v in self.overrides.items():
            setattr(gc, k, v)


def _unwrap(layer: L.Layer) -> L.Layer:
    return layer.layer if isinstance(layer, L.FrozenLayer) else layer


def _copy_tree(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def _shapes(tree):
    return {p: tuple(get_path(tree, p).shape) for p in leaf_paths(tree)}


class TransferLearning:
    class Builder:
        def __init__(self, model: MultiLayerNetwork):
            model._check_init()
            self._src = model
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._freeze_until: Optional[int] = None
            self._n_out_replace = {}          # index -> (n_out, weight_init)
            self._remove_from = None          # keep layers [0, remove_from)
            self._added: List[L.Layer] = []

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, layer_idx: int):
            """Freeze layers ``0..layer_idx``, inclusive."""
            self._freeze_until = layer_idx
            return self

        def n_out_replace(self, layer_idx: int, n_out: int,
                          weight_init: str = "xavier"):
            """Change a layer's ``n_out`` and re-initialize it and the
            layer after it (whose ``n_in`` changes)."""
            self._n_out_replace[layer_idx] = (n_out, weight_init)
            return self

        def remove_output_layer(self):
            return self.remove_layers_from_output(1)

        def remove_layers_from_output(self, n: int):
            cur = self._remove_from if self._remove_from is not None \
                else len(self._src.layers)
            self._remove_from = max(0, cur - n)
            return self

        def add_layer(self, layer: L.Layer):
            self._added.append(layer)
            return self

        addLayer = add_layer

        def build(self) -> MultiLayerNetwork:
            src = self._src
            keep_until = self._remove_from if self._remove_from is not None \
                else len(src.layers)
            new_layers: List[L.Layer] = []
            reinit = set()              # new indices that take fresh params
            for i, layer in enumerate(src.layers[:keep_until]):
                lcopy = copy.deepcopy(_unwrap(layer))
                if i in self._n_out_replace:
                    n_out, wi = self._n_out_replace[i]
                    if not hasattr(lcopy, "n_out"):
                        raise ValueError(f"layer {i} ({type(lcopy).__name__})"
                                         f" has no n_out")
                    lcopy.n_out = n_out
                    lcopy.weight_init = wi
                    reinit.add(i)
                    if i + 1 < keep_until:
                        reinit.add(i + 1)            # its n_in changes
                if self._freeze_until is not None and i <= self._freeze_until:
                    if i in reinit:
                        raise ValueError(
                            f"layer {i} is both frozen and re-initialized")
                    lcopy = L.FrozenLayer(layer=lcopy)
                new_layers.append(lcopy)
            gc = copy.deepcopy(src.conf.global_conf)
            if self._fine_tune is not None:
                self._fine_tune.apply_to(gc)
            for layer in self._added:
                apply_layer_defaults(layer, gc)
                new_layers.append(layer)
                reinit.add(len(new_layers) - 1)
            conf = MultiLayerConfiguration(gc, new_layers)
            conf.backprop_type = src.conf.backprop_type
            conf.tbptt_fwd_length = src.conf.tbptt_fwd_length
            conf.tbptt_back_length = src.conf.tbptt_back_length
            # the copies carry their old n_in: set_input_type re-infers
            # every one, in order
            conf.set_input_type(src.conf.input_type)
            net = MultiLayerNetwork(conf).init(gc.seed, device=src.device)
            for i in range(min(keep_until, len(new_layers))):
                if i in reinit:
                    continue
                key = net._keys[i]
                src_p, dst_p = src._params[src._keys[i]], net._params[key]
                if _shapes(src_p) != _shapes(dst_p):
                    raise ValueError(
                        f"layer {i} shape mismatch carrying weights over: "
                        f"{_shapes(src_p)} vs {_shapes(dst_p)}")
                net._params[key] = _copy_tree(src_p)
                net._states[key] = _copy_tree(src._states[src._keys[i]])
            return net

    @staticmethod
    def builder(model: MultiLayerNetwork) -> "TransferLearning.Builder":
        return TransferLearning.Builder(model)


class TransferLearningHelper:
    """Featurize once through the frozen bottom, then train the unfrozen
    top alone on the features."""

    def __init__(self, model: MultiLayerNetwork,
                 frozen_until: Optional[int] = None):
        model._check_init()
        if frozen_until is None:
            frozen = [i for i, layer in enumerate(model.layers)
                      if isinstance(layer, L.FrozenLayer)]
            if not frozen:
                raise ValueError("model has no FrozenLayer layers; pass "
                                 "frozen_until explicitly")
            frozen_until = max(frozen)
        self.frozen_until = frozen_until
        self.model = model
        self._top: Optional[MultiLayerNetwork] = None

    def featurize(self, ds: DataSet) -> DataSet:
        """The frozen bottom's output on ``ds``'s features, in inference
        mode (in ``compute_dtype`` when set), with ``ds``'s labels: the
        input of :meth:`fit_featurized`."""
        model = self.model
        (x,) = model._place((ds.features,))
        # no_grad, not inference_mode: the features feed autograd later
        with torch.no_grad():
            params, x = model._cast(model._params, x, False)
            for i in range(self.frozen_until + 1):
                pre = model.conf.preprocessors.get(i)
                if pre is not None:
                    x = pre(x)
                x, _ = model.layers[i].apply(params[model._keys[i]], x,
                                             model._states[model._keys[i]],
                                             False)
        return DataSet(x, ds.labels, labels_mask=ds.labels_mask)

    def fit_featurized(self, ds: DataSet, epochs: int = 1) -> None:
        """Train the top network on featurized data, then copy its
        parameters and states into the full model, in place."""
        top = self._top_net()
        top.fit(ds, epochs=epochs)
        model = self.model
        with torch.no_grad():
            for j, i in enumerate(range(self.frozen_until + 1,
                                        len(model.layers))):
                for tree, src in ((model._params, top._params),
                                  (model._states, top._states)):
                    dst_t, src_t = tree[model._keys[i]], src[top._keys[j]]
                    for p in leaf_paths(dst_t):
                        get_path(dst_t, p).copy_(get_path(src_t, p))
        model._cast_cache = None

    def _top_net(self) -> MultiLayerNetwork:
        if self._top is None:
            model = self.model
            gc = copy.deepcopy(model.conf.global_conf)
            layers = [copy.deepcopy(_unwrap(layer))
                      for layer in model.layers[self.frozen_until + 1:]]
            conf = MultiLayerConfiguration(gc, layers)
            conf.set_input_type(
                model.conf.layer_output_types[self.frozen_until])
            net = MultiLayerNetwork(conf).init(gc.seed, device=model.device)
            for j, i in enumerate(range(self.frozen_until + 1,
                                        len(model.layers))):
                net._params[net._keys[j]] = _copy_tree(
                    model._params[model._keys[i]])
                net._states[net._keys[j]] = _copy_tree(
                    model._states[model._keys[i]])
            self._top = net
        return self._top

    def unfrozen_mln(self) -> MultiLayerNetwork:
        return self._top_net()
