"""Network configuration builders: global defaults that cascade onto layers.

Counterpart of ``deeplearning4j_tpu/nn/conf/builder.py``:
``NeuralNetConfiguration.builder()`` → ``GlobalConf``, then either the list
builder (``.list()`` → :class:`ListBuilder` → :class:`MultiLayerConfiguration`,
for ``MultiLayerNetwork``) or the graph builder (``nn/graph.py``, which takes
a ``Builder`` here).

``MultiLayerConfiguration.set_input_type`` walks the layers, infers each
``n_in`` and inserts the shape adapters (``_preprocessor_for``,
``builder.py:351-372`` of the JAX package). ``to_json``/``from_json`` write
and read the JAX package's format (``format_version`` 1: every dataclass as
``{"__class__", "fields"}``, tuples as ``{"__tuple__"}``), so a
configuration written by one package reads in the other. A field the JAX
package has and the port does not (an embedding's ``table_sharding``) reads
only when it is inert (None or False); otherwise ``from_json`` raises. A
``LambdaLayer`` is written by its name and read back through
``imports/keras_import.resolve_lambda``; weight noise is written in the
same form, which the JAX package can neither write nor read.

:func:`remat_wrap` is the rematerialization both networks apply to their
blocks (``builder.py:122-149`` of the JAX package, on
``torch.utils.checkpoint``).
"""

from __future__ import annotations

import dataclasses
import functools
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ...learning import schedules as _schedules
from ...learning import updaters as _updaters
from ...learning.updaters import GradientUpdater, Sgd
from .. import losses as _losses
from ..losses import ILossFunction
from . import inputs as _inputs
from . import layers as L
from .inputs import (CNN3DInput, CNNFlatInput, CNNInput, InputType,
                     Preprocessor, RNNInput, cnn3d_to_ff, cnn_to_ff,
                     flat_to_cnn, rnn_to_ff)


@dataclass
class GlobalConf:
    seed: int = 12345
    updater: GradientUpdater = field(default_factory=lambda: Sgd(1e-1))
    weight_init: str = "xavier"
    activation: str = "identity"
    l1: float = 0.0
    l2: float = 0.0
    dropout: float = 0.0
    dtype: str = "float32"                 # parameter storage dtype
    # Mixed precision: forward compute dtype (e.g. "bfloat16") while the
    # parameters stay in `dtype`; BN running stats stay float32.
    compute_dtype: Optional[str] = None
    # Rematerialization (remat_wrap): each layer (graph node) of a training
    # forward runs under torch.utils.checkpoint, per the policy: None or
    # "none", "full", "dots_only", "checkpoint_dots_with_no_batch_dims" or
    # a list of layer indices (graph node names); the legacy
    # gradient_checkpointing=True means "full".
    gradient_checkpointing: bool = False
    remat_policy: Any = None
    # Fused inference epilogue (ops/epilogue): inference BatchNormalization
    # + relu/identity run as one kernel, and ComputationGraph also fuses
    # the resnet block tail BN(identity) → ElementWiseVertex(add) → relu
    # into one BN+residual+relu launch. Opt-in (the folded affine
    # reassociates the dense ops); gated per call with a dense fallback,
    # counted under precision/epilogue_*.
    fused_epilogue: bool = False
    # Fused weight update (ops/update): parameters, gradients and updater
    # state live in Zero1Plan per-dtype flat buckets and the updater runs
    # as one kernel launch per float32 bucket instead of per leaf. Needs an
    # elementwise updater (falls back to the per-leaf path, counted under
    # precision/fused_fallbacks, otherwise). Composes with
    # updater.state_dtype (bf16 moments, stochastic rounding).
    fused_update: bool = False
    # The JAX package's switch between gradients born flat and a dense
    # gradient tree flattened before the update (the two give the same
    # bits). Kept for configuration parity; the port does not read it: with
    # fused_update on, each parameter's .grad is always a view of one flat
    # gradient bucket, so autograd accumulates straight into the layout the
    # kernel reads.
    flat_backward: bool = True
    # Gradient normalization/clipping between the backward and the update
    # (nn/gradnorm.py); None leaves the gradients as they are.
    grad_normalization: Optional[str] = None
    grad_norm_threshold: float = 1.0


#: the named policies :func:`remat_wrap` resolves (a list of blocks is the
#: fourth, open-ended form)
REMAT_POLICIES = ("none", "full", "dots_only",
                  "checkpoint_dots_with_no_batch_dims")


def effective_remat_policy(gc: GlobalConf):
    """The policy in force: ``remat_policy`` when set, else the legacy
    ``gradient_checkpointing`` flag as "full" or "none"."""
    if gc.remat_policy is not None:
        return gc.remat_policy
    return "full" if gc.gradient_checkpointing else "none"


def _check_policy(policy) -> None:
    if isinstance(policy, str) and policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; expected one of "
                         f"{sorted(REMAT_POLICIES)} or a selective block list")


class _Replay:
    """Makes a checkpointed region draw the same random bits when the
    backward recomputes it: the region's first run records ``generator``'s
    state; a recompute runs from that state and then puts back the state
    it found, so the draws after the region are not disturbed.
    ``preserve_rng_state`` would restore only the global generators, and
    every draw of the port comes from the network's own."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator
        self.first: Optional[torch.Tensor] = None
        self.found: Optional[torch.Tensor] = None

    def __enter__(self):
        if self.generator is None:
            return
        if self.first is None:
            self.first = self.generator.get_state()
        else:
            self.found = self.generator.get_state()
            self.generator.set_state(self.first)

    def __exit__(self, *exc):
        if self.found is not None:
            self.generator.set_state(self.found)
            self.found = None


def _save_only(*ops):
    """A selective-checkpoint context that keeps the outputs of ``ops``
    and recomputes every other op of the region."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def remat_wrap(gc: GlobalConf, fn: Callable, block=None,
               generator: Optional[torch.Generator] = None) -> Callable:
    """``fn`` (one block's training forward: a layer apply, a truncated-BPTT
    recurrent segment or a graph node) under the configured policy
    (``builder.py:122-149`` of the JAX package). ``block`` is the block's
    identity for a selective list: the layer index (``MultiLayerNetwork``)
    or the node name (``ComputationGraph``). "none" returns ``fn`` itself;
    the others run it under ``torch.utils.checkpoint.checkpoint(
    use_reentrant=False)``: "full" keeps only the block's inputs and
    recomputes the rest in the backward, "dots_only" (JAX's
    ``checkpoint_dots``) keeps the outputs of the matrix products
    (``aten.mm``, ``addmm``, ``bmm``) and recomputes everything else,
    convolutions included, "checkpoint_dots_with_no_batch_dims" keeps
    those of ``mm`` and ``addmm`` only. Draws from ``generator`` replay
    (:class:`_Replay`); a block returns new layer states (BatchNormalization's
    running statistics) as values, which a recompute computes again and
    drops, so they are applied once. An unknown policy raises here, when
    the step is built."""
    pol = effective_remat_policy(gc)
    if pol == "none":
        return fn
    context_fn = None
    if isinstance(pol, (list, tuple, set)):
        if block not in pol:
            return fn
    elif pol == "dots_only":
        aten = torch.ops.aten
        context_fn = _save_only(aten.mm.default, aten.addmm.default,
                                aten.bmm.default)
    elif pol == "checkpoint_dots_with_no_batch_dims":
        aten = torch.ops.aten
        context_fn = _save_only(aten.mm.default, aten.addmm.default)
    elif pol != "full":
        _check_policy(pol)
        raise ValueError(f"unknown remat policy {pol!r}")

    def run(*args):
        from torch.utils.checkpoint import checkpoint

        replay = _Replay(generator)

        def body(*a):
            with replay:
                return fn(*a)

        kw = {} if context_fn is None else {"context_fn": context_fn}
        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    return run


class NeuralNetConfiguration:
    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    def __init__(self) -> None:
        self._conf = GlobalConf()

    def seed(self, s: int) -> "Builder":
        self._conf.seed = int(s)
        return self

    def updater(self, u: GradientUpdater) -> "Builder":
        self._conf.updater = u
        return self

    def weight_init(self, w: str) -> "Builder":
        self._conf.weight_init = w
        return self

    def activation(self, a: str) -> "Builder":
        self._conf.activation = a
        return self

    def l1(self, v: float) -> "Builder":
        self._conf.l1 = v
        return self

    def l2(self, v: float) -> "Builder":
        self._conf.l2 = v
        return self

    def dropout(self, v: float) -> "Builder":
        self._conf.dropout = v
        return self

    def gradient_normalization(self, mode: str,
                               threshold: float = 1.0) -> "Builder":
        """Normalize or clip the gradients before each update (the modes
        of nn/gradnorm.normalize_gradients_)."""
        self._conf.grad_normalization = mode
        self._conf.grad_norm_threshold = threshold
        return self

    def data_type(self, dtype: str) -> "Builder":
        self._conf.dtype = dtype
        return self

    def compute_dtype(self, dtype: str) -> "Builder":
        self._conf.compute_dtype = dtype
        return self

    def gradient_checkpointing(self, v: bool = True) -> "Builder":
        """Recompute each layer's activations in the backward (the legacy
        form of ``remat_policy("full")``)."""
        self._conf.gradient_checkpointing = bool(v)
        return self

    def remat_policy(self, policy) -> "Builder":
        """A named rematerialization policy (``REMAT_POLICIES``) or a list
        of blocks to recompute in full; see :func:`remat_wrap`."""
        _check_policy(policy)
        self._conf.remat_policy = policy
        return self

    def fused_update(self, v: bool = True) -> "Builder":
        """Apply the updater over flat per-dtype buckets, one fused kernel
        launch per float32 bucket (ops/update); see
        GlobalConf.fused_update."""
        self._conf.fused_update = bool(v)
        return self

    def fused_epilogue(self, v: bool = True) -> "Builder":
        """Fuse inference BN + relu (+ the graph residual add) into one
        epilogue kernel (ops/epilogue); see GlobalConf.fused_epilogue."""
        self._conf.fused_epilogue = bool(v)
        return self

    def list(self) -> "ListBuilder":
        return ListBuilder(self._conf)


class ListBuilder:
    """The layer list of a ``MultiLayerNetwork``, in order."""

    def __init__(self, conf: GlobalConf) -> None:
        self._conf = conf
        self._layers: List[L.Layer] = []
        self._input_type: Optional[InputType] = None
        self._backprop_type = "Standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def layer(self, idx_or_layer,
              maybe_layer: Optional[L.Layer] = None) -> "ListBuilder":
        """``layer(l)`` or DL4J's ``layer(index, l)``: appends ``l``."""
        self._layers.append(maybe_layer if maybe_layer is not None
                            else idx_or_layer)
        return self

    def set_input_type(self, input_type: InputType) -> "ListBuilder":
        self._input_type = input_type
        return self

    setInputType = set_input_type

    def backprop_type(self, bp: str) -> "ListBuilder":
        """"Standard" or "TruncatedBPTT": ``MultiLayerNetwork.fit`` then
        steps once per ``tbptt_length`` segment of each sequence batch."""
        if bp not in ("Standard", "TruncatedBPTT"):
            raise ValueError("backprop_type must be Standard|TruncatedBPTT")
        self._backprop_type = bp
        return self

    def tbptt_fwd_length(self, k: int) -> "ListBuilder":
        self._tbptt_fwd = int(k)
        return self

    def tbptt_back_length(self, k: int) -> "ListBuilder":
        self._tbptt_back = int(k)
        return self

    def tbptt_length(self, k: int) -> "ListBuilder":
        return self.tbptt_fwd_length(k).tbptt_back_length(k)

    def build(self) -> "MultiLayerConfiguration":
        if self._backprop_type == "TruncatedBPTT" \
                and self._tbptt_fwd != self._tbptt_back:
            # as the JAX package: one segment is both windows
            raise ValueError(
                "tbptt_fwd_length must equal tbptt_back_length (use "
                "tbptt_length(k)); unequal truncation windows are not "
                "supported")
        for layer in self._layers:
            apply_layer_defaults(layer, self._conf)
        mlc = MultiLayerConfiguration(self._conf, self._layers)
        mlc.backprop_type = self._backprop_type
        mlc.tbptt_fwd_length = self._tbptt_fwd
        mlc.tbptt_back_length = self._tbptt_back
        if self._input_type is not None:
            mlc.set_input_type(self._input_type)
        return mlc


def apply_layer_defaults(l: L.Layer, gc: GlobalConf) -> None:
    """Cascade global defaults onto a layer, and onto the layer a wrapper
    (``TimeDistributed``, ``Bidirectional``, ``LastTimeStep``) holds."""
    if l.activation is None and not isinstance(l, L.OutputLayer):
        l.activation = gc.activation
    if l.weight_init is None:
        l.weight_init = gc.weight_init
    if isinstance(l, L.BatchNormalization) and l.fused_epilogue is None:
        l.fused_epilogue = gc.fused_epilogue
    if l.l1 is None:
        l.l1 = gc.l1
    if l.l2 is None:
        l.l2 = gc.l2
    if l.dropout is None:
        l.dropout = gc.dropout
    inner = getattr(l, "layer", None)
    if isinstance(inner, L.Layer):
        apply_layer_defaults(inner, gc)


class MultiLayerConfiguration:
    def __init__(self, global_conf: GlobalConf, layers: List[L.Layer]):
        self.global_conf = global_conf
        self.layers = layers
        self.preprocessors: Dict[int, Preprocessor] = {}
        self.input_type: Optional[InputType] = None
        self.layer_output_types: List[InputType] = []
        self.backprop_type = "Standard"
        self.tbptt_fwd_length = 20
        self.tbptt_back_length = 20

    def set_input_type(self, input_type: InputType) -> None:
        """Infer every layer's ``n_in`` from ``input_type`` and insert the
        shape adapters between layers."""
        self.input_type = input_type
        self.preprocessors = {}
        self.layer_output_types = []
        cur = input_type
        for i, layer in enumerate(self.layers):
            pre = self._preprocessor_for(cur, layer)
            if pre is not None:
                self.preprocessors[i] = pre
                cur = pre.out_type
            cur = layer.set_input_type(cur)
            self.layer_output_types.append(cur)

    @staticmethod
    def _preprocessor_for(cur: InputType,
                          layer: L.Layer) -> Optional[Preprocessor]:
        # a frozen layer keeps its inner layer's input contract (a frozen
        # dense layer after a convolution still gets cnn_to_ff)
        if isinstance(layer, L.FrozenLayer) and layer.layer is not None:
            layer = layer.layer
        if isinstance(cur, CNNFlatInput):
            return flat_to_cnn(cur)
        if isinstance(cur, CNNInput) and isinstance(layer, L.FF_LIKE) \
                and not isinstance(layer, L.RnnOutputLayer):
            return cnn_to_ff(cur)
        if isinstance(cur, CNN3DInput) and isinstance(layer, L.FF_LIKE) \
                and not isinstance(layer, L.RnnOutputLayer):
            return cnn3d_to_ff(cur)
        if isinstance(cur, RNNInput) and isinstance(layer, L.DenseLayer) \
                and not isinstance(layer, L.OutputLayer):
            return rnn_to_ff(cur)
        return None

    # --- serde -------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "format_version": 1,
            "global": _ser_obj(self.global_conf),
            "layers": [_ser_obj(layer) for layer in self.layers],
            "input_type": (_ser_obj(self.input_type)
                           if self.input_type else None),
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        mlc = MultiLayerConfiguration(_deser_obj(d["global"]),
                                      [_deser_obj(ld) for ld in d["layers"]])
        mlc.backprop_type = d.get("backprop_type", "Standard")
        mlc.tbptt_fwd_length = d.get("tbptt_fwd_length", 20)
        mlc.tbptt_back_length = d.get("tbptt_back_length", 20)
        if d.get("input_type"):
            mlc.set_input_type(_deser_obj(d["input_type"]))
        return mlc


# --- dataclass (de)serialization of configurations ------------------------------

def _registry() -> Dict[str, type]:
    classes: Dict[str, type] = {"GlobalConf": GlobalConf}
    for mod in (L, _inputs, _updaters, _schedules):
        for name in dir(mod):
            obj = getattr(mod, name)
            if isinstance(obj, type) and (dataclasses.is_dataclass(obj)
                                          or (issubclass(obj, L.IWeightNoise)
                                              and obj is not L.IWeightNoise)):
                classes[name] = obj
    for name in dir(_losses):
        obj = getattr(_losses, name)
        if isinstance(obj, type) and issubclass(obj, ILossFunction) \
                and obj is not ILossFunction:
            classes[name] = obj
    return classes


_CLASSES = _registry()


def _ser_obj(obj: Any) -> Any:
    if obj is None or isinstance(obj, (int, float, str, bool)):
        return obj
    if isinstance(obj, tuple):
        return {"__tuple__": [_ser_obj(v) for v in obj]}
    if isinstance(obj, list):
        return [_ser_obj(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": obj.tolist(), "dtype": str(obj.dtype)}
    if isinstance(obj, (ILossFunction, GradientUpdater, L.IWeightNoise)) \
            and not dataclasses.is_dataclass(obj):
        # weight noise: the JAX package cannot write these (its _ser_obj
        # raises TypeError) nor read them; the port writes them in the
        # same {"__class__", "fields"} form (ROADMAP §C)
        return {"__class__": type(obj).__name__,
                "fields": {k: _ser_obj(v) for k, v in obj.__dict__.items()}}
    if dataclasses.is_dataclass(obj):
        fields = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(obj, L.LambdaLayer) and f.name == "fn" \
                    and callable(v):
                # a function body does not serialize: its registered name
                # does (imports/keras_import.register_lambda)
                if not obj.name:
                    raise TypeError(
                        "cannot serialize an unnamed LambdaLayer: give it a "
                        "unique name=... so that reading it back can look "
                        "up the registered function")
                fields[f.name] = {"__lambda__": obj.name}
            else:
                fields[f.name] = _ser_obj(v)
        return {"__class__": type(obj).__name__, "fields": fields}
    raise TypeError(f"cannot serialize config object {type(obj)}")


def _deser_obj(d: Any) -> Any:
    if d is None or isinstance(d, (int, float, str, bool)):
        return d
    if isinstance(d, list):
        return [_deser_obj(v) for v in d]
    if "__tuple__" in d:
        return tuple(_deser_obj(v) for v in d["__tuple__"])
    if "__ndarray__" in d:
        return np.asarray(d["__ndarray__"], dtype=d["dtype"])
    if "__lambda__" in d:
        from ...imports.keras_import import resolve_lambda

        return resolve_lambda(d["__lambda__"])
    if "__class__" not in d:
        return {k: _deser_obj(v) for k, v in d.items()}
    name = d["__class__"]
    if name not in _CLASSES:
        raise NotImplementedError(f"configuration class {name!r} is not "
                                  f"ported yet")
    cls = _CLASSES[name]
    fields = {k: _deser_obj(v) for k, v in d["fields"].items()}
    if not dataclasses.is_dataclass(cls):
        obj = cls.__new__(cls)
        obj.__dict__.update(fields)
        return obj
    known = {f.name for f in dataclasses.fields(cls)}
    extra = {k: v for k, v in fields.items() if k not in known}
    live = {k: v for k, v in extra.items() if v not in (None, False)}
    if live:
        raise NotImplementedError(f"{name}: field(s) {sorted(live)} are not "
                                  f"ported yet")
    return cls(**{k: v for k, v in fields.items() if k in known})
