"""MultiLayerNetwork: a stack of layers, trained and served.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``, with its API:
``init``, ``fit``, ``output``, ``feed_forward``, ``score``,
``compute_gradient_and_score``, ``evaluate``, ``evaluate_regression``,
``params``/``set_params``/``num_params``, ``param_table``, ``summary``,
``clone``, ``set_listeners``, ``get_layer``, ``n_layers``, ``save``/
``load`` (the JAX package's model zip, ``util/model_serializer.py``).

Parameters are a dict keyed by the layer's zero-padded index (``"0000"``,
``"0001"``, ...) of per-layer dicts, so the order of the leaves (layer by
layer, names sorted) is ``jax.tree.flatten``'s on the JAX network's list:
``params()`` gives the JAX network's vector, and the flat buckets of the
fused update (``nn/_fused.FlatStore``, shared with ``ComputationGraph``) hold
the elements in the JAX package's places.

**The loss** (``multilayer.py:274-346``): the forward to the output head's
input (in ``compute_dtype`` when set), the head's input dropout, the head's
``compute_score`` (``OutputLayer``, ``LossLayer``,
``CenterLossOutputLayer`` with its center term, ``Yolo2OutputLayer``) in
float32 from the float32 master parameters, the
``labels_mask``, and for the input pipeline's batches the example weights
``w`` (``sum(w * loss) / max(sum(w), 1)``, so the wrapped rows of a padded
batch count for nothing), plus l1/l2 over every parameter but
``b``/``beta``/``mean``/``var``.

**The step** (``_step_core``, ``:386-484``): the backward through autograd,
the gradient normalization (``nn/gradnorm.py``), the update (one launch of
the ``csrc/fused_update.cu`` kernel per float32 bucket with
``fused_update``, the per-leaf updater otherwise), then the layers'
constraints. Dropout bits and stochastic-rounding bits come from the
network's own ``torch.Generator``, seeded from the configuration.

**A feature mask** (``DataSet.features_mask`` or ``output(x, fmask=)``,
``[B, T]``) routes every layer through ``apply_masked``
(``multilayer.py:148-163``): self-attention masks its keys (the flash
kernel's additive bias), global pooling leaves padded steps out and the
recurrent layers zero their outputs there. Without one, a ``MaskingLayer``
derives it from its input and hands it to the layers after it, and (as the
first layer) to the loss of a ``RnnOutputLayer`` head (``:190-225``).

**Truncated BPTT** (``backprop_type("TruncatedBPTT").tbptt_length(k)``,
``:825-866``): ``fit`` takes the serial loop, even for an iterator, and
cuts each ``[B, T, F]`` batch into segments of ``k`` steps. Each segment
is one ``_step`` (one ``fused_update`` launch per segment on the fused
path), all at the batch's iteration; the recurrent carries run on from
segment to segment, detached at each boundary, where the gradient stops.
2-D labels serve every segment. The listeners hear one step per batch,
with the last segment's loss. ``rnn_time_step`` (``:869-903``) serves a
stream chunk by chunk from the carries it keeps (in the configuration's
``dtype``), until ``rnn_clear_previous_state``.

``fit`` takes a DataSet or a ``(features, labels)`` tuple (one step each,
unpadded: ``bench.py``'s loop), or an iterator or a ``batch_size``, which go
through the input pipeline (``data/pipeline.py``): the partial last batch is
padded by wrapping rows, ``prefetch`` batches are placed ahead (pinned
memory and non-blocking copies on the card), and ``steps_per_dispatch=K``
runs K steps before the listeners hear of them, as the JAX package's
``lax.scan`` chunk does.

``fit(resume_from=)`` continues a run from a checkpoint that
``CheckpointListener`` wrote, bitwise (``util/checkpoint.py``).

**Frozen layers** (``FrozenLayer``, ``nn/transfer.py``): the layer gets its
parameters detached and ``training`` as given (its dropout and batch
statistics act in ``fit``, as in the JAX package); l1/l2 leave it out, and
the step writes its parameters back after the update
(``multilayer.py:465-469``), so they end every step bitwise unchanged
under any updater while their updater state evolves as the JAX step's.
**Weight noise** (a layer's ``weight_noise``: ``DropConnect``,
``WeightNoise``) perturbs the layer's parameters before its ``apply`` in
training (``:159-161``). **Rematerialization** (``remat_policy``,
``gradient_checkpointing``, ``set_remat_policy``): each layer's training
forward, and each truncated-BPTT segment's recurrent layer, runs under
``conf.builder.remat_wrap`` (``:166-167``, ``:212``). **Pretraining**
(``pretrain``, ``:769-818``): each ``VariationalAutoencoder`` on the
inference-mode output of the layers below it, with a fresh per-leaf
updater.

**Telemetry** (``set_listeners`` with ``TelemetrySink`` or
``NanSentinelListener``, ``optimize/telemetry.py``): every step, on every
loop (serial, pipeline, ``steps_per_dispatch``, truncated BPTT), computes
the per-layer aux on the card, and the NaN guard keeps a poisoned step's
pre-step values (``nn/_train.TrainableNetwork._step``). ``fit(host_prefetch=
N)`` assembles the batches on a worker thread through an N-deep queue.

``init`` places the parameters on the card unless the caller asks for
another device (``device="cpu"``); so does ``load``. The fleet's per-call
``hyper`` overrides have no entry here.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..common.dtypes import tensor_from_numpy, torch_dtype
from ..common.environment import resolve_device
from ..common.tree import leaf_paths, tree_map
from ..data import pipeline as _pipe
from ..data.dataset import DataSet
from ..learning.precision import apply_updater, cast_floating
from ..optimize import telemetry as _tel
from ._fused import FlatStore
from ._train import TrainableNetwork
from .conf import layers as L
from .conf.builder import MultiLayerConfiguration, _check_policy, remat_wrap

#: parameter names that take no l1/l2 (biases and normalization)
_NO_REG = ("b", "beta", "mean", "var")
#: parameter names that constraints leave alone
_NO_CONSTRAINT = ("b", "beta", "gamma", "mean", "var", "centers")


def layer_key(i: int) -> str:
    """The dict key of layer ``i``: sorted keys keep the layer order."""
    return f"{i:04d}"


class MultiLayerNetwork(TrainableNetwork):
    def __init__(self, conf: MultiLayerConfiguration):
        if len(conf.layers) > 9999:
            raise ValueError("at most 9999 layers")
        super().__init__(conf)
        self.layers = conf.layers
        self._keys = [layer_key(i) for i in range(len(conf.layers))]
        # rnn_time_step's recurrent carries, by layer key
        self._rnn_state_map: Optional[Dict[str, object]] = None

    # --- set-up ------------------------------------------------------------
    def init(self, seed: Optional[int] = None,
             device=None) -> "MultiLayerNetwork":
        """Create the parameters from a seeded ``torch.Generator`` (drawn on
        the CPU, so a seed gives the same weights on every device) and place
        them on ``device``: the card unless the caller asks for another."""
        if self.conf.input_type is None:
            raise ValueError("configuration needs set_input_type(...) "
                             "before init()")
        self.device = resolve_device(device)
        gen = torch.Generator()
        gen.manual_seed(int(seed if seed is not None
                            else self.conf.global_conf.seed))
        dtype = torch_dtype(self.conf.global_conf.dtype)
        self._params, self._states = {}, {}
        for key, layer in zip(self._keys, self.layers):
            self._params[key] = (layer.init_params(gen, dtype, self.device)
                                 if layer.has_params else {})
            self._states[key] = layer.init_state(self.device)
        self._updater_state = None
        self._flat = None
        self._cast_cache = None
        self._initialized = True
        return self

    def set_remat_policy(self, policy) -> None:
        """Switch the rematerialization policy (:func:`~.conf.builder.
        remat_wrap`); the next training step runs under it."""
        _check_policy(policy)
        self.conf.global_conf.remat_policy = policy

    # --- parameter access --------------------------------------------------
    def set_params(self, flat) -> None:
        """Load a flat vector (numpy or tensor, e.g. the JAX network's
        ``params()``) into the parameters, in place: the fused update's
        bucket views stay the parameters."""
        self._check_init()
        if not isinstance(flat, torch.Tensor):
            flat = tensor_from_numpy(np.asarray(flat))
        flat = flat.reshape(-1).to(self.device)
        leaves = self._leaves()
        n = sum(int(t.numel()) for t in leaves)
        if flat.numel() != n:
            raise ValueError(f"param vector length {flat.numel()} != model "
                             f"params {n}")
        off = 0
        with torch.no_grad():
            for t in leaves:
                k = int(t.numel())
                t.copy_(flat[off:off + k].reshape(t.shape))
                off += k

    def param_table(self, layer_idx: int) -> Dict[str, torch.Tensor]:
        return dict(self._params[self._keys[layer_idx]])

    def get_layer(self, idx: int) -> L.Layer:
        return self.layers[idx]

    def n_layers(self) -> int:
        return len(self.layers)

    def summary(self) -> str:
        lines = [f"{'idx':<4}{'layer':<28}{'out type':<28}{'params':<10}"]
        total = 0
        for i, layer in enumerate(self.layers):
            n = (sum(int(t.numel()) for _, t in
                     _named_leaves(self._params[self._keys[i]]))
                 if self._initialized else 0)
            total += n
            ot = (self.conf.layer_output_types[i]
                  if i < len(self.conf.layer_output_types) else "?")
            lines.append(f"{i:<4}{type(layer).__name__:<28}{str(ot):<28}"
                         f"{n:<10}")
        lines.append(f"Total params: {total}")
        return "\n".join(lines)

    def clone(self) -> "MultiLayerNetwork":
        """A new network with a copy of the configuration and copies of the
        parameters and layer states (not of the updater state), on the
        same device."""
        self._check_init()
        net = MultiLayerNetwork(copy.deepcopy(self.conf))
        net.device = self.device
        with torch.no_grad():
            net._params = tree_map(lambda t: t.detach().clone(),
                                   self._params)
            net._states = tree_map(torch.clone, self._states)
        net._initialized = True
        return net

    # --- forward -----------------------------------------------------------
    def _cast(self, params, x, training: bool):
        cd = self.conf.global_conf.compute_dtype
        if not cd:
            return params, x
        ct = torch_dtype(cd)
        if training:
            # inside autograd: the gradients flow back to the float32
            # master parameters through the cast
            params = cast_floating(params, ct)
        else:
            params = self._compute_params(params)
        return params, (x.to(ct) if x.is_floating_point() else x)

    def _forward(self, params, states, x, training: bool, fmask=None,
                 to_preout: bool = False, rnn=None):
        """``(y, new_states)``. ``to_preout``: stop at the output head's
        input, after its input dropout (the loss applies the head). ``rnn``
        (truncated BPTT): the recurrent layers' carries by layer key; those
        layers start from them and leave their new carries there, and their
        outputs are masked after them."""
        params, x = self._cast(params, x, training)
        gen = self.generator() if training else None
        new_states = dict(states)
        n_body = len(self.layers) - 1 if to_preout else len(self.layers)
        for i in range(n_body):
            layer, key = self.layers[i], self._keys[i]
            pre = self.conf.preprocessors.get(i)
            if pre is not None:
                x = pre(x)
            if isinstance(layer, L.MaskingLayer) and fmask is None:
                # Keras Masking: the mask derived here reaches the layers
                # after this one
                fmask = layer.derive_mask(x)
            if rnn is not None and layer.is_rnn():
                def run_rnn(lp, xx, carry, st, _l=layer):
                    return _l.apply_rnn(lp, xx, carry, st, training,
                                        generator=gen)

                if training:
                    # a truncated-BPTT segment's recurrence, where the
                    # activations pile up: the same policy applies
                    run_rnn = remat_wrap(self.conf.global_conf, run_rnn,
                                         block=i, generator=gen)
                x, rnn[key], st = run_rnn(params[key], x, rnn[key],
                                          states[key])
                if fmask is not None:
                    x = x * fmask[:, :, None].to(x.dtype)
            else:
                x, st = self._apply_layer(i, params[key], x, states[key],
                                          training, gen, fmask)
            if st:
                new_states[key] = st
        if to_preout:
            i = len(self.layers) - 1
            pre = self.conf.preprocessors.get(i)
            if pre is not None:
                x = pre(x)
            x = self.layers[i]._maybe_dropout(x, training, gen)
        return x, new_states

    def _apply_layer(self, i: int, lp, x, st, training: bool, gen, fmask):
        """Layer ``i``'s forward (``multilayer.py:148-167``): its weight
        noise first (in training, with draws from ``gen``), then ``apply``
        or, with a feature mask, ``apply_masked``; in training under the
        configured rematerialization policy (the selective list matches
        the layer's index)."""
        layer = self.layers[i]

        def run(lp, x, st, fmask):
            if layer.weight_noise is not None:
                lp = layer.weight_noise.apply(lp, gen, training)
            if fmask is not None:
                return layer.apply_masked(lp, x, st, training, fmask,
                                          generator=gen)
            return layer.apply(lp, x, st, training, generator=gen)

        if training:
            run = remat_wrap(self.conf.global_conf, run, block=i,
                             generator=gen)
        return run(lp, x, st, fmask)

    def _place(self, arrays: Tuple) -> Tuple:
        """Arrays (numpy, tensors or None) on the network's device
        (``_place_array``)."""
        return tuple(self._place_array(a) for a in arrays)

    _place_batch = _place

    def output(self, x, training: bool = False, fmask=None) -> torch.Tensor:
        """Inference (``training=True``: with dropout and batch
        statistics, without a step). ``fmask`` ``[B, T]``: the per-step
        feature mask of sequence inputs."""
        self._check_init()
        x, fmask = self._place((x, fmask))
        with torch.inference_mode():
            out, _ = self._forward(self._params, self._states, x, training,
                                   fmask)
        return out

    def feed_forward(self, x, training: bool = False) -> List[torch.Tensor]:
        """Every layer's activation, the input first (in the parameters'
        dtype, as the JAX network's ``feed_forward``)."""
        self._check_init()
        (cur,) = self._place((x,))
        acts = [cur]
        gen = self.generator() if training else None
        with torch.inference_mode():
            for i, layer in enumerate(self.layers):
                pre = self.conf.preprocessors.get(i)
                if pre is not None:
                    cur = pre(cur)
                cur, _ = layer.apply(self._params[self._keys[i]], cur,
                                     self._states[self._keys[i]], training,
                                     generator=gen)
                acts.append(cur)
        return acts

    # --- loss --------------------------------------------------------------
    def _loss(self, params, states, x, labels, mask, training: bool,
              fmask=None, w=None, rnn=None):
        out_layer = self.layers[-1]
        if not hasattr(out_layer, "compute_score"):
            raise ValueError("the last layer must be a loss head "
                             "(OutputLayer, LossLayer, Yolo2OutputLayer, ...) "
                             "to train or score")
        if fmask is None and isinstance(self.layers[0], L.MaskingLayer):
            # the mask of a leading MaskingLayer masks a recurrent head's
            # loss too (derived here, before the compute-dtype cast)
            pre0 = self.conf.preprocessors.get(0)
            fmask = self.layers[0].derive_mask(pre0(x) if pre0 is not None
                                               else x)
        if mask is None and fmask is not None \
                and isinstance(out_layer, L.RnnOutputLayer):
            mask = fmask
        pre_in, new_states = self._forward(params, states, x, training,
                                           fmask, to_preout=True, rnn=rnn)
        head = params[self._keys[-1]]
        if self.conf.global_conf.compute_dtype:
            # the head and the loss in float32, from the master parameters
            head = {k: t.to(torch.float32) for k, t in head.items()}
            pre_in = pre_in.to(torch.float32)
        if w is None:
            data_loss = out_layer.compute_score(head, pre_in, labels, mask,
                                                average=True)
        else:
            total = out_layer.compute_score(head, pre_in, labels,
                                            _fold_weights(mask, w),
                                            average=False)
            data_loss = total / torch.clamp_min(w.sum(), 1.0)
        gc = self.conf.global_conf
        reg = 0.0
        for key, layer in zip(self._keys, self.layers):
            if isinstance(layer, L.FrozenLayer):
                continue    # frozen parameters take no decay either
            l1 = layer.l1 if layer.l1 is not None else gc.l1
            l2 = layer.l2 if layer.l2 is not None else gc.l2
            for name, t in _named_leaves(params[key]):
                if name in _NO_REG:
                    continue
                if l2:
                    reg = reg + 0.5 * l2 * torch.sum(torch.square(t))
                if l1:
                    reg = reg + l1 * torch.sum(torch.abs(t))
        return data_loss + reg, new_states

    def _bind_dataset(self, ds: DataSet):
        """``(x, y, mask, fmask)`` of a DataSet, placed."""
        if not isinstance(ds, DataSet):
            raise TypeError(f"expected a DataSet, got {type(ds).__name__}")
        return self._place((ds.features, ds.labels, ds.labels_mask,
                            ds.features_mask))

    def score(self, dataset: DataSet, training: bool = False) -> float:
        """The loss on ``dataset`` (regularization included), without a
        step."""
        self._check_init()
        x, y, mask, fmask = self._bind_dataset(dataset)
        with torch.no_grad():
            loss, _ = self._loss(self._params, self._states, x, y, mask,
                                 training, fmask)
        return float(loss)

    def compute_gradient_and_score(self, dataset: DataSet):
        """``(gradients, score)`` in inference mode: the gradients as one
        dict per layer (the JAX network's list)."""
        self._check_init()
        x, y, mask, fmask = self._bind_dataset(dataset)
        grads, score = self._gradient_and_score(
            lambda p: self._loss(p, self._states, x, y, mask, False,
                                 fmask)[0])
        return [grads[key] for key in self._keys], score

    # --- training ----------------------------------------------------------
    def _apply_constraints(self) -> None:
        """Project the weights after the update, in place
        (``multilayer.py:534-550``)."""
        for key, layer in zip(self._keys, self.layers):
            if not layer.constraints:
                continue
            for name, t in _named_leaves(self._params[key]):
                if name in _NO_CONSTRAINT:
                    continue
                w = t
                for c in layer.constraints:
                    w = c.apply(w)
                t.copy_(w)

    def _step_core(self, store: Optional[FlatStore], batch, iteration: int,
                   rnn=None) -> torch.Tensor:
        """One training step on a placed batch ``(x, y, mask, fmask, w)``:
        forward, loss, backward, gradient normalization, update (through
        ``store`` on the fused path), constraints. Returns the loss, a
        detached device scalar. ``rnn``: a truncated-BPTT segment's
        recurrent carries (see :meth:`_forward`), left in place as the
        segment's new carries, still attached to its graph."""
        x, y, mask, fmask, w = batch
        loss, self._states = self._train_step(
            store, lambda p: self._loss(p, self._states, x, y, mask, True,
                                        fmask, w, rnn), iteration)
        with torch.no_grad():
            self._apply_constraints()
        return loss

    def _serial_step(self, store: Optional[FlatStore], batch) -> torch.Tensor:
        if self.conf.backprop_type == "TruncatedBPTT" and batch[0].ndim == 3:
            return self._fit_tbptt(store, batch)
        return self._step(store, batch, self._iteration)

    def _fit_tbptt(self, store: Optional[FlatStore], batch) -> torch.Tensor:
        """Truncated BPTT over one placed batch: ``[B, T, F]`` in segments
        of ``tbptt_fwd_length`` steps, one :meth:`_step` each at the
        batch's iteration (Adam's bias correction sees the batch, not the
        segment); the carries start at zero and are detached at each
        boundary. Returns the last segment's loss. With telemetry the
        batch's aux has the last segment's norms and every segment's
        non-finite counts and skips; under the NaN guard a skipped segment
        also keeps its incoming carries (``multilayer.py:825-866``)."""
        x, y, mask, fmask, w = batch
        gc = self.conf.global_conf
        dtype = torch_dtype(gc.compute_dtype or gc.dtype)
        rnn = {key: layer.init_rnn_state(x.shape[0], dtype, self.device)
               for key, layer in zip(self._keys, self.layers)
               if layer.is_rnn()}
        k = self.conf.tbptt_fwd_length
        loss, aux = None, None
        for s0 in range(0, x.shape[1], k):
            seg = slice(s0, s0 + k)
            before = dict(rnn)
            loss = self._step(store, (
                x[:, seg], y[:, seg] if y.ndim == 3 else y,
                mask[:, seg] if mask is not None and mask.ndim >= 2
                else mask,
                fmask[:, seg] if fmask is not None else None, w),
                self._iteration, rnn)
            rnn = {key: _detach(c) for key, c in rnn.items()}
            if self._aux is not None:
                if "skipped" in self._aux:
                    ok = self._aux["skipped"] == 0
                    rnn = {key: _keep_carry(ok, c, before[key])
                           for key, c in rnn.items()}
                aux = _tel.merge_segment_aux(aux, self._aux)
        self._aux = aux
        return loss

    def _frozen_paths(self):
        """The leaf paths of the ``FrozenLayer`` layers' parameters."""
        return [(key,) + p for key, layer in zip(self._keys, self.layers)
                if isinstance(layer, L.FrozenLayer)
                for p in leaf_paths(self._params[key])]

    def fit(self, data, epochs: int = 1, batch_size: Optional[int] = None,
            *, pad_partial: bool = True,
            drop_remainder: bool = False, prefetch: int = 2,
            steps_per_dispatch: int = 1, host_prefetch: int = 0,
            resume_from: Optional[str] = None) -> None:
        """Train on ``data`` for ``epochs`` passes (see the module
        docstring for the two loops). ``resume_from``: a checkpoint written
        by ``CheckpointListener``; the call must be given the same data,
        epochs and batch arguments as the run that wrote it."""
        self._check_init()
        # truncated BPTT has its own segment loop: always the serial path
        tbptt = self.conf.backprop_type == "TruncatedBPTT"
        self._run_fit(data, epochs, batch_size, pad_partial=pad_partial,
                      drop_remainder=drop_remainder, prefetch=prefetch,
                      steps_per_dispatch=steps_per_dispatch,
                      host_prefetch=host_prefetch, resume_from=resume_from,
                      serial=tbptt or (isinstance(data, (DataSet, tuple))
                                       and batch_size is None))

    def _bind_batch(self, ds: DataSet, w) -> Tuple:
        """A batch as the step's tuple ``(x, y, mask, fmask, w)``, not yet
        placed (``w``: the pipeline's example weights, or None for the
        plain mean)."""
        if not isinstance(ds, DataSet):
            raise TypeError(f"expected a DataSet, got {type(ds).__name__}")
        self._last_batch_size = ds.num_examples()
        return (ds.features, ds.labels, ds.labels_mask, ds.features_mask, w)

    # --- streaming inference --------------------------------------------------
    def rnn_time_step(self, x) -> torch.Tensor:
        """Forward ``[B, T, F]`` (or ``[B, F]``, one step) from the stored
        recurrent carries, which it then replaces: the outputs ``[B, T,
        out]``. The carries start at zero, in the configuration's
        ``dtype`` (not its compute dtype, as in the JAX package), and the
        parameters are not cast."""
        self._check_init()
        (cur,) = self._place((x,))
        if cur.ndim == 2:
            cur = cur[:, None, :]
        if self._rnn_state_map is None:
            dtype = torch_dtype(self.conf.global_conf.dtype)
            self._rnn_state_map = {
                key: layer.init_rnn_state(cur.shape[0], dtype, self.device)
                for key, layer in zip(self._keys, self.layers)
                if layer.is_rnn()}
        carries = self._rnn_state_map
        with torch.inference_mode():
            for i, (key, layer) in enumerate(zip(self._keys, self.layers)):
                pre = self.conf.preprocessors.get(i)
                if pre is not None:
                    cur = pre(cur)
                if layer.is_rnn():
                    cur, carries[key], _ = layer.apply_rnn(
                        self._params[key], cur, carries[key],
                        self._states[key], False)
                else:
                    cur, _ = layer.apply(self._params[key], cur,
                                         self._states[key], False)
        return cur

    rnnTimeStep = rnn_time_step

    def rnn_clear_previous_state(self) -> None:
        self._rnn_state_map = None

    rnnClearPreviousState = rnn_clear_previous_state

    # --- layerwise pretraining ---------------------------------------------------
    def _below(self, idx: int, x):
        """The inference-mode activations that feed layer ``idx`` (its
        preprocessor applied), without the compute-dtype cast."""
        for i in range(idx):
            pre = self.conf.preprocessors.get(i)
            if pre is not None:
                x = pre(x)
            x, _ = self.layers[i].apply(self._params[self._keys[i]], x,
                                        self._states[self._keys[i]], False)
        pre = self.conf.preprocessors.get(idx)
        return pre(x) if pre is not None else x

    def pretrain(self, data, epochs: int = 1) -> None:
        """Layerwise unsupervised pretraining (``multilayer.py:769-818``):
        each pretrainable layer (``VariationalAutoencoder``: its negative
        ELBO) in order, on the inference-mode activations of the layers
        below it, one step per DataSet, with a fresh state of the
        configured updater applied leaf by leaf (``apply_updater``, never
        the fused buckets). The layer's parameters are updated in place;
        draws come from the network's generator."""
        self._check_init()
        updater = self.conf.global_conf.updater
        gen = self.generator()
        for idx, layer in enumerate(self.layers):
            if not getattr(layer, "is_pretrain_layer", lambda: False)():
                continue
            lp = self._params[self._keys[idx]]
            upd_state = updater.init(lp)
            it = 0
            for _ in range(max(1, epochs)):
                for ds in _pipe.iter_datasets(data, None):
                    (x,) = self._place((ds.features,))
                    with torch.no_grad():
                        feats = self._below(idx, x)
                    p = {k: t.detach().requires_grad_(True)
                         for k, t in lp.items()}
                    with torch.enable_grad():
                        loss = layer.pretrain_loss(p, feats, gen)
                        grads = dict(zip(p, torch.autograd.grad(
                            loss, list(p.values()))))
                    with torch.no_grad():
                        new_lp, upd_state = apply_updater(
                            updater, grads, upd_state, lp, it, gen)
                        for k, t in lp.items():
                            t.copy_(new_lp[k])
                    it += 1
                    self._score = loss.detach()
        self._cast_cache = None

    # --- persistence ---------------------------------------------------------
    def save(self, path: str, save_updater: bool = False) -> None:
        """The model zip in the JAX package's format
        (``util/model_serializer.write_model``)."""
        from ..util.model_serializer import write_model

        write_model(self, path, save_updater)

    @staticmethod
    def load(path: str, load_updater: bool = False,
             device=None) -> "MultiLayerNetwork":
        """A network from a model zip (either package's), on ``device``:
        the card unless the caller asks for another."""
        from ..util.model_serializer import restore_multi_layer_network

        return restore_multi_layer_network(path, load_updater, device)

    # --- evaluation ----------------------------------------------------------
    def evaluate(self, data, batch_size: Optional[int] = None):
        from ..eval.evaluation import Evaluation

        ev = Evaluation()
        for ds in _pipe.iter_datasets(data, batch_size):
            out = self.output(ds.features, fmask=ds.features_mask)
            ev.eval(ds.labels, out, ds.labels_mask)
        return ev

    def evaluate_regression(self, data, batch_size: Optional[int] = None):
        from ..eval.evaluation import RegressionEvaluation

        ev = RegressionEvaluation()
        for ds in _pipe.iter_datasets(data, batch_size):
            ev.eval(ds.labels, self.output(ds.features))
        return ev


def _named_leaves(tree):
    """``(name, tensor)`` of every leaf of a layer's parameter dict, in
    insertion order, through a wrapper's subtrees."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v)
        else:
            yield k, v


def _detach(carry):
    """A recurrent carry (a tensor or an LSTM's ``(h, c)``) detached."""
    if isinstance(carry, tuple):
        return tuple(c.detach() for c in carry)
    return carry.detach()


def _keep_carry(ok, new, old):
    """A recurrent carry where ``ok`` (a device boolean), else ``old``."""
    if isinstance(new, tuple):
        return tuple(torch.where(ok, n, o) for n, o in zip(new, old))
    return torch.where(ok, new, old)


def _fold_weights(mask, w):
    """The example weights ``w`` ``[B]`` folded into an optional loss
    mask: pad rows carry 0, so their loss terms are exactly 0."""
    if mask is None:
        return w
    wb = w
    while wb.ndim < mask.ndim:
        wb = wb[..., None]
    return mask * wb
