"""SameDiff: a symbolic graph of registered ops, run eagerly on one device.

Counterpart of ``deeplearning4j_tpu/autodiff/samediff.py`` (reference
nd4j-api ``org.nd4j.autodiff.samediff.{SameDiff, SDVariable}``). The graph
is the same: variables (trainable), placeholders (fed per call), constants
and op outputs, and nodes that name a registered op (``ops/registry.py``)
with its inputs and static kwargs. Running it differs:

- The JAX package traces the whole graph into one ``jax.jit`` module. Here
  ``output`` walks the needed nodes in topological order, calling each op
  on tensors (under ``torch.inference_mode()``), and drops each
  intermediate after its last use.
- Gradients are autograd over the same walk (``calculate_gradients``, and
  the training step, as ``jax.grad`` of the traced function).
- The training step is the JAX step (``_train_step_fn``): the loss summed,
  the L2 and L1 terms, ``grad_clip_value``, then ``updater.apply`` leaf by
  leaf. The updater is the port's (``learning/updaters``), given the flat
  ``{name: tensor}`` tree under one key. No fused kernel: the JAX SameDiff
  step has none either.
- Values stay on ``sd.device``: variables and constants are uploaded once
  (when created or imported), a step replaces the variables' tensors on the
  device, and nothing is copied back to the host after ``fit`` (the JAX
  package re-uploads its numpy parameters on every call and writes them
  back after every fit).

``save``/``load`` write and read the JAX package's zip (``graph.json``,
``vars.npz``, ``updater.npz``, format version 2) with ``TrainingConfig``'s
JSON, so a graph saved by one package loads in the other, every array
bitwise.

The dropout and noise ops (``dropout``, ``alpha_dropout``,
``gaussian_dropout``, ``gaussian_noise``) draw from the graph's generator on
its device in training (``fit``, ``output(training=True)``) and are the
identity outside it, as the JAX SameDiff passes them a fresh key or skips
them. The registry's ``random`` ops draw from the same generator in every
call, where the JAX SameDiff splits a fresh key for each.

Structured control flow (reference ``SameDiff.ifCond``/``whileLoop``) is
the JAX SameDiff's: each branch, condition and body is a nested SameDiff
whose placeholders are its operands, saved as the node's ``control`` entry
of ``graph.json``. Where the JAX package lowers them to ``lax.cond``,
``lax.while_loop`` and ``lax.scan``, the walk here runs them:

- ``cond`` reads its predicate on the host (one synchronisation a call)
  and runs the taken branch only, so the gradient flows through that branch
  alone (not both under ``torch.where``, whose gradient differs where the
  other branch is not finite).
- ``while_loop`` without ``max_iters`` reads its condition on the host
  each iteration. It is forward-only, as in the JAX package (reverse mode
  has no rule for an unbounded loop): a gradient through it raises the
  ``ValueError`` the JAX package raises, in ``calculate_gradients`` and in
  ``fit``.
- ``while_loop(max_iters=n)`` runs condition and body ``n`` times and
  holds the loop values by ``torch.where`` once the condition has failed:
  differentiable, with no host synchronisation.
- Random ops inside a control node draw from generators of its own, one for
  a ``cond``'s branch and, for a loop, one for the condition and one for the
  body (the JAX lowering's distinct per-iteration streams), seeded from the
  graph's own host generator and made only for a branch that draws; each
  iteration draws afresh.
"""

from __future__ import annotations

import io
import json
import zipfile
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from ..common import xprof
from ..common.dtypes import tensor_from_numpy, torch_dtype
from ..common.environment import resolve_device
from ..learning.updaters import Adam, GradientUpdater
from ..ops.registry import get_op

#: the single node under which the flat ``{name: tensor}`` parameters sit
#: in the port updaters' ``{node: {name: tensor}}`` trees
TREE = "samediff"
#: the JAX package's SameDiff file format
_FORMAT_VERSION = 2


class VariableType:
    VARIABLE = "VARIABLE"        # trainable
    PLACEHOLDER = "PLACEHOLDER"  # fed per call
    CONSTANT = "CONSTANT"
    ARRAY = "ARRAY"              # op output


@dataclass
class _Var:
    name: str
    vtype: str
    shape: Optional[Tuple[Optional[int], ...]] = None
    dtype: str = "float32"
    value: Optional[torch.Tensor] = None    # on the device: VARIABLE/CONSTANT
    producer: Optional[int] = None          # node id for ARRAY vars
    out_index: int = 0


@dataclass
class _Node:
    id: int
    op_name: str
    inputs: List[str]
    kwargs: Dict[str, Any]
    outputs: List[str]
    n_outputs: int = 1
    # Mixed positional spec: [("v", var_name) | ("s", static_value)]. Static
    # entries (shape tuples, axis ints) stay Python values.
    arg_spec: List[Tuple[str, Any]] = field(default_factory=list)
    # Structured control flow (op_name "__cond__"/"__while__"): nested
    # graphs by tag ("true"/"false" or "cond"/"body"), their placeholder
    # and output names, and the bounded loop's length
    subgraphs: Optional[Dict[str, "SameDiff"]] = None
    sub_inputs: Optional[Dict[str, List[str]]] = None
    sub_outputs: Optional[Dict[str, List[str]]] = None
    max_iters: Optional[int] = None


#: the outputs of the registry's multi-output ops, where the caller does
#: not say (the JAX SameDiff's table)
_N_OUTPUTS = {
    "moments": 2, "lstm_layer": 2, "gru_layer": 2, "simple_rnn_layer": 2,
    "sru_layer": 2, "lstm_cell": 2, "qr": 2, "svd": 3, "lu": 2,
    "log_matrix_determinant": 2, "self_adjoint_eig": 2, "top_k": 2,
    "unique": 2, "normalize_moments": 2, "sufficient_statistics": 4,
}
#: ops that draw in training and pass their input through outside it
_TRAIN_ONLY = frozenset({"dropout", "alpha_dropout", "gaussian_dropout",
                         "gaussian_noise"})
#: the control-flow nodes' op names
_CONTROL = frozenset({"__cond__", "__while__"})


def _upload(value, device: torch.device) -> torch.Tensor:
    """An array or tensor as a tensor on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(device)
    return tensor_from_numpy(value, device)


class SDVariable:
    """Symbolic handle into a SameDiff graph (reference SDVariable)."""

    def __init__(self, sd: "SameDiff", name: str):
        self.sd = sd
        self.name = name

    # --- metadata ------------------------------------------------------
    @property
    def shape(self):
        return self.sd._vars[self.name].shape

    def var_type(self) -> str:
        return self.sd._vars[self.name].vtype

    # --- evaluation ----------------------------------------------------
    def eval(self, placeholders: Optional[Dict[str, Any]] = None
             ) -> torch.Tensor:
        return self.sd.output(placeholders or {}, [self.name])[self.name]

    def arr(self) -> Optional[torch.Tensor]:
        return self.sd._vars[self.name].value

    # --- graph-building operators --------------------------------------
    def _bin(self, op: str, other, reverse: bool = False):
        other_v = self.sd._lift(other)
        a, b = (other_v, self) if reverse else (self, other_v)
        return self.sd._add_op(op, [a, b])

    def __add__(self, o):
        return self._bin("add", o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin("subtract", o)

    def __rsub__(self, o):
        return self._bin("subtract", o, reverse=True)

    def __mul__(self, o):
        return self._bin("multiply", o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin("divide", o)

    def __rtruediv__(self, o):
        return self._bin("divide", o, reverse=True)

    def __pow__(self, o):
        return self._bin("pow", o)

    def __neg__(self):
        return self.sd._add_op("neg", [self])

    def __matmul__(self, o):
        return self._bin("matmul", o)

    # common math sugar (sd.math covers everything; these are convenience)
    def add(self, o):
        return self.__add__(o)

    def sub(self, o):
        return self.__sub__(o)

    def mul(self, o):
        return self.__mul__(o)

    def div(self, o):
        return self.__truediv__(o)

    def rsub(self, o):
        return self.__rsub__(o)

    def rdiv(self, o):
        return self.__rtruediv__(o)

    def mmul(self, o):
        return self.__matmul__(o)

    def dot(self, o):
        return self.sd._add_op("dot", [self, self.sd._lift(o)])

    def sum(self, *dims, keep_dims: bool = False):
        return self.sd._add_op("reduce_sum", [self],
                               dims=dims if dims else None,
                               keep_dims=keep_dims)

    def mean(self, *dims, keep_dims: bool = False):
        return self.sd._add_op("reduce_mean", [self],
                               dims=dims if dims else None,
                               keep_dims=keep_dims)

    def max(self, *dims, keep_dims: bool = False):
        return self.sd._add_op("reduce_max", [self],
                               dims=dims if dims else None,
                               keep_dims=keep_dims)

    def min(self, *dims, keep_dims: bool = False):
        return self.sd._add_op("reduce_min", [self],
                               dims=dims if dims else None,
                               keep_dims=keep_dims)

    def std(self, *dims, bias_corrected: bool = True):
        return self.sd._add_op("reduce_stdev", [self],
                               dims=dims if dims else None,
                               bias_corrected=bias_corrected)

    def norm2(self, *dims):
        return self.sd._add_op("reduce_norm2", [self],
                               dims=dims if dims else None)

    def argmax(self, dim: int = -1):
        return self.sd._add_op("argmax", [self], dims=dim)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self.sd._add_op("reshape", [self], shape=shape)

    def permute(self, *dims):
        return self.sd._add_op("permute", [self], dims=dims)

    def transpose(self):
        return self.sd._add_op("transpose", [self])

    def rename(self, new_name: str) -> "SDVariable":
        self.sd._rename(self.name, new_name)
        self.name = new_name
        return self

    def __repr__(self):
        v = self.sd._vars[self.name]
        return (f"SDVariable(name={self.name!r}, type={v.vtype}, "
                f"shape={v.shape})")


_ARRAYS = (SDVariable, np.ndarray, torch.Tensor)


class _OpNamespace:
    """sd.math / sd.nn / sd.loss_ops / ... facade: any registered op is
    reachable; the namespace is resolution sugar, not a gate."""

    def __init__(self, sd: "SameDiff"):
        self._sd = sd

    def __getattr__(self, op_name: str):
        if op_name.startswith("_"):
            raise AttributeError(op_name)
        get_op(op_name)  # KeyError (unknown) or NotImplementedError (unported)

        def call(*args, name: Optional[str] = None, **kwargs):
            # lift only tensor-likes into the graph; ints/floats/tuples stay
            # static positionals (axes, shapes)
            mixed = [self._sd._lift(a) if isinstance(a, _ARRAYS) else a
                     for a in args]
            return self._sd._add_op(op_name, mixed, name=name, **kwargs)

        return call


class SameDiff:
    """Graph container (reference SameDiff.java). ``device``: where its
    values live and its ops run; the card unless the caller asks for
    another (``device="cpu"``), and without a card that request is
    required."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._vars: Dict[str, _Var] = {}
        self._nodes: List[_Node] = []
        self._name_counter: Dict[str, int] = {}
        self._plans: Dict[Tuple[str, ...], list] = {}
        self._training_config: Optional["TrainingConfig"] = None
        self._updater_state = None
        self._iteration = 0
        self._epoch = 0
        self._loss_var: Optional[str] = None
        self._generator = torch.Generator().manual_seed(0)
        self._device_generator: Optional[torch.Generator] = None
        self.math = _OpNamespace(self)
        # All namespaces resolve the same registry; aliases for API parity.
        self.nn = self.cnn = self.rnn = self.loss_ops = self.image = self.math
        self.linalg = self.random_ops = self.bitwise = self.math
        self.ops = self.math

    # ------------------------------------------------------------------
    @staticmethod
    def create(device=None) -> "SameDiff":
        return SameDiff(device)

    def _unique(self, base: str) -> str:
        if base not in self._vars:
            return base
        i = self._name_counter.get(base, 0) + 1
        while f"{base}_{i}" in self._vars:
            i += 1
        self._name_counter[base] = i
        return f"{base}_{i}"

    def _rename(self, old: str, new: str) -> None:
        if new in self._vars:
            raise ValueError(f"variable {new!r} already exists")
        v = self._vars.pop(old)
        v.name = new
        self._vars[new] = v
        for n in self._nodes:
            n.inputs = [new if i == old else i for i in n.inputs]
            n.outputs = [new if o == old else o for o in n.outputs]
            n.arg_spec = [("v", new) if (k == "v" and a == old) else (k, a)
                          for k, a in n.arg_spec]
        if self._loss_var == old:
            self._loss_var = new
        self._plans.clear()

    def _store(self, name: str, vtype: str, value) -> None:
        t = _upload(value, self.device)
        self._vars[name] = _Var(name, vtype, tuple(t.shape),
                                str(t.dtype).replace("torch.", ""), t)

    # --- variable creation ---------------------------------------------
    def var(self, name: str, shape: Optional[Sequence[int]] = None,
            init: Union[str, np.ndarray, torch.Tensor, None] = "xavier",
            dtype: str = "float32") -> SDVariable:
        """Trainable variable (reference sd.var). A string ``init`` draws
        from this graph's own generator (seed 0): the JAX package's draws
        come from threefry and cannot be matched."""
        name = self._unique(name)
        if isinstance(init, (np.ndarray, torch.Tensor)):
            value = init
        else:
            if shape is None:
                raise ValueError("var() needs a shape or an initial value")
            value = _initialize(tuple(shape), init or "zeros", dtype,
                                self._generator)
        self._store(name, VariableType.VARIABLE, value)
        self._plans.clear()
        return SDVariable(self, name)

    def placeholder(self, name: str,
                    shape: Optional[Sequence[Optional[int]]] = None,
                    dtype: str = "float32") -> SDVariable:
        name = self._unique(name)
        self._vars[name] = _Var(name, VariableType.PLACEHOLDER,
                                tuple(shape) if shape else None, dtype)
        return SDVariable(self, name)

    # reference API spelling
    placeHolder = placeholder

    def constant(self, name_or_value, value=None) -> SDVariable:
        if value is None:
            name, value = "const", name_or_value
        else:
            name = name_or_value
        name = self._unique(name)
        # bare Python scalars take the framework defaults (float32, int32),
        # as the JAX package pins them against its x64 mode; numpy and
        # torch values keep their dtype
        if type(value) is float:
            value = np.asarray(value, dtype=np.float32)
        elif type(value) is int:
            value = np.asarray(value, dtype=np.int32 if -2**31 <= value < 2**31
                               else np.int64)
        self._store(name, VariableType.CONSTANT, value)
        return SDVariable(self, name)

    def get_variable(self, name: str) -> SDVariable:
        if name not in self._vars:
            raise KeyError(f"no variable {name!r}")
        return SDVariable(self, name)

    def convert_to_variables(self, names: Optional[Sequence[str]] = None,
                             min_size: int = 2) -> List[str]:
        """Promote CONSTANT vars to trainable VARIABLEs (reference
        ``SameDiff.convertToVariables``). Default: all floating-point
        constants with at least ``min_size`` elements (scalars and axis
        vectors stay constant)."""
        promoted = []
        targets = set(names) if names is not None else None
        for n, v in self._vars.items():
            if v.vtype != VariableType.CONSTANT:
                continue
            if targets is not None:
                if n not in targets:
                    continue
            elif v.value.numel() < min_size or \
                    not v.value.is_floating_point():
                continue
            v.vtype = VariableType.VARIABLE
            promoted.append(n)
        self._plans.clear()
        return promoted

    convertToVariables = convert_to_variables

    def variables(self) -> List[str]:
        return [n for n, v in self._vars.items()
                if v.vtype == VariableType.VARIABLE]

    def placeholders(self) -> List[str]:
        return [n for n, v in self._vars.items()
                if v.vtype == VariableType.PLACEHOLDER]

    # --- graph building -------------------------------------------------
    def _lift(self, value) -> SDVariable:
        if isinstance(value, SDVariable):
            if value.sd is not self:
                raise ValueError(
                    "SDVariable belongs to a different SameDiff instance")
            return value
        return self.constant(value)

    def _add_op(self, op_name: str, inputs: List[Any],
                name: Optional[str] = None, n_outputs: Optional[int] = None,
                **kwargs) -> Union[SDVariable, Tuple[SDVariable, ...]]:
        get_op(op_name)   # an unported op raises here, naming itself
        nid = len(self._nodes)
        n_out = n_outputs or _N_OUTPUTS.get(op_name, 1)
        out_names = [self._unique(name or op_name if i == 0
                                  else f"{name or op_name}:{i}")
                     for i in range(n_out)]
        arg_spec: List[Tuple[str, Any]] = []
        var_inputs: List[str] = []
        for a in inputs:
            if isinstance(a, SDVariable):
                arg_spec.append(("v", a.name))
                var_inputs.append(a.name)
            else:
                arg_spec.append(("s", a))
        self._nodes.append(_Node(nid, op_name, var_inputs, dict(kwargs),
                                 out_names, n_out, arg_spec))
        for i, out in enumerate(out_names):
            self._vars[out] = _Var(out, VariableType.ARRAY, producer=nid,
                                   out_index=i)
        self._plans.clear()
        outs = tuple(SDVariable(self, o) for o in out_names)
        return outs if n_out > 1 else outs[0]

    # --- structured control flow ----------------------------------------
    def _build_branch(self, fn, n_args: int, tag: str):
        """Trace a branch body into a NESTED SameDiff whose placeholders are
        the branch arguments. Branch bodies see ONLY their operands (pass
        outer variables explicitly)."""
        sub = SameDiff(self.device)
        phs = [sub.placeholder(f"{tag}_arg{i}") for i in range(n_args)]
        out = fn(sub, *phs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            if o.sd is not sub:
                raise ValueError(
                    f"{tag} body must return variables built in its own "
                    "scope (got one from the outer graph)")
        return sub, [p.name for p in phs], [o.name for o in outs]

    def _add_control(self, kind: str, inputs: List[SDVariable], subgraphs,
                     sub_inputs, sub_outputs, n_out: int,
                     name: Optional[str], max_iters: Optional[int] = None):
        nid = len(self._nodes)
        base = name or kind.strip("_")
        out_names = [self._unique(base if i == 0 else f"{base}:{i}")
                     for i in range(n_out)]
        self._nodes.append(_Node(
            nid, kind, [v.name for v in inputs], {}, out_names, n_out,
            [("v", v.name) for v in inputs], subgraphs=subgraphs,
            sub_inputs=sub_inputs, sub_outputs=sub_outputs,
            max_iters=max_iters))
        for i, out in enumerate(out_names):
            self._vars[out] = _Var(out, VariableType.ARRAY, producer=nid,
                                   out_index=i)
        self._plans.clear()
        outs = tuple(SDVariable(self, o) for o in out_names)
        return outs if n_out > 1 else outs[0]

    def cond(self, pred: SDVariable, true_fn, false_fn,
             *operands: SDVariable, name: Optional[str] = None):
        """``true_fn(sub_sd, *args)`` / ``false_fn(sub_sd, *args)`` build
        their result from the operands; both return the same number of
        outputs. Only the taken branch runs; differentiable through it."""
        pred = self._lift(pred)
        ops = [self._lift(o) for o in operands]
        sub_t, in_t, out_t = self._build_branch(true_fn, len(ops), "true")
        sub_f, in_f, out_f = self._build_branch(false_fn, len(ops), "false")
        if len(out_t) != len(out_f):
            raise ValueError(
                f"branches return different arity: {len(out_t)} vs "
                f"{len(out_f)}")
        return self._add_control(
            "__cond__", [pred] + ops, {"true": sub_t, "false": sub_f},
            {"true": in_t, "false": in_f}, {"true": out_t, "false": out_f},
            len(out_t), name)

    ifCond = cond

    def while_loop(self, cond_fn, body_fn, *loop_vars: SDVariable,
                   max_iters: Optional[int] = None,
                   name: Optional[str] = None):
        """``cond_fn(sub_sd, *vars) -> scalar bool``; ``body_fn(sub_sd,
        *vars)`` returns the updated loop vars (same arity). Unbounded
        loops are forward-only; ``max_iters`` makes a fixed-length masked
        loop, which is differentiable."""
        ops = [self._lift(v) for v in loop_vars]
        sub_c, in_c, out_c = self._build_branch(cond_fn, len(ops), "cond")
        if len(out_c) != 1:
            raise ValueError("cond_fn must return exactly one scalar")
        sub_b, in_b, out_b = self._build_branch(body_fn, len(ops), "body")
        if len(out_b) != len(ops):
            raise ValueError(
                f"body_fn must return {len(ops)} loop vars, got {len(out_b)}")
        return self._add_control(
            "__while__", ops, {"cond": sub_c, "body": sub_b},
            {"cond": in_c, "body": in_b}, {"cond": out_c, "body": out_b},
            len(ops), name, max_iters=max_iters)

    whileLoop = while_loop

    def _sub_generator(self, sub: "SameDiff", outs: Tuple[str, ...],
                       training: bool) -> Optional[torch.Generator]:
        """A generator on the graph's device for one stream of a control
        node, seeded from the graph's own host generator (no
        synchronisation); None when the branch draws nothing."""
        if not any(kind == "random" or (training and kind == "train_only")
                   for _, _, _, kind in sub._plan(outs)):
            return None
        seed = int(torch.randint(0, 2 ** 62, (1,),
                                 generator=self._generator))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _lower_control(self, node: _Node, args: List[torch.Tensor],
                       training: bool) -> Tuple[torch.Tensor, ...]:
        def branch(tag: str):
            sub = node.subgraphs[tag]
            names = node.sub_inputs[tag]
            outs = tuple(node.sub_outputs[tag])
            gen = self._sub_generator(sub, outs, training)

            def run(vs):
                return sub._run(outs, dict(zip(names, vs)),
                                training=training, generator=gen)

            return run

        def scalar(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(()).to(torch.bool)

        if node.op_name == "__cond__":
            # the predicate on the host: one synchronisation a call
            taken = "true" if bool(scalar(args[0])) else "false"
            return branch(taken)(tuple(args[1:]))
        cond_run = branch("cond")
        body_run = branch("body")
        vs = tuple(args)
        if node.max_iters is None:
            if torch.is_grad_enabled() and any(v.requires_grad for v in vs):
                raise ValueError(
                    "Reverse-mode differentiation does not work for an "
                    "unbounded while_loop; pass max_iters to make it a "
                    "fixed-length masked loop")
            while bool(scalar(cond_run(vs)[0])):
                vs = body_run(vs)
            return vs
        for _ in range(int(node.max_iters)):
            go = scalar(cond_run(vs)[0])
            new = body_run(vs)
            vs = tuple(torch.where(go, nv, v) for v, nv in zip(vs, new))
        return vs

    # --- running the graph ------------------------------------------------
    def _topo_for(self, outputs: Sequence[str]) -> List[_Node]:
        needed: List[_Node] = []
        seen = set()
        for out in outputs:
            if out not in self._vars:
                raise KeyError(f"unknown variable {out!r}")
            # iterative post-order (deep graphs would exhaust recursion)
            stack = [(out, False)]
            while stack:
                name, expanded = stack.pop()
                v = self._vars.get(name)
                if v is None:
                    raise KeyError(f"unknown variable {name!r}")
                if v.producer is None:
                    continue
                if expanded:
                    if v.producer not in seen:
                        seen.add(v.producer)
                        needed.append(self._nodes[v.producer])
                    continue
                if v.producer in seen:
                    continue
                stack.append((name, True))
                for i in reversed(self._nodes[v.producer].inputs):
                    stack.append((i, False))
        return needed

    def _plan(self, outputs: Tuple[str, ...]) -> list:
        """The walk for ``outputs``: (op function, node, names to drop after
        it) per needed node; cached until the graph changes."""
        plan = self._plans.get(outputs)
        if plan is None:
            nodes = self._topo_for(outputs)
            last: Dict[str, int] = {}
            for step, node in enumerate(nodes):
                for name in node.inputs:
                    if self._vars[name].vtype == VariableType.ARRAY:
                        last[name] = step
            drops: List[List[str]] = [[] for _ in nodes]
            for name, step in last.items():
                if name not in outputs:
                    drops[step].append(name)
            plan = []
            for n, d in zip(nodes, drops):
                if n.op_name in _CONTROL:
                    plan.append((None, n, d, "control"))
                    continue
                desc = get_op(n.op_name)
                kind = ("random" if desc.family == "random" else
                        "train_only" if n.op_name in _TRAIN_ONLY else "op")
                plan.append((desc.fn, n, d, kind))
            self._plans[outputs] = plan
        return plan

    def _feeds(self, placeholders: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        feeds = {}
        for k, v in placeholders.items():
            if k not in self._vars:
                raise KeyError(f"no placeholder {k!r}")
            feeds[k] = v.to(self.device) if isinstance(v, torch.Tensor) \
                else _upload(v, self.device)
        return feeds

    def _rng(self) -> torch.Generator:
        """The generator the dropout and noise ops draw from, on the graph's
        device (seed 0, made at the first draw)."""
        if self._device_generator is None:
            self._device_generator = torch.Generator(
                device=self.device).manual_seed(0)
        return self._device_generator

    def _run(self, outputs: Tuple[str, ...], feeds: Dict[str, torch.Tensor],
             params: Optional[Dict[str, torch.Tensor]] = None,
             training: bool = False,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, ...]:
        """Walk the nodes ``outputs`` need. ``params`` overrides the stored
        variable values (the leaves autograd differentiates). Outside
        ``training`` the dropout and noise ops pass their input through.
        ``generator``: the random and noise ops' (default the graph's)."""
        env: Dict[str, torch.Tensor] = dict(feeds)
        if params:
            env.update(params)
        store = self._vars

        def value(name: str) -> torch.Tensor:
            t = env.get(name)
            if t is None:
                t = store[name].value
                if t is None:
                    raise ValueError(
                        f"placeholder {name!r} was not fed" if
                        store[name].vtype == VariableType.PLACEHOLDER else
                        f"variable {name!r} has no value")
            return t

        for fn, node, drops, kind in self._plan(outputs):
            args = [value(a) if k == "v" else a for k, a in node.arg_spec]
            if kind == "op":
                res = fn(*args, **node.kwargs)
            elif kind == "control":
                res = self._lower_control(node, args, training)
                if node.n_outputs == 1:
                    res = res[0]
            elif kind == "random":
                res = fn(generator or self._rng(), *args, **node.kwargs)
            elif training:
                res = fn(args[0], generator or self._rng(), *args[1:],
                         **node.kwargs)
            else:
                res = args[0]
            if node.n_outputs > 1:
                for out_name, r in zip(node.outputs, res):
                    env[out_name] = r
            else:
                env[node.outputs[0]] = res
            for name in drops:
                env.pop(name, None)
        return tuple(value(o) for o in outputs)

    def output(self, placeholders: Dict[str, Any], outputs: Sequence[str],
               training: bool = False) -> Dict[str, torch.Tensor]:
        """Reference sd.output(map, names): run the graph for ``outputs``;
        ``training`` turns the dropout and noise ops on."""
        outputs = tuple(outputs)
        # one census wrapper per (outputs, training): the JAX jit cache key
        run = xprof.censused(
            self, "samediff/exec",
            lambda feeds: self._run(outputs, feeds, training=training),
            key=(outputs, training))
        with torch.inference_mode():
            res = run(self._feeds(placeholders))
        return dict(zip(outputs, res))



    def batch_output(self, placeholders=None, outputs=None):
        return self.output(placeholders or {}, outputs or [])

    # --- autodiff --------------------------------------------------------
    def calculate_gradients(self, placeholders: Dict[str, Any], loss: str,
                            wrt: Optional[Sequence[str]] = None
                            ) -> Dict[str, torch.Tensor]:
        """Gradient of ``sum(loss)`` with respect to ``wrt`` (default every
        trainable variable), by autograd over the walk (reference
        sd.calculateGradients)."""
        wrt = tuple(wrt) if wrt is not None else tuple(self.variables())
        grad = xprof.censused(
            self, "samediff/grad",
            lambda feeds: self._gradients(feeds, loss, wrt), key=(loss, wrt))
        return grad(self._feeds(placeholders))

    def _gradients(self, feeds, loss: str, wrt: Tuple[str, ...]
                   ) -> Dict[str, torch.Tensor]:
        leaves = {n: self._vars[n].value.detach().requires_grad_(True)
                  for n in wrt}
        with torch.enable_grad():
            out = self._run((loss,), feeds, leaves)[0]
            grads = torch.autograd.grad(torch.sum(out), list(leaves.values()),
                                        allow_unused=True)
        return {n: torch.zeros_like(leaves[n]) if g is None else g
                for n, g in zip(wrt, grads)}

    def grad(self, var_name: str, loss: Optional[str] = None) -> torch.Tensor:
        loss = loss or self._require_loss()
        return self.calculate_gradients({}, loss, [var_name])[var_name]

    def _require_loss(self) -> str:
        if self._loss_var is None:
            raise ValueError("no loss variable set; call set_loss_variables "
                             "or pass loss=")
        return self._loss_var

    def set_loss_variables(self, *names: str) -> None:
        self._loss_var = names[0]

    setLossVariables = set_loss_variables

    # --- training --------------------------------------------------------
    def set_training_config(self, config: "TrainingConfig") -> None:
        self._training_config = config
        self._updater_state = None

    setTrainingConfig = set_training_config

    def _params(self) -> Dict[str, torch.Tensor]:
        return {n: v.value for n, v in self._vars.items()
                if v.vtype == VariableType.VARIABLE}

    def _train_step_fn(self, loss_name: str):
        """One step: forward and backward over the walk, the regularization
        terms, gradient clipping and the updater, as the JAX step computes
        them. ``step(params, upd_state, feeds, iteration) -> (new_params,
        new_state, loss)``; the tensors of ``params`` are not changed."""
        tc = self._training_config
        updater, l1, l2, clip = tc.updater, tc.l1, tc.l2, tc.grad_clip_value

        def step(params, upd_state, feeds, iteration):
            leaves = {n: p.detach().requires_grad_(True)
                      for n, p in params.items()}
            with torch.enable_grad():
                loss = torch.sum(self._run((loss_name,), feeds, leaves,
                                           training=True)[0])
                reg = 0.0
                if l2:
                    # DL4J L2: score += 0.5*l2*||w||^2 (grad = l2*w)
                    reg = reg + 0.5 * l2 * sum(torch.sum(torch.square(w))
                                               for w in leaves.values())
                if l1:
                    reg = reg + l1 * sum(torch.sum(torch.abs(w))
                                         for w in leaves.values())
                total = loss + reg
                grads = torch.autograd.grad(total, list(leaves.values()),
                                            allow_unused=True)
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(params.items(), grads)}
            if clip:
                grads = {n: torch.clamp(g, -clip, clip)
                         for n, g in grads.items()}
            new_params, new_state = updater.apply(
                {TREE: grads}, upd_state, {TREE: dict(params)}, iteration)
            return new_params[TREE], new_state, total.detach()

        return step

    def fit(self, data=None, epochs: int = 1, batch_size: Optional[int] = None,
            feature_placeholder: Optional[str] = None,
            label_placeholder: Optional[str] = None,
            listeners: Optional[List] = None) -> "History":
        """Train against dict batches ``{placeholder: array}`` (one, or a
        list), a DataSet, a DataSetIterator or a ``(features, labels)``
        tuple. With exactly two placeholders and non-dict data, the first
        is the features and the second the labels unless named."""
        from .history import History

        if self._training_config is None:
            raise ValueError("call set_training_config first")
        loss_name = self._training_config.loss_name or self._require_loss()
        phs = self.placeholders()
        dict_batches = isinstance(data, dict) or (
            isinstance(data, list) and data and isinstance(data[0], dict))
        if feature_placeholder is None and label_placeholder is None:
            if dict_batches:
                pass  # batches carry their own {placeholder: array} binding
            elif len(phs) == 2:
                feature_placeholder, label_placeholder = phs[0], phs[1]
            elif len(phs) == 1:
                feature_placeholder = phs[0]
            else:
                raise ValueError("ambiguous placeholders; name them "
                                 "explicitly or feed dict batches "
                                 "{placeholder: array}")
        elif feature_placeholder is None:
            remaining = [p for p in phs if p != label_placeholder]
            if len(remaining) != 1:
                raise ValueError("ambiguous feature placeholder; name it "
                                 "explicitly")
            feature_placeholder = remaining[0]

        params = self._params()
        if self._updater_state is None:
            self._updater_state = self._training_config.updater.init(
                {TREE: params})
        step = xprof.register_jit("samediff/fit_step",
                                  self._train_step_fn(loss_name))
        history = History()
        listeners = listeners or []
        for _ in range(epochs):
            loss_sum, n_batches = None, 0
            for ds in _iter_batches(data, batch_size):
                if isinstance(ds, dict):
                    feeds = self._feeds(ds)
                else:
                    feeds = self._feeds({feature_placeholder: ds.features})
                    if label_placeholder is not None and \
                            ds.labels is not None:
                        feeds.update(self._feeds({label_placeholder:
                                                  ds.labels}))
                params, self._updater_state, loss = step(
                    params, self._updater_state, feeds, self._iteration)
                # the graph holds the new values at once: a listener (or
                # an exception in the next step) sees the current state
                for n, t in params.items():
                    self._vars[n].value = t
                self._iteration += 1
                # one host sync per epoch: the losses add up on the device
                loss_sum = loss if loss_sum is None else loss_sum + loss
                n_batches += 1
                for lst in listeners:
                    lst.iteration_done(self, self._iteration, loss)
            self._epoch += 1
            if loss_sum is None:
                raise ValueError(
                    "training data yielded no batches this epoch (exhausted "
                    "iterator or empty dataset)")
            history.add_epoch(self._epoch, float(loss_sum) / n_batches)
            for lst in listeners:
                if hasattr(lst, "epoch_done"):
                    lst.epoch_done(self, self._epoch)
        return history

    # --- serialization ---------------------------------------------------
    def save(self, path: str, save_updater: bool = False,
             save_updater_state: bool = False) -> None:
        """The JAX package's zip: ``graph.json`` (variables, nodes, the loss
        variable, iteration, epoch, the training configuration),
        ``vars.npz`` (every variable and constant value by name) and, with
        ``save_updater`` (or its SameDiff spelling ``save_updater_state``),
        ``updater.npz`` (the updater state's leaves in ``jax.tree.flatten``
        order)."""
        from ..util.model_serializer import savez_leaves, tree_leaves

        arrays: Dict[str, np.ndarray] = {}
        graph = self._graph_dict(arrays, "")
        graph.update({
            "loss_var": self._loss_var,
            "iteration": self._iteration,
            "epoch": self._epoch,
            "training_config": (self._training_config.to_json()
                                if self._training_config else None),
        })
        # stored, not deflated (float values do not compress; the JAX
        # package deflates, and either package reads either)
        with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
            zf.writestr("graph.json", json.dumps(graph))
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            zf.writestr("vars.npz", buf.getvalue())
            if (save_updater or save_updater_state) \
                    and self._updater_state is not None:
                zf.writestr("updater.npz",
                            savez_leaves(tree_leaves(self._updater_state)))

    def _graph_dict(self, arrays: Dict[str, np.ndarray],
                    prefix: str) -> Dict[str, Any]:
        """The JSON graph structure, the values collected into ``arrays``
        under ``prefix`` (a control node's graphs under
        ``<prefix>n<id>.<tag>/``, so one npz holds every scope's values)."""
        for n, v in self._vars.items():
            if v.value is not None:
                if v.value.dtype == torch.bfloat16:
                    raise ValueError(f"variable {n!r} is bfloat16, which the "
                                     f"SameDiff file format cannot hold")
                arrays[prefix + n] = v.value.detach().cpu().numpy()
        nodes = []
        for n in self._nodes:
            d = {"id": n.id, "op": n.op_name, "inputs": n.inputs,
                 "kwargs": _jsonify(n.kwargs), "outputs": n.outputs,
                 "n_outputs": n.n_outputs,
                 "arg_spec": None if n.subgraphs is not None else
                 [[k, _jsonify({"v": v})["v"]] for k, v in n.arg_spec]}
            if n.subgraphs is not None:
                d["control"] = {
                    "max_iters": n.max_iters,
                    "sub_inputs": n.sub_inputs,
                    "sub_outputs": n.sub_outputs,
                    "branches": {
                        tag: sub._graph_dict(arrays,
                                             f"{prefix}n{n.id}.{tag}/")
                        for tag, sub in n.subgraphs.items()}}
            nodes.append(d)
        return {
            "format_version": _FORMAT_VERSION,
            "variables": [
                {"name": v.name, "type": v.vtype, "shape": v.shape,
                 "dtype": v.dtype, "producer": v.producer,
                 "out_index": v.out_index}
                for v in self._vars.values()],
            "nodes": nodes,
        }

    @staticmethod
    def _from_graph_dict(graph: Dict[str, Any], arrays, prefix: str,
                         device) -> "SameDiff":
        sd = SameDiff(device)
        for v in graph["variables"]:
            key = prefix + v["name"]
            value = arrays[key] if key in arrays.files else None
            sd._vars[v["name"]] = _Var(
                v["name"], v["type"],
                tuple(v["shape"]) if v["shape"] else None, v["dtype"],
                None if value is None else _upload(value, sd.device),
                v["producer"], v["out_index"])
        for n in graph["nodes"]:
            ctl = n.get("control")
            if ctl is None:
                get_op(n["op"])     # an unknown op raises here by name
            spec = n.get("arg_spec")
            spec = ([(k, tuple(a) if isinstance(a, list) and k == "s"
                      else a) for k, a in spec] if spec is not None
                    else [("v", i) for i in n["inputs"]])
            node = _Node(n["id"], n["op"], n["inputs"], n["kwargs"],
                         n["outputs"], n["n_outputs"], spec)
            if ctl is not None:
                node.max_iters = ctl.get("max_iters")
                node.sub_inputs = ctl["sub_inputs"]
                node.sub_outputs = ctl["sub_outputs"]
                node.subgraphs = {
                    tag: SameDiff._from_graph_dict(
                        sub, arrays, f"{prefix}n{n['id']}.{tag}/", device)
                    for tag, sub in ctl["branches"].items()}
            sd._nodes.append(node)
        return sd

    @staticmethod
    def load(path: str, device=None) -> "SameDiff":
        """A graph from :meth:`save`'s zip (either package's), its values on
        ``device``: the card unless the caller asks for another."""
        from ..util.model_serializer import load_leaves, tree_leaves

        with zipfile.ZipFile(path) as zf:
            graph = json.loads(zf.read("graph.json"))
            if graph["format_version"] > _FORMAT_VERSION:
                raise ValueError("file written by a newer format version")
            arrays = np.load(io.BytesIO(zf.read("vars.npz")))
            sd = SameDiff._from_graph_dict(graph, arrays, "", device)
            sd._loss_var = graph.get("loss_var")
            sd._iteration = graph.get("iteration", 0)
            sd._epoch = graph.get("epoch", 0)
            tc = graph.get("training_config")
            if tc:
                sd._training_config = TrainingConfig.from_json(tc)
            if "updater.npz" in zf.namelist() \
                    and sd._training_config is not None:
                params = {n: t.to("meta") for n, t in sd._params().items()}
                template = sd._training_config.updater.init({TREE: params})
                want = tree_leaves(template)
                got = load_leaves(zf.read("updater.npz"), "updater state",
                                  len(want))
                it = iter(t.to(sd.device) for t in got)
                sd._updater_state = {
                    slot: {TREE: {k: next(it) for k in sorted(d[TREE])}}
                    for slot, d in sorted(template.items())}
        return sd

    def summary(self) -> str:
        lines = [f"SameDiff: {len(self._vars)} vars, {len(self._nodes)} ops"]
        for v in self._vars.values():
            if v.vtype != VariableType.ARRAY:
                lines.append(f"  {v.vtype:<12} {v.name:<24} {v.shape}")
        for n in self._nodes:
            lines.append(f"  op#{n.id:<4} {n.op_name:<24} {n.inputs} -> "
                         f"{n.outputs}")
        return "\n".join(lines)


@dataclass
class TrainingConfig:
    """Reference org.nd4j.autodiff.samediff.TrainingConfig."""

    updater: GradientUpdater = field(default_factory=Adam)
    l1: float = 0.0
    l2: float = 0.0
    loss_name: Optional[str] = None
    grad_clip_value: Optional[float] = None

    def to_json(self) -> Dict[str, Any]:
        """The JAX package's dict: the updater's class name and its scalar
        fields (a schedule as ``{"__schedule__", "config"}``)."""
        import dataclasses

        from ..learning.schedules import ISchedule

        cfg = {}
        for k, v in self.updater.__dict__.items():
            if isinstance(v, ISchedule):
                cfg[k] = {"__schedule__": type(v).__name__,
                          "config": dataclasses.asdict(v)}
            elif isinstance(v, (int, float, str, bool)):
                cfg[k] = v
        return {"updater": type(self.updater).__name__,
                "updater_config": cfg, "l1": self.l1, "l2": self.l2,
                "loss_name": self.loss_name,
                "grad_clip_value": self.grad_clip_value}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "TrainingConfig":
        from ..learning import schedules as _sched
        from ..learning.updaters import _BY_NAME

        cfg = {}
        for k, v in d.get("updater_config", {}).items():
            if isinstance(v, dict) and "__schedule__" in v:
                cfg[k] = getattr(_sched, v["__schedule__"])(**v["config"])
            else:
                cfg[k] = v
        return TrainingConfig(
            updater=_BY_NAME[d["updater"].lower()](**cfg),
            l1=d.get("l1", 0.0), l2=d.get("l2", 0.0),
            loss_name=d.get("loss_name"),
            grad_clip_value=d.get("grad_clip_value"))


def _jsonify(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Static op arguments as JSON values (tuples as lists, arrays as
    nested lists), as the JAX package writes them."""
    out = {}
    for k, v in kwargs.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            out[k] = np.asarray(v.cpu() if isinstance(v, torch.Tensor)
                                else v).tolist()
        elif isinstance(v, tuple):
            out[k] = list(v)
        else:
            out[k] = v
    return out


def _initialize(shape: Tuple[int, ...], init: str, dtype: str,
                generator: torch.Generator) -> torch.Tensor:
    dt = torch_dtype(dtype)
    init = init.lower()
    if init == "zeros":
        return torch.zeros(shape, dtype=dt)
    if init == "ones":
        return torch.ones(shape, dtype=dt)
    fan_in = shape[0] if shape else 1
    fan_out = shape[-1] if len(shape) > 1 else 1
    if init == "xavier":
        std = float(np.sqrt(2.0 / (fan_in + fan_out)))
    elif init in ("relu", "he"):
        std = float(np.sqrt(2.0 / fan_in))
    elif init == "normal":
        std = 1.0
    elif init == "uniform":
        lim = float(np.sqrt(1.0 / fan_in))
        return (torch.rand(shape, generator=generator) * (2 * lim)
                - lim).to(dt)
    else:
        raise ValueError(f"unknown initializer {init!r}")
    return (torch.randn(shape, generator=generator) * std).to(dt)


def _iter_batches(data, batch_size):
    """Accept dict batches, a DataSetIterator-like, a DataSet, or a
    (features, labels) tuple."""
    from ..data.dataset import DataSet

    if isinstance(data, dict):
        yield data  # one multi-input batch: {placeholder_name: array}
        return
    if isinstance(data, list) and data and isinstance(data[0], dict):
        yield from data
        return
    if hasattr(data, "reset") and hasattr(data, "__iter__"):
        data.reset()
        yield from data
        return
    if isinstance(data, DataSet):
        if batch_size is None:
            yield data
        else:
            yield from data.batch_by(batch_size)
        return
    if isinstance(data, tuple) and len(data) == 2:
        yield from _iter_batches(DataSet(data[0], data[1]), batch_size)
        return
    raise TypeError(f"cannot iterate training data of type {type(data)}")
