"""Fleet training: M same-architecture members trained as one population.

Counterpart of ``deeplearning4j_tpu/parallel/fleet.py``: per-user fine-tunes,
hyperparameter sweeps (:meth:`FleetTrainer.from_sweep`) and RL populations
(``rl/population.py``), whose parameters, updater state and random streams
carry a leading member axis. The JAX fleet vmaps the solo step core under
one ``jit``; here the member axis lives in the buckets:

- **Stacked state.** Per dtype bucket of the solo flat layout
  (``parallel/sharding.Zero1Plan``) there is ONE contiguous ``[M, N]``
  tensor of parameters, one of gradients and one per updater moment. Member
  m's layers read views of row m, as the solo ``nn/_fused.FlatStore`` does
  with its one bucket. Each member has its own ``torch.Generator``.
- **The step.** Each live member's forward, loss and backward run in turn
  through the solo code (``MultiLayerNetwork._grad_core``) on row m's
  views, into row m of the gradient bucket; then ONE member-batched
  ``fused_update`` launch per bucket updates every row
  (``ops/update.fused_apply_members``), each row with its own learning rate
  (the sweep's, a float32 ``[M]`` on the device) under an int32 ``[M]``
  live mask. Without ``fused_update`` each member's update runs through the
  per-leaf updater instead. Member k is bitwise its solo twin
  (:meth:`FleetTrainer.solo_twin`): the same init, the same stream, the
  same operations.
- **Shape-stable lifecycle.** After the first step no ``step``, ``cull``,
  ``spawn`` or NaN cull reallocates a stacked buffer: ``spawn`` writes the
  slice in place and the masks are written in place.
  ``trace/fleet_step`` counts the buffers' build, once per fleet. The
  step and the inference run under the executable census
  (``common/xprof.py``) as ``fleet/step`` and ``fleet/infer``.
- **Per-member NaN isolation without a host sync.** With a
  ``NanSentinelListener("skip")`` each member's non-finite evidence (its
  gradient row and its loss) is folded into the live mask on the device: a
  poisoned member's row keeps its parameters and moments bitwise while the
  other M-1 updates land. Under ``"cull"`` its alive bit drops on the device
  too; the host hears of it at the next drain (event ``fleet/nan_cull``).
  The JAX fleet's alive-freeze ``lax.cond`` (about 2x the stacked state at
  peak) has no counterpart: the kernel leaves a masked row alone.
- **Telemetry, one readback per window.** The per-member aux (``loss``
  ``[M]``, per-layer norms and non-finite counts ``[M, L]``, ``alive``)
  stays on the device; :meth:`FleetTrainer.drain` reads the window back in
  one copy (``telemetry/drain``) and feeds :class:`FleetStatsSink`,
  :class:`FleetEarlyStop` and the NaN-cull reporter.
- **Checkpoints.** :meth:`FleetTrainer.save_member` writes an ordinary solo
  checkpoint (the member's generator included), which a solo
  ``MultiLayerNetwork`` restores and continues bitwise;
  :meth:`FleetTrainer.save`/:meth:`~FleetTrainer.restore` carry the whole
  stacked state plus the fleet extras (alive mask, generator states, hyper,
  member seeds) in ``resume.json``.

Serving handoff: :meth:`FleetTrainer.export_member` gives a solo network,
and ``save_member`` a checkpoint that ``ServingEngine.publish_checkpoint``
canaries onto a live engine.

Host cost: the M member passes are launched one after another from the
host (no ``vmap``: batching the members' convolutions into grouped ones
would pick other cuDNN algorithms than the solo step's, and the bits would
differ). ``last_step_timing`` records their host time.
"""

from __future__ import annotations

import base64
import copy
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..common import flightrec, xprof
from ..common.dtypes import torch_dtype
from ..common.profiler import OpProfiler
from ..common.tree import get_path, leaf_paths, set_path, skeleton, tree_map
from ..data import pipeline as _pipe
from ..learning.precision import apply_updater, state_dtype_of
from ..learning.updaters import with_learning_rate
from ..ops.update import fused_apply_members, supports_fused
from ..optimize import telemetry as _tel
from .sharding import Zero1Plan

logger = logging.getLogger("deeplearning4j_tpu_torch")

#: hyperparameters sweepable per member
SWEEPABLE = ("lr", "l2", "dropout")


class FleetEarlyStop:
    """Per-member early stopping from the telemetry bus: a member whose loss
    has not improved by ``min_delta`` for ``patience`` consecutive trained
    steps is culled (its slice freezes; the rest of the fleet trains on).
    Decisions run at drain boundaries on the batched window readback. A
    ``spawn`` resets the member's history (:meth:`member_spawned`)."""

    wants_telemetry = True

    def __init__(self, patience: int, min_delta: float = 0.0):
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        self.patience = int(patience)
        self.min_delta = float(min_delta)
        self._best: Optional[np.ndarray] = None
        self._stale: Optional[np.ndarray] = None

    def member_spawned(self, member: int) -> None:
        """Forget a re-initialized member's history."""
        if self._best is not None:
            self._best[int(member)] = np.inf
            self._stale[int(member)] = 0

    def decide(self, losses: np.ndarray, alive: np.ndarray) -> List[int]:
        """``losses``: ``[W, M]`` drained window; ``alive``: ``[M]``.
        Returns the alive members whose staleness passed the patience."""
        W, M = losses.shape
        if self._best is None:
            self._best = np.full(M, np.inf)
            self._stale = np.zeros(M, np.int64)
        for w in range(W):
            improved = losses[w] < self._best - self.min_delta
            self._best = np.where(improved, losses[w], self._best)
            self._stale = np.where(improved, 0, self._stale + 1)
        return [m for m in range(M)
                if alive[m] and self._stale[m] > self.patience]

    def state_dict(self) -> Dict[str, Any]:
        return {"best": None if self._best is None else self._best.tolist(),
                "stale": None if self._stale is None
                else self._stale.tolist()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._best = (None if state.get("best") is None
                      else np.asarray(state["best"], np.float64))
        self._stale = (None if state.get("stale") is None
                       else np.asarray(state["stale"], np.int64))


class FleetStatsSink:
    """Drains per-member fleet telemetry into a ``StatsStorage``: per
    drained iteration and member ``fleet/loss/m<i>``, ``fleet/grad_norm/
    m<i>`` (the member's global gradient norm), ``fleet/alive/m<i>`` and,
    when non-zero, ``fleet/nonfinite/m<i>``. It reads nothing from the
    device itself: the trainer hands it the window it read back."""

    wants_telemetry = True

    def __init__(self, storage, session_id: str = ""):
        self.storage = storage
        self.session = session_id

    def fleet_window(self, fleet: "FleetTrainer", iters: Sequence[int],
                     window: List[Dict[str, np.ndarray]]) -> None:
        put = self.storage.put_scalar
        for it, aux in zip(iters, window):
            loss = np.asarray(aux["loss"])
            gnorm = np.sqrt(np.sum(np.square(np.asarray(aux["grad_norm"],
                                                        np.float64)),
                                   axis=-1))
            alive = np.asarray(aux["alive"])
            nf = np.asarray(aux["nonfinite"])
            for m in range(fleet.n_members):
                put(self.session, f"fleet/loss/m{m}", it, float(loss[m]))
                put(self.session, f"fleet/grad_norm/m{m}", it,
                    float(gnorm[m]))
                put(self.session, f"fleet/alive/m{m}", it, int(alive[m]))
                nfm = int(np.sum(nf[m]))
                if nfm:
                    put(self.session, f"fleet/nonfinite/m{m}", it, nfm)


def _normalize_grid(grid) -> Dict[str, np.ndarray]:
    """Sweep grid → ``{field: float64 [M]}``: a dict of equal-length lists
    (one member per position) or a list of per-member dicts naming the
    same fields."""
    if isinstance(grid, dict):
        fields = dict(grid)
    elif isinstance(grid, (list, tuple)):
        if not grid:
            raise ValueError("empty sweep grid")
        keys = set(grid[0])
        if any(set(g) != keys for g in grid):
            raise ValueError("every sweep-grid row must name the same "
                             "hyperparameters")
        fields = {k: [g[k] for g in grid] for k in keys}
    else:
        raise TypeError(f"grid must be a dict of lists or a list of "
                        f"dicts, got {type(grid).__name__}")
    unknown = sorted(set(fields) - set(SWEEPABLE))
    if unknown:
        raise ValueError(f"unknown sweep field(s) {unknown}; sweepable: "
                         f"{list(SWEEPABLE)}")
    sizes = {len(v) for v in fields.values()}
    if len(sizes) != 1:
        raise ValueError(f"sweep-grid fields disagree on member count: "
                         f"{ {k: len(v) for k, v in fields.items()} }")
    return {k: np.asarray(v, np.float64) for k, v in fields.items()}


def stream_seed(seed: int, member: int) -> int:
    """The seed of member ``member``'s generator in a fleet seeded ``seed``
    (the counterpart of the JAX fleet's ``fold_in(PRNGKey(seed), m)``)."""
    words = np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF,
                                    int(member)]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def _gen_state(gen: torch.Generator) -> str:
    return base64.b64encode(gen.get_state().numpy().tobytes()).decode("ascii")


def _set_gen_state(gen: torch.Generator, state: str) -> None:
    gen.set_state(torch.frombuffer(bytearray(base64.b64decode(state)),
                                   dtype=torch.uint8))


class _MemberRows:
    """Row m of the stacked buckets as the gradient target of the solo
    backward (``TrainableNetwork._backward``): each parameter view's
    ``.grad`` is its view of row m of the gradient bucket, which the fleet
    zeroes once for all members."""

    def __init__(self, paths, param_views, grad_views):
        self.paths = paths
        self.param_views = param_views
        self.grad_views = grad_views

    def bind_grads(self) -> None:
        for p in self.paths:
            get_path(self.param_views, p).grad = get_path(self.grad_views, p)


class _Stacked:
    """The fleet as the checkpoint machinery sees a model: the stacked
    trees (leading member axis) as views of the buckets, the counters, no
    generator of its own (the members' ride in the fleet extras)."""

    def __init__(self, fleet: "FleetTrainer"):
        self.conf = fleet.model.conf
        self.device = fleet.device
        self._params = fleet._stacked_tree(fleet._P)
        self._states = fleet._stacked_states()
        self._updater_state = ({s: fleet._stacked_tree(d)
                                for s, d in fleet._S.items()}
                               if fleet._S else None)
        self._iteration = fleet._iteration
        self._epoch = fleet._epoch
        self._steps_in_epoch = 0
        self._generator = None
        self._listeners = []


class FleetTrainer:
    """Train M stacked same-architecture members. ``model`` is the
    architecture template (an ``init``-ed ``MultiLayerNetwork``): its
    configuration, layers and device; its own parameters stay untouched.
    Every mutation of the stacked state holds ``_lock`` (a controller
    thread may cull or export while the training thread steps)."""

    def __init__(self, model, n_members: Optional[int] = None, *,
                 hyper=None, seed: Optional[int] = None,
                 member_seeds: Optional[Sequence[int]] = None,
                 drain_every_n: int = 10):
        model._check_init()
        self._lock = threading.Lock()
        self.model = model
        self.device = model.device
        self._hyper_np = _normalize_grid(hyper) if hyper else None
        counts = set()
        if n_members is not None:
            counts.add(int(n_members))
        if member_seeds is not None:
            counts.add(len(member_seeds))
        if self._hyper_np:
            counts.add(len(next(iter(self._hyper_np.values()))))
        if len(counts) != 1:
            raise ValueError(
                f"member count ambiguous or missing: n_members/"
                f"member_seeds/hyper imply {sorted(counts)}")
        M = counts.pop()
        if M < 1:
            raise ValueError(f"need at least one member, got {M}")
        self.n_members = M
        self._seed = int(seed if seed is not None
                         else model.conf.global_conf.seed)
        self.member_seeds = (list(member_seeds) if member_seeds is not None
                             else [self._seed + i for i in range(M)])
        gc = model.conf.global_conf
        self._fused = bool(gc.fused_update) and supports_fused(gc.updater)
        # the stacked buckets: member i's rows replay init(member_seeds[i])
        per_member = [self._init_member(s) for s in self.member_seeds]
        self._plan = Zero1Plan(per_member[0][0], 1)
        with torch.no_grad():
            flats = [self._plan.flatten(p) for p, _ in per_member]
            self._P = {b.key: torch.stack([f[b.key] for f in flats])
                       for b in self._plan.buckets}
            self._G = {k: torch.zeros_like(v) for k, v in self._P.items()}
            self._S: Dict[str, Dict[str, torch.Tensor]] = {}
            st0 = self._plan.flatten_state(gc.updater.init(per_member[0][0]))
            for slot, d in st0.items():
                self._S[slot] = {k: torch.zeros((M,) + tuple(v.shape),
                                                dtype=v.dtype,
                                                device=self.device)
                                 for k, v in d.items()}
        self._states = [s for _, s in per_member]
        self._gens = [self._new_generator(stream_seed(self._seed, m))
                      for m in range(M)]
        self._alive = torch.ones((M,), dtype=torch.int32, device=self.device)
        self._live = torch.ones((M,), dtype=torch.int32, device=self.device)
        self._alive_np = np.ones(M, np.int64)      # host mirror
        self._spawn_it = np.full(M, -1, np.int64)  # iteration of last spawn
        self._lr_dev = self._lr_tensor()
        self._members = [self._member_net(m) for m in range(M)]
        self._bits: Optional[Dict[str, torch.Tensor]] = None
        self._seg: Optional[Dict[str, torch.Tensor]] = None
        self._frozen_cols: Optional[list] = None
        self._built = False
        self._iteration = 0
        self._epoch = 0
        self._score_dev: Optional[torch.Tensor] = None
        self._loss_vec: Optional[torch.Tensor] = None
        self._listeners: List[Any] = []
        self._tele = None
        self._drain_every = max(1, int(drain_every_n))
        self._aux_buf: List[tuple] = []
        self._last_losses: Optional[np.ndarray] = None
        #: host seconds of the last step's member passes and of the whole
        #: step call (launches only: nothing waits for the card)
        self.last_step_timing: Dict[str, float] = {}
        OpProfiler.get().gauge("fleet/members", M)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_sweep(cls, base_model, grid, *, seed: Optional[int] = None,
                   same_init: bool = True,
                   drain_every_n: int = 10) -> "FleetTrainer":
        """One member per grid row. ``same_init=True`` gives every member
        the same initial parameters (the sweep isolates the hyperparameter
        axis); False re-inits member i from seed + i. Sweepable: ``lr``,
        ``l2``, ``dropout``."""
        hyper = _normalize_grid(grid)
        M = len(next(iter(hyper.values())))
        seed = int(seed if seed is not None
                   else base_model.conf.global_conf.seed)
        seeds = [seed] * M if same_init else [seed + i for i in range(M)]
        return cls(base_model, M, hyper=hyper, seed=seed,
                   member_seeds=seeds, drain_every_n=drain_every_n)

    # -- plumbing ----------------------------------------------------------
    @property
    def conf(self):
        return self.model.conf

    def _new_generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return gen

    def _init_member(self, seed: int):
        """``MultiLayerNetwork.init(seed)``'s parameters and layer states,
        replayed for one member (bitwise the solo init)."""
        conf = self.model.conf
        gen = torch.Generator()
        gen.manual_seed(int(seed))
        dtype = torch_dtype(conf.global_conf.dtype)
        params, states = {}, {}
        for key, layer in zip(self.model._keys, self.model.layers):
            params[key] = (layer.init_params(gen, dtype, self.device)
                           if layer.has_params else {})
            states[key] = layer.init_state(self.device)
        return params, states

    def _lr_tensor(self) -> Optional[torch.Tensor]:
        """The swept learning rates as the kernel reads them: float32 ``[M]``
        (each rounded once from its Python float, as ``ops/update._scalars``
        rounds the configured one)."""
        if self._hyper_np is None or "lr" not in self._hyper_np:
            return None
        return torch.tensor(self._hyper_np["lr"].astype(np.float32),
                            device=self.device)

    def _member_hyper(self, m: int) -> Dict[str, float]:
        if self._hyper_np is None:
            return {}
        return {k: float(v[m]) for k, v in self._hyper_np.items()}

    def _row(self, flats: Dict[str, torch.Tensor], m: int):
        return self._plan.unflatten({k: v[m] for k, v in flats.items()})

    def _member_net(self, m: int):
        """Member m as a solo network whose parameters are views of row m:
        the solo step's first half runs on it unchanged."""
        from ..nn.multilayer import MultiLayerNetwork

        net = MultiLayerNetwork(self.model.conf)
        net.device = self.device
        net._params = self._row(self._P, m)
        for p in self._plan.paths:
            t = get_path(net._params, p)
            if t.is_floating_point():
                t.requires_grad_(True)
        net._states = self._states[m]
        net._generator = self._gens[m]
        net._initialized = True
        net._rows = _MemberRows(self._plan.paths, net._params,
                                self._row(self._G, m))
        net._upd_views = {s: self._row(d, m) for s, d in self._S.items()}
        return net

    def _stacked_tree(self, flats: Dict[str, torch.Tensor]):
        """The dense tree of ``[M, *shape]`` views of ``[M, N]`` buckets."""
        out = skeleton(self._plan.skeleton)
        M = self.n_members
        for b in self._plan.buckets:
            flat, pos = flats[b.key], 0
            for i, sz, shape in zip(b.leaf_idx, b.sizes, b.shapes):
                set_path(out, self._plan.paths[i],
                         flat[:, pos:pos + sz].view((M,) + tuple(shape)))
                pos += sz
        return out

    def _stacked_states(self):
        if not leaf_paths(self._states[0]):
            return copy.deepcopy(self._states[0])
        return tree_map(lambda *xs: torch.stack(xs), *self._states)

    def member_conf(self, member: int):
        """A copy of the configuration with member ``member``'s swept
        hyperparameters baked in: its learning rate, its l2 on every
        layer that takes decay, its dropout rate on every layer whose input
        dropout is on."""
        from ..nn.conf import layers as L

        conf = copy.deepcopy(self.model.conf)
        hp = self._member_hyper(int(member))
        gc = conf.global_conf
        if "lr" in hp:
            gc.updater = with_learning_rate(gc.updater, hp["lr"])
        for layer in conf.layers:
            if "l2" in hp and not isinstance(layer, L.FrozenLayer):
                layer.l2 = hp["l2"]
            if "dropout" in hp and layer.dropout and layer.dropout > 0.0:
                layer.dropout = hp["dropout"]
        return conf

    def member_stream_state(self, member: int) -> Dict[str, Any]:
        """Where member ``member``'s random stream starts: the fleet's seed
        and the member's generator seed (:func:`stream_seed`)."""
        return {"seed": self._seed, "member": int(member),
                "stream_seed": stream_seed(self._seed, int(member))}

    def solo_twin(self, member: int):
        """A fresh solo network that trains bitwise as member ``member``:
        the member's init seed, its hyperparameters baked into the
        configuration (:meth:`member_conf`), and a generator at the start of
        the member's stream. The parity gates' comparator."""
        from ..nn.multilayer import MultiLayerNetwork

        m = int(member)
        net = MultiLayerNetwork(self.member_conf(m))
        net.init(self.member_seeds[m], device=self.device)
        net._generator = self._new_generator(stream_seed(self._seed, m))
        return net

    def set_listeners(self, *listeners) -> None:
        """Attach listeners. Telemetry-wanting ones turn the per-member aux
        on; ``NanSentinelListener`` carries the NaN policy (``"skip"``:
        transient isolation, ``"cull"``: permanent); :class:`FleetEarlyStop`
        culls from the drained window; objects with ``fleet_window``
        (:class:`FleetStatsSink`) receive every drained window."""
        with self._lock:
            self._listeners = list(listeners)
            self._tele = _tel.config_for(self._listeners)

    # -- the step ----------------------------------------------------------
    def _build(self) -> None:
        """The step's buffers beside the stacked state, once per fleet: the
        random bits of a bfloat16 state, the telemetry's layer slots, the
        frozen columns."""
        OpProfiler.get().count("trace/fleet_step")
        gc = self.model.conf.global_conf
        sd = state_dtype_of(gc.updater)
        if self._fused and sd and self._S:
            self._bits = {k: torch.empty(v.shape, dtype=torch.int32,
                                         device=self.device)
                          for k, v in self._P.items()}
        self._seg = {b.key: self._plan.shard_segment_ids(b.key, 0, b.padded,
                                                         self.device)
                     for b in self._plan.buckets}
        frozen = set(self.model._frozen_paths())
        cols = []
        for b in self._plan.buckets:
            pos = 0
            for i, sz in zip(b.leaf_idx, b.sizes):
                if self._plan.paths[i] in frozen:
                    cols.append((b.key, pos, pos + sz))
                pos += sz
        self._frozen_cols = cols
        self._built = True

    def _place(self, a) -> torch.Tensor:
        return self.model._place_array(a)

    def step(self, x, y, per_member: bool = False) -> torch.Tensor:
        """One fleet step. ``per_member=True``: ``x``/``y`` carry a leading
        ``[M]`` member axis (per-user data); otherwise the one batch serves
        every member. Returns the per-member loss ``[M]`` on the device (no
        host sync)."""
        xv, yv = self._place(x), self._place(y)
        if per_member and xv.shape[0] != self.n_members:
            raise ValueError(
                f"per_member batch leading axis {xv.shape[0]} != fleet "
                f"size {self.n_members}")
        prof = OpProfiler.get()
        with self._lock:
            if not self._built:
                self._build()
            with prof.time_section("pipeline/dispatch"):
                aux = xprof.censused(
                    self, "fleet/step", self._step_locked,
                    static_argnames=("per_member",))(
                    xv, yv, per_member=per_member)
            self._iteration += 1
            it_done = self._iteration
            losses = self._score_dev
        if aux is not None:
            self._note_aux(it_done, aux)
        return losses

    def _step_locked(self, xv, yv, per_member: bool):
        t0 = time.perf_counter()
        M = self.n_members
        tele = self._tele
        guard = bool(tele and tele.nan_guard)
        ran = [bool(a) for a in self._alive_np]
        for g in self._G.values():
            g.zero_()
        old_states = list(self._states) if guard else None
        losses: List[torch.Tensor] = []
        for m in range(M):
            if not ran[m]:
                losses.append(self._loss_vec[m] if self._loss_vec is not None
                              else torch.full((), float("nan"),
                                              device=self.device))
                continue
            net = self._members[m]
            net._states = self._states[m]
            batch = ((xv[m], yv[m]) if per_member else (xv, yv)) \
                + (None, None, None)
            loss, _ = net._grad_core(net._rows, batch,
                                     self._member_hyper(m))
            self._states[m] = net._states
            losses.append(loss)
        t_pass = time.perf_counter()
        loss_vec = torch.stack(losses).to(torch.float32)
        with torch.no_grad():
            aux = None
            old_P = None
            if tele is not None:
                nf = self._layer_sums(
                    {k: (~torch.isfinite(g)).to(torch.int32)
                     for k, g in self._G.items()}, torch.int32)
                # a culled member's loss is its last one (or NaN before
                # any): evidence only for the live members
                nf_total = nf.sum(dim=1, dtype=torch.int32) \
                    + (~torch.isfinite(loss_vec)).to(torch.int32) \
                    * self._alive
                gsq = self._layer_sums(
                    {k: g.to(torch.float32).square()
                     for k, g in self._G.items()}, torch.float32)
                if tele.stats:
                    old_P = {k: v.clone() for k, v in self._P.items()}
            live = self._alive
            ok = None
            if guard:
                ok = nf_total == 0
                torch.mul(self._alive, ok.to(torch.int32), out=self._live)
                live = self._live
            kept = [(k, a, b, self._P[k][:, a:b].clone())
                    for k, a, b in self._frozen_cols]
            self._update(live, ran)
            for k, a, b, v in kept:
                self._P[k][:, a:b].copy_(v)
            self._constrain(live, ran)
            if guard:
                for m in range(M):
                    if ran[m] and leaf_paths(self._states[m]):
                        self._states[m] = _tel.where_tree(
                            ok[m], self._states[m], old_states[m])
                if tele.member_cull:
                    # the permanent flavour: the poisoned member's alive
                    # bit drops here, on the device
                    nan_culled = self._alive * (~ok).to(torch.int32)
                    self._alive.mul_(ok.to(torch.int32))
            if tele is not None:
                aux = {"loss": loss_vec, "grad_norm": gsq.sqrt(),
                       "nonfinite": nf, "nonfinite_total": nf_total,
                       "alive": self._alive.clone()}
                if old_P is not None:
                    dsq = self._layer_sums(
                        {k: (self._P[k] - old_P[k]).square()
                         for k in self._P}, torch.float32)
                    psq = self._layer_sums(
                        {k: self._P[k].square() for k in self._P},
                        torch.float32)
                    aux["update_norm"] = dsq.sqrt()
                    aux["param_norm"] = psq.sqrt()
                    aux["update_ratio"] = aux["update_norm"] / \
                        torch.clamp_min(aux["param_norm"], 1e-12)
                if guard:
                    aux["skipped"] = (~ok).to(torch.int32)
                    if tele.member_cull:
                        aux["nan_culled"] = nan_culled
        for net in self._members:
            net._cast_cache = None
        self._loss_vec = loss_vec
        self._score_dev = loss_vec
        self.last_step_timing = {"passes_host_s": t_pass - t0,
                                 "step_host_s": time.perf_counter() - t0}
        return aux

    def _layer_sums(self, per_bucket: Dict[str, torch.Tensor], dtype):
        """``[M, L]`` per-layer sums of ``[M, N]`` bucket values."""
        L = self._plan.n_layers
        out = torch.zeros((self.n_members, L + 1), dtype=dtype,
                          device=self.device)
        for k, v in per_bucket.items():
            out.index_add_(1, self._seg[k], v.to(dtype))
        return out[:, :L]

    def _update(self, live: torch.Tensor, ran: List[bool]) -> None:
        """Every live row's update: one member-batched launch per bucket
        with ``fused_update``, else each member's per-leaf updater on its
        views, kept only where the member is live."""
        gc = self.model.conf.global_conf
        it = self._iteration
        if self._fused:
            fused_apply_members(gc.updater, self._P, self._G, self._S, it,
                                self._gens, lr=self._lr_dev, live=live,
                                draw=ran, bits_buf=self._bits)
            return
        for m, net in enumerate(self._members):
            if not ran[m]:
                continue
            lr = self._member_hyper(m).get("lr")
            up = gc.updater if lr is None \
                else with_learning_rate(gc.updater, lr)
            new_p, new_s = apply_updater(up, net._rows.grad_views,
                                         net._upd_views, net._params, it,
                                         net._generator)
            ok = live[m] != 0
            for p in self._plan.paths:
                t = get_path(net._params, p)
                torch.where(ok, get_path(new_p, p), t, out=t)
            for s, tree in net._upd_views.items():
                for p in self._plan.paths:
                    t = get_path(tree, p)
                    torch.where(ok, get_path(new_s[s], p), t, out=t)

    def _constrain(self, live: torch.Tensor, ran: List[bool]) -> None:
        """The layers' constraints on every live row (the solo step's,
        after the update)."""
        from ..nn.multilayer import _NO_CONSTRAINT, _named_leaves

        if not any(layer.constraints for layer in self.model.layers):
            return
        for m, net in enumerate(self._members):
            if not ran[m]:
                continue
            ok = live[m] != 0
            for key, layer in zip(net._keys, net.layers):
                if not layer.constraints:
                    continue
                for name, t in _named_leaves(net._params[key]):
                    if name in _NO_CONSTRAINT:
                        continue
                    w = t
                    for c in layer.constraints:
                        w = c.apply(w)
                    torch.where(ok, w, t, out=t)

    def fit(self, data, epochs: int = 1,
            batch_size: Optional[int] = None) -> None:
        """Train the whole fleet on a shared data stream: each DataSet
        batch is one fleet step (per-member data goes through
        ``step(..., per_member=True)``)."""
        for _ in range(max(1, epochs)):
            for ds in _pipe.iter_datasets(data, batch_size):
                self.step(ds.features, ds.labels)
            with self._lock:
                self._epoch += 1
            self.drain()

    # -- telemetry bus (one readback per drain window) ---------------------
    def _note_aux(self, iteration: int, aux) -> None:
        with self._lock:
            self._aux_buf.append((iteration, aux))
            full = len(self._aux_buf) >= self._drain_every
        if full:
            self.drain()

    def drain(self) -> None:
        """Flush the buffered telemetry window: one batched readback for the
        whole fleet, then the sinks, the NaN-cull report and the early-stop
        decisions."""
        with self._lock:
            buf, self._aux_buf = self._aux_buf, []
            listeners = list(self._listeners)
        if not buf:
            return
        prof = OpProfiler.get()
        with prof.time_section("telemetry/drain"):
            host = _tel.readback([a for _, a in buf])
        prof.count("fleet/drains")
        iters = [it for it, _ in buf]
        # culls on the device surface here: the members whose alive bit a
        # step dropped
        culled = []
        for it, aux in zip(iters, host):
            if "nan_culled" in aux:
                for m in np.nonzero(np.asarray(aux["nan_culled"]) > 0)[0]:
                    culled.append((int(m), int(it)))
                    flightrec.event("fleet/nan_cull", severity="warn",
                                    member=int(m), iteration=int(it))
                    prof.count("fleet/nan_culls")
                    logger.warning(
                        "fleet: member %d produced non-finite gradients at "
                        "iteration %d; its alive bit dropped on the device "
                        "(other members unaffected)", int(m), int(it))
        losses = np.stack([np.asarray(a["loss"], np.float64) for a in host])
        with self._lock:
            # the host mirror learns the device's culls, unless the member
            # was spawned again since
            for m, it in culled:
                if self._spawn_it[m] < it:
                    self._alive_np[m] = 0
            alive_now = self._alive_np.copy()
            self._last_losses = losses[-1]
        prof.gauge("fleet/members", int(alive_now.sum()))
        for lst in listeners:
            win = getattr(lst, "fleet_window", None)
            if callable(win):
                win(self, iters, host)
            if isinstance(lst, FleetEarlyStop):
                for m in lst.decide(losses, alive_now):
                    self.cull(m, reason="early_stop")

    # -- lifecycle ---------------------------------------------------------
    def alive_mask(self) -> np.ndarray:
        """The alive mask, read from the device (culls on the device
        included, drained or not)."""
        alive = self._alive.cpu().numpy().astype(np.int64)
        with self._lock:
            self._alive_np = alive.copy()
        return alive

    def _check_member(self, member: int) -> int:
        m = int(member)
        if not 0 <= m < self.n_members:
            raise ValueError(f"member {m} out of range [0, "
                             f"{self.n_members})")
        return m

    def cull(self, member: int, reason: str = "cull") -> None:
        """Freeze member ``member``: its alive bit drops (in place on the
        device) and every later update leaves its slice bitwise as it is.
        Its pass is no longer run."""
        m = self._check_member(member)
        with self._lock:
            self._alive[m] = 0
            self._alive_np[m] = 0
            alive_now = int(self._alive_np.sum())
        OpProfiler.get().count("fleet/culls")
        OpProfiler.get().gauge("fleet/members", alive_now)
        flightrec.event("fleet/cull", severity="warn", member=m,
                        reason=reason)

    def spawn(self, member: int, params=None,
              seed: Optional[int] = None) -> None:
        """Re-initialize member ``member`` in place: fresh parameters (from
        ``seed``, default its member seed, or a given solo parameter tree),
        fresh updater state, a fresh stream, alive again. The member keeps
        the fleet's iteration counter (bias correction continues from
        it)."""
        m = self._check_member(member)
        init_seed = self.member_seeds[m] if seed is None else int(seed)
        fresh_p, fresh_s = self._init_member(init_seed)
        if params is not None:
            fresh_p = tree_map(
                lambda t: (t if isinstance(t, torch.Tensor)
                           else torch.from_numpy(np.asarray(t))
                           ).to(self.device), params)
        gc = self.model.conf.global_conf
        with torch.no_grad():
            flat = self._plan.flatten(fresh_p)
            st = self._plan.flatten_state(gc.updater.init(fresh_p))
        with self._lock:
            with torch.no_grad():
                for k, v in flat.items():
                    self._P[k][m].copy_(v)
                for slot, d in st.items():
                    for k, v in d.items():
                        self._S[slot][k][m].copy_(v)
            self._states[m] = fresh_s
            self._members[m]._states = fresh_s
            self._gens[m].manual_seed(stream_seed(
                self._seed if seed is None else int(seed), m))
            self._alive[m] = 1
            self._alive_np[m] = 1
            self._spawn_it[m] = self._iteration
            self._members[m]._cast_cache = None
            alive_now = int(self._alive_np.sum())
            listeners = list(self._listeners)
        for lst in listeners:
            cb = getattr(lst, "member_spawned", None)
            if callable(cb):
                cb(m)
        OpProfiler.get().count("fleet/spawns")
        OpProfiler.get().gauge("fleet/members", alive_now)
        flightrec.event("fleet/spawn", member=m, seed=init_seed)

    def best_member(self) -> int:
        """The alive member with the lowest last-drained loss (needs a
        telemetry listener; drains the buffered window first)."""
        self.drain()
        with self._lock:
            losses = self._last_losses
            alive = self._alive_np.copy()
        if losses is None:
            raise RuntimeError("best_member needs telemetry: attach a "
                               "telemetry listener (set_listeners) and "
                               "train at least one step")
        return int(np.argmin(np.where(alive > 0, losses, np.inf)))

    # -- member export / checkpoints ---------------------------------------
    def export_member(self, member: int):
        """Member ``member`` as a fresh solo ``MultiLayerNetwork`` owning
        copies of its parameters, layer states, updater state, counters
        and generator, configured with its hyperparameters
        (:meth:`member_conf`): the serving handoff and the solo
        continuation."""
        from ..nn.multilayer import MultiLayerNetwork

        m = self._check_member(member)
        net = MultiLayerNetwork(self.member_conf(m))
        net.init(self.member_seeds[m], device=self.device)
        with self._lock, torch.no_grad():
            row = self._row(self._P, m)
            for p in self._plan.paths:
                get_path(net._params, p).copy_(get_path(row, p))
            net._states = tree_map(lambda t: t.detach().clone(),
                                   self._states[m])
            net._updater_state = (
                {s: tree_map(lambda t: t.clone(), self._row(d, m))
                 for s, d in self._S.items()} if self._S else {})
            net._iteration = self._iteration
            net._epoch = self._epoch
            net._generator = torch.Generator(device=self.device)
            net._generator.set_state(self._gens[m].get_state())
        return net

    def save_member(self, member: int, directory: str,
                    tag: Optional[str] = None, keep_last: int = 10) -> str:
        """Commit member ``member`` as an ordinary solo checkpoint (the
        manifest entry tagged ``{"member": k, "members": M}``). It carries
        the member's generator where it stands, so a solo network restoring
        it continues bitwise as the member would in the fleet."""
        from ..util.checkpoint import (commit_checkpoint, serialize_snapshot,
                                       snapshot_training_state)

        m = self._check_member(member)
        os.makedirs(directory, exist_ok=True)
        net = self.export_member(m)
        snap = snapshot_training_state(net)
        tag = tag if tag is not None else f"member{m}_it{snap['iteration']}"
        return commit_checkpoint(
            directory, tag, serialize_snapshot(snap), snap["iteration"],
            keep_last, state_dtype=snap.get("state_dtype"),
            fleet={"member": m, "members": self.n_members})

    def _fleet_extras(self) -> Dict[str, Any]:
        return {
            "members": self.n_members,
            "member_seeds": [int(s) for s in self.member_seeds],
            "seed": self._seed,
            "alive": [int(a) for a in self._alive.cpu().tolist()],
            "torch_generators": {"device": self.device.type,
                                 "states": [_gen_state(g)
                                            for g in self._gens]},
            "hyper": (None if self._hyper_np is None else
                      {k: v.tolist() for k, v in self._hyper_np.items()}),
        }

    def save(self, directory: str, tag: Optional[str] = None,
             keep_last: int = 3) -> str:
        """Commit the whole stacked fleet atomically: the stacked trees
        through the standard snapshot, the fleet extras (alive mask,
        generator states, hyper, member seeds) in ``resume.json``.
        :meth:`restore` resumes bitwise, alive mask included."""
        from ..util.checkpoint import (commit_checkpoint, serialize_snapshot,
                                       snapshot_training_state)

        self.drain()
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            extras = self._fleet_extras()
            listeners = list(self._listeners)
            snap = snapshot_training_state(_Stacked(self),
                                           listeners=listeners)
        snap["generator"] = None
        snap["fleet"] = extras
        tag = tag if tag is not None else f"fleet_it{snap['iteration']}"
        return commit_checkpoint(
            directory, tag, serialize_snapshot(snap), snap["iteration"],
            keep_last, state_dtype=snap.get("state_dtype"),
            fleet={"members": self.n_members})

    def restore(self, path: str) -> None:
        """Resume a :meth:`save` checkpoint into this trainer (same
        architecture and member count), copying into the stacked buffers in
        place. A JAX-written fleet checkpoint restores all but the streams,
        which restart from each member's :func:`stream_seed` (logged)."""
        from ..util.checkpoint import (read_resume_state,
                                       restore_training_state)

        extra = read_resume_state(path).get("fleet")
        if not extra:
            raise ValueError(
                f"{path} is not a fleet checkpoint (no fleet extras in "
                f"resume.json); member checkpoints restore into a SOLO "
                f"model via restore_training_state")
        if int(extra["members"]) != self.n_members:
            raise ValueError(
                f"checkpoint has {extra['members']} members, trainer has "
                f"{self.n_members}")
        with self._lock:
            listeners = list(self._listeners)
            view = _Stacked(self)
            want_p = view._params
            want_u = view._updater_state
        restore_training_state(view, path, listeners=listeners,
                               restore_rng=False)
        with self._lock, torch.no_grad():
            for p in leaf_paths(want_p):
                get_path(want_p, p).copy_(get_path(view._params, p))
            if want_u is not None and view._updater_state is not None:
                for s, tree in want_u.items():
                    for p in leaf_paths(tree):
                        get_path(tree, p).copy_(
                            get_path(view._updater_state[s], p))
            if leaf_paths(view._states):
                self._states = [tree_map(lambda t, _m=m: t[_m].clone(),
                                         view._states)
                                for m in range(self.n_members)]
                for m, net in enumerate(self._members):
                    net._states = self._states[m]
            self._iteration = int(view._iteration)
            self._epoch = int(view._epoch)
            alive = np.asarray(extra["alive"], np.int64)
            self._alive.copy_(torch.from_numpy(alive.astype(np.int32)))
            self._alive_np = alive.copy()
            self._seed = int(extra.get("seed", self._seed))
            self.member_seeds = [int(s) for s in extra["member_seeds"]]
            hyper = extra.get("hyper")
            self._hyper_np = (None if hyper is None else
                              {k: np.asarray(v, np.float64)
                               for k, v in hyper.items()})
            self._lr_dev = self._lr_tensor()
            gens = extra.get("torch_generators") or {}
            if gens.get("device") == self.device.type:
                for g, st in zip(self._gens, gens["states"]):
                    _set_gen_state(g, st)
            else:
                for m, g in enumerate(self._gens):
                    g.manual_seed(stream_seed(self._seed, m))
                logger.info("fleet checkpoint %s carries no %s generator "
                            "states; the member streams restart from their "
                            "stream seeds", path, self.device.type)
            for net in self._members:
                net._cast_cache = None
            self._aux_buf = []
        OpProfiler.get().gauge("fleet/members", int(self._alive_np.sum()))

    # -- stacked inference (population hooks) ------------------------------
    def output(self, x, params=None, per_member: bool = True):
        """Inference for every member: ``x`` ``[M, B, ...]`` (or one shared
        batch with ``per_member=False``) → ``[M, B, ...]``. ``params``: a
        ``(params, states)`` pair of stacked trees (:meth:`stacked_state`)
        instead of the live state, as a frozen target network."""
        xv = self._place(x)
        with self._lock, torch.inference_mode():
            return xprof.censused(
                self, "fleet/infer", self._infer,
                static_argnames=("per_member",))(
                xv, params, per_member=per_member)

    def _infer(self, xv, params, per_member: bool) -> torch.Tensor:
        outs = []
        for m, net in enumerate(self._members):
            if params is None:
                p, s = net._params, self._states[m]
            else:
                p = tree_map(lambda t, _m=m: t[_m], params[0])
                s = tree_map(lambda t, _m=m: t[_m], params[1])
            out, _ = net._forward(p, s, xv[m] if per_member else xv, False)
            outs.append(out)
        return torch.stack(outs)

    def stacked_state(self):
        """Owning copies of the live ``(params, states)`` as stacked trees
        (leading member axis): a frozen target-network snapshot."""
        with self._lock, torch.no_grad():
            params = tree_map(lambda t: t.clone(),
                              self._stacked_tree(self._P))
            states = tree_map(lambda t: t.clone(), self._stacked_states())
        return params, states

    def stacked_views(self):
        """Views of the live stacked trees ``(params, states, updater
        state)`` (``util/convert.fleet_state_from_numpy`` writes through
        them)."""
        return (self._stacked_tree(self._P), self._states,
                {s: self._stacked_tree(d) for s, d in self._S.items()})

    def buffer_ptrs(self) -> Dict[str, int]:
        """``data_ptr()`` of every stacked buffer: they stay the same for
        the fleet's life after its first step."""
        out = {f"params/{k}": v.data_ptr() for k, v in self._P.items()}
        out.update({f"grads/{k}": v.data_ptr() for k, v in self._G.items()})
        for s, d in self._S.items():
            out.update({f"{s}/{k}": v.data_ptr() for k, v in d.items()})
        out["alive"] = self._alive.data_ptr()
        out["live"] = self._live.data_ptr()
        for k, v in (self._bits or {}).items():
            out[f"bits/{k}"] = v.data_ptr()
        return out
