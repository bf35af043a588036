"""Replica consistency: fingerprints, the in-step verdict, bit-flip drills.

Counterpart of the in-step half of ``deeplearning4j_tpu/common/
integrity.py``. Data-parallel training keeps every replica's copy of the
replicated state bitwise identical; the check folds each replica's copy
into one 32-bit word and compares the words across replicas:

- :func:`fingerprint_tree` / :func:`fingerprint_flats`: every leaf's raw
  bits as 32-bit words (sub-32-bit dtypes widened after the bit view, 64-bit
  dtypes as two words, bool as bytes), folded with a wrapping sum and an
  xor, combined as ``sum * 2654435761 ^ xor`` modulo 2^32. Both folds are
  commutative, so the dense tree and its flat buckets (their live prefix,
  :meth:`~deeplearning4j_tpu_torch.parallel.sharding.Zero1Plan.
  unpadded_views`) give the same word, and that word equals the JAX
  package's for the same bytes. PyTorch has no xor reduction and few
  uint32 operators: the sum runs in int64 (masked to 32 bits), the xor as a
  tree of halvings, the product in 16-bit halves. Values are int64
  tensors holding the uint32 word.
- :func:`replica_verdict`: the per-replica words gathered and
  majority-voted on the device: ``(checked, diverged, replica)``, the
  replica named when exactly one is in the minority, else -1.
- :class:`IntegrityListener` drains the verdicts (one readback per window
  that holds a checked step) and raises :class:`ReplicaCorruptionError`
  naming the replica (``policy="warn"``: logs instead).
- :func:`apply_bitflip` flips one bit of one replica's parameter copy
  between steps; :func:`materialize_from_survivors` copies training state
  from a replica that is not being evicted.

- :class:`CheckpointScrubber` re-hashes the retained committed checkpoints
  against their manifest sha256 on a cadence, stamps the passing entries
  and quarantines the failing ones (``util/checkpoint.record_scrub``);
  ``_flip_file_byte`` rots one byte of a file on disk for its drills.

The ``integrity/fingerprint`` fault-injection site (``parallel/
wrapper.py``'s dispatch) flips bits through :func:`apply_bitflip`; callers
may also call it directly. The listener records the flight-recorder events
``integrity/divergence`` (each divergent check) and
``integrity/fingerprint`` (the last checked fingerprint of a drained
window), as the JAX package's does.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import faultinject, flightrec
from .profiler import OpProfiler

logger = logging.getLogger("deeplearning4j_tpu_torch")

_FNV = 2654435761
_MASK = 0xFFFFFFFF


class ReplicaCorruptionError(RuntimeError):
    """The consistency check found replicas that disagree. ``replica`` is
    the minority replica, or None when no single one can be named (a
    two-way split, or two replicas)."""

    def __init__(self, message: str, replica: Optional[int] = None,
                 iteration: Optional[int] = None):
        super().__init__(message)
        self.replica = replica
        self.iteration = iteration


# --- folds -------------------------------------------------------------------

def _words(a: torch.Tensor) -> torch.Tensor:
    """The raw bits of ``a`` as 32-bit words in an int32 (32-bit and wider
    dtypes) or zero-extended int32 (narrower) tensor, 1-D."""
    a = a.detach().contiguous().reshape(-1)
    if a.dtype == torch.bool:
        a = a.view(torch.uint8)
    size = a.element_size()
    if size >= 4:
        return a.view(torch.int32)
    if size == 2:
        return a.view(torch.int16).to(torch.int32) & 0xFFFF
    return a.view(torch.uint8).to(torch.int32)


def _xor_reduce(u: torch.Tensor) -> torch.Tensor:
    """The xor of all elements of a 1-D integer tensor (0 when empty), by
    halving."""
    if u.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=u.device)
    while u.numel() > 1:
        n = u.numel()
        h = n // 2
        head = u[:h] ^ u[h:2 * h]
        u = torch.cat([head, u[2 * h:]]) if n % 2 else head
    return u[0].to(torch.int64) & _MASK


def _fold_words(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tensor -> (wrapping uint32 sum, uint32 xor) of its raw bits, as
    int64 tensors. Bit views, never value casts: NaN payloads, -0.0 and
    denormals all count."""
    u = _words(a)
    s = torch.sum(u, dtype=torch.int64) & _MASK
    return s, _xor_reduce(u)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c`` modulo 2^32 for ``a`` in [0, 2^32) (int64), in 16-bit
    halves so nothing overflows int64."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK


def combine_fp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two digests into one (parameters with updater state)."""
    return _mul32(a, _FNV) ^ b


def _tensor_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, np.ndarray):
        return [torch.from_numpy(np.ascontiguousarray(tree))]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return []


def _digest(leaves: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    dev = device if device is not None else (
        leaves[0].device if leaves else torch.device("cpu"))
    s = torch.zeros((), dtype=torch.int64, device=dev)
    x = torch.zeros((), dtype=torch.int64, device=dev)
    for leaf in leaves:
        ls, lx = _fold_words(leaf)
        s = (s + ls.to(dev)) & _MASK
        x = x ^ lx.to(dev)
    return _mul32(s, _FNV) ^ x


def fingerprint_tree(tree) -> torch.Tensor:
    """The digest of every leaf's bits (0-dim int64 holding the uint32
    word); independent of leaf order and layout."""
    return _digest(_tensor_leaves(tree))


def fingerprint_flats(plan, flats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The digest of a plan's flat buckets, over each bucket's live prefix
    only: equal to :func:`fingerprint_tree` of the same parameters for any
    replica count."""
    return _digest(list(plan.unpadded_views(flats).values()))


def bitwise_neq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Whether any element differs in its bits (``!=`` on floats cannot
    see NaN payloads)."""
    if a.dtype == torch.bool:
        return torch.any(a != b)
    return torch.any(_words(a) != _words(b))


def replica_verdict(fps: Sequence[torch.Tensor],
                    mismatches: Optional[Sequence[torch.Tensor]] = None,
                    do_check: bool = True):
    """Majority vote over the replicas' digests: int32 tensors ``(checked,
    diverged, replica)`` on the first digest's device. ``mismatches``: per
    replica, nonzero when the replica saw a transport mismatch."""
    from ..parallel._collectives import all_gather_scalars

    f = all_gather_scalars(list(fps))
    dev = f.device
    mis = (all_gather_scalars([m.to(torch.int32) for m in mismatches])
           if mismatches is not None
           else torch.zeros_like(f, dtype=torch.int32))
    n = f.shape[0]
    support = (f[None, :] == f[:, None]).to(torch.int32).sum(dim=1)
    fp_div = torch.any(support < n)
    bad = (support < support.max()) | (mis > 0)
    n_bad = bad.to(torch.int32).sum()
    checked = torch.full((), bool(do_check), dtype=torch.bool, device=dev)
    diverged = (fp_div | torch.any(mis > 0)) & checked
    replica = torch.where(diverged & (n_bad == 1),
                          torch.argmax(bad.to(torch.int32)).to(torch.int32),
                          torch.full((), -1, dtype=torch.int32, device=dev))
    return (checked.to(torch.int32), diverged.to(torch.int32), replica)


def host_fingerprint(tree) -> int:
    """:func:`fingerprint_tree` on host copies, as a Python int."""
    return int(_digest([t.detach().cpu() for t in _tensor_leaves(tree)],
                       torch.device("cpu")))


# --- the listener ------------------------------------------------------------

class IntegrityListener:
    """Drains the step's consistency verdict and raises on divergence.
    ``wants_integrity`` asks the wrapper for a check every ``check_every``
    steps; the aux then carries ``integrity_checked``,
    ``integrity_diverged``, ``integrity_replica`` and ``integrity_fp``.
    Values are buffered on the device and read back once per window that
    holds a checked step (the host knows which from the iteration)."""

    POLICIES = ("raise", "warn")

    def __init__(self, check_every: int = 8, policy: str = "raise"):
        if policy not in self.POLICIES:
            raise ValueError("policy must be one of %r" % (self.POLICIES,))
        self.check_every = max(1, int(check_every))
        self.policy = policy
        self.wants_telemetry = True
        self.wants_telemetry_stats = False
        self.wants_integrity = self.check_every
        self.fingerprints: List[Tuple[int, int]] = []
        self.divergences: List[Dict[str, int]] = []
        self._buf: List[Tuple[int, Any]] = []

    def iteration_done(self, model, iteration: int, score) -> None:
        pass

    def epoch_done(self, model, epoch: int) -> None:
        self._drain()

    def telemetry_done(self, model, iteration: int, aux) -> None:
        if "integrity_checked" not in aux:
            return
        self._buf.append((iteration, aux))
        if getattr(model, "_at_dispatch_boundary", True):
            # the check ran at step it iff it % every == 0; the listener
            # sees iteration = it + 1
            if any((it - 1) % self.check_every == 0 for it, _ in self._buf):
                self._drain()
            else:
                self._buf.clear()

    def _drain(self) -> None:
        if not self._buf:
            return
        buf, self._buf = self._buf, []
        prof = OpProfiler.get()
        with prof.time_section("telemetry/drain"):
            rows = torch.stack([torch.stack([
                a["integrity_checked"].to(torch.int64),
                a["integrity_diverged"].to(torch.int64),
                a["integrity_replica"].to(torch.int64),
                a["integrity_fp"].to(torch.int64)]) for _, a in buf])
            vals = rows.cpu().tolist()
        last_fp = None
        for (it, _), (checked, diverged, replica, fp) in zip(buf, vals):
            if not checked:
                continue
            prof.count("integrity/checks")
            last_fp = (it, int(fp))
            self.fingerprints.append(last_fp)
            if diverged:
                rep = int(replica)
                prof.count("integrity/divergences")
                flightrec.event("integrity/divergence", severity="error",
                                iteration=it, replica=rep, fp=int(fp))
                self.divergences.append(
                    {"iteration": it, "replica": rep, "fp": int(fp)})
                who = rep if rep >= 0 else "unattributable"
                if self.policy == "raise":
                    raise ReplicaCorruptionError(
                        "replica-consistency fingerprint diverged at "
                        "iteration %d (replica %s)" % (it, who),
                        replica=rep if rep >= 0 else None, iteration=it)
                logger.warning(
                    "integrity: fingerprint divergence at iteration %d "
                    "(replica %s), policy=warn, training continues", it, who)
        if last_fp is not None:
            flightrec.event("integrity/fingerprint", iteration=last_fp[0],
                            fp=last_fp[1], checks=len(self.fingerprints))

    def state_dict(self) -> dict:
        return {"fingerprints": [[i, f] for i, f in self.fingerprints[-64:]]}

    def load_state_dict(self, state: dict) -> None:
        self.fingerprints = [(int(i), int(f))
                             for i, f in state.get("fingerprints", [])]


# --- drills ------------------------------------------------------------------

def _label(path) -> str:
    return "".join(f"[{p!r}]" for p in path)


def apply_bitflip(holder, mesh, spec: Dict[str, Any]) -> Dict[str, Any]:
    """Flip bit ``spec["bit"]`` (default 12, a mantissa bit of every float
    dtype in use) of element ``spec["offset"]`` (default 0) of one
    parameter leaf (``spec["tensor"]``: a substring of its path, default
    the first floating leaf) in replica ``spec["replica"]``'s copy, in
    place, between steps. ``holder``: a ``ParallelWrapper`` or the model it
    trains; ``mesh``: the wrapper's mesh."""
    from ..common.tree import get_path, leaf_paths

    pw = holder if hasattr(holder, "replica_params") \
        else getattr(holder, "_parallel", None)
    if pw is None:
        raise ValueError("bitflip: the holder is not trained by a "
                         "ParallelWrapper")
    replica = int(spec.get("replica", 0))
    bit = int(spec.get("bit", 12))
    offset = int(spec.get("offset", 0))
    name = spec.get("tensor")
    n = mesh.shape["data"]
    if not 0 <= replica < n:
        raise ValueError("bitflip replica %d outside mesh of %d"
                         % (replica, n))
    params = pw.replica_params(replica)
    target = None
    for path in leaf_paths(params):
        leaf = get_path(params, path)
        if name is not None:
            if name in _label(path):
                target = path
                break
        elif leaf.is_floating_point():
            target = path
            break
    if target is None:
        raise ValueError("bitflip: no param leaf matches %r" % (name,))
    leaf = get_path(params, target)
    with torch.no_grad():
        words = _bit_view(leaf)
        i = offset % words.numel()
        mask = 1 << bit
        if mask >= 1 << (8 * words.element_size() - 1):
            mask -= 1 << (8 * words.element_size())   # the sign bit
        words[i] ^= mask
    OpProfiler.get().count("integrity/bitflips_injected")
    logger.warning("integrity: injected bitflip on replica %d tensor %s "
                   "bit %d offset %d", replica, _label(target), bit, offset)
    return {"replica": replica, "tensor": _label(target), "bit": bit,
            "offset": offset}


def _bit_view(t: torch.Tensor) -> torch.Tensor:
    """An integer view of ``t``'s storage, 1-D."""
    flat = t.detach().view(-1)
    if flat.dtype == torch.bool:
        return flat.view(torch.uint8)
    return flat.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                      8: torch.int64}[flat.element_size()])


def materialize_from_survivors(replicas: Sequence[Any],
                               lost: Sequence[int]):
    """Owning host copies of the first replica not in ``lost``: the
    counterpart of the JAX function, which reads a replicated array's
    surviving shard instead of shard 0 (that may be the corrupt copy).
    ``replicas``: one state tree per replica (tensors in nested
    dicts/lists/tuples)."""
    lost_set = {int(r) for r in lost}
    survivor = next((i for i in range(len(replicas)) if i not in lost_set),
                    None)
    if survivor is None:
        raise ValueError("no surviving replica to materialize from")

    def host(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().to("cpu", copy=True)
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(host(v) for v in tree)
        return tree

    return host(replicas[survivor])


# --- checkpoint scrubber ----------------------------------------------------

def _flip_file_byte(path: str, offset: int, bit: int) -> None:
    """Scrub-drill helper: rot one byte of an on-disk file in place."""
    size = os.path.getsize(path)
    if size == 0:
        return
    with open(path, "r+b") as f:
        f.seek(offset % size)
        byte = f.read(1)
        f.seek(offset % size)
        f.write(bytes([byte[0] ^ (1 << (bit % 8))]))


class CheckpointScrubber:
    """Background re-verification of retained committed checkpoints.

    Walks the manifest on a cadence, re-hashes each non-quarantined
    generation against its committed sha256, stamps passing entries with a
    ``scrub`` record and quarantines failures in the manifest (the file is
    never deleted). Manifest read-modify-writes go through
    ``util/checkpoint``'s manifest lock, so the scrubber and the async
    ``CheckpointWriter`` never tear each other's updates.

    Fault site ``checkpoint/scrub`` fires once per entry per pass with a
    rising ordinal: ``transient`` skips the entry this pass, ``bitflip``
    rots the file on disk (``offset``, ``bit``) before hashing."""

    def __init__(self, directory: str, interval_s: float = 30.0):
        self.directory = directory
        self.interval_s = max(0.05, float(interval_s))
        self.passes = 0
        self._ordinal = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "CheckpointScrubber":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="ckpt-scrubber", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scrub_now()
            except Exception:
                logger.exception("integrity: scrub pass failed")

    def scrub_now(self) -> Dict[str, int]:
        """One scrub pass; returns {scanned, verified, quarantined,
        skipped}."""
        from ..util import checkpoint as _ckpt
        prof = OpProfiler.get()
        summary = {"scanned": 0, "verified": 0, "quarantined": 0,
                   "skipped": 0}
        for entry in _ckpt.read_manifest(self.directory):
            if not isinstance(entry, dict) or "sha256" not in entry \
                    or entry.get("quarantined"):
                summary["skipped"] += 1
                continue
            ordinal = self._ordinal
            self._ordinal += 1
            try:
                advisory = faultinject.fault_point("checkpoint/scrub",
                                                   ordinal)
            except faultinject.TransientFault:
                prof.count("integrity/scrub_retries")
                summary["skipped"] += 1
                continue
            path = os.path.join(self.directory, entry["file"])
            for spec in advisory:
                if spec.get("kind") == "bitflip":
                    _flip_file_byte(path, int(spec.get("offset", 128)),
                                    int(spec.get("bit", 0)))
            summary["scanned"] += 1
            try:
                ok = _ckpt._sha256_file(path) == entry["sha256"]
            except OSError:
                ok = False
            if ok:
                _ckpt.record_scrub(self.directory, entry["file"], True)
                prof.count("integrity/scrub_verified")
                summary["verified"] += 1
            else:
                _ckpt.record_scrub(self.directory, entry["file"], False,
                                   reason="sha256 mismatch on scrub")
                summary["quarantined"] += 1
        self.passes += 1
        prof.count("integrity/scrub_passes")
        flightrec.event("integrity/scrub", directory=self.directory,
                        **summary)
        return summary
