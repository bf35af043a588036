"""The multi-process cluster runtime: the control plane around
``torch.distributed``.

Counterpart of ``deeplearning4j_tpu/parallel/cluster.py`` (the reference's
``VoidConfiguration`` handshake plus the Aeron transport's heartbeat and
dead-node detection). The data plane is ``torch.distributed``'s process
group (``parallel/_collectives.ProcessGroupRoute``); this module hardens the
control plane around it, with files and the standard library only, so it
keeps working exactly when a collective is wedged:

- **bring-up with a deadline** (:meth:`ClusterRuntime.form`): bounded
  exponential-backoff retries of ``torch.distributed.init_process_group``
  (a ``TCPStore`` hosted by rank 0 at the coordinator address), each
  attempt's timeout clipped to what is left of ``init_deadline_s``.
  Non-zero ranks probe the coordinator by TCP first, so "nobody listening"
  is a refused connect the retry loop absorbs. A coordinator that never
  answers fails with :class:`ClusterInitError` naming the address, the
  ranks whose heartbeats did report, and the attempt and elapsed counts.
  The backend is chosen by rule (:func:`choose_backend`), never by trying
  one and falling back, and every collective has the bounded timeout
  ``collective_timeout_s`` (gloo's default is 30 minutes).
- **rank heartbeats** (:meth:`ClusterRuntime.start_heartbeat`): a file per
  rank (``hb-rank<k>.json`` in the shared cluster directory) rewritten by a
  daemon thread, independent of collectives: a wedged rank is found by its
  heartbeat's age while its peers block in a collective.
  :func:`read_heartbeats` is the supervisor's reader.
- **barrier with a deadline** (:meth:`ClusterRuntime.barrier`): a
  token-file rendezvous that on timeout names every missing rank with its
  heartbeat staleness, records a ``cluster/barrier`` event, dumps this
  rank's blackbox and raises :class:`BarrierTimeout`.
- **group checkpoint commit** (:meth:`ClusterRuntime
  .commit_group_checkpoint`): pre-commit barrier, rank 0 commits through
  ``util/checkpoint`` under the manifest's incarnation fence, publish
  barrier, then every other rank verifies that the manifest names the new
  generation (``util/checkpoint.verify_group_commit``).
- **per-rank blackboxes** (:meth:`ClusterRuntime.dump_rank_blackbox`,
  :func:`merge_rank_blackboxes`): each rank's flight recorder, tagged with
  rank and incarnation, joined by the supervising process.

The fault sites ``cluster/init``, ``cluster/heartbeat``,
``cluster/barrier`` and ``cluster/commit`` sit where the JAX module has
them.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional

from ..common import faultinject, flightrec
from ..common.profiler import OpProfiler

logger = logging.getLogger("deeplearning4j_tpu_torch")

#: per-rank heartbeat file (in the shared cluster directory)
HEARTBEAT_PREFIX = "hb-rank"
#: per-rank flight-recorder dump (tagged with rank and incarnation)
BLACKBOX_PREFIX = "blackbox-rank"
#: environment override of the rank's card (else rank % device_count)
ENV_LOCAL_DEVICE = "DL4J_TPU_LOCAL_DEVICE"
#: environment override of the collectives' timeout, seconds
ENV_COLLECTIVE_TIMEOUT = "DL4J_TPU_COLLECTIVE_TIMEOUT_S"


class ClusterInitError(RuntimeError):
    """Bring-up failed inside its deadline, with the whole diagnosis:
    coordinator address, ranks that reported a heartbeat, attempts and
    elapsed seconds."""

    def __init__(self, message: str, *, coordinator: Optional[str] = None,
                 attempts: int = 0, elapsed_s: float = 0.0,
                 reported_ranks: Optional[List[int]] = None):
        super().__init__(message)
        self.coordinator = coordinator
        self.attempts = attempts
        self.elapsed_s = elapsed_s
        self.reported_ranks = list(reported_ranks or [])


class BarrierTimeout(RuntimeError):
    """A barrier's deadline ran out: the missing ranks and each one's
    heartbeat staleness (``None``: no heartbeat ever seen)."""

    def __init__(self, message: str, *, name: str, gen: int,
                 missing: List[int],
                 staleness: Dict[int, Optional[float]]):
        super().__init__(message)
        self.name = name
        self.gen = gen
        self.missing = list(missing)
        self.staleness = dict(staleness)


class GroupCommitError(RuntimeError):
    """A non-zero rank could not verify the group commit it was told was
    published."""


# ---------------------------------------------------------------------------
# heartbeat files (readable with no live collective)
# ---------------------------------------------------------------------------

def heartbeat_path(cluster_dir: str, rank: int) -> str:
    return os.path.join(cluster_dir, f"{HEARTBEAT_PREFIX}{rank}.json")


def read_heartbeats(cluster_dir: str) -> Dict[int, Dict[str, Any]]:
    """Every rank's last heartbeat, ``{rank: {age_s, pid, incarnation, seq,
    t_wall, cadence_s}}``; ranks that never beat are absent. Ages are by
    the wall clock, since the writers are other processes."""
    out: Dict[int, Dict[str, Any]] = {}
    try:
        names = os.listdir(cluster_dir)
    except OSError:
        return out
    now = time.time()
    for f in names:
        if not (f.startswith(HEARTBEAT_PREFIX) and f.endswith(".json")):
            continue
        try:
            rank = int(f[len(HEARTBEAT_PREFIX):-len(".json")])
            with open(os.path.join(cluster_dir, f), encoding="utf-8") as fh:
                doc = json.load(fh)
            doc["age_s"] = max(0.0, now - float(doc.get("t_wall", 0.0)))
            out[rank] = doc
        except (ValueError, OSError):
            continue   # a beat being replaced: the next poll reads it
    return out


def _staleness_text(missing: List[int],
                    staleness: Dict[int, Optional[float]]) -> str:
    parts = []
    for r in missing:
        age = staleness.get(r)
        parts.append(f"rank {r}: no heartbeat ever" if age is None
                     else f"rank {r}: heartbeat {age:.1f}s stale")
    return "; ".join(parts)


# ---------------------------------------------------------------------------
# backend and device, by rule
# ---------------------------------------------------------------------------

def local_device(rank: int):
    """The rank's device: ``cuda:$DL4J_TPU_LOCAL_DEVICE``, else
    ``cuda:(rank % device_count)``; the CPU where no card is visible."""
    import torch

    if not torch.cuda.is_available():
        return torch.device("cpu")
    env = os.environ.get(ENV_LOCAL_DEVICE)
    idx = int(env) if env not in (None, "") else \
        int(rank) % torch.cuda.device_count()
    return torch.device("cuda", idx)


def choose_backend(world: int, device) -> str:
    """``"nccl"`` when every rank of the (single-host) group has a card of
    its own, ``"gloo"`` when ranks share a card or run on the CPU. Chosen
    by rule: NCCL refuses two ranks on one device, so trying it first and
    falling back would turn a refusal into a silent change of route."""
    import torch

    if getattr(device, "type", str(device)) != "cuda":
        return "gloo"
    if torch.cuda.device_count() >= int(world):
        return "nccl"
    return "gloo"


def collective_timeout_s(default: float = 120.0) -> float:
    env = os.environ.get(ENV_COLLECTIVE_TIMEOUT)
    return float(env) if env not in (None, "") else float(default)


# ---------------------------------------------------------------------------
# the per-process runtime
# ---------------------------------------------------------------------------

class ClusterRuntime:
    """One process's membership of a multi-process cluster.

    ``cluster_dir`` is the shared control-plane directory (heartbeats,
    barrier tokens, per-rank blackboxes); ``rank``/``world`` are this
    process's index and the group's size. ``coordinator`` (``host:port``)
    enables the ``torch.distributed`` bring-up in :meth:`form` on the
    backend :func:`choose_backend` picks for the rank's
    :func:`local_device`; ``None`` keeps the runtime file-only
    (heartbeats, barriers and commits without collectives, as the
    subprocess drills use it)."""

    def __init__(self, cluster_dir: str, rank: int, world: int, *,
                 coordinator: Optional[str] = None,
                 heartbeat_interval_s: float = 0.25,
                 init_deadline_s: float = 60.0,
                 init_backoff_base_s: float = 0.25,
                 init_backoff_max_s: float = 4.0,
                 incarnation: int = 0,
                 poll_s: float = 0.02):
        self.cluster_dir = cluster_dir
        self.rank = int(rank)
        self.world = int(world)
        self.coordinator = coordinator
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.init_deadline_s = float(init_deadline_s)
        self.init_backoff_base_s = float(init_backoff_base_s)
        self.init_backoff_max_s = float(init_backoff_max_s)
        self.incarnation = int(incarnation)
        self.poll_s = float(poll_s)
        self.device = local_device(self.rank)
        self.backend = choose_backend(self.world, self.device)
        self.collective_timeout_s = collective_timeout_s()
        #: the checkpoint manifest's fence for group commits (rank 0 claims
        #: it with :meth:`claim_commit_incarnation`; other ranks never
        #: write)
        self.commit_incarnation: Optional[int] = None
        os.makedirs(cluster_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        self._hb_seq = 0
        self._commit_ordinal = 0
        self._formed = False
        self._form_attempts = 0
        self._owns_group = False

    # -- heartbeats -------------------------------------------------------

    def _write_beat(self) -> None:
        with self._lock:
            self._hb_seq += 1
            seq = self._hb_seq
        path = heartbeat_path(self.cluster_dir, self.rank)
        tmp = f"{path}.tmp.{os.getpid()}"
        doc = {"rank": self.rank, "pid": os.getpid(),
               "incarnation": self.incarnation, "seq": seq,
               "t_wall": time.time(),
               "cadence_s": self.heartbeat_interval_s}
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, path)

    def start_heartbeat(self) -> None:
        """One beat now (this rank has reported; the bring-up diagnosis
        counts it), then the cadence thread. Idempotent."""
        self._write_beat()
        with self._lock:
            if self._hb_thread is not None and self._hb_thread.is_alive():
                return
            self._hb_stop.clear()
            t = threading.Thread(target=self._beat_loop,
                                 name=f"cluster-heartbeat-r{self.rank}",
                                 daemon=True)
            self._hb_thread = t
        t.start()

    def _beat_loop(self) -> None:
        n = 0
        while not self._hb_stop.wait(self.heartbeat_interval_s):
            n += 1
            # slow: a late beat (stale until it lands); wedge: the beat
            # thread dies, the "alive, no progress" signature the
            # supervisor classifies as a hang
            try:
                faultinject.fault_point("cluster/heartbeat", index=n)
            except faultinject.WedgeReleased:
                return
            try:
                self._write_beat()
            except OSError:
                logger.warning("cluster: rank %d heartbeat write failed",
                               self.rank, exc_info=True)

    def stop_heartbeat(self) -> None:
        with self._lock:
            t = self._hb_thread
            self._hb_thread = None
        self._hb_stop.set()
        if t is not None and t.is_alive():
            t.join(timeout=2.0)

    # -- bring-up ---------------------------------------------------------

    @staticmethod
    def _probe_coordinator(coordinator: str, timeout_s: float) -> None:
        """One bounded TCP connect to the coordinator: a non-zero rank's
        ``TCPStore`` client would otherwise wait out its whole timeout on a
        dead coordinator; the refused connect is a ConnectionError the
        retry loop absorbs and diagnoses."""
        import socket

        host, _, port = coordinator.rpartition(":")
        with socket.create_connection((host or "127.0.0.1", int(port)),
                                      timeout=max(0.1, min(timeout_s, 5.0))):
            pass

    def _default_initialize(self, coordinator: str, world: int, rank: int,
                            timeout_s: float) -> None:
        """``torch.distributed.init_process_group`` on this runtime's
        backend, at ``tcp://<coordinator>``, with the store's connect
        bounded by the attempt's timeout and every collective by
        ``collective_timeout_s``."""
        import torch
        import torch.distributed as dist

        if rank != 0:
            self._probe_coordinator(coordinator, timeout_s)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        host, _, port = coordinator.rpartition(":")
        store = dist.TCPStore(host or "127.0.0.1", int(port), world,
                              is_master=rank == 0,
                              timeout=timedelta(seconds=max(1.0, timeout_s)),
                              wait_for_workers=False)
        kwargs = {}
        if self.backend == "nccl":
            kwargs["device_id"] = self.device
        dist.init_process_group(
            self.backend, store=store, world_size=world, rank=rank,
            timeout=timedelta(seconds=self.collective_timeout_s), **kwargs)
        self._owns_group = True

    def form(self, initialize_fn: Optional[Callable[..., None]] = None
             ) -> "ClusterRuntime":
        """Bring this rank up: the heartbeat first, then the process group
        under bounded exponential-backoff retries and the init deadline.
        Records ``cluster/form`` (with the backend and device) on success;
        raises :class:`ClusterInitError` with the whole diagnosis on
        failure. ``initialize_fn(coordinator, world, rank, timeout_s)``
        replaces the ``torch.distributed`` bring-up (drills inject refused
        connects through it)."""
        prof = OpProfiler.get()
        self.start_heartbeat()
        t0 = time.monotonic()
        deadline = t0 + self.init_deadline_s
        attempts = 0
        while True:
            attempts += 1
            remaining = deadline - time.monotonic()
            try:
                # transient: one refused coordinator connect (the bring-up
                # drill), absorbed by the retry loop
                faultinject.fault_point("cluster/init", index=attempts - 1)
                if self.coordinator is not None:
                    fn = initialize_fn or self._default_initialize
                    fn(self.coordinator, self.world, self.rank,
                       max(0.5, remaining))
                break
            except (faultinject.TransientFault, ConnectionError, OSError,
                    RuntimeError) as e:
                prof.count("cluster/init_retries")
                elapsed = time.monotonic() - t0
                backoff = min(
                    self.init_backoff_base_s * (2 ** (attempts - 1)),
                    self.init_backoff_max_s)
                if time.monotonic() + backoff >= deadline:
                    hb = read_heartbeats(self.cluster_dir)
                    reported = sorted(hb)
                    msg = (f"cluster bring-up failed on rank {self.rank}: "
                           f"coordinator {self.coordinator!r} unreachable "
                           f"after {attempts} attempt(s) over "
                           f"{elapsed:.1f}s (deadline "
                           f"{self.init_deadline_s:.1f}s); ranks that "
                           f"reported a heartbeat: {reported}; "
                           f"last error: {e}")
                    prof.count("cluster/init_failures")
                    logger.error(msg)
                    raise ClusterInitError(
                        msg, coordinator=self.coordinator,
                        attempts=attempts, elapsed_s=elapsed,
                        reported_ranks=reported) from e
                logger.warning("cluster: rank %d bring-up attempt %d "
                               "failed (%s); retrying in %.2fs",
                               self.rank, attempts, e, backoff)
                time.sleep(backoff)
        with self._lock:
            self._formed = True
            self._form_attempts = attempts
        prof.count("cluster/formed")
        logger.info("cluster: rank %d of %d formed on %s over %s",
                    self.rank, self.world, self.device, self.backend)
        flightrec.event("cluster/form", rank=self.rank, world=self.world,
                        coordinator=self.coordinator, attempts=attempts,
                        incarnation=self.incarnation,
                        backend=self.backend, device=str(self.device),
                        elapsed_s=round(time.monotonic() - t0, 3))
        return self

    @property
    def formed(self) -> bool:
        with self._lock:
            return self._formed

    @property
    def form_attempts(self) -> int:
        with self._lock:
            return self._form_attempts

    # -- barrier ----------------------------------------------------------

    def _token_path(self, name: str, gen: int, rank: int) -> str:
        safe = "".join(c if (c.isalnum() or c in "-_.") else "_"
                       for c in name)
        return os.path.join(self.cluster_dir, f"bar-{safe}-{gen}.r{rank}")

    def barrier(self, name: str, *, deadline_s: float = 30.0,
                gen: int = 0) -> None:
        """A rendezvous over token files, independent of collectives. On
        timeout: a ``cluster/barrier`` event (missing ranks and their
        heartbeat staleness), this rank's blackbox beside the heartbeats,
        and :class:`BarrierTimeout` naming every missing rank with its
        staleness. ``gen`` tells reuses of one name apart."""
        prof = OpProfiler.get()
        # crash: a rank dying at the fence, before its token (the
        # survivors must then time out naming it)
        faultinject.fault_point("cluster/barrier", index=gen)
        token = self._token_path(name, gen, self.rank)
        with open(token, "w", encoding="utf-8") as f:
            f.write(str(os.getpid()))
        t0 = time.monotonic()
        deadline = t0 + float(deadline_s)
        while True:
            missing = [r for r in range(self.world)
                       if not os.path.exists(self._token_path(name, gen, r))]
            if not missing:
                prof.count("cluster/barriers")
                return
            if time.monotonic() >= deadline:
                break
            time.sleep(self.poll_s)
        hb = read_heartbeats(self.cluster_dir)
        staleness: Dict[int, Optional[float]] = {
            r: (round(hb[r]["age_s"], 3) if r in hb else None)
            for r in missing}
        msg = (f"barrier {name!r} (gen {gen}) timed out after "
               f"{deadline_s:.1f}s on rank {self.rank}: missing ranks "
               f"{missing} — {_staleness_text(missing, staleness)}")
        prof.count("cluster/barrier_timeouts")
        flightrec.event("cluster/barrier", severity="error", rank=self.rank,
                        barrier=name, gen=gen, missing=missing,
                        staleness={str(r): s for r, s in staleness.items()},
                        deadline_s=float(deadline_s))
        self.dump_rank_blackbox()
        logger.error(msg)
        raise BarrierTimeout(msg, name=name, gen=gen, missing=missing,
                             staleness=staleness)

    # -- group checkpoint commit ------------------------------------------

    def claim_commit_incarnation(self, ckpt_dir: str) -> int:
        """Rank 0 claims the checkpoint directory's incarnation fence for
        this incarnation of the group: a writer of an earlier one that
        wakes up late can never commit over it."""
        from ..util import checkpoint as _ckpt

        if self.rank != 0:
            raise GroupCommitError(
                f"rank {self.rank}: only rank 0 claims the commit fence")
        self.commit_incarnation = _ckpt.claim_incarnation(ckpt_dir)
        return self.commit_incarnation

    def commit_group_checkpoint(self, ckpt_dir: str, tag: str, data: bytes,
                                iteration: int, *, keep_last: int = 4,
                                seq: Optional[int] = None,
                                barrier_deadline_s: float = 30.0,
                                max_total_bytes: Optional[int] = None,
                                state_dtype: Optional[str] = None) -> str:
        """The commit protocol; every rank calls it with the same ``tag``
        (only rank 0's ``data`` is written): pre-commit barrier, rank 0's
        atomic commit under the incarnation fence, publish barrier, then
        each other rank verifies that the manifest's entry for the tag is
        intact. Returns the committed path. A rank killed inside the
        protocol leaves the previous generation restorable: the manifest
        names only whole files."""
        from ..util import checkpoint as _ckpt

        with self._lock:
            self._commit_ordinal += 1
            ordinal = self._commit_ordinal
        gen = seq if seq is not None else iteration
        self.barrier(f"commit-{tag}-pre", deadline_s=barrier_deadline_s,
                     gen=gen)
        path: Optional[str] = None
        if self.rank == 0:
            os.makedirs(ckpt_dir, exist_ok=True)
            # crash: the torn-group-commit drill, rank 0 dying between the
            # fences; the survivors' publish barrier times out and the
            # previous generation stays restorable
            faultinject.fault_point("cluster/commit", index=ordinal - 1)
            path = _ckpt.commit_checkpoint(
                ckpt_dir, tag, data, iteration, keep_last,
                max_total_bytes=max_total_bytes, seq=seq,
                incarnation=self.commit_incarnation,
                state_dtype=state_dtype)
        self.barrier(f"commit-{tag}-pub", deadline_s=barrier_deadline_s,
                     gen=gen)
        if self.rank != 0:
            path = _ckpt.verify_group_commit(ckpt_dir, tag)
            if path is None:
                newest = _ckpt.last_checkpoint(ckpt_dir)
                raise GroupCommitError(
                    f"rank {self.rank}: group commit {tag!r} not intact "
                    f"in the manifest after the publish barrier (newest "
                    f"verified: {newest!r})")
        OpProfiler.get().count("cluster/group_commits")
        return path  # type: ignore[return-value]

    # -- blackbox ---------------------------------------------------------

    def dump_rank_blackbox(self) -> str:
        """This rank's flight-recorder ring, every row tagged with rank and
        incarnation, to ``blackbox-rank<k>.jsonl`` in the cluster directory
        (atomic replace)."""
        path = os.path.join(self.cluster_dir,
                            f"{BLACKBOX_PREFIX}{self.rank}.jsonl")
        rows = flightrec.get().snapshot()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            for row in rows:
                tagged = dict(row)
                tagged["rank"] = self.rank
                tagged["incarnation"] = self.incarnation
                f.write(json.dumps(tagged, default=str) + "\n")
        os.replace(tmp, path)
        return path

    def shutdown(self) -> None:
        """Stop the heartbeat (the file stays: its growing age says when
        this rank went quiet) and destroy the process group this runtime
        made."""
        self.stop_heartbeat()
        if self._owns_group:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
            self._owns_group = False


# ---------------------------------------------------------------------------
# helpers of the supervising process
# ---------------------------------------------------------------------------

def cpu_multiprocess_collectives_available() -> bool:
    """Whether this torch can run collectives across processes on the CPU
    (the gloo backend)."""
    try:
        import torch.distributed as dist

        return dist.is_available() and dist.is_gloo_available()
    except Exception:
        return False


def stale_ranks(cluster_dir: str, stale_after_s: float,
                world: Optional[int] = None) -> List[int]:
    """Ranks whose heartbeat is older than ``stale_after_s``: the hang
    detector (a rank stale while its process lives is a hang, not a crash).
    Ranks that never beat are reported only when ``world`` says they should
    exist."""
    hb = read_heartbeats(cluster_dir)
    out = [r for r, doc in hb.items() if doc["age_s"] > stale_after_s]
    if world is not None:
        out += [r for r in range(world) if r not in hb]
    return sorted(set(out))


def merge_rank_blackboxes(cluster_dir: str) -> List[Dict[str, Any]]:
    """Every rank's dumped blackbox joined into one list ordered by wall
    clock (rows carry their ``rank`` and ``incarnation``)."""
    merged: List[Dict[str, Any]] = []
    try:
        names = os.listdir(cluster_dir)
    except OSError:
        return merged
    for f in sorted(names):
        if not (f.startswith(BLACKBOX_PREFIX) and f.endswith(".jsonl")):
            continue
        try:
            with open(os.path.join(cluster_dir, f), encoding="utf-8") as fh:
                for line in fh:
                    try:
                        merged.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            continue
    merged.sort(key=lambda e: (e.get("t", 0.0), e.get("rank", -1),
                               e.get("seq", 0)))
    return merged
