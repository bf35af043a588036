"""Atomic, async, resumable training checkpoints (one device).

Counterpart of the single-device part of
``deeplearning4j_tpu/util/checkpoint.py``: a checkpoint either exists
completely or not at all, a reader can prove which, and a resumed run is
bitwise the run that was never killed. Three layers, as there:

- **Snapshot** (:func:`snapshot_training_state`): on the training thread,
  at a step boundary, the parameters, layer states and updater state in
  ONE readback (every leaf's bytes gathered on the device into one buffer,
  then one copy to the host, split there into owning CPU tensors), plus
  what makes the resume exact: iteration and epoch, the pipeline cursor
  (epochs done and steps into the epoch, kept by ``data/pipeline``), the
  listeners' ``state_dict``s and the network's ``torch.Generator`` state
  (the dropout and stochastic-rounding bits). The snapshot is host data:
  the fused kernel updates the device buckets in place, and the writer
  never touches them.
- **Commit** (:func:`commit_checkpoint`): serialize (the
  ``util/model_serializer`` container plus ``resume.json``, ZIP_STORED) →
  ``<name>.tmp`` → flush + fsync → ``os.replace`` → fsync of the
  directory. A sha256 of the committed bytes goes into ``checkpoint.json``
  (the manifest, itself replaced atomically), with the retention
  (``keep_last``, ``max_total_bytes``) applied to committed files only and
  an entry dropped from the manifest before its file is unlinked. The
  manifest's ``incarnation`` fence is read and written as the JAX package
  does, so a directory written by one package is resumed by the other.
- **Verify** (:func:`last_checkpoint`): the manifest newest → oldest,
  re-hashing each file; a missing, truncated or bit-flipped one is skipped
  with a warning, so the newest intact file wins. Without a usable
  manifest, a directory scan validates each ``checkpoint_*.zip`` (zip CRC
  and its meta entry). Generations that the JAX package's scrubber marked
  quarantined are skipped too.

``resume.json`` holds the JAX package's keys: ``cursor``,
``listener_state`` and ``rng``. The JAX ``rng`` is a threefry key, which
the port cannot continue: a checkpoint written by the JAX package restores
everything else bitwise, and the port then reseeds the network's generator
from ``rng.seed`` (logged). The port writes ``rng`` as the JAX package's
``PRNGKey(seed)`` of the configuration's seed, so the JAX package reads
the file, and adds its own generator state under ``torch_generator``
(the JAX package reads only the keys it knows), so a port-written
checkpoint resumes bitwise in the port.

A data-parallel fit (``parallel/wrapper.py``) adds the accumulator entry
(``accumulatorState.npz``: the encoded exchange's residuals, threshold and
counters, in the JAX package's host layout) and the live worker count in
``resume.json``'s cursor; the snapshot first asks the wrapper for its
state (the model's ``_parallel_sync``). The updater state on disk is always
the dense tree, so a ZeRO-1 checkpoint restores under any worker count.

The serving and scrub half: :func:`quarantine_checkpoint` marks a
generation quarantined in the manifest (the file stays, as evidence; every
reader skips it from then on), :func:`record_scrub` folds a scrub verdict
in (a pass stamps ``scrub = {ok, t}``, a fail quarantines),
``last_checkpoint(require_scrubbed=True)`` prefers the newest
scrub-verified generation, and :func:`read_checkpoint_params` reads just
(params, states) against templates, as ``parallel/serving``'s canaried
publication does. ``common/integrity.CheckpointScrubber`` walks the
manifest and calls :func:`record_scrub`. The ``checkpoint/pre_rename``
fault site sits in the torn-write window of every commit, and each commit
records a ``checkpoint/commit`` flight-recorder event.

The fleet extras (``parallel/fleet.py``): ``commit_checkpoint(fleet=)``
records ``{"members": M}`` (a whole fleet) or ``{"member": k, "members":
M}`` (one member saved as a solo checkpoint) on the manifest entry, and a
snapshot's ``fleet`` entry (alive mask, member seeds, the members'
generator states, the sweep's hyperparameters) rides in ``resume.json``
under ``fleet``, as the JAX package's does (its threefry ``keys`` aside).
Every restore records a ``checkpoint/restore`` flight-recorder event.
A pipeline trainer's snapshot records its live stage count in the cursor
(``stages``, informational: the layout on disk is per layer).

Group commits (``parallel/cluster.ClusterRuntime.commit_group_checkpoint``):
rank 0 commits through :func:`commit_checkpoint` under its incarnation
fence, and every other rank checks :func:`verify_group_commit` after the
publish barrier: only the manifest publishes a group commit, and a
generation the scrubber quarantined is refused.
"""

from __future__ import annotations

import base64
import hashlib
import io
import json
import logging
import os
import queue
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional

import torch

from ..common import faultinject, flightrec
from ..common.profiler import OpProfiler
from ..learning.precision import state_dtype_of
from ..parallel.sharding import is_flat_state, unflatten_updater_state
from .model_serializer import (COEFF_ENTRY, CONF_ENTRY, META_ENTRY,
                               STATES_ENTRY, UPDATER_ENTRY, _checked,
                               _unflatten, dense_updater_state, load_leaves,
                               load_state_entries, savez_leaves, tree_leaves)

logger = logging.getLogger("deeplearning4j_tpu_torch")

MANIFEST_NAME = "checkpoint.json"
RESUME_ENTRY = "resume.json"
ACC_ENTRY = "accumulatorState.npz"
MANIFEST_FORMAT = 2
#: the port's own key in resume.json
GENERATOR_KEY = "torch_generator"

# in-process serialization of the manifest's read-modify-writes
_MANIFEST_LOCK = threading.RLock()


class StaleIncarnationError(RuntimeError):
    """A writer of an older incarnation tried to commit into a directory a
    newer incarnation has claimed (``checkpoint.json``'s monotonic
    ``incarnation``): the commit is refused and the manifest untouched."""


# --------------------------------------------------------------------------
# snapshot
# --------------------------------------------------------------------------

def _host_copy(leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """Owning CPU copies of ``leaves`` in one device-to-host transfer: the
    bytes of every leaf gathered into one device buffer first."""
    if not leaves:
        return []
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in leaves])
    host = flat.cpu() if flat.device.type != "cpu" else flat
    out, off = [], 0
    for t in leaves:
        n = t.numel() * t.element_size()
        out.append(host[off:off + n].view(t.dtype).reshape(t.shape))
        off += n
    return out


def _seed_key(seed: int) -> List[int]:
    """The JAX package's threefry ``PRNGKey(seed)`` as uint32 words."""
    seed = int(seed)
    return [(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF]


def snapshot_training_state(model, listeners=None) -> Dict[str, Any]:
    """Host snapshot of everything a resume needs, taken on the training
    thread at a step boundary, with one readback."""
    sync = getattr(model, "_parallel_sync", None)
    if callable(sync):
        sync()      # a data-parallel fit's updater and accumulator state
    upd = dense_updater_state(model)
    acc = getattr(model, "_acc_state", None) or None
    trees = (model._params, model._states, upd if upd is not None else {})
    counts = [len(tree_leaves(t)) for t in trees]
    host = _host_copy([leaf for t in trees for leaf in tree_leaves(t)])
    params = host[:counts[0]]
    states = host[counts[0]:counts[0] + counts[1]]
    updater = host[counts[0] + counts[1]:] if upd is not None else None
    # the wrapper hands its accumulator state over as host tensors already
    accumulator = ([t.detach().to("cpu", copy=True) for t in tree_leaves(acc)]
                   if acc is not None else None)
    gen = model._generator
    conf_json = getattr(model, "_ckpt_conf_json", None)
    if conf_json is None:
        conf_json = model.conf.to_json()
        model._ckpt_conf_json = conf_json
    fit_epoch0 = getattr(model, "_fit_epoch0", model._epoch)
    seed = int(model.conf.global_conf.seed)
    return {
        "kind": type(model).__name__,
        "conf_json": conf_json,
        "params": params, "states": states, "updater": updater,
        "accumulator": accumulator,
        "state_dtype": state_dtype_of(model.conf.global_conf.updater),
        "iteration": int(model._iteration),
        "epoch": int(model._epoch),
        "rng": {"seed": seed, "key": _seed_key(seed), "key_dtype": "uint32"},
        "generator": None if gen is None else {
            "device": gen.device.type,
            "state": base64.b64encode(
                gen.get_state().numpy().tobytes()).decode("ascii")},
        "cursor": {
            "epochs_done": int(model._epoch) - int(fit_epoch0),
            "steps_in_epoch": int(getattr(model, "_steps_in_epoch", 0)),
            "workers": int(getattr(model, "_live_workers", 1)),
            **({"stages": int(model._live_stages)}
               if hasattr(model, "_live_stages") else {})},
        "listener_state": gather_listener_state(listeners),
    }


def gather_listener_state(listeners) -> Dict[str, Any]:
    """Listeners opt into an exact resume with ``state_dict`` /
    ``load_state_dict`` (JSON-serializable), keyed by position and
    class."""
    out: Dict[str, Any] = {}
    for i, lst in enumerate(listeners or []):
        fn = getattr(lst, "state_dict", None)
        if callable(fn):
            out[f"{i}:{type(lst).__name__}"] = fn()
    return out


def restore_listener_state(listeners, state: Dict[str, Any]) -> None:
    for i, lst in enumerate(listeners or []):
        key = f"{i}:{type(lst).__name__}"
        fn = getattr(lst, "load_state_dict", None)
        if callable(fn) and key in state:
            fn(state[key])


def serialize_snapshot(snapshot: Dict[str, Any]) -> bytes:
    """Snapshot → the model-serializer container (``meta.json`` at
    ``format_version`` 2 with ``updater_state_dtype``) plus
    ``resume.json``. ZIP_STORED: trained float parameters do not
    compress, and the write's latency bounds the cadence."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr(CONF_ENTRY, snapshot["conf_json"])
        zf.writestr(COEFF_ENTRY, savez_leaves(snapshot["params"]))
        zf.writestr(STATES_ENTRY, savez_leaves(snapshot["states"]))
        zf.writestr(META_ENTRY, json.dumps({
            "iteration": snapshot["iteration"], "epoch": snapshot["epoch"],
            "kind": snapshot["kind"], "format_version": 2,
            "updater_state_dtype": snapshot.get("state_dtype"),
        }))
        if snapshot["updater"] is not None:
            zf.writestr(UPDATER_ENTRY, savez_leaves(snapshot["updater"]))
        if snapshot.get("accumulator"):
            zf.writestr(ACC_ENTRY, savez_leaves(snapshot["accumulator"]))
        resume = {"rng": snapshot["rng"], "cursor": snapshot["cursor"],
                  "listener_state": snapshot["listener_state"]}
        if snapshot.get("generator") is not None:
            resume[GENERATOR_KEY] = snapshot["generator"]
        if snapshot.get("fleet") is not None:
            # a stacked fleet's extras; solo readers never look for them
            resume["fleet"] = snapshot["fleet"]
        zf.writestr(RESUME_ENTRY, json.dumps(resume))
    return buf.getvalue()


# --------------------------------------------------------------------------
# atomic commit + manifest
# --------------------------------------------------------------------------

def _fsync_dir(directory: str) -> None:
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(path: str, data: bytes, seq: Optional[int] = None,
                  durable: bool = True) -> None:
    """data → <path>.tmp → fsync → rename (``durable=False`` skips the
    fsyncs, still atomic: the manifest, whose loss the directory scan
    recovers from). The ``checkpoint/pre_rename`` fault site sits in the
    torn-write window the rename closes."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        if durable:
            f.flush()
            os.fsync(f.fileno())
    faultinject.fault_point("checkpoint/pre_rename", seq)
    os.replace(tmp, path)
    if durable:
        _fsync_dir(os.path.dirname(path) or ".")


def read_manifest_doc(directory: str) -> Dict[str, Any]:
    """The manifest document ({} when missing or unreadable: the scan
    fallback still finds the checkpoints)."""
    path = os.path.join(directory, MANIFEST_NAME)
    try:
        with open(path) as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else {}
    except FileNotFoundError:
        return {}
    except (json.JSONDecodeError, OSError):
        logger.warning("unreadable checkpoint manifest %s; falling back to "
                       "a directory scan", path)
        return {}


def read_manifest(directory: str) -> List[Any]:
    """Manifest entries, oldest first (dicts; bare paths in format 1)."""
    entries = read_manifest_doc(directory).get("checkpoints", [])
    return entries if isinstance(entries, list) else []


def manifest_incarnation(directory: str) -> int:
    try:
        return int(read_manifest_doc(directory).get("incarnation", 0))
    except (TypeError, ValueError):
        return 0


def write_manifest(directory: str, entries: List[Any],
                   incarnation: Optional[int] = None) -> None:
    doc: Dict[str, Any] = {"format": MANIFEST_FORMAT, "checkpoints": entries}
    if incarnation is None:
        incarnation = manifest_incarnation(directory)
    if incarnation:
        doc["incarnation"] = int(incarnation)
    _atomic_write(os.path.join(directory, MANIFEST_NAME),
                  json.dumps(doc).encode(), durable=False)


def claim_incarnation(directory: str) -> int:
    """Bump and record the directory's incarnation, fencing off every
    writer of an older one."""
    os.makedirs(directory, exist_ok=True)
    with _MANIFEST_LOCK:
        doc = read_manifest_doc(directory)
        inc = int(doc.get("incarnation", 0) or 0) + 1
        write_manifest(directory, doc.get("checkpoints", []),
                       incarnation=inc)
    return inc


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _entry_name(e: Any) -> str:
    return e["file"] if isinstance(e, dict) else os.path.basename(e)


def _entry_bytes(directory: str, e: Any) -> int:
    if isinstance(e, dict) and "bytes" in e:
        return int(e["bytes"])
    try:
        return os.path.getsize(os.path.join(directory, _entry_name(e)))
    except OSError:
        return 0


def _append_and_retain(directory: str, name: str, sha: str, iteration: int,
                       keep_last: int, size: Optional[int] = None,
                       max_total_bytes: Optional[int] = None,
                       incarnation: Optional[int] = None,
                       state_dtype: Optional[str] = None,
                       fleet: Optional[Dict[str, Any]] = None) -> None:
    """Fold one committed file into the manifest, then retention: count
    (``keep_last``) and bytes (``max_total_bytes``; the newest always
    stays). The manifest stops naming a file before it is unlinked.
    ``fleet``: the entry's fleet provenance."""
    with _MANIFEST_LOCK:
        doc = read_manifest_doc(directory)
        current = int(doc.get("incarnation", 0) or 0)
        if incarnation is not None and int(incarnation) < current:
            raise StaleIncarnationError(
                f"writer incarnation {incarnation} is stale: {directory} "
                f"was claimed by incarnation {current}; refusing to commit "
                f"{name}")
        old = doc.get("checkpoints", [])
        entries = [e for e in (old if isinstance(old, list) else [])
                   if _entry_name(e) != name]
        entry: Dict[str, Any] = {"file": name, "sha256": sha,
                                 "iteration": int(iteration),
                                 "tag": name[len("checkpoint_"):-len(".zip")]}
        if size is not None:
            entry["bytes"] = int(size)
        if state_dtype is not None:
            entry["state_dtype"] = str(state_dtype)
        if fleet is not None:
            entry["fleet"] = {k: int(v) for k, v in fleet.items()}
        entries.append(entry)
        retained, dropped = entries, []
        if keep_last and len(entries) > keep_last:
            retained, dropped = entries[-keep_last:], entries[:-keep_last]
        if max_total_bytes:
            total = sum(_entry_bytes(directory, e) for e in retained)
            while len(retained) > 1 and total > max_total_bytes:
                total -= _entry_bytes(directory, retained[0])
                dropped.append(retained[0])
                retained = retained[1:]
                OpProfiler.get().count("checkpoint/bytes_gc")
        write_manifest(directory, retained,
                       incarnation=max(current, int(incarnation or 0)))
    for e in dropped:
        try:
            os.remove(os.path.join(directory, _entry_name(e)))
        except FileNotFoundError:
            pass


def commit_checkpoint(directory: str, tag: str, data: bytes, iteration: int,
                      keep_last: int, max_total_bytes: Optional[int] = None,
                      seq: Optional[int] = None,
                      incarnation: Optional[int] = None,
                      state_dtype: Optional[str] = None,
                      fleet: Optional[Dict[str, Any]] = None) -> str:
    """Commit one checkpoint atomically and fold it into the manifest with
    retention; returns its path. One writer per directory. ``seq`` is the
    ``checkpoint/pre_rename`` fault index (the writer's commit ordinal).
    ``fleet``: provenance of a fleet's commit, recorded on the manifest
    entry (``{"members": M}``, plus ``"member": k`` for one member)."""
    if incarnation is not None \
            and manifest_incarnation(directory) > int(incarnation):
        raise StaleIncarnationError(
            f"writer incarnation {incarnation} is stale: {directory} was "
            f"claimed by incarnation {manifest_incarnation(directory)}")
    name = f"checkpoint_{tag}.zip"
    path = os.path.join(directory, name)
    _atomic_write(path, data, seq=seq)
    _append_and_retain(directory, name, hashlib.sha256(data).hexdigest(),
                       iteration, keep_last, size=len(data),
                       max_total_bytes=max_total_bytes,
                       incarnation=incarnation, state_dtype=state_dtype,
                       fleet=fleet)
    prof = OpProfiler.get()
    prof.count("checkpoint/committed")
    prof.count("checkpoint/bytes", len(data))
    flightrec.event("checkpoint/commit", tag=tag, file=name,
                    iteration=int(iteration), bytes=len(data))
    return path


def committed_checkpoints(directory: str) -> List[str]:
    """Committed checkpoint paths, oldest first: the manifest's order, or
    an iteration-ordered directory scan without one."""
    entries = read_manifest(directory)
    if entries:
        paths = (os.path.join(directory, _entry_name(e)) for e in entries)
        return [p for p in paths if os.path.exists(p)]
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    cands = [os.path.join(directory, f) for f in names
             if f.startswith("checkpoint_") and f.endswith(".zip")]
    return [p for _, _, p in sorted(
        (_checkpoint_iteration(p), os.path.getmtime(p), p) for p in cands)]


def register_committed(directory: str, path: str, iteration: int,
                       keep_last: int, max_total_bytes: Optional[int] = None,
                       incarnation: Optional[int] = None) -> None:
    """Fold a file written by ``model.save`` (SameDiff's path) into the
    manifest, with retention."""
    try:
        size: Optional[int] = os.path.getsize(path)
    except OSError:
        size = None
    _append_and_retain(directory, os.path.basename(path), _sha256_file(path),
                       iteration, keep_last, size=size,
                       max_total_bytes=max_total_bytes,
                       incarnation=incarnation)


def clean_stale_tmp(directory: str) -> int:
    """Remove the ``*.tmp`` of writes torn before their rename."""
    n = 0
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return 0
    for f in names:
        if f.endswith(".tmp"):
            try:
                os.remove(os.path.join(directory, f))
                n += 1
            except OSError:
                pass
    return n


# --------------------------------------------------------------------------
# verified reads
# --------------------------------------------------------------------------

def _zip_intact(path: str) -> bool:
    try:
        with zipfile.ZipFile(path) as zf:
            if zf.testzip() is not None:
                return False
            json.loads(zf.read(META_ENTRY))
        return True
    except (zipfile.BadZipFile, OSError, KeyError, ValueError):
        return False


def _checkpoint_iteration(path: str) -> int:
    try:
        with zipfile.ZipFile(path) as zf:
            return int(json.loads(zf.read(META_ENTRY)).get("iteration", -1))
    except (zipfile.BadZipFile, OSError, KeyError, ValueError):
        return -1


def verify_checkpoint(directory: str, entry: Any) -> Optional[str]:
    """One manifest entry → its path when the file is intact (format 2:
    its sha256; format 1: the zip CRC), else None with a warning."""
    if isinstance(entry, str):
        path = entry if os.path.isabs(entry) else os.path.join(
            directory, os.path.basename(entry))
        if os.path.exists(path) and _zip_intact(path):
            return path
        logger.warning("checkpoint %s missing or corrupt; skipping", path)
        return None
    if entry.get("quarantined"):
        logger.warning("checkpoint %s is quarantined (%s); skipping",
                       entry.get("file"),
                       entry.get("quarantine_reason", "scrub"))
        return None
    path = os.path.join(directory, entry["file"])
    if not os.path.exists(path):
        logger.warning("checkpoint %s indexed but missing; skipping", path)
        return None
    if _sha256_file(path) != entry.get("sha256"):
        logger.warning("checkpoint %s fails its manifest checksum "
                       "(truncated or bit-flipped write); skipping", path)
        return None
    return path


def _update_entry(directory: str, name: str, mutate) -> bool:
    """Locked read-modify-write of one manifest entry (by file name).
    Returns whether an entry was found and rewritten."""
    with _MANIFEST_LOCK:
        doc = read_manifest_doc(directory)
        entries = doc.get("checkpoints", [])
        if not isinstance(entries, list):
            return False
        hit = False
        for e in entries:
            if isinstance(e, dict) and e.get("file") == name:
                mutate(e)
                hit = True
        if hit:
            write_manifest(directory, entries)
        return hit


def quarantine_checkpoint(directory: str, name: str,
                          reason: str = "") -> bool:
    """Mark one generation quarantined in the manifest. The file is never
    deleted (a rotten checkpoint is evidence), and every reader
    (:func:`verify_checkpoint`, :func:`last_checkpoint`,
    :func:`scan_newest_intact`) skips it from now on, even if a later
    re-hash passes: quarantine is sticky."""
    def mut(e):
        e["quarantined"] = True
        e["quarantine_reason"] = str(reason)[:200]
        e["quarantine_t"] = time.time()
    hit = _update_entry(directory, name, mut)
    if hit:
        OpProfiler.get().count("integrity/quarantined_checkpoints")
        flightrec.event("integrity/quarantine", severity="warn",
                        file=name, reason=str(reason)[:200])
        logger.warning("checkpoint %s quarantined: %s", name, reason)
    return hit


def record_scrub(directory: str, name: str, ok: bool,
                 reason: str = "") -> bool:
    """Fold one scrub verdict into the manifest: a pass stamps the entry
    with ``scrub = {ok, t}``; a fail quarantines the generation."""
    if not ok:
        return quarantine_checkpoint(
            directory, name, reason or "scrub checksum mismatch")

    def mut(e):
        e["scrub"] = {"ok": True, "t": time.time()}
    return _update_entry(directory, name, mut)


def last_checkpoint(directory: str,
                    require_scrubbed: bool = False) -> Optional[str]:
    """The newest checkpoint that proves intact: the manifest newest →
    oldest (quarantined generations skipped), then the directory scan.
    ``require_scrubbed`` prefers the newest scrub-verified generation and
    falls back to the ordinary walk (which re-hashes at read time) with a
    warning when no scrub pass has stamped anything yet."""
    entries = read_manifest(directory)
    if require_scrubbed:
        for entry in reversed(entries):
            if (isinstance(entry, dict) and not entry.get("quarantined")
                    and (entry.get("scrub") or {}).get("ok")):
                path = verify_checkpoint(directory, entry)
                if path is not None:
                    return path
        logger.warning(
            "no scrub-verified checkpoint in %s; falling back to the "
            "newest checksum-verified generation", directory)
    for entry in reversed(entries):
        path = verify_checkpoint(directory, entry)
        if path is not None:
            return path
    return scan_newest_intact(directory)


def verify_group_commit(directory: str, tag: str) -> Optional[str]:
    """A non-zero rank's check after a group commit's publish barrier: the
    manifest names ``checkpoint_<tag>.zip`` and its checksum verifies.
    Returns the verified path, or None (absent from the manifest, torn, or
    quarantined: :func:`verify_checkpoint` refuses quarantined
    generations). The directory scan is not consulted: a group commit is
    published by the manifest alone."""
    name = f"checkpoint_{tag}.zip"
    for entry in reversed(read_manifest(directory)):
        if _entry_name(entry) == name:
            return verify_checkpoint(directory, entry)
    return None


def scan_newest_intact(directory: str) -> Optional[str]:
    """Without a manifest: the intact ``checkpoint_*.zip`` (zip CRC and
    meta entry) with the highest iteration (newest mtime on a tie),
    skipping generations the manifest marks quarantined."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return None
    quarantined = {_entry_name(e) for e in read_manifest(directory)
                   if isinstance(e, dict) and e.get("quarantined")}
    cands = []
    for f in names:
        if not (f.startswith("checkpoint_") and f.endswith(".zip")) \
                or f in quarantined:
            continue
        path = os.path.join(directory, f)
        if _zip_intact(path):
            cands.append((_checkpoint_iteration(path),
                          os.path.getmtime(path), path))
        else:
            logger.warning("checkpoint %s is corrupt; skipping", path)
    return max(cands)[2] if cands else None


# --------------------------------------------------------------------------
# resume
# --------------------------------------------------------------------------

def read_resume_state(path: str) -> Dict[str, Any]:
    """The ``resume.json`` payload ({} for a plain model zip)."""
    with zipfile.ZipFile(path) as zf:
        if RESUME_ENTRY not in zf.namelist():
            return {}
        return json.loads(zf.read(RESUME_ENTRY))


def read_checkpoint_params(path: str, params_template, states_template):
    """Just (params, states) of a checkpoint or model zip, as CPU tensors
    in the templates' tree shapes (leaf counts and shapes checked), without
    touching a model: the serving tier's canaried publication reads its
    candidate weights so. The caller owns device placement."""
    with zipfile.ZipFile(path) as zf:
        pt = tree_leaves(params_template)
        params = _checked("coefficient", load_leaves(
            zf.read(COEFF_ENTRY), "coefficient", len(pt)), pt, cast=False)
        st = tree_leaves(states_template)
        states = _checked("state", load_leaves(
            zf.read(STATES_ENTRY), "state", len(st)), st, cast=False)
    return _unflatten(params_template, params), _unflatten(states_template,
                                                           states)


def _restore_generator(model, resume: Dict[str, Any], path: str) -> None:
    saved = resume.get(GENERATOR_KEY)
    gen = model.generator()
    if saved is not None and saved.get("device") == gen.device.type:
        state = torch.frombuffer(bytearray(base64.b64decode(saved["state"])),
                                 dtype=torch.uint8)
        gen.set_state(state)
        return
    seed = (resume.get("rng") or {}).get("seed")
    if seed is None:
        return
    # a JAX-written checkpoint's stream is a threefry key: reseed
    gen.manual_seed(int(seed))
    logger.info("checkpoint %s carries no torch.Generator state for %s; the "
                "network's generator was reseeded from rng.seed=%d",
                os.path.basename(path), gen.device.type, int(seed))


def restore_training_state(model, path: str, listeners=None,
                           restore_rng: bool = True,
                           convert_state_dtype: bool = False
                           ) -> Dict[str, int]:
    """Load a checkpoint into an initialized model and return its pipeline
    cursor ``{"epochs_done", "steps_in_epoch"}``: parameters, layer states,
    updater state (refused when its dtype disagrees with the configured
    ``state_dtype``, unless ``convert_state_dtype``), iteration, epoch, the
    generator (see the module docstring for a JAX-written file) and the
    listeners' state."""
    with zipfile.ZipFile(path) as zf:
        load_state_entries(zf, model, load_updater=True,
                           convert_state_dtype=convert_state_dtype)
        # the accumulator state stays raw bytes until a wrapper with the
        # owning accumulator reads it against its own template
        model._acc_blob = (zf.read(ACC_ENTRY)
                           if ACC_ENTRY in zf.namelist() else None)
        model._acc_state = None
    resume = read_resume_state(path)
    if restore_rng:
        _restore_generator(model, resume, path)
    if listeners and resume.get("listener_state"):
        restore_listener_state(listeners, resume["listener_state"])
    cursor = resume.get("cursor") or {}
    if cursor.get("workers") is not None:
        # informational: the on-disk layout does not depend on it
        model._ckpt_workers = int(cursor["workers"])
        logger.info("checkpoint %s was taken under %d data-parallel "
                    "worker(s)", os.path.basename(path), model._ckpt_workers)
    if cursor.get("stages") is not None:
        # informational too: the pipeline's layout on disk is per layer
        model._ckpt_stages = int(cursor["stages"])
        logger.info("checkpoint %s was taken under %d pipeline stage(s)",
                    os.path.basename(path), model._ckpt_stages)
    flightrec.event("checkpoint/restore", file=os.path.basename(path),
                    epochs_done=int(cursor.get("epochs_done", 0)),
                    steps_in_epoch=int(cursor.get("steps_in_epoch", 0)))
    return {"epochs_done": int(cursor.get("epochs_done", 0)),
            "steps_in_epoch": int(cursor.get("steps_in_epoch", 0))}


def begin_fit_cursor(model, resume_from: Optional[str], listeners=None,
                     keep_flat: bool = False):
    """The resume setup of every fit: restore ``resume_from`` into the
    model and anchor the cursor (``_fit_epoch0`` pins epoch counting to
    the logical run; ``_steps_in_epoch`` counts the steps taken in the
    current epoch). Returns the pipeline's ``skip`` tuple, or None for a
    fresh fit. ``keep_flat``: a ZeRO-1 fit takes a flat updater state as
    it is; every other fit gets a flat state (left by a ZeRO-1 fit) as
    the dense tree first."""
    if not keep_flat:
        _ensure_dense_updater_layout(model)
    # the stage count is per-fit metadata: a later fit that is not a
    # pipeline's must not stamp it (PipelineTrainer.fit sets it again)
    if hasattr(model, "_live_stages"):
        del model._live_stages
    if resume_from is None:
        model._fit_epoch0 = model._epoch
        model._steps_in_epoch = 0
        return None
    cursor = restore_training_state(model, resume_from, listeners=listeners)
    model._fit_epoch0 = model._epoch - cursor["epochs_done"]
    model._steps_in_epoch = cursor["steps_in_epoch"]
    return (cursor["epochs_done"], cursor["steps_in_epoch"])


def _ensure_dense_updater_layout(model) -> None:
    """A flat (ZeRO-1) updater state left on the model by a wrapper fit,
    turned back into the dense tree like the parameters; a no-op for a
    dense state or None."""
    if is_flat_state(getattr(model, "_updater_state", None)):
        model._updater_state = unflatten_updater_state(
            model._updater_state, model._params)


# --------------------------------------------------------------------------
# async writer
# --------------------------------------------------------------------------

class CheckpointWriter:
    """One background thread that serializes snapshots and commits them,
    so the training loop never waits on the zip or the disk. The queue is
    2 deep: checkpoints that outrun the disk push back on ``submit``. A
    failed write is logged and kept in ``errors``; the manifest is
    untouched, so ``last_checkpoint`` keeps the previous intact file.
    ``commit_seconds`` holds the serialize-and-commit time of each
    checkpoint, off the training thread."""

    def __init__(self, directory: str, keep_last: int = 3, on_commit=None,
                 max_total_bytes: Optional[int] = None,
                 incarnation: Optional[int] = None):
        self.dir = directory
        self.keep_last = keep_last
        self.max_total_bytes = max_total_bytes
        self.incarnation = incarnation
        self.errors: List[BaseException] = []
        self.commit_seconds: List[float] = []
        self._on_commit = on_commit
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._pending = 0
        self._seq = 0
        self._cond = threading.Condition()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dl4j-ckpt-writer")
        self._thread.start()

    def submit(self, snapshot: Dict[str, Any], tag: str) -> None:
        with self._cond:
            self._pending += 1
            seq = self._seq
            self._seq += 1
        self._q.put((snapshot, tag, seq))

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            snapshot, tag, seq = job
            try:
                t0 = time.perf_counter()
                data = serialize_snapshot(snapshot)
                path = commit_checkpoint(
                    self.dir, tag, data, snapshot["iteration"],
                    self.keep_last, max_total_bytes=self.max_total_bytes,
                    seq=seq, incarnation=self.incarnation,
                    state_dtype=snapshot.get("state_dtype"))
                self.commit_seconds.append(time.perf_counter() - t0)
                if self._on_commit is not None:
                    self._on_commit(path)
            except Exception as e:    # kept in errors and logged, not lost
                self.errors.append(e)
                logger.warning("async checkpoint %s failed: %s", tag, e,
                               exc_info=True)
            finally:
                with self._cond:
                    self._pending -= 1
                    self._cond.notify_all()

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted checkpoint is committed or failed;
        False when ``timeout`` ran out first."""
        with self._cond:
            return self._cond.wait_for(lambda: self._pending == 0, timeout)

    def close(self, timeout: float = 30.0) -> None:
        drained = self.flush(timeout)
        try:
            self._q.put(None, timeout=5.0 if drained else 1.0)
        except queue.Full:
            logger.warning("checkpoint writer did not drain within %.0fs; "
                           "abandoning it (daemon thread)", timeout)
        self._thread.join(timeout)
