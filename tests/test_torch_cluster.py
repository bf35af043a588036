"""The port's cluster runtime and process supervisor against the JAX
package's drills (``tests/test_cluster.py``).

Every fault is deterministic: injected at the four cluster sites
(``cluster/init``, ``cluster/heartbeat``, ``cluster/barrier``,
``cluster/commit``) or staged with real OS processes killed or preempted
on cue, and every diagnosis is asserted as the JAX tests assert it: the
bring-up deadline names the coordinator and the ranks that reported, the
barrier timeout names the missing ranks with their heartbeat staleness,
the supervisor classifies 75 as preempted and a stale-while-alive rank as
a hang, a torn group commit leaves the previous generation restorable, and
a shrink-to-survivors relaunch resumes bitwise against a fresh (N-1)-rank
run through ``Zero1Plan``'s replica-count-independent layout. The hang
drill also checks the watchtower's incident, as the JAX drill does: one
incident whose chain runs from the lost rank to the relaunched group's
formation, the merged per-rank blackboxes attached.

Every subprocess has a timeout and is reaped in ``finally``.
"""

import glob
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from deeplearning4j_tpu.parallel import cluster as jcluster
from deeplearning4j_tpu_torch.common import faultinject, flightrec, watchtower
from deeplearning4j_tpu_torch.parallel import cluster
from deeplearning4j_tpu_torch.parallel.distributed import supervise_processes
from deeplearning4j_tpu_torch.util import checkpoint as ckpt_util

REPO_ROOT = str(Path(__file__).resolve().parents[1])


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.clear_plan()
    yield
    faultinject.clear_plan()
    faultinject.release_wedges()
    watchtower.uninstall()


def _plan(*specs):
    faultinject.set_plan(faultinject.FaultPlan(list(specs)))


def _plant_heartbeat(cluster_dir, rank, age_s=0.0):
    """A peer's heartbeat file as another process would leave it."""
    with open(cluster.heartbeat_path(str(cluster_dir), rank), "w") as f:
        json.dump({"rank": rank, "pid": 0, "incarnation": 0, "seq": 1,
                   "t_wall": time.time() - age_s, "cadence_s": 0.25}, f)


def _last_event(name):
    rows = [e for e in flightrec.get().snapshot() if e["name"] == name]
    return rows[-1] if rows else None


# ---------------------------------------------------------------------------
# bring-up: bounded retries, deadline diagnosis
# ---------------------------------------------------------------------------

class TestBringUp:
    def test_form_retries_transient_init_fault(self, tmp_path):
        _plan({"site": "cluster/init", "kind": "transient", "times": 1})
        rt = cluster.ClusterRuntime(str(tmp_path), 0, 1,
                                    init_backoff_base_s=0.01)
        try:
            rt.form()
            assert rt.formed
            assert rt.form_attempts == 2
            ev = _last_event("cluster/form")
            assert ev is not None
            assert ev["attrs"]["rank"] == 0
            assert ev["attrs"]["attempts"] == 2
            # the route chosen by rule rides the event
            assert ev["attrs"]["backend"] == "gloo"
            assert ev["attrs"]["device"] == "cpu"
        finally:
            rt.shutdown()

    def test_init_deadline_failure_names_full_diagnosis(self, tmp_path):
        def refused(coordinator, world, rank, timeout_s):
            raise ConnectionRefusedError(f"connect to {coordinator}: "
                                         "connection refused")

        _plant_heartbeat(tmp_path, 1)
        rt = cluster.ClusterRuntime(str(tmp_path), 0, 2,
                                    coordinator="198.51.100.7:9999",
                                    init_deadline_s=0.5,
                                    init_backoff_base_s=0.05,
                                    init_backoff_max_s=0.1)
        try:
            with pytest.raises(cluster.ClusterInitError) as ei:
                rt.form(initialize_fn=refused)
        finally:
            rt.shutdown()
        e = ei.value
        msg = str(e)
        assert "198.51.100.7:9999" in msg
        assert "ranks that reported a heartbeat: [0, 1]" in msg
        assert "connection refused" in msg
        assert e.coordinator == "198.51.100.7:9999"
        assert e.attempts >= 2
        assert 0.0 < e.elapsed_s < 5.0
        assert e.reported_ranks == [0, 1]
        assert not rt.formed

    def test_dead_local_coordinator_fails_inside_deadline(self, tmp_path):
        """The real bring-up path: a non-zero rank whose coordinator never
        listens probes, retries, and fails inside its deadline."""
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()                      # nobody listens there
        rt = cluster.ClusterRuntime(str(tmp_path), 1, 2,
                                    coordinator=f"127.0.0.1:{port}",
                                    init_deadline_s=1.0,
                                    init_backoff_base_s=0.05,
                                    init_backoff_max_s=0.2)
        t0 = time.monotonic()
        try:
            with pytest.raises(cluster.ClusterInitError) as ei:
                rt.form()
        finally:
            rt.shutdown()
        assert time.monotonic() - t0 < 5.0
        assert ei.value.reported_ranks == [1]
        assert f"127.0.0.1:{port}" in str(ei.value)

    @pytest.mark.parametrize("world,cards,device,want", [
        (2, 0, "cpu", "gloo"), (2, 1, "cuda", "gloo"),
        (4, 4, "cuda", "nccl"), (2, 4, "cuda", "nccl")])
    def test_backend_is_chosen_by_rule(self, monkeypatch, world, cards,
                                       device, want):
        import torch

        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        assert cluster.choose_backend(world, torch.device(device)) == want

    def test_cpu_collectives_probe(self):
        import torch.distributed as dist

        assert cluster.cpu_multiprocess_collectives_available() == \
            dist.is_gloo_available()


# ---------------------------------------------------------------------------
# heartbeats, the deadline-diagnosed barrier
# ---------------------------------------------------------------------------

class TestHeartbeatsAndBarrier:
    def test_heartbeat_wedge_goes_stale_while_process_lives(self, tmp_path):
        _plan({"site": "cluster/heartbeat", "kind": "wedge", "index": 1,
               "seconds": 30.0})
        rt = cluster.ClusterRuntime(str(tmp_path), 0, 1,
                                    heartbeat_interval_s=0.05)
        try:
            rt.start_heartbeat()
            time.sleep(0.7)
            assert cluster.stale_ranks(str(tmp_path), 0.4, world=1) == [0]
        finally:
            faultinject.release_wedges()
            rt.shutdown()

    def test_heartbeat_slow_beat_recovers(self, tmp_path):
        _plan({"site": "cluster/heartbeat", "kind": "slow", "index": 1,
               "seconds": 0.4})
        rt = cluster.ClusterRuntime(str(tmp_path), 0, 1,
                                    heartbeat_interval_s=0.05)
        try:
            rt.start_heartbeat()
            time.sleep(0.25)
            assert cluster.stale_ranks(str(tmp_path), 0.15, world=1) == [0]
            time.sleep(0.5)
            assert cluster.stale_ranks(str(tmp_path), 0.25, world=1) == []
        finally:
            rt.shutdown()

    def test_never_beaten_rank_needs_world_to_be_reported(self, tmp_path):
        _plant_heartbeat(tmp_path, 0, age_s=3.0)
        assert cluster.stale_ranks(str(tmp_path), 1.0) == [0]
        assert cluster.stale_ranks(str(tmp_path), 1.0, world=3) == [0, 1, 2]
        # the JAX reader sees the same files the same way
        assert jcluster.stale_ranks(str(tmp_path), 1.0, world=3) == \
            [0, 1, 2]

    def test_barrier_timeout_names_missing_ranks_and_staleness(
            self, tmp_path):
        rt = cluster.ClusterRuntime(str(tmp_path), 0, 3)
        _plant_heartbeat(tmp_path, 2, age_s=5.0)
        with pytest.raises(cluster.BarrierTimeout) as ei:
            rt.barrier("epoch-fence", deadline_s=0.3)
        e = ei.value
        assert e.missing == [1, 2]
        assert e.staleness[1] is None
        assert 4.0 < e.staleness[2] < 8.0
        msg = str(e)
        assert "rank 1: no heartbeat ever" in msg
        assert "rank 2: heartbeat" in msg and "stale" in msg
        ev = _last_event("cluster/barrier")
        assert ev["sev"] == "error"
        assert ev["attrs"]["rank"] == 0
        assert ev["attrs"]["missing"] == [1, 2]
        assert os.path.exists(
            os.path.join(str(tmp_path), "blackbox-rank0.jsonl"))

    def test_barrier_crash_drill_fires_before_the_token(self, tmp_path):
        _plan({"site": "cluster/barrier", "kind": "crash", "mode": "raise"})
        rt = cluster.ClusterRuntime(str(tmp_path), 0, 2)
        with pytest.raises(faultinject.SimulatedCrash):
            rt.barrier("epoch-fence", deadline_s=0.2)
        assert glob.glob(os.path.join(str(tmp_path), "bar-*")) == []

    def test_barrier_completes_when_all_tokens_land(self, tmp_path):
        a = cluster.ClusterRuntime(str(tmp_path), 0, 2)
        b = cluster.ClusterRuntime(str(tmp_path), 1, 2)
        t = threading.Thread(
            target=lambda: b.barrier("sync", deadline_s=5.0))
        t.start()
        a.barrier("sync", deadline_s=5.0)
        t.join(5.0)
        assert not t.is_alive()


# ---------------------------------------------------------------------------
# the group checkpoint commit
# ---------------------------------------------------------------------------

class TestGroupCommit:
    def _rt(self, tmp_path, rank=0, world=1):
        return cluster.ClusterRuntime(str(tmp_path / "cd"), rank, world)

    def test_commit_publishes_a_verifiable_generation(self, tmp_path):
        rt = self._rt(tmp_path)
        ck = str(tmp_path / "ck")
        os.makedirs(ck)
        rt.claim_commit_incarnation(ck)
        path = rt.commit_group_checkpoint(ck, "it3", b"generation-3", 3)
        assert os.path.basename(path) == "checkpoint_it3.zip"
        assert ckpt_util.verify_group_commit(ck, "it3") == path
        assert ckpt_util.verify_group_commit(ck, "it99") is None
        # a quarantined generation is refused
        ckpt_util.quarantine_checkpoint(ck, "checkpoint_it3.zip", "scrub")
        assert ckpt_util.verify_group_commit(ck, "it3") is None

    def test_kill_during_commit_leaves_previous_generation(self, tmp_path):
        rt = self._rt(tmp_path)
        ck = str(tmp_path / "ck")
        os.makedirs(ck)
        rt.claim_commit_incarnation(ck)
        first = rt.commit_group_checkpoint(ck, "it3", b"generation-3", 3)
        _plan({"site": "cluster/commit", "kind": "crash", "mode": "raise",
               "index": 1})
        with pytest.raises(faultinject.SimulatedCrash):
            rt.commit_group_checkpoint(ck, "it6", b"generation-6", 6)
        assert ckpt_util.verify_group_commit(ck, "it6") is None
        assert ckpt_util.last_checkpoint(ck) == first
        assert ckpt_util.verify_group_commit(ck, "it3") == first

    def test_stale_incarnation_cannot_commit_over_replacement(self,
                                                              tmp_path):
        ck = str(tmp_path / "ck")
        os.makedirs(ck)
        old = self._rt(tmp_path)
        old.claim_commit_incarnation(ck)
        new = cluster.ClusterRuntime(str(tmp_path / "cd2"), 0, 1)
        new.claim_commit_incarnation(ck)
        with pytest.raises(ckpt_util.StaleIncarnationError):
            old.commit_group_checkpoint(ck, "late", b"zombie-write", 9)
        new.commit_group_checkpoint(ck, "it1", b"generation-1", 1)
        assert ckpt_util.verify_group_commit(ck, "it1") is not None

    def test_only_rank_zero_claims_the_fence(self, tmp_path):
        rt = cluster.ClusterRuntime(str(tmp_path / "cd"), 1, 2)
        with pytest.raises(cluster.GroupCommitError):
            rt.claim_commit_incarnation(str(tmp_path / "ck"))

    def test_two_ranks_commit_and_verify(self, tmp_path):
        """Both halves of the protocol in one process: rank 1 verifies
        what rank 0 published, and the JAX package's reader agrees."""
        from deeplearning4j_tpu.util import checkpoint as jckpt

        ck = str(tmp_path / "ck")
        os.makedirs(ck)
        a, b = self._rt(tmp_path, 0, 2), self._rt(tmp_path, 1, 2)
        a.claim_commit_incarnation(ck)
        got = {}
        t = threading.Thread(target=lambda: got.setdefault(
            1, b.commit_group_checkpoint(ck, "it2", b"", 2)))
        t.start()
        got[0] = a.commit_group_checkpoint(ck, "it2", b"payload", 2)
        t.join(10.0)
        assert got[0] == got[1]
        assert jckpt.verify_group_commit(ck, "it2") == got[0]


# ---------------------------------------------------------------------------
# per-rank blackboxes
# ---------------------------------------------------------------------------

class TestBlackboxes:
    def test_merge_orders_by_wallclock_with_rank_lanes(self, tmp_path):
        a = cluster.ClusterRuntime(str(tmp_path), 0, 2, incarnation=3)
        b = cluster.ClusterRuntime(str(tmp_path), 1, 2, incarnation=3)
        flightrec.event("cluster/form", rank=0, world=2)
        a.dump_rank_blackbox()
        b.dump_rank_blackbox()
        merged = cluster.merge_rank_blackboxes(str(tmp_path))
        assert merged, "blackbox merge lost every row"
        assert {r["rank"] for r in merged} == {0, 1}
        assert all(r["incarnation"] == 3 for r in merged)
        ts = [r["t"] for r in merged]
        assert ts == sorted(ts)


# ---------------------------------------------------------------------------
# the process supervisor's exit-code contract (real OS processes)
# ---------------------------------------------------------------------------

_SUP_WORKER = r"""
import os, sys, time
from deeplearning4j_tpu_torch.parallel import cluster

cluster_dir, ckpt_dir, rank, world, mode = (
    sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
    sys.argv[5])
att = os.environ.get("DL4J_ATTEMPT", "0")
rt = cluster.ClusterRuntime(cluster_dir, rank, world,
                            heartbeat_interval_s=0.05,
                            incarnation=int(att))
rt.form()
rt.dump_rank_blackbox()

if mode == "preempt" and att == "0":
    # the group commits the resumable state, then rank 0 exits 75
    if rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        rt.claim_commit_incarnation(ckpt_dir)
    rt.commit_group_checkpoint(ckpt_dir, "evict", b"resumable-state", 1,
                               barrier_deadline_s=20.0)
    if rank == 0:
        time.sleep(0.2)
        sys.exit(75)
if mode == "hang" and att == "0":
    if rank == world - 1:
        # a wedged collective: alive, no more beats, and a marker that
        # says so
        rt.stop_heartbeat()
        open(ckpt_dir + ".wedged", "w").close()
        time.sleep(120)
    # the healthy ranks beat on until the supervisor reaps them
    time.sleep(120)
if att != "0":
    # the relaunched group beats together for a while, so the supervisor
    # sees every rank fresh at one poll (its cluster/form) however slowly
    # the ranks started
    rt.barrier("relaunched", deadline_s=60.0)
time.sleep(3.0 if att == "0" else 1.0)
# leave at once: an interpreter that imported torch takes a while to
# finalize with its heartbeat stopped
sys.stdout.flush()
os._exit(0)
"""


def _worker_env():
    return {"PYTHONPATH": REPO_ROOT + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""),
        "OMP_NUM_THREADS": "1"}


def _write_worker(tmp_path, body):
    script = tmp_path / "worker.py"
    script.write_text(body)
    return script


class TestSuperviseContract:
    def test_preempted_exit_returns_resumable_with_checkpoint(
            self, tmp_path):
        script = _write_worker(tmp_path, _SUP_WORKER)
        cd, ck = str(tmp_path / "cd"), str(tmp_path / "ck")
        cmds = [[sys.executable, str(script), cd, ck, str(r), "2",
                 "preempt"] for r in range(2)]
        summary = supervise_processes(
            cmds, env=_worker_env(),
            make_env=lambda attempt: {"DL4J_ATTEMPT": str(attempt)},
            cluster_dir=cd, heartbeat_stale_s=10.0,
            max_restarts=2, backoff_base_s=0.05, kill_grace_s=2.0,
            timeout_s=120.0)
        assert summary["status"] == "preempted"
        assert summary["resumable"] is True
        assert summary["restarts"] == 0
        row = summary["history"][0]
        assert row["failed_rank"] == 0
        assert row["classes"][0] == "preempted"
        assert row["classes"][1] == "terminated"
        assert ckpt_util.last_checkpoint(ck) is not None
        assert ckpt_util.verify_group_commit(ck, "evict") is not None

    def test_heartbeat_stale_rank_is_hang_not_crash(self, tmp_path):
        # the staleness is many times any scheduling delay of a beat every
        # 0.05 s, so only the wedged rank (which stopped beating, and says
        # so in a marker) can read as hung
        script = _write_worker(tmp_path, _SUP_WORKER)
        cd, ck = str(tmp_path / "cd"), str(tmp_path / "ck")
        tower = watchtower.install(watchtower.Watchtower(
            [], incident_dir=str(tmp_path / "inc"), interval_s=0.05,
            finalize_after_s=60.0))
        cmds = [[sys.executable, str(script), cd, ck, str(r), "2", "hang"]
                for r in range(2)]
        summary = supervise_processes(
            cmds, env=_worker_env(),
            make_env=lambda attempt: {"DL4J_ATTEMPT": str(attempt)},
            cluster_dir=cd, heartbeat_stale_s=4.0,
            max_restarts=2, backoff_base_s=0.05, kill_grace_s=2.0,
            storm_min_uptime_s=0.0, timeout_s=120.0)
        assert os.path.exists(ck + ".wedged")
        assert summary["status"] == "completed"
        assert summary["restarts"] == 1
        row = summary["history"][0]
        assert row["failed_rank"] == 1
        assert row["classes"] == {0: "terminated", 1: "hang"}
        lost = _last_event("cluster/rank_lost")
        assert lost["attrs"]["rank"] == 1
        assert lost["attrs"]["class"] == "hang"
        assert lost["attrs"]["hung"] is True
        restart = _last_event("cluster/group_restart")
        assert restart["attrs"]["world_from"] == 2
        assert restart["attrs"]["world_to"] == 2
        # the events the incident is built from: cause, mitigation, then
        # the relaunched group's formation
        names = [e["name"] for e in flightrec.get().snapshot()]
        i = names.index("cluster/rank_lost")
        assert "cluster/group_restart" in names[i:]
        assert "cluster/form" in names[names.index(
            "cluster/group_restart", i):]
        assert row["rank_blackbox_rows"] > 0
        # ONE incident, finalized once the recovery landed, with the
        # merged per-rank blackboxes attached
        tower.evaluate_now()
        incs = tower.incidents()
        assert len(incs) == 1
        report = json.loads(Path(incs[0]["path"]).read_text())
        assert report["complete"] is True
        assert report["chain"]["cause"]["name"] == "cluster/rank_lost"
        assert report["chain"]["cause"]["attrs"]["rank"] == 1
        assert report["chain"]["mitigation"]["name"] == \
            "cluster/group_restart"
        assert report["chain"]["recovery"]["name"] == "cluster/form"
        att = report["attachments"]
        assert att["lost_rank"] == 1 and att["class"] == "hang"
        ranks = {r.get("rank") for r in att["rank_blackboxes"]}
        assert 0 in ranks or 1 in ranks


# ---------------------------------------------------------------------------
# elastic shrink-to-survivors: bitwise against a fresh (N-1) run
# ---------------------------------------------------------------------------

_Z1_TRAINER = r"""
import io, json, os, sys
import numpy as np
import torch
from deeplearning4j_tpu_torch.parallel import cluster
from deeplearning4j_tpu_torch.parallel.sharding import Zero1Plan
from deeplearning4j_tpu_torch.util import checkpoint as ckpt

(cluster_dir, ckpt_dir, log_path, rank, world, total_iters, crash_rank,
 crash_iter) = (sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]),
                int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7]),
                int(sys.argv[8]))
att = os.environ.get("DL4J_ATTEMPT", "0")
N = 25   # odd: 3-way padding (27) differs from 2-way padding (26)

rt = cluster.ClusterRuntime(cluster_dir, rank, world,
                            heartbeat_interval_s=0.05,
                            incarnation=int(att))
rt.form()
rt.dump_rank_blackbox()
plan = Zero1Plan({"w": torch.zeros(N)}, world)
bucket = plan.buckets[0]
key, shard, padded = bucket.key, bucket.shard, bucket.padded
lo, hi = rank * shard, (rank + 1) * shard

params = np.linspace(-1.0, 1.0, N).astype(np.float32)
m = np.zeros(padded, np.float32)
start_it = 0
last = ckpt.last_checkpoint(ckpt_dir) if os.path.isdir(ckpt_dir) else None
if last is not None:
    with np.load(last) as z:
        params = z["params"]
        start_it = int(z["iteration"])
        stored = {"m": {key: torch.from_numpy(z["m"])}}
    # the flat layout does not depend on the replica count: the shrunk
    # group re-pads the old group's state for its own
    m = plan.reshard_state(stored)["m"][key].numpy().copy()
if rank == 0:
    os.makedirs(ckpt_dir, exist_ok=True)
    rt.claim_commit_incarnation(ckpt_dir)

for it in range(start_it + 1, total_iters + 1):
    gp = np.zeros(padded, np.float32)
    gp[:N] = np.float32(0.05) * params + np.float32(0.001) * np.float32(it)
    m[lo:hi] = np.float32(0.9) * m[lo:hi] + gp[lo:hi]   # own shard only
    mine = os.path.join(cluster_dir, f"m-a{att}-{it}.r{rank}.npy")
    np.save(mine, m[lo:hi])
    rt.barrier(f"step-a{att}", gen=it, deadline_s=30.0)
    m = np.concatenate([
        np.load(os.path.join(cluster_dir, f"m-a{att}-{it}.r{r}.npy"))
        for r in range(world)])
    params = params - (np.float32(0.1) * m)[:N]
    if rank == 0:
        with open(log_path, "a") as f:
            f.write(json.dumps({"iteration": it,
                                "loss": float(np.sum(params))}) + "\n")
    if it % 3 == 0:
        buf = io.BytesIO()
        np.savez(buf, params=params, m=m, iteration=np.int64(it))
        rt.commit_group_checkpoint(ckpt_dir, f"it{it}", buf.getvalue(),
                                   it, seq=it, barrier_deadline_s=30.0)
    if att == "0" and rank == crash_rank and it == crash_iter:
        rt.dump_rank_blackbox()
        os._exit(1)
print("TRAINER", rank, "DONE", flush=True)
"""


def _run_z1_group(script, cluster_dir, ckpt_dir, log_path, world,
                  total_iters):
    """A fresh uninterrupted group run (the baseline)."""
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), cluster_dir, ckpt_dir,
                 log_path, str(r), str(world), str(total_iters), "-1",
                 "-1"],
                env={**os.environ, **_worker_env()},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"baseline rank {r}:\n{err[-2000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(5.0)


def _loss_log(path):
    rows = [json.loads(line) for line in Path(path).read_text().splitlines()]
    return {r["iteration"]: r["loss"] for r in rows}


class TestElasticShrink:
    def test_shrink_to_survivors_resumes_bit_exact(self, tmp_path):
        script = _write_worker(tmp_path, _Z1_TRAINER)
        total = 12
        base_log = str(tmp_path / "base.jsonl")
        _run_z1_group(script, str(tmp_path / "bcd"), str(tmp_path / "bck"),
                      base_log, 2, total)
        baseline = _loss_log(base_log)
        assert sorted(baseline) == list(range(1, total + 1))

        cd, ck = str(tmp_path / "cd"), str(tmp_path / "ck")
        log = str(tmp_path / "sup.jsonl")

        def make_commands(world, attempt):
            return [[sys.executable, str(script), cd, ck, log, str(r),
                     str(world), str(total), "2", "5"]
                    for r in range(world)]

        summary = supervise_processes(
            make_commands(3, 0), env=_worker_env(),
            make_env=lambda attempt: {"DL4J_ATTEMPT": str(attempt)},
            cluster_dir=cd, heartbeat_stale_s=15.0,
            make_commands=make_commands, shrink_to_survivors=True,
            min_world=2, max_restarts=2, backoff_base_s=0.05,
            kill_grace_s=2.0, storm_min_uptime_s=0.0, timeout_s=120.0)
        assert summary["status"] == "completed"
        assert summary["world"] == 2
        assert summary["restarts"] == 1
        row = summary["history"][0]
        assert row["failed_rank"] == 2
        assert row["classes"][2] == "crash"
        ev = _last_event("cluster/group_restart")
        assert ev["attrs"]["world_from"] == 3
        assert ev["attrs"]["world_to"] == 2
        final = _loss_log(log)
        assert sorted(final) == list(range(1, total + 1))
        assert final == baseline   # bitwise, not allclose
