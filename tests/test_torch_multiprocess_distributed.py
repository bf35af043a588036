"""Real multi-process training in the port, over ``torch.distributed``'s
gloo backend on the CPU (``tests/test_multiprocess_distributed.py``'s
counterparts, and the route's own contract).

- Two OS processes bring themselves up through the port's
  ``parallel.distributed.initialize``, gather across the process boundary
  and take the JAX test's one data-parallel gradient step: per-process
  gradients ``[-2, -2]`` and ``[-6, -6]`` summed to ``[-8, -8]``.
- A two-rank ``ParallelWrapper`` joined to the group (one replica a rank)
  is bitwise the one-process two-replica wrapper on the same rows: dense,
  ZeRO-1, ZeRO-1 with bfloat16 state (each rank steps its generator past
  the lower ranks' rounding bits), and a model with dropout (each
  replica's forward draws from the stream of its global index).
- Lose one rank of a two-process group: ``supervise_processes`` reaps the
  survivor and relaunches the group, and the relaunched trainer's losses
  are bitwise an uninterrupted run's.
- ``SharedTrainingMaster`` across two ranks with group checkpoints: rank 1
  dies at step 5 of attempt 0, the group restarts from the step-3 group
  commit, and the final parameters are bitwise an uninterrupted two-rank
  run's.
- SIGTERM to both ranks, or to rank 1 alone, of that group mid-run: every
  rank stops after the same step, the group commits one preemption
  checkpoint, both exit 75, and the relaunched group resumes from it to
  the uninterrupted run's final parameters, bitwise.

Every worker runs one intra-op thread (so the CPU sums are the same in
every process), every subprocess has a timeout and is reaped in
``finally``, and every coordinator port comes from ``bind(0)``.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.parallel import cluster as _cluster

REPO_ROOT = str(Path(__file__).resolve().parents[1])

pytestmark = pytest.mark.skipif(
    not _cluster.cpu_multiprocess_collectives_available(),
    reason="this torch has no gloo backend: cross-process collectives "
           "cannot run on the CPU here")

N_ROWS, PER_RANK = 48, 8          # 3 global batches of 16 an epoch

_WORKER = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from deeplearning4j_tpu_torch.common import faultinject
from deeplearning4j_tpu_torch.parallel import distributed

mode, out = sys.argv[1], sys.argv[2]
if len(sys.argv) > 3:
    os.environ["DL4J_TPU_PROC_ID"] = sys.argv[3]
rt = distributed.initialize(init_deadline_s=30.0)
rank = rt.rank
plan = os.environ.get("DL4J_TEST_FAULT_PLAN")
if plan and os.environ.get("DL4J_TEST_FAULT_RANK") == str(rank):
    faultinject.set_plan(faultinject.FaultPlan.from_json(plan))
sys.path.insert(0, os.environ["DL4J_TEST_DIR"])
import mp_model

if mode == "psum":
    from deeplearning4j_tpu_torch.parallel._collectives import (
        ProcessGroupRoute, sum_to)
    route = ProcessGroupRoute()
    got = [v[0] for v in route.gather([[torch.tensor([float(rank + 1)])]])]
    assert torch.cat(got).tolist() == [1.0, 2.0], got
    w = torch.zeros(2, requires_grad=True)
    x = torch.ones(2, 2)
    y = torch.full((2,), 1.0 + 2.0 * rank)
    torch.mean((x @ w - y) ** 2).backward()
    g = sum_to([v[0] for v in route.gather([[w.grad]])])
    assert g.tolist() == [-8.0, -8.0], g
elif mode in ("dense", "zero1", "zero1_bf16", "dropout"):
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                                   ReduceScatterAccumulator)
    model = mp_model.model(mode)
    np.save(out + f".init{rank}.npy", mp_model.flat(model._params))
    b = ParallelWrapper.Builder(model).process_group()
    if mode.startswith("zero1"):
        b.gradients_accumulator(ReduceScatterAccumulator())
    pw = b.build()
    scores = mp_model.Scores()
    pw.set_listeners(scores)
    pw.fit(mp_model.rank_iter(rank), epochs=2)
    np.save(out + f".params{rank}.npy", mp_model.flat(model._params))
    with open(out + f".scores{rank}.json", "w") as f:
        json.dump(scores.scores, f)
elif mode == "master":
    from deeplearning4j_tpu_torch.parallel import SharedTrainingMaster
    model = mp_model.model("dense")
    if os.environ.get("DL4J_TEST_PROGRESS"):
        # the preemption drill: steps slow enough for the signal to land
        # mid-run (a timing fault never changes the numbers), each step
        # reported
        model.set_listeners(mp_model.Progress(out + f".progress{rank}"))
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "pipeline/bind", "kind": "slow", "seconds": 0.25,
              "times": 1000}]))
    master = (SharedTrainingMaster.Builder(batch_size_per_worker=8)
              .checkpoint(os.environ["DL4J_TEST_CKPT"], every_n_iterations=3)
              .build())
    master.fit(model, mp_model.rank_iter(rank), epochs=3)
    res = master.last_result
    with open(out + f".result{rank}.json", "w") as f:
        json.dump({"status": res.status, "resume_from": res.resume_from,
                   "iteration": int(model._iteration)}, f)
    if res.status == "preempted":
        distributed.shutdown()
        sys.stdout.flush()
        os._exit(res.resumable_exit_code)
    assert res.status == "completed"
    np.save(out + f".params{rank}.npy", mp_model.flat(model._params))
distributed.shutdown()
print(f"WORKER {rank} OK", flush=True)
sys.stdout.flush()
os._exit(0)
"""

_MODEL = r'''
import os

import numpy as np
import torch
from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
from deeplearning4j_tpu_torch.learning import Adam
from deeplearning4j_tpu_torch.nn import (InputType, MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf import layers as L

N_ROWS, PER_RANK, WORLD = %d, %d, 2


def model(mode):
    upd = Adam(learning_rate=0.05)
    if mode == "zero1_bf16":
        upd.state_dtype = "bfloat16"
    b = NeuralNetConfiguration.builder().seed(5).updater(upd)
    if mode == "dropout":
        b.dropout(0.3)
    conf = (b.activation("tanh").list()
            .layer(L.DenseLayer(n_out=9))
            .layer(L.OutputLayer(n_out=3, loss="mcxent",
                                 activation="softmax"))
            .set_input_type(InputType.feed_forward(4)).build())
    conf.global_conf.fused_update = True
    return MultiLayerNetwork(conf).init(device="cpu")


def data():
    rng = np.random.RandomState(7)
    x = rng.randn(N_ROWS, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, N_ROWS)]
    return x, y


def rank_rows(rank):
    """The rows replica ``rank`` takes of each global batch."""
    b = PER_RANK * WORLD
    return np.concatenate([np.arange(k * b + rank * PER_RANK,
                                     k * b + (rank + 1) * PER_RANK)
                           for k in range(N_ROWS // b)])


def rank_iter(rank):
    x, y = data()
    sel = rank_rows(rank)
    return NDArrayDataSetIterator(x[sel], y[sel], batch_size=PER_RANK)


def global_iter():
    x, y = data()
    return NDArrayDataSetIterator(x, y, batch_size=PER_RANK * WORLD)


def flat(tree):
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.append(flat(v))
        else:
            out.append(v.detach().reshape(-1).to(torch.float32).numpy())
    return np.concatenate(out) if out else np.zeros(0, np.float32)


class Scores:
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, score):
        self.scores.append(float(score))


class Progress:
    """Writes the last finished iteration to ``path``."""

    def __init__(self, path):
        self.path = path

    def iteration_done(self, model, iteration, score):
        with open(self.path + ".tmp", "w") as f:
            f.write(str(iteration))
        os.replace(self.path + ".tmp", self.path)
''' % (N_ROWS, PER_RANK)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(tmp_path, port, world=2, **extra):
    env = {"PYTHONPATH": REPO_ROOT + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""),
        "OMP_NUM_THREADS": "1", "DL4J_TEST_DIR": str(tmp_path),
        "DL4J_TPU_COORDINATOR": f"127.0.0.1:{port}",
        "DL4J_TPU_NUM_PROCS": str(world),
        "DL4J_TPU_CLUSTER_DIR": str(tmp_path / f"cd{port}"),
        "DL4J_TPU_COLLECTIVE_TIMEOUT_S": "60"}
    env.update(extra)
    return env


def _scripts(tmp_path):
    (tmp_path / "mp_model.py").write_text(_MODEL)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    return script


def _run_group(tmp_path, mode, world=2, timeout=120, **extra):
    """One uninterrupted group; every rank must exit 0."""
    script = _scripts(tmp_path)
    out = str(tmp_path / mode)
    env = {**os.environ, **_env(tmp_path, _free_port(), world, **extra)}
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), mode, out],
                env={**env, "DL4J_TPU_PROC_ID": str(r)},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=REPO_ROOT))
        for r, p in enumerate(procs):
            so, se = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {r} failed:\n{se[-3000:]}"
            assert f"WORKER {r} OK" in so
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(5.0)
    return out


def _reference(tmp_path, mode):
    """The one-process two-replica wrapper on the same rows."""
    sys.path.insert(0, str(tmp_path))
    try:
        import importlib

        import mp_model
        importlib.reload(mp_model)
        from deeplearning4j_tpu_torch.parallel import (
            ParallelWrapper, ReduceScatterAccumulator)

        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            model = mp_model.model(mode)
            init = mp_model.flat(model._params)
            b = ParallelWrapper.Builder(model).workers(2)
            if mode.startswith("zero1"):
                b.gradients_accumulator(ReduceScatterAccumulator())
            pw = b.build()
            scores = mp_model.Scores()
            pw.set_listeners(scores)
            pw.fit(mp_model.global_iter(), epochs=2)
            return init, mp_model.flat(model._params), scores.scores
        finally:
            torch.set_num_threads(n)
    finally:
        sys.path.remove(str(tmp_path))


def test_two_process_cluster_psum_and_dp_step(tmp_path):
    _run_group(tmp_path, "psum")


@pytest.mark.parametrize("mode", ["dense", "zero1", "zero1_bf16", "dropout"])
def test_two_rank_step_bitwise_the_two_replica_wrapper(tmp_path, mode):
    out = _run_group(tmp_path, mode)
    init, want, want_scores = _reference(tmp_path, mode)
    for r in range(2):
        assert np.array_equal(np.load(f"{out}.init{r}.npy"), init)
        got = np.load(f"{out}.params{r}.npy")
        assert np.array_equal(got, want), (
            f"rank {r}: max diff {np.abs(got - want).max()}")
        with open(f"{out}.scores{r}.json") as f:
            assert json.load(f) == want_scores


_TRAINER = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from deeplearning4j_tpu_torch.common import faultinject
from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
from deeplearning4j_tpu_torch.learning import Sgd
from deeplearning4j_tpu_torch.nn import (InputType, MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.optimize.listeners import (CheckpointListener,
                                                         TrainingListener)

ckpt_dir, log_path, mode = sys.argv[1], sys.argv[2], sys.argv[3]
rng = np.random.RandomState(7)
x = rng.randn(64, 4).astype(np.float32)
y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
it = NDArrayDataSetIterator(x, y, batch_size=16, shuffle=True, seed=3)
conf = (NeuralNetConfiguration.builder().seed(5)
        .updater(Sgd(learning_rate=0.3)).activation("tanh").list()
        .layer(L.DenseLayer(n_out=8))
        .layer(L.OutputLayer(n_out=2, loss="mcxent", activation="softmax"))
        .set_input_type(InputType.feed_forward(4)).build())
model = MultiLayerNetwork(conf).init(device="cpu")


class JsonlLossLog(TrainingListener):
    def iteration_done(self, model, iteration, score):
        with open(log_path, "a") as f:
            f.write(json.dumps({"iteration": iteration,
                                "loss": float(score)}) + "\n")


listeners = [JsonlLossLog()]
resume_from = None
if mode != "baseline":
    listeners.append(CheckpointListener(ckpt_dir, save_every_n_iterations=3,
                                        keep_last=2))
    resume_from = CheckpointListener.last_checkpoint(ckpt_dir)
    if os.environ.get("DL4J_ATTEMPT", "0") == "0":
        # the first incarnation trains slowly so the peer's death lands
        # mid-run; a timing fault never changes the numbers
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "pipeline/bind", "kind": "slow", "seconds": 0.1,
              "times": 1000}]))
model.set_listeners(*listeners)
model.fit(it, epochs=5, batch_size=16, resume_from=resume_from)
listeners[-1].close() if mode != "baseline" else None
print("DONE", model._iteration, flush=True)
"""

_FLAKY_PEER = r"""
import os, sys, time
# rank 1: dies on the first incarnation after a short grace, then runs
# clean (the lost-host drill)
if os.environ.get("DL4J_ATTEMPT", "0") == "0":
    time.sleep(2.0)
    sys.exit(1)
time.sleep(0.2)
sys.exit(0)
"""


def test_host_loss_group_restart_resumes_bit_exact(tmp_path):
    from deeplearning4j_tpu_torch.parallel.distributed import (
        supervise_processes)

    trainer = tmp_path / "trainer.py"
    trainer.write_text(_TRAINER)
    peer = tmp_path / "peer.py"
    peer.write_text(_FLAKY_PEER)
    env = {"PYTHONPATH": REPO_ROOT, "OMP_NUM_THREADS": "1"}
    base_log = tmp_path / "baseline.jsonl"
    p = subprocess.run([sys.executable, str(trainer), str(tmp_path / "no"),
                        str(base_log), "baseline"],
                       env={**os.environ, **env}, capture_output=True,
                       text=True, timeout=120, cwd=REPO_ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    baseline = {r["iteration"]: r["loss"] for r in
                map(json.loads, base_log.read_text().splitlines())}
    assert sorted(baseline) == list(range(1, 21))

    log = tmp_path / "supervised.jsonl"
    summary = supervise_processes(
        [[sys.executable, str(trainer), str(tmp_path / "ckpts"), str(log),
          "supervised"], [sys.executable, str(peer)]],
        env=env, make_env=lambda attempt: {"DL4J_ATTEMPT": str(attempt)},
        max_restarts=3, backoff_base_s=0.1, storm_min_uptime_s=0.2,
        timeout_s=120.0)
    assert summary["status"] == "completed"
    assert summary["restarts"] == 1
    assert summary["history"][0]["failed_rank"] == 1
    # the trainer was terminated as attempt 0's survivor
    assert summary["history"][0]["codes"][0] not in (0, None)
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    final = {r["iteration"]: r["loss"] for r in rows}
    assert sorted(final) == list(range(1, 21))
    assert final == baseline


@pytest.fixture(scope="module")
def master_params(tmp_path_factory):
    """An uninterrupted two-rank SharedTrainingMaster run's final
    parameters (the same on both ranks)."""
    bdir = tmp_path_factory.mktemp("master_baseline")
    base = _run_group(bdir, "master", DL4J_TEST_CKPT=str(bdir / "ck"))
    want = [np.load(f"{base}.params{r}.npy") for r in range(2)]
    assert np.array_equal(want[0], want[1])
    return want[0]


def test_master_group_restart_bitwise_uninterrupted(tmp_path, master_params):
    """The CPU form of the card's process-group drill: SharedTrainingMaster
    across two ranks with a group commit every 3 steps; rank 1 exits at
    step 5 of attempt 0, the group restarts from the step-3 commit, and
    the final parameters are bitwise the uninterrupted group's."""
    from deeplearning4j_tpu_torch.parallel.distributed import (
        supervise_processes)
    from deeplearning4j_tpu_torch.util import checkpoint as ckpt

    script = _scripts(tmp_path)
    out = str(tmp_path / "sup")
    ck = str(tmp_path / "ck")
    ports = {}

    def make_env(attempt):
        ports[attempt] = _free_port()
        e = _env(tmp_path, ports[attempt], DL4J_TEST_CKPT=ck,
                 DL4J_ATTEMPT=str(attempt))
        if attempt == 0:
            # rank 1 leaves at the dispatch of step 5 (ordinal 4)
            e["DL4J_TEST_FAULT_RANK"] = "1"
            e["DL4J_TEST_FAULT_PLAN"] = json.dumps(
                [{"site": "train/step", "index": 4, "kind": "crash",
                  "mode": "exit", "code": 1}])
        return e

    cmds = [[sys.executable, str(script), "master", out, str(r)]
            for r in range(2)]
    summary = supervise_processes(
        cmds, env={}, make_env=make_env, max_restarts=2,
        backoff_base_s=0.1, kill_grace_s=3.0, storm_min_uptime_s=0.0,
        timeout_s=180.0)
    assert summary["status"] == "completed", summary
    assert summary["restarts"] == 1
    assert summary["history"][0]["failed_rank"] == 1
    assert summary["history"][0]["classes"][1] == "crash"
    names = [os.path.basename(p) for p in ckpt.committed_checkpoints(ck)]
    assert "checkpoint_iter_3.zip" in names
    for r in range(2):
        assert np.array_equal(np.load(f"{out}.params{r}.npy"), master_params)


@pytest.mark.parametrize("signalled", [(0, 1), (1,)],
                         ids=["both_ranks", "rank1_only"])
def test_sigterm_preempts_the_group_at_one_boundary(tmp_path, master_params,
                                                    signalled):
    """SIGTERM mid-run, to both ranks or to one: the ranks agree on the
    stop through the step's gather, stop after the same step, write one
    group commit and exit 75; the relaunched group resumes from it to the
    uninterrupted run's final parameters, bitwise."""
    import signal
    import time

    from deeplearning4j_tpu_torch.util import checkpoint as ckpt

    script = _scripts(tmp_path)
    out = str(tmp_path / "pre")
    ck = str(tmp_path / "ck")
    env = {**os.environ, **_env(tmp_path, _free_port(), DL4J_TEST_CKPT=ck,
                                DL4J_TEST_PROGRESS="1")}
    procs = []
    try:
        for r in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), "master", out],
                env={**env, "DL4J_TPU_PROC_ID": str(r)},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=REPO_ROOT))

        def progress(r):
            try:
                with open(f"{out}.progress{r}") as f:
                    return int(f.read() or 0)
            except OSError:
                return 0

        deadline = time.monotonic() + 90.0
        while min(progress(0), progress(1)) < 2:
            assert time.monotonic() < deadline, "the group made no progress"
            assert all(p.poll() is None for p in procs), "a rank exited"
            time.sleep(0.05)
        for r in signalled:
            procs[r].send_signal(signal.SIGTERM)
        for r, p in enumerate(procs):
            _, se = p.communicate(timeout=120)
            assert p.returncode == 75, f"rank {r} exit {p.returncode}:\n" \
                f"{se[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(5.0)
    got = []
    for r in range(2):
        with open(f"{out}.result{r}.json") as f:
            got.append(json.load(f))
    assert got[0] == got[1], got
    assert got[0]["status"] == "preempted"
    assert 2 <= got[0]["iteration"] < 9
    tag = os.path.basename(got[0]["resume_from"])
    assert tag == f"checkpoint_preempt_{got[0]['iteration']}.zip"
    assert ckpt.verify_group_commit(
        ck, f"preempt_{got[0]['iteration']}") is not None
    # the relaunched group resumes from the preemption commit
    out2 = _run_group(tmp_path, "master", DL4J_TEST_CKPT=ck)
    for r in range(2):
        with open(f"{out2}.result{r}.json") as f:
            assert json.load(f)["status"] == "completed"
        assert np.array_equal(np.load(f"{out2}.params{r}.npy"),
                              master_params)
