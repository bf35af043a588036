"""Checkpoints and model files, across the two packages and within the
port, on the CPU.

- A checkpoint the JAX package writes (``CheckpointListener`` on the
  residual graph with ``fused_update`` and bfloat16 Nesterovs state) is
  restored by the port (``fit(resume_from=)``'s restore): parameters, BN
  states, bf16 moments and the pipeline cursor bitwise; the next forward
  within the graph parity bound (rtol 1e-4, atol 1e-6,
  tests/test_torch_graph.py); and both packages' ``fit(resume_from=)`` of
  the file, the port's steps given the random bits of the JAX steps,
  within the training bound of tests/test_torch_train.py (rtol 1e-4, atol
  1e-6; the bf16 moments
  within 1 bf16 ulp and bitwise in at least 99.9% of the elements: equal
  bits round a float32 moment that differs by an ulp differently only at a
  rounding boundary).
- A model zip the port writes is read by the JAX package's
  ``restore_computation_graph``/``restore_multi_layer_network(...,
  load_updater=True)`` with every array bitwise and the same configuration
  JSON, and the other way round; the same for SameDiff ``save``/``load``.
- Kill and resume in the port: a fit resumed from the iteration-6
  checkpoint ends bitwise where the uninterrupted 9-step fit ends
  (parameters, BN states, moments, losses), fused and per-leaf, float32
  and bf16 state (the stochastic-rounding bits continue from the saved
  generator).
- The manifest: a flipped byte in the newest file makes
  ``last_checkpoint`` fall back to the one before, ``*.tmp`` wreckage is
  cleared when a listener is made, and a checkpoint whose moments disagree
  with the configured ``state_dtype`` is refused unless converted.
"""

import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import (
    NDArrayDataSetIterator as JNDIter)
from deeplearning4j_tpu.learning import precision as jprec
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.optimize.listeners import (
    CheckpointListener as JCheckpointListener)
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.autodiff import samediff as psd
from deeplearning4j_tpu_torch.data import DataSet, NDArrayDataSetIterator
from deeplearning4j_tpu_torch.learning.updaters import Adam as PAdam
from deeplearning4j_tpu_torch.nn import _fused
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.ops import update as tupdate
from deeplearning4j_tpu_torch.optimize import (CheckpointListener,
                                               CollectScoresIterationListener)
from deeplearning4j_tpu_torch.util import checkpoint as tckpt
from torch_parity import lenet_conf, mln_twins, numpy_tree, residual_conf

RTOL, ATOL = 1e-4, 1e-6


def _nesterovs(m):
    return m.Nesterovs(0.01, momentum=0.9)


def _conf(which, fused=True, state_dtype="bfloat16"):
    conf = residual_conf(which, False, 16, updater=_nesterovs,
                         fused_update=fused)
    conf.global_conf.updater.state_dtype = state_dtype
    return conf


def _data(n=10, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 4, 8, 8)).astype(np.float32),
            np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)])


def _bits(a) -> np.ndarray:
    """Raw bit patterns of a numpy, jax or torch array (bf16 as int16)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_bitwise(got, want, what):
    for n, d in want.items():
        for k, v in d.items():
            g, w = _bits(got[n][k]), _bits(v)
            assert g.dtype.itemsize == w.dtype.itemsize, (what, n, k)
            assert np.array_equal(g.view(w.dtype), w), (what, n, k)


def _assert_close(got, want, what):
    for n, d in want.items():
        for k, v in d.items():
            g = got[n][k].detach().float().numpy()
            w = np.asarray(jnp.asarray(v, jnp.float32))
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}/{n}/{k}")


def _assert_bf16_close(got, want, what):
    share = []
    for n, d in want.items():
        for k, v in d.items():
            g = got[n][k].detach().float().numpy()
            w = np.asarray(jnp.asarray(v, jnp.float32))
            ulp = np.ldexp(1.0, np.frexp(np.abs(w))[1] - 8)
            assert np.all(np.abs(g - w) <= ulp), (what, n, k)
            share.append(np.mean(g == w))
    assert min(share) >= 0.999, (what, min(share))


# --- the JAX package's files in the port -------------------------------------

def test_jax_checkpoint_restores_bitwise_and_steps_on(tmp_path, monkeypatch):
    x, y = _data()
    jg = JGraph(_conf("jax")).init()
    ck = JCheckpointListener(str(tmp_path), save_every_n_iterations=3,
                             keep_last=2)
    jg.set_listeners(ck)
    jg.fit(JNDIter(x, y, batch_size=4))
    (path,) = ck.saved
    ck.close()
    assert os.path.basename(path) == "checkpoint_iter_3.zip"

    tg = TGraph(_conf("torch")).init(device="cpu")
    cursor = tckpt.restore_training_state(tg, path)
    # taken at the third step, before the epoch's end
    assert cursor == {"epochs_done": 0, "steps_in_epoch": 3}
    assert tg._iteration == jg._iteration == 3 and tg._epoch == 0
    _assert_bitwise(tg._params, jg._params, "params")
    _assert_bitwise(tg._states, jg._states, "states")
    _assert_bitwise(tg._updater_state["v"], jg._updater_state["v"], "v")
    assert all(t.dtype == torch.bfloat16
               for d in tg._updater_state["v"].values() for t in d.values())
    xb, yb = _data(4, seed=8)
    np.testing.assert_allclose(tg.output(xb)[0].numpy(),
                               np.asarray(jg.output(xb)[0].value),
                               rtol=RTOL, atol=ATOL)

    # both packages resume the file with fit(resume_from=): the rest of
    # the first epoch is empty, the second takes 3 steps; the port's
    # steps get the bits the JAX steps draw from the restored stream
    with zipfile.ZipFile(path) as zf:
        rng = json.loads(zf.read("resume.json"))["rng"]
    key = jnp.asarray(np.asarray(rng["key"], dtype=rng["key_dtype"]))
    n = sum(int(np.prod(v.shape)) for d in tg._params.values()
            for v in d.values())
    bits = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        sub = jax.random.fold_in(jax.random.fold_in(sub, jprec.SR_STREAM_TAG),
                                 0)
        bits.append(torch.from_numpy(np.asarray(jax.random.bits(
            sub, (n,), jnp.uint32)).view(np.int32).copy()))

    def with_jax_bits(updater, p, g, s, iteration, generator=None):
        return tupdate.fused_apply(updater, p, g, s, iteration,
                                   bits={"flat::float32": bits.pop(0)})

    monkeypatch.setattr(_fused, "apply_flat_updater", with_jax_bits)
    jr = JGraph(_conf("jax")).init()
    jr.fit(JNDIter(x, y, batch_size=4), epochs=2, resume_from=path)
    tr = TGraph(_conf("torch")).init(device="cpu")
    tr.fit(NDArrayDataSetIterator(x, y, batch_size=4), epochs=2,
           resume_from=path)
    assert not bits and tr._iteration == jr._iteration == 6
    assert tr._epoch == jr._epoch == 2
    assert abs(tr.score_value - float(jr.score_value)) <= \
        RTOL * abs(float(jr.score_value))
    _assert_close(tr._params, jr._params, "params")
    _assert_close(tr._states, jr._states, "states")
    _assert_bf16_close(tr._updater_state["v"], jr._updater_state["v"], "v")


def test_port_model_zip_reads_in_jax_bitwise(tmp_path):
    x, y = _data()
    tg = TGraph(_conf("torch", state_dtype=None)).init(device="cpu")
    tg.fit(NDArrayDataSetIterator(x, y, batch_size=4))
    path = str(tmp_path / "model.zip")
    tg.save(path, save_updater=True)
    jg = jser.restore_computation_graph(path, load_updater=True)
    assert jg._iteration == 3 and jg._epoch == 1
    _assert_bitwise(tg._params, jg._params, "params")
    _assert_bitwise(tg._states, jg._states, "states")
    _assert_bitwise(tg._updater_state["v"], jg._updater_state["v"], "v")
    assert json.loads(jg.conf.to_json()) == json.loads(tg.conf.to_json())
    back = TGraph.load(path, load_updater=True, device="cpu")
    _assert_bitwise(back._params, numpy_tree(jg._params), "reload")


def test_port_bf16_checkpoint_entries_read_in_jax(tmp_path):
    x, y = _data()
    tg = TGraph(_conf("torch")).init(device="cpu")
    ck = CheckpointListener(str(tmp_path), save_every_n_iterations=3)
    tg.set_listeners(ck)
    tg.fit(NDArrayDataSetIterator(x, y, batch_size=4))
    (path,) = ck.saved
    assert not ck.errors()
    jg = JGraph(_conf("jax")).init()
    jg._updater_state = jg.conf.global_conf.updater.init(jg._params)
    with zipfile.ZipFile(path) as zf:
        jser.load_state_entries(zf, jg, load_updater=True)
        names = np.load(zf.open("updaterState.npz")).files
    assert all(n.endswith("::bfloat16") for n in names)
    _assert_bitwise(tg._params, jg._params, "params")
    _assert_bitwise(tg._updater_state["v"], jg._updater_state["v"], "v")
    manifest = json.loads((tmp_path / "checkpoint.json").read_text())
    assert manifest["checkpoints"][0]["state_dtype"] == "bfloat16"


def test_lenet_model_zips_both_ways(tmp_path):
    jconf, tconf = lenet_conf("jax"), lenet_conf("torch")
    jn, tn = mln_twins(jconf, tconf)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 1, 28, 28)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)]
    jn.fit(JDataSet(x, y))
    jpath = str(tmp_path / "jax.zip")
    jn.save(jpath, save_updater=True)
    tl = TNet.load(jpath, load_updater=True, device="cpu")
    assert tl._iteration == 1
    want = {f"{i:04d}": p for i, p in enumerate(jn._params)}
    _assert_bitwise(tl._params, want, "params")
    _assert_bitwise(tl._updater_state["v"],
                    {f"{i:04d}": p for i, p in
                     enumerate(jn._updater_state["v"])}, "v")
    assert tl.get_layer(5) is tl.layers[5] and tl.n_layers() == 6
    tl.fit(DataSet(x, y))
    tpath = str(tmp_path / "port.zip")
    tl.save(tpath, save_updater=True)
    back = jser.restore_multi_layer_network(tpath, load_updater=True)
    _assert_bitwise(tl._params, {f"{i:04d}": p for i, p in
                                 enumerate(back._params)}, "params")
    assert json.loads(back.conf.to_json()) == json.loads(tl.conf.to_json())


def test_samediff_files_both_ways(tmp_path):
    from deeplearning4j_tpu.autodiff import samediff as jsd
    from deeplearning4j_tpu.learning import Adam as JAdam
    from test_torch_samediff import X, Y, _graph

    ph = {"x": X, "y": Y}
    j, t = _graph("jax"), _graph("torch")
    j.set_training_config(jsd.TrainingConfig(updater=JAdam(0.01)))
    t.set_training_config(psd.TrainingConfig(updater=PAdam(0.01)))
    j.fit([ph] * 2)
    jpath = str(tmp_path / "jax_sd.zip")
    j.save(jpath, save_updater=True)
    tl = psd.SameDiff.load(jpath, device="cpu")
    assert tl._iteration == 2 and tl.variables() == ["w", "b"]
    for n in ("w", "b"):
        assert np.array_equal(tl._vars[n].value.numpy(), j._vars[n].value)
        for slot in ("m", "v"):
            assert np.array_equal(
                tl._updater_state[slot][psd.TREE][n].numpy(),
                np.asarray(j._updater_state[slot][n]))
    want = j.output(ph, ["loss"])["loss"]
    np.testing.assert_allclose(tl.output(ph, ["loss"])["loss"].numpy(),
                               np.asarray(want.to_numpy()), rtol=1e-5)
    t.fit([ph] * 2)
    tpath = str(tmp_path / "port_sd.zip")
    t.save(tpath, save_updater=True)
    jl = jsd.SameDiff.load(tpath)
    assert jl._training_config.to_json() == t._training_config.to_json()
    for n in ("w", "b"):
        assert np.array_equal(np.asarray(jl._vars[n].value),
                              t._vars[n].value.numpy())
        for slot in ("m", "v"):
            assert np.array_equal(np.asarray(jl._updater_state[slot][n]),
                                  t._updater_state[slot][psd.TREE][n]
                                  .numpy())
    again = psd.SameDiff.load(tpath, device="cpu")
    assert torch.equal(again.output(ph, ["loss"])["loss"],
                       t.output(ph, ["loss"])["loss"])


# --- kill and resume in the port ---------------------------------------------

@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("fused", [True, False])
def test_resume_is_bitwise_the_uninterrupted_run(tmp_path, fused,
                                                 state_dtype):
    x, y = _data()
    runs = []
    for resume in (False, True):
        tg = TGraph(_conf("torch", fused, state_dtype)).init(device="cpu")
        scores = CollectScoresIterationListener()
        listeners = [scores]
        if not resume:
            ck = CheckpointListener(str(tmp_path),
                                    save_every_n_iterations=3, keep_last=2)
            listeners.append(ck)
        tg.set_listeners(*listeners)
        tg.fit(NDArrayDataSetIterator(x, y, batch_size=4), epochs=3,
               resume_from=str(tmp_path / "checkpoint_iter_6.zip")
               if resume else None)
        if not resume:
            assert [os.path.basename(p) for p in ck.saved] == \
                ["checkpoint_iter_6.zip", "checkpoint_iter_9.zip"]
            ck.close()
            assert ck.errors() == []
        runs.append((tg, scores.scores))
    (a, sa), (b, sb) = runs
    assert a._iteration == b._iteration == 9 and a._epoch == b._epoch == 3
    assert sb == sa          # the listener's history resumed with it
    _assert_bitwise(b._params, a._params, "params")
    _assert_bitwise(b._states, a._states, "states")
    for slot in a._updater_state:
        _assert_bitwise(b._updater_state[slot], a._updater_state[slot], slot)


def test_mln_resume_is_bitwise(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(10, 1, 28, 28)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 10)]
    nets = []
    for resume in (False, True):
        net = TNet(lenet_conf("torch", fused_update=True)).init(device="cpu")
        if not resume:
            net.set_listeners(CheckpointListener(
                str(tmp_path), save_every_n_iterations=2, async_write=False))
        net.fit(NDArrayDataSetIterator(x, y, batch_size=4), epochs=2,
                resume_from=str(tmp_path / "checkpoint_iter_4.zip")
                if resume else None)
        nets.append(net)
    a, b = nets
    assert a._iteration == b._iteration == 6
    assert torch.equal(a.params(), b.params())


# --- the manifest ------------------------------------------------------------

def _three_checkpoints(tmp_path, state_dtype="bfloat16"):
    x, y = _data()
    tg = TGraph(_conf("torch", state_dtype=state_dtype)).init(device="cpu")
    ck = CheckpointListener(str(tmp_path), save_every_n_iterations=1,
                            keep_last=3)
    tg.set_listeners(ck)
    tg.fit(NDArrayDataSetIterator(x, y, batch_size=4))
    return ck.saved


def test_a_flipped_byte_falls_back_to_the_previous_checkpoint(tmp_path):
    saved = _three_checkpoints(tmp_path)
    assert tckpt.last_checkpoint(str(tmp_path)) == saved[-1]
    with open(saved[-1], "r+b") as f:
        f.seek(os.path.getsize(saved[-1]) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    assert CheckpointListener.last_checkpoint(str(tmp_path)) == saved[-2]
    os.remove(tmp_path / "checkpoint.json")          # the scan fallback
    assert tckpt.last_checkpoint(str(tmp_path)) in saved[:-1] + [saved[-1]]


def test_tmp_wreckage_is_cleared_and_retention_survives(tmp_path):
    saved = _three_checkpoints(tmp_path)
    (tmp_path / "checkpoint_iter_9.zip.tmp").write_bytes(b"torn")
    ck = CheckpointListener(str(tmp_path), keep_last=3)
    assert not (tmp_path / "checkpoint_iter_9.zip.tmp").exists()
    assert ck.saved == saved
    assert tckpt.committed_checkpoints(str(tmp_path)) == saved


def test_byte_budget_and_samediff_checkpoints(tmp_path):
    """``max_total_bytes`` keeps the newest files that fit (always the
    newest); a SameDiff checkpoints through its own ``save``, into the same
    verified manifest."""
    x, y = _data()
    tg = TGraph(_conf("torch")).init(device="cpu")
    one = str(tmp_path / "one")
    ck = CheckpointListener(one, save_every_n_iterations=1, keep_last=0,
                            max_total_bytes=1)
    tg.set_listeners(ck)
    tg.fit(NDArrayDataSetIterator(x, y, batch_size=4))
    assert [os.path.basename(p) for p in ck.saved] == \
        ["checkpoint_iter_3.zip"]
    assert sorted(os.listdir(one)) == ["checkpoint.json",
                                       "checkpoint_iter_3.zip"]
    from test_torch_samediff import X, Y, _graph

    sd = _graph("torch")
    sd.set_training_config(psd.TrainingConfig(updater=PAdam(0.01)))
    sdir = str(tmp_path / "sd")
    ck = CheckpointListener(sdir, save_every_n_iterations=1, keep_last=2)
    sd.fit([{"x": X, "y": Y}] * 3, listeners=[ck])
    assert [os.path.basename(p) for p in ck.saved] == \
        ["checkpoint_iter_2.zip", "checkpoint_iter_3.zip"]
    last = tckpt.last_checkpoint(sdir)
    assert last == ck.saved[-1]
    back = psd.SameDiff.load(last, device="cpu")
    assert back._iteration == 3 and torch.equal(back._vars["w"].value,
                                                sd._vars["w"].value)


def test_a_state_dtype_flip_is_refused(tmp_path):
    saved = _three_checkpoints(tmp_path)
    tg = TGraph(_conf("torch", state_dtype=None)).init(device="cpu")
    with pytest.raises(ValueError, match="state dtype mismatch"):
        tckpt.restore_training_state(tg, saved[-1])
    tckpt.restore_training_state(tg, saved[-1], convert_state_dtype=True)
    assert all(t.dtype == torch.float32
               for d in tg._updater_state["v"].values() for t in d.values())
    stale = tckpt.claim_incarnation(str(tmp_path))
    writer = tckpt.CheckpointWriter(str(tmp_path), incarnation=stale - 1)
    writer.submit(tckpt.snapshot_training_state(tg), "stale")
    writer.close()
    assert len(writer.errors) == 1 and isinstance(
        writer.errors[0], tckpt.StaleIncarnationError)


# --- the serving and scrub half ------------------------------------------------

def test_read_checkpoint_params_of_a_jax_checkpoint(tmp_path):
    """The serving tier's candidate weights: the port reads just (params,
    states) of a JAX-written checkpoint, bitwise the JAX package's read,
    without touching a model."""
    from deeplearning4j_tpu.util import checkpoint as jckpt

    x, y = _data()
    jg = JGraph(_conf("jax")).init()
    ck = JCheckpointListener(str(tmp_path), save_every_n_iterations=3,
                             keep_last=2)
    jg.set_listeners(ck)
    jg.fit(JNDIter(x, y, batch_size=4))
    (path,) = ck.saved
    ck.close()
    tg = TGraph(_conf("torch")).init(device="cpu")
    before = {n: {k: v.clone() for k, v in d.items()}
              for n, d in tg._params.items()}
    tp, ts = tckpt.read_checkpoint_params(path, tg._params, tg._states)
    jp, js = jckpt.read_checkpoint_params(path, jg._params, jg._states)
    _assert_bitwise(tp, jp, "params")
    _assert_bitwise(ts, js, "states")
    assert all(t.device.type == "cpu" for d in tp.values()
               for t in d.values())
    _assert_bitwise(tg._params, numpy_tree(before), "model untouched")


def test_read_checkpoint_params_refuses_a_mismatched_template(tmp_path):
    saved = _three_checkpoints(tmp_path)
    small = TGraph(residual_conf("torch", False, 8)).init(device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tckpt.read_checkpoint_params(saved[-1], small._params, small._states)


def _manifest_flags(ck, d):
    return [(e["file"], bool(e.get("quarantined")),
             e.get("quarantine_reason"),
             bool((e.get("scrub") or {}).get("ok")))
            for e in ck.read_manifest(d)]


@pytest.mark.parametrize("ops", [
    [("scrub", 0, True), ("scrub", 1, True)],
    [("quarantine", 2, "operator drill")],
    [("scrub", 1, True), ("scrub", 2, False)],
    [("scrub", 0, True), ("quarantine", 0, "rot"), ("scrub", 1, True)],
    []], ids=["stamped", "quarantined", "failed-scrub", "sticky", "none"])
def test_quarantine_and_scrub_records_equal_jax(tmp_path, ops):
    """``quarantine_checkpoint``, ``record_scrub`` and
    ``last_checkpoint(require_scrubbed=)`` on twin directories: the same
    manifest flags and the same generation chosen."""
    import shutil

    from deeplearning4j_tpu.util import checkpoint as jckpt

    saved = _three_checkpoints(tmp_path / "t")
    shutil.copytree(tmp_path / "t", tmp_path / "j")
    names = [os.path.basename(p) for p in saved]
    out = []
    for ck, d in ((tckpt, str(tmp_path / "t")), (jckpt, str(tmp_path / "j"))):
        hits = []
        for op, i, arg in ops:
            if op == "scrub":
                hits.append(ck.record_scrub(d, names[i], arg))
            else:
                hits.append(ck.quarantine_checkpoint(d, names[i], arg))
        hits.append(ck.quarantine_checkpoint(d, "checkpoint_none.zip"))
        chosen = [os.path.basename(ck.last_checkpoint(d, **kw) or "")
                  for kw in ({}, {"require_scrubbed": True})]
        verified = [ck.verify_checkpoint(d, e) is not None
                    for e in ck.read_manifest(d)]
        out.append((hits, _manifest_flags(ck, d), chosen, verified))
    assert out[0] == out[1]


def test_quarantined_generation_is_skipped_by_every_reader(tmp_path):
    saved = _three_checkpoints(tmp_path)
    d = str(tmp_path)
    name = os.path.basename(saved[-1])
    assert tckpt.quarantine_checkpoint(d, name, "drill")
    assert tckpt.last_checkpoint(d) == saved[-2]
    os.remove(tmp_path / "checkpoint.json")
    # without a manifest nothing is quarantined any more: the scan sees all
    assert tckpt.scan_newest_intact(d) == saved[-1]


def test_commit_fires_the_pre_rename_site_and_records_the_commit(tmp_path):
    from deeplearning4j_tpu_torch.common import faultinject, flightrec

    d = str(tmp_path)
    faultinject.set_plan(faultinject.FaultPlan(
        [{"site": "checkpoint/pre_rename", "kind": "crash", "index": 1}]))
    try:
        tckpt.commit_checkpoint(d, "a", b"first", iteration=1, keep_last=3,
                                seq=0)
        with pytest.raises(faultinject.SimulatedCrash):
            tckpt.commit_checkpoint(d, "b", b"second", iteration=2,
                                    keep_last=3, seq=1)
    finally:
        faultinject.clear_plan()
    # the torn write left only its .tmp; the manifest names the first
    assert [os.path.basename(p) for p in tckpt.committed_checkpoints(d)] \
        == ["checkpoint_a.zip"]
    assert (tmp_path / "checkpoint_b.zip.tmp").exists()
    ev = flightrec.events("checkpoint/commit")[-1]["attrs"]
    assert ev["file"] == "checkpoint_a.zip" and ev["iteration"] == 1


def test_fleet_argument_is_still_refused(tmp_path):
    """The fleet argument (once refused, before the fleet was ported) is
    taken now: a fleet's provenance on the manifest entry, as the JAX
    package records it."""
    from deeplearning4j_tpu.util import checkpoint as jckpt

    for pkg, sub in ((tckpt, "port"), (jckpt, "jax")):
        (tmp_path / sub).mkdir()
        pkg.commit_checkpoint(str(tmp_path / sub), "a", b"x", iteration=1,
                              keep_last=1, fleet={"members": 2})
        pkg.commit_checkpoint(str(tmp_path / sub), "b", b"y", iteration=2,
                              keep_last=3, fleet={"member": 1, "members": 2})
    got = [e["fleet"] for e in tckpt.read_manifest(str(tmp_path / "port"))]
    assert got == [e["fleet"] for e in
                   jckpt.read_manifest(str(tmp_path / "jax"))]
    assert got == [{"members": 2}, {"member": 1, "members": 2}]
