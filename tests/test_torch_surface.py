"""Public names of the JAX package that the port gained late, against the
JAX package on the CPU: ``DataType``'s whole table, ``DataSet`` files,
``NGramTokenizerFactory`` and ``FileSentenceIterator``, the stored
``Environment`` flags and properties, the persistent build cache and the
native helper's sanitizer flavor.

The build cache is held through the native helper's ``g++`` build, which
runs here: a second process with the same ``DL4J_TPU_COMPILE_CACHE`` finds
the library and compiles nothing, and an edited source gets another name.
The kernels' ``nvcc`` build follows the same rule (``ops/cuda_lib.py``);
its card test is in ``tests/test_torch_kernel_cuda.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common import dtypes as jdtypes
from deeplearning4j_tpu.common.environment import Environment as JEnv
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nlp import text as jtext
from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.common import build_cache
from deeplearning4j_tpu_torch.common import dtypes as tdtypes
from deeplearning4j_tpu_torch.common.environment import Environment as TEnv
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.learning import updaters as tupd
from deeplearning4j_tpu_torch.ndarray import factory as tfactory
from deeplearning4j_tpu_torch.nlp import (FileSentenceIterator,
                                          NGramTokenizerFactory)
from deeplearning4j_tpu_torch.optimize.listeners import \
    PipelineMetricsListener

ROOT = Path(__file__).resolve().parents[1]
TDT, JDT = tdtypes.DataType, jdtypes.DataType


@pytest.mark.parametrize("name", [m.name for m in JDT])
def test_data_type_member_against_jax(name):
    j, t = JDT[name], TDT[name]
    assert t.value == j.value
    assert (t.is_fp, t.is_int) == (j.is_fp, j.is_int)
    if j is JDT.UTF8:
        for f in (lambda: t.to_np(), lambda: t.to_torch(), lambda: t.width):
            with pytest.raises(TypeError):
                f()
        return
    assert t.width == j.width
    assert t.to_np() == j.to_np()
    assert TDT.from_np(j.to_np()) is t
    assert t.to_torch().itemsize == t.width
    a = tfactory.zeros(2, dtype=t, device="cpu")
    assert a.data_type() is t
    assert a.cast(TDT.FLOAT).cast(t).data_type() is t


def test_module_aliases_match_jax():
    for alias in ("FLOAT", "DOUBLE", "HALF", "BFLOAT16", "INT", "LONG",
                  "BOOL"):
        assert getattr(tdtypes, alias).name == getattr(jdtypes, alias).name
    with pytest.raises(TypeError, match="no DataType"):
        TDT.from_np(np.dtype("complex64"))


def _arrays(masks: bool):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 3, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 5)]
    fm = (rng.random((5, 3)) > 0.3).astype(np.float32) if masks else None
    lm = np.ones((5,), np.float32) if masks else None
    return x, y, fm, lm


def _assert_same(ds, arrays):
    for got, want in zip((ds.features, ds.labels, ds.features_mask,
                          ds.labels_mask), arrays):
        if want is None:
            assert got is None
        else:
            got = got.to_numpy() if hasattr(got, "to_numpy") else got
            np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_dataset_file_written_by_one_package_loads_in_the_other(
        writer, masks, tmp_path):
    arrays = _arrays(masks)
    path = str(tmp_path / "batch")          # both append ".npz"
    if writer == "jax":
        JDataSet(*arrays).save(path)
        got = DataSet.load(path)
    else:
        DataSet(torch.from_numpy(arrays[0]), *arrays[1:]).save(path)
        got = JDataSet.load(path + ".npz")
    assert os.path.exists(path + ".npz")
    _assert_same(got, arrays)
    assert isinstance(got.get_features(), type(got.features))
    assert got.get_labels() is got.labels


def _corpus(root: Path):
    (root / "b").mkdir()
    (root / "a.txt").write_text("the quick brown fox\n\n  jumps over  \n")
    (root / "b" / "c.txt").write_text("a lazy dog\nthe end\n")
    (root / "b" / "d.txt").write_text("")


def test_ngram_tokens_and_file_sentences_match_jax(tmp_path):
    _corpus(tmp_path)
    jsent = list(jtext.FileSentenceIterator(tmp_path))
    tsent = list(FileSentenceIterator(tmp_path))
    assert tsent == jsent and len(tsent) == 4
    jf, tf = jtext.NGramTokenizerFactory(1, 2), NGramTokenizerFactory(1, 2)
    jf.set_token_pre_processor(jtext.LowCasePreProcessor())
    from deeplearning4j_tpu_torch.nlp import LowCasePreProcessor

    tf.set_token_pre_processor(LowCasePreProcessor())
    for s in tsent + ["One Two THREE"]:
        assert tf.create(s).get_tokens() == jf.create(s).get_tokens()
    assert tf.create("a b c").get_tokens() == ["a", "b", "c", "a b", "b c"]


def test_stored_flags_and_properties_match_jax(monkeypatch):
    for var in ("DL4J_TPU_DEBUG", "DL4J_TPU_VERBOSE",
                "DL4J_TPU_DETERMINISTIC"):
        monkeypatch.setenv(var, "1")
    monkeypatch.setenv("DL4J_TPU_ALLOW_PALLAS", "0")
    j, t = JEnv(), TEnv()
    for env in (j, t):
        assert env.is_debug() and env.is_verbose()
        assert env.is_deterministic() and not env.allow_pallas()
        assert not env.is_profiling() and not env.is_check_nan()
        env.set_debug(False)
        env.set_property("k", 3)
        assert not env.is_debug() and env.get_property("k") == 3
        assert env.get_property("absent", "d") == "d"
    assert not t.is_tpu()
    assert t.num_devices() == len(t.devices()) == torch.cuda.device_count()


def test_the_profiler_sets_the_profiling_flag(tmp_path):
    env, prof = TEnv.get(), OpProfiler.get()
    with prof.trace(str(tmp_path)):
        assert env.is_profiling()
        torch.ones(4).sum()
    assert not env.is_profiling()


def test_updater_update_is_apply_and_listener_reads_counts():
    u = tupd.Sgd(0.5)
    p, g = {"w": torch.ones(3)}, {"w": torch.full((3,), 2.0)}
    assert torch.equal(u.update(g, {}, p, 0)[0]["w"],
                       u.apply(g, {}, p, 0)[0]["w"])
    prof = OpProfiler.get()
    before = PipelineMetricsListener().trace_count("fleet_step")
    prof.count("trace/fleet_step")
    assert PipelineMetricsListener().trace_count("fleet_step") == before + 1
    assert isinstance(PipelineMetricsListener().overlap_stats(), dict)


_LOAD = ("import json, numpy as np\n"
         "from deeplearning4j_tpu_torch import native\n"
         "c, x = native.sg_pairs(np.arange(40, dtype=np.int32), "
         "np.array([0, 40], np.int64), 3, None, 5)\n"
         "print(json.dumps({'builds': native.builds, "
         "'path': str(native.library_path()), 'pairs': int(len(c)), "
         "'sum': int(c.sum() + x.sum())}))\n")


def _run(code, env):
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    return p


def test_a_second_process_finds_the_cached_helper_and_builds_nothing(
        tmp_path, monkeypatch):
    """This process builds the helper into a fresh cache; another process
    with the same DL4J_TPU_COMPILE_CACHE loads it and builds nothing."""
    cache = tmp_path / "cache"
    monkeypatch.setattr(build_cache, "_DIR", str(cache))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.delenv("DL4J_TPU_NATIVE_SANITIZE", raising=False)
    assert TEnv.get().compile_cache_dir() == str(cache)
    builds = native.builds
    c, x = native.sg_pairs(np.arange(40, dtype=np.int32),
                           np.array([0, 40], np.int64), 3, None, 5)
    assert native.builds == builds + 1
    path = str(native.library_path())
    assert Path(path).parent == cache and Path(path).exists()
    env = dict(os.environ, DL4J_TPU_COMPILE_CACHE=str(cache),
               PYTHONPATH=str(ROOT))
    env.pop("DL4J_TPU_NATIVE_SANITIZE", None)
    second = json.loads(_run(_LOAD, env).stdout.splitlines()[-1])
    assert second["builds"] == 0 and second["path"] == path
    assert second["pairs"] == len(c) > 0
    assert second["sum"] == int(c.sum() + x.sum())
    # an edited source is another library, never the cached one
    edited = tmp_path / "datavec_native.cpp"
    edited.write_text(native.SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", edited)
    assert native.library_path().parent == cache
    assert str(native.library_path()) != path
    assert not native.library_path().exists()


def test_enable_compilation_cache_sets_the_directory(tmp_path, monkeypatch):
    from deeplearning4j_tpu_torch.common.environment import \
        enable_compilation_cache

    monkeypatch.setattr(build_cache, "_DIR", None)
    monkeypatch.delenv("DL4J_TPU_COMPILE_CACHE", raising=False)
    assert TEnv.get().compile_cache_dir() is None
    assert native.library_path() == native.LIBRARY
    d = TEnv.get().set_compile_cache(str(tmp_path / "c"),
                                     min_compile_secs=0.0)
    assert d == str(tmp_path / "c") and os.path.isdir(d)
    assert enable_compilation_cache(str(tmp_path / "e")) == \
        TEnv.get().compile_cache_dir()


def test_asan_flavor_runs_clean(tmp_path):
    """The port's counterpart of ``tests/test_native.py``'s
    ``TestSanitizerFlavor``: the helper built with
    ``-fsanitize=address`` into its flavor's library, exercised in a
    process with the ASAN runtime preloaded."""
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    if not asan or not Path(asan).exists():
        pytest.skip("libasan not available")
    code = ("import numpy as np\n"
            "from deeplearning4j_tpu_torch import native\n"
            "assert native.available(), 'sanitized build failed'\n"
            "assert native.library_path().name.startswith("
            "'libdatavec_native_address-'), native.library_path()\n"
            "ids = np.random.default_rng(0).integers(0, 100, 5000)"
            ".astype(np.int32)\n"
            "offsets = np.arange(0, 5001, 20, dtype=np.int64)\n"
            "c, x = native.sg_pairs(ids, offsets, 5, np.full(100, 0.8), 7)\n"
            "assert len(c) > 0\n"
            "assert native.tokenize('a b  c') == ['a', 'b', 'c']\n"
            "print('ASAN-CLEAN')\n")
    env = dict(os.environ, DL4J_TPU_NATIVE_SANITIZE="address",
               LD_PRELOAD=asan, ASAN_OPTIONS="detect_leaks=0",
               PYTHONPATH=str(ROOT),
               DL4J_TPU_COMPILE_CACHE=str(tmp_path / "cache"))
    p = _run(code, env)
    assert "ASAN-CLEAN" in p.stdout
    assert "AddressSanitizer" not in p.stderr


def test_available_says_whether_the_helper_builds(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "libbroken.so")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(build_cache, "_DIR", None)
    monkeypatch.delenv("DL4J_TPU_COMPILE_CACHE", raising=False)
    assert native.available() is False
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.sg_pairs(np.arange(4, dtype=np.int32),
                        np.array([0, 4], np.int64), 2, None, 1)
