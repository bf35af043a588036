"""The port stands alone: it never imports JAX or the JAX package, nor
TensorFlow or protobuf (it reads and writes GraphDefs itself), and it runs
on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "deeplearning4j_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu", "tensorflow",
             "google.protobuf")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def _sources():
    scripts = [ROOT / "chip_smoke.py", ROOT / "profile_port.py"]
    files = sorted(PORT.rglob("*.py")) + scripts
    assert len(files) > 20 and all(p.exists() for p in scripts)
    return files


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    bad = [(ln, m) for ln, m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_catches_forbidden_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom jax import numpy\n"
                 "import deeplearning4j_tpu.nn\n"
                 "from deeplearning4j_tpu_torch import ops\n"
                 "importlib.import_module('jax.numpy')\n"
                 "import tensorflow as tf\n"
                 "from google.protobuf import message\n"
                 "import google.protobufx\n")
    found = [m for _, m in _imports(p) if _forbidden(m)]
    # (ast.walk visits the statements before the call inside one)
    assert found == ["jax", "deeplearning4j_tpu.nn", "tensorflow",
                     "google.protobuf", "jax.numpy"]


def test_import_in_fresh_process_pulls_no_jax():
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch\n"
            "from deeplearning4j_tpu_torch.models import ResNet50\n"
            "from deeplearning4j_tpu_torch.parallel import ParallelInference\n"
            "from deeplearning4j_tpu_torch.util import graph_state_from_numpy\n"
            "from deeplearning4j_tpu_torch.util.calibrate import "
            "calibrate_batchnorm\n"
            "import deeplearning4j_tpu_torch.ops.epilogue\n"
            "import deeplearning4j_tpu_torch.ops.update\n"
            "from deeplearning4j_tpu_torch.data import DataSet\n"
            "from deeplearning4j_tpu_torch.learning import precision\n"
            "from deeplearning4j_tpu_torch.parallel import sharding\n"
            "from deeplearning4j_tpu_torch.nn import _fused\n"
            "from deeplearning4j_tpu_torch.util import "
            "updater_state_from_numpy, word2vec_state_from_numpy\n"
            "import deeplearning4j_tpu_torch.nlp\n"
            "from deeplearning4j_tpu_torch.nlp import Word2Vec, "
            "VocabConstructor, CollectionSentenceIterator\n"
            "from deeplearning4j_tpu_torch.nlp.word2vec import "
            "SequenceVectors\n"
            "from deeplearning4j_tpu_torch.nlp import ParagraphVectors, "
            "LabelAwareIterator\n"
            "import deeplearning4j_tpu_torch.nlp.paragraph_vectors\n"
            "import deeplearning4j_tpu_torch.ops.embeddings\n"
            "from deeplearning4j_tpu_torch.nn import MultiLayerNetwork\n"
            "from deeplearning4j_tpu_torch.models import LeNet, VGG16\n"
            "from deeplearning4j_tpu_torch.data import (MnistDataSetIterator, "
            "NormalizerStandardize)\n"
            "from deeplearning4j_tpu_torch.data import pipeline\n"
            "from deeplearning4j_tpu_torch.eval import Evaluation\n"
            "from deeplearning4j_tpu_torch.optimize import "
            "PerformanceListener\n"
            "from deeplearning4j_tpu_torch.util import "
            "multilayer_state_from_numpy\n"
            "from deeplearning4j_tpu_torch.imports import import_frozen_tf\n"
            "from deeplearning4j_tpu_torch.imports import graphdef, "
            "tf_fixtures\n"
            "from deeplearning4j_tpu_torch.autodiff import SameDiff\n"
            "from deeplearning4j_tpu_torch.ops import registry\n"
            "registry.all_ops()\n"
            "from deeplearning4j_tpu_torch.util import "
            "samediff_state_from_numpy\n"
            "from deeplearning4j_tpu_torch.nlp import (FastText, Glove, "
            "DeepWalk, Node2Vec, Graph, random_walks, char_ngrams, "
            "fasttext_hash, read_word2vec_model, write_word2vec_model, "
            "read_word_vectors, write_word_vectors, read_paragraph_vectors, "
            "write_paragraph_vectors)\n"
            "from deeplearning4j_tpu_torch.util import "
            "fasttext_state_from_numpy, glove_state_from_numpy\n"
            "from deeplearning4j_tpu_torch import native\n"
            "from deeplearning4j_tpu_torch.common.background import "
            "prefetch_iter\n"
            "from deeplearning4j_tpu_torch.nn import (TransferLearning, "
            "TransferLearningHelper, FineTuneConfiguration)\n"
            "from deeplearning4j_tpu_torch.nn.conf.layers import ("
            "FrozenLayer, VariationalAutoencoder, CapsuleLayer, "
            "ConvLSTM2DLayer, LambdaLayer, DropConnect, WeightNoise)\n"
            "from deeplearning4j_tpu_torch.nn.conf.builder import "
            "remat_wrap\n"
            "from deeplearning4j_tpu_torch.imports import keras_import\n"
            "from deeplearning4j_tpu_torch.models import PretrainedType\n"
            "from deeplearning4j_tpu_torch.util.model_serializer import "
            "restore_model\n"
            "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
            "'tensorflow') or m == 'deeplearning4j_tpu' or m.startswith(("
            "'jax.', 'deeplearning4j_tpu.', 'tensorflow.', "
            "'google.protobuf'))]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_default_device_is_the_card_and_raises_without_one():
    from deeplearning4j_tpu_torch.common.environment import resolve_device
    from deeplearning4j_tpu_torch.models import ResNet50

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResNet50(num_classes=10, image_size=32).init()
    from deeplearning4j_tpu_torch.models import LeNet

    with pytest.raises(RuntimeError, match="device='cpu'"):
        LeNet().init()
    assert LeNet().init(device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    g = ResNet50(num_classes=10, image_size=32).init(device="cpu")
    assert all(t.device.type == "cpu" for p in g._params.values()
               for t in p.values())


def test_word2vec_defaults_to_the_card_and_raises_without_one():
    from deeplearning4j_tpu_torch.nlp import Word2Vec

    if torch.cuda.is_available():
        assert Word2Vec(algorithm="cbow").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Word2Vec(algorithm="cbow")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Word2Vec.builder().elements_learning_algorithm("CBOW").build()
    assert Word2Vec(algorithm="cbow", device="cpu").device.type == "cpu"
    from deeplearning4j_tpu_torch.nlp import ParagraphVectors

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Word2Vec()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParagraphVectors.builder().dm(True).build()
    assert ParagraphVectors(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("name", ["FastText", "Glove", "DeepWalk",
                                  "Node2Vec"])
def test_nlp_models_default_to_the_card_and_raise_without_one(name):
    import deeplearning4j_tpu_torch.nlp as tnlp

    cls = getattr(tnlp, name)
    if torch.cuda.is_available():
        assert cls().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls()
    if hasattr(cls, "builder") and name != "Node2Vec":
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls.builder().build()
        assert cls.builder().device("cpu").build().device.type == "cpu"
    assert cls(device="cpu").device.type == "cpu"


def test_native_helper_is_the_ports_own_source():
    """The port builds its own copy of the C++ helper, into its own build
    directory, never a file of the JAX package; importing it builds
    nothing."""
    from deeplearning4j_tpu_torch import native

    src = native.SOURCE.resolve()
    assert src.exists() and src.suffix == ".cpp"
    assert src.is_relative_to(PORT.resolve())
    assert not src.is_relative_to((ROOT / "deeplearning4j_tpu").resolve())
    assert native.LIBRARY.resolve().parent == (PORT / "_build").resolve()


def test_import_frozen_tf_defaults_to_the_card_and_raises_without_one():
    from deeplearning4j_tpu_torch.imports import import_frozen_tf
    from deeplearning4j_tpu_torch.imports.tf_fixtures import \
        build_bert_frozen_graph

    data, _, _ = build_bert_frozen_graph(batch=1, seq=4, hidden=8, layers=1,
                                         heads=2, intermediate=16, vocab=11,
                                         max_pos=8)
    if torch.cuda.is_available():
        assert import_frozen_tf(data).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        import_frozen_tf(data)
    sd = import_frozen_tf(data, device="cpu")
    assert sd.device.type == "cpu"
    assert all(v.value.device.type == "cpu" for v in sd._vars.values()
               if v.value is not None)


def test_tf32_policy_stated_and_set():
    from deeplearning4j_tpu_torch.common.environment import Environment

    env = Environment.get()
    assert env.tf32_flags() == {"cuda.matmul.allow_tf32": False,
                                "cudnn.allow_tf32": False}
    env.set_tf32(True)
    try:
        assert all(env.tf32_flags().values())
    finally:
        env.set_tf32(False)


def test_kernel_build_is_lazy():
    """Importing the kernel modules builds nothing: the build directory
    appears only when a kernel first launches on the card."""
    from deeplearning4j_tpu_torch.ops import (cuda_lib, embeddings,  # noqa: F401
                                              epilogue, update)

    assert cuda_lib.source_path("bn_act").exists()
    assert cuda_lib.source_path("fused_update").exists()
    assert cuda_lib.source_path("embedding_bag").exists()
    assert "_build" in str(cuda_lib.BUILD_DIR)
    if not torch.cuda.is_available():
        assert not cuda_lib._LIBS
