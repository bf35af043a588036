"""The port's functional Keras importer (``imports/keras_graph_import.py``)
against the JAX package's on every case of
``tests/test_keras_functional_import.py``: each Keras-written file imported
by both into a ``ComputationGraph``, outputs held to the JAX package's at
``atol=1e-4, rtol=1e-3`` and to Keras's at the case's tolerance, refusals
of the same class and message. The training case is written out, since it
sets the graph's updater.
"""

from __future__ import annotations

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
from tensorflow import keras  # noqa: E402

import test_keras_functional_import as J  # noqa: E402
import torch_keras_dual as D  # noqa: E402

_DIRECT = {("TestFunctionalImport", "test_imported_graph_trains")}


@pytest.mark.parametrize("cname,mname,kwargs", D.cases(J, _DIRECT))
def test_jax_case_through_both_importers(cname, mname, kwargs, tmp_path,
                                         monkeypatch):
    D.patch(monkeypatch, J)
    D.run_case(J, cname, mname, kwargs, tmp_path)


def test_imported_graph_trains(tmp_path):
    """The JAX case's flow on the port (Sgd 0.5, 30 fits of one batch, the
    score below 0.7 of its first), and the first step against the JAX
    package's."""
    from deeplearning4j_tpu.data import MultiDataSet as JMDS
    from deeplearning4j_tpu.imports import import_functional as jimport
    from deeplearning4j_tpu.learning import Sgd as JSgd
    from deeplearning4j_tpu_torch.data import MultiDataSet
    from deeplearning4j_tpu_torch.imports import import_functional
    from deeplearning4j_tpu_torch.learning.updaters import Sgd

    inp = keras.layers.Input((6,), name="in0")
    d = keras.layers.Dense(8, activation="tanh")(inp)
    out = keras.layers.Dense(2, activation="softmax")(d)
    m = keras.Model(inp, out)
    path = str(tmp_path / "m.h5")
    m.save(path)
    net = import_functional(path, device="cpu")
    jnet = jimport(path)
    net.conf.global_conf.updater = Sgd(learning_rate=0.5)
    jnet.conf.global_conf.updater = JSgd(learning_rate=0.5)
    rng = np.random.RandomState(23)
    x = rng.randn(32, 6).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    first = None
    for _ in range(30):
        net.fit(MultiDataSet([x], [y]), epochs=1)
        if first is None:
            first = float(net.score_value)
            jnet.fit(JMDS([x], [y]), epochs=1)
            np.testing.assert_allclose(first, float(jnet.score_value),
                                       rtol=1e-4)
    assert float(net.score_value) < first * 0.7
