"""The port's Keras importer against the JAX package's on every case of
``tests/test_keras_import_breadth.py`` (each Keras-written file imported
by both, the port's outputs held to the JAX package's at ``atol=1e-4,
rtol=1e-3`` and to Keras's at the case's tolerance; refusals of the same
class and message; custom layers registered in both packages), with the
registered-lambda case written out for the port's registry.
"""

from __future__ import annotations

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
from tensorflow import keras  # noqa: E402

import test_keras_import_breadth as J  # noqa: E402
import torch_keras_dual as D  # noqa: E402

_DIRECT = {("TestRound5Tail", "test_lambda_registered")}


@pytest.mark.parametrize("cname,mname,kwargs", D.cases(J, _DIRECT))
def test_jax_case_through_both_importers(cname, mname, kwargs, tmp_path,
                                         monkeypatch):
    D.patch(monkeypatch, J)
    D.run_case(J, cname, mname, kwargs, tmp_path)


def test_lambda_registered(tmp_path, monkeypatch):
    """A ``Lambda`` layer imports once its function is registered under its
    name in each package's registry."""
    from deeplearning4j_tpu.imports import keras_import as jki
    from deeplearning4j_tpu_torch.imports import keras_import as tki

    D.patch(monkeypatch, J)
    m = keras.Sequential([
        keras.layers.Input((6,)),
        keras.layers.Lambda(lambda t: t * 2.0 + 1.0, name="scale2"),
        keras.layers.Dense(3),
    ])
    jki.register_lambda("scale2", lambda t: t * 2.0 + 1.0)
    tki.register_lambda("scale2", lambda t: t * 2.0 + 1.0)
    try:
        J.roundtrip(m, J.rng.randn(4, 6).astype(np.float32), tmp_path)
    finally:
        jki.unregister_lambda("scale2")
        tki.unregister_lambda("scale2")
