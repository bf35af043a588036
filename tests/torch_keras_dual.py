"""Both Keras importers on one file: the helpers of the port's Keras tests.

``DualImport`` stands in for the JAX test modules' ``KerasModelImport`` and
``import_functional``: each call imports the same Keras-written file with
the JAX package and with the port (on the CPU) and returns a
:class:`DualNet`. A refusal must be the same in both: the port's exception
has the JAX one's class name and message, and the JAX exception is raised
on, so the case's own ``pytest.raises`` sees it.

``DualNet.output`` runs both networks, holds the port's outputs to the JAX
package's at ``atol=1e-4, rtol=1e-3`` (the Keras tests' own tolerance
against Keras) and returns the port's, so the case's comparison with Keras
is made on the port's numbers. ``fit`` fits both; ``score`` returns the
port's score and, on its first call (before any fit), holds it to the
JAX one. ``isinstance`` sees the JAX network's class (``__class__``), and
the import checks that both packages built the same class.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from deeplearning4j_tpu.imports import keras_graph_import as jgi
from deeplearning4j_tpu.imports import keras_import as jki
from deeplearning4j_tpu_torch.data import DataSet as TDataSet
from deeplearning4j_tpu_torch.data import MultiDataSet as TMultiDataSet
from deeplearning4j_tpu_torch.imports import keras_graph_import as tgi
from deeplearning4j_tpu_torch.imports import keras_import as tki
from deeplearning4j_tpu_torch.nn.conf import layers as TL

ATOL, RTOL = 1e-4, 1e-3


def _np(v):
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if hasattr(v, "to_numpy"):
        return v.to_numpy()
    return np.asarray(v)


class _Out:
    """The port's output with the JAX ``NDArray``'s ``to_numpy``."""

    def __init__(self, t):
        self._a = _np(t)

    def to_numpy(self) -> np.ndarray:
        return self._a


def _port_data(ds):
    if hasattr(ds, "features_masks"):
        return TMultiDataSet([_np(f) for f in ds.features],
                             [_np(y) for y in ds.labels],
                             [_np(m) for m in ds.features_masks]
                             if ds.features_masks else None,
                             [_np(m) for m in ds.labels_masks]
                             if ds.labels_masks else None)
    return TDataSet(_np(ds.features), _np(ds.labels),
                    _np(ds.features_mask), _np(ds.labels_mask))


def _port_input(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return _np(x)


def compare(got, want, atol=ATOL, rtol=RTOL) -> None:
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)


class DualNet:
    def __init__(self, jnet, tnet):
        self.jnet, self.tnet = jnet, tnet
        self._scored = False

    @property
    def __class__(self):
        return type(self.jnet)

    def output(self, x, *args, **kwargs):
        want = self.jnet.output(x, *args, **kwargs)
        got = self.tnet.output(_port_input(x), *args, **kwargs)
        compare(got, want)
        if isinstance(got, (list, tuple)):
            return [_Out(g) for g in got]
        return _Out(got)

    def fit(self, ds, *args, **kwargs):
        self.jnet.fit(ds, *args, **kwargs)
        self.tnet.fit(_port_data(ds), *args, **kwargs)
        self._scored = True

    def score(self, ds, *args, **kwargs) -> float:
        got = self.tnet.score(_port_data(ds), *args, **kwargs)
        if not self._scored:
            want = self.jnet.score(ds, *args, **kwargs)
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
            self._scored = True
        return got

    @property
    def score_value(self) -> float:
        return self.tnet.score_value


def _both(jcall, tcall):
    """Run the port's import, then the JAX one; a refusal must match."""
    terr = None
    try:
        tnet = tcall()
    except Exception as e:          # compared with the JAX refusal below
        terr = e
    try:
        jnet = jcall()
    except Exception as jerr:
        assert terr is not None, f"the port imported what JAX refused: {jerr}"
        assert type(terr).__name__ == type(jerr).__name__, (terr, jerr)
        # a message may name its own package's registry
        assert str(terr).replace("deeplearning4j_tpu_torch.",
                                 "deeplearning4j_tpu.") == str(jerr), \
            (str(terr), str(jerr))
        raise
    if terr is not None:
        raise AssertionError(f"the port refused what JAX imported: "
                             f"{terr!r}") from terr
    assert type(tnet).__name__ == type(jnet).__name__
    return DualNet(jnet, tnet)


class DualImport:
    """``KerasModelImport`` of both packages (the JAX test modules'
    spelling)."""

    @staticmethod
    def import_keras_sequential_model_and_weights(path):
        return _both(
            lambda: jki.KerasModelImport
            .import_keras_sequential_model_and_weights(path),
            lambda: tki.KerasModelImport
            .import_keras_sequential_model_and_weights(path, device="cpu"))

    @staticmethod
    def import_keras_model_and_weights(path):
        return _both(
            lambda: jki.KerasModelImport.import_keras_model_and_weights(path),
            lambda: tki.KerasModelImport.import_keras_model_and_weights(
                path, device="cpu"))


def import_functional(path):
    return _both(lambda: jgi.import_functional(path),
                 lambda: tgi.import_functional(path, device="cpu"))


def port_layer(layer):
    """The port's layer of the same class and fields as a JAX layer."""
    cls = getattr(TL, type(layer).__name__)
    names = {f.name for f in dataclasses.fields(cls)}
    out = cls(**{f.name: getattr(layer, f.name)
                 for f in dataclasses.fields(layer) if f.name in names})
    if getattr(layer, "shape_preserving", False):
        out.shape_preserving = True
    return out


def register_custom_layer(class_name, factory):
    """Register ``factory`` (which builds JAX layers) in both packages; the
    port's registration builds the port's layer of the same class."""
    jki.register_custom_layer(class_name, factory)

    def port_factory(config, weights):
        layer, setter = factory(config, weights)
        return port_layer(layer), setter

    tki.register_custom_layer(class_name, port_factory)


def unregister_custom_layer(class_name):
    jki.unregister_custom_layer(class_name)
    tki.unregister_custom_layer(class_name)


def patch(monkeypatch, module) -> None:
    """Point a JAX Keras test module's importer names at both packages."""
    for name, value in (("KerasModelImport", DualImport),
                        ("import_functional", import_functional),
                        ("register_custom_layer", register_custom_layer),
                        ("unregister_custom_layer",
                         unregister_custom_layer)):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, value)


def cases(module, direct=()):
    """``(class, method, kwargs)`` of every test of a JAX test module but
    those in ``direct`` (written out for the port)."""
    import inspect

    import pytest

    out = []
    for cname, cls in inspect.getmembers(module, inspect.isclass):
        if not cname.startswith("Test") or cls.__module__ != module.__name__:
            continue
        for mname, fn in inspect.getmembers(cls, inspect.isfunction):
            if not mname.startswith("test_") or (cname, mname) in direct:
                continue
            marks = [m for m in getattr(fn, "pytestmark", [])
                     if m.name == "parametrize"]
            if not marks:
                out.append(pytest.param(cname, mname, {},
                                        id=f"{cname}.{mname}"))
                continue
            argnames, values = marks[0].args[:2]
            names = [a.strip() for a in argnames.split(",")] \
                if isinstance(argnames, str) else list(argnames)
            for v in values:
                v = v if len(names) > 1 else (v,)
                kw = dict(zip(names, v))
                out.append(pytest.param(
                    cname, mname, kw,
                    id=f"{cname}.{mname}[{'-'.join(map(str, v))}]"))
    return out


def run_case(module, cname, mname, kwargs, tmp_path) -> None:
    getattr(getattr(module, cname)(), mname)(tmp_path=tmp_path, **kwargs)
