"""The registry of ``LambdaLayer`` functions.

Counterpart of the lambda registry of
``deeplearning4j_tpu/imports/keras_import.py`` (``register_lambda``,
``unregister_lambda``, ``resolve_lambda``): a function body does not
serialize, so a configuration names its ``LambdaLayer``'s function and
reading it back looks the name up here. The Keras importer of a later slice
resolves the same names. Each package keeps its own registry: a model zip
written by one loads in the other once the same name is registered in both.
"""

from __future__ import annotations

from typing import Callable, Dict

_LAMBDA_FNS: Dict[str, Callable] = {}


def register_lambda(name: str, fn: Callable) -> None:
    _LAMBDA_FNS[name] = fn


def unregister_lambda(name: str) -> None:
    _LAMBDA_FNS.pop(name, None)


def resolve_lambda(name: str) -> Callable:
    """The function registered under ``name``; raises with the registration
    recipe when there is none."""
    fn = _LAMBDA_FNS.get(name)
    if fn is None:
        raise ValueError(
            f"Lambda {name!r}: lambda bodies do not serialize; register the "
            f"function first with deeplearning4j_tpu_torch.imports."
            f"keras_import.register_lambda({name!r}, fn)")
    return fn
