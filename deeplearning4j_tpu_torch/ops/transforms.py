"""Elementwise transforms, activations, the dtype cast and TF's strided
slice.

Counterpart of ``deeplearning4j_tpu/ops/transforms.py`` (the ops the
TF-imported BERT graph reaches).
"""

from __future__ import annotations

import torch

from ..common.dtypes import torch_dtype
from .registry import op


@op("sqrt", "transform")
def sqrt(x):
    return torch.sqrt(x)


@op("rsqrt", "transform")
def rsqrt(x):
    return torch.rsqrt(x)


@op("tanh", "transform")
def tanh(x):
    return torch.tanh(x)


@op("erf", "transform")
def erf(x):
    return torch.erf(x)


@op("identity", "activation")
def identity(x):
    return x


@op("softmax", "activation")
def softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)


@op("cast", "datatype")
def cast(x, dtype="float32"):
    """Dtype cast (the TF Cast import target)."""
    return torch.as_tensor(x).to(torch_dtype(dtype))


@op("tf_strided_slice", "shape")
def tf_strided_slice(x, spec=None):
    """TF StridedSlice semantics. ``spec`` is the JSON-safe encoding of a
    numpy-style index that the TF importer computes from the begin/end/
    stride masks (``imports/tf_graph_mapper.py``): each entry is ["slice",
    b, e, s] | ["idx", i] | ["newaxis"] | ["ellipsis"]. A negative stride
    (which PyTorch's slicing refuses) gathers the indices numpy's slice
    gives."""
    d = 0
    for i, ent in enumerate(spec):
        kind = ent[0]
        if kind == "slice":
            sl = slice(ent[1], ent[2], ent[3])
            if sl.step is not None and sl.step < 0:
                idx = list(range(x.shape[d]))[sl]
                x = x.index_select(d, torch.tensor(idx, dtype=torch.long,
                                                   device=x.device))
            else:
                x = x[(slice(None),) * d + (sl,)]
            d += 1
        elif kind == "idx":
            x = x.select(d, int(ent[1]))
        elif kind == "newaxis":
            x = x.unsqueeze(d)
            d += 1
        elif kind == "ellipsis":
            # the entries after it consume the last dimensions
            d = x.dim() - sum(1 for e in spec[i + 1:]
                              if e[0] in ("slice", "idx"))
        else:
            raise ValueError(f"bad strided-slice spec entry {ent!r}")
    return x
