"""Linear-algebra ops.

Counterpart of ``deeplearning4j_tpu/ops/linalg.py`` (``matmul`` and
``batched_gemm``). On the card the products run in cuBLAS, in float32
unless the caller turned TF32 on (``common/environment.py``).
"""

from __future__ import annotations

import torch

from .registry import op


@op("matmul", "linalg")
def matmul(x, y, transpose_x: bool = False, transpose_y: bool = False):
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@op("batched_gemm", "linalg")
def batched_gemm(x, y, transpose_x: bool = False, transpose_y: bool = False,
                 alpha: float = 1.0):
    out = matmul(x, y, transpose_x, transpose_y)
    # alpha * out is exact for alpha 1, so the product stands alone then
    return out if alpha == 1.0 else alpha * out
