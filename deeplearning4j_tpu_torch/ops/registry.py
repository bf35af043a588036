"""Op registry + coverage ledger.

Counterpart of ``deeplearning4j_tpu/ops/registry.py``: every op is a plain
function over tensors (plus static kwargs) registered by name, with the JAX
registry's names, families and kwargs; ``exec_op`` runs one by name and
records it as validated, and ``coverage_report`` lists the registered ops a
test never ran.

The port registers the ops its paths reach (the TF-imported BERT graph, the
``SDVariable`` arithmetic that fine-tunes it, and the recurrent layers'
ops). :data:`JAX_OPS` names
every op of the JAX registry: ``get_op`` raises ``NotImplementedError``
naming one that is not ported yet, and ``KeyError`` for a name neither
registry has. Gradients come from autograd through each function, as
``jax.grad`` through the JAX ops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Set

#: every op of the JAX package's registry (331), ported or not
JAX_OPS = frozenset("""
    abs absolute_difference_loss acos acosh add adjust_contrast adjust_gamma
    adjust_hue adjust_saturation all alpha_dropout any argamax argamin argmax
    argmin asin asinh atan atan2 atanh avgpool2d avgpool3d batch_to_space
    batched_gemm batchnorm batchnorm_train betainc bias_add bidirectional_lstm
    bincount bits_hamming_distance bitwise_and bitwise_not bitwise_or
    bitwise_xor boolean_and boolean_mask boolean_not boolean_or boolean_xor
    broadcast_to cast cbow cbow_hs cbrt ceil cholesky clip_by_global_norm
    clip_by_norm clip_by_value concat confusion_matrix conv1d conv2d conv3d
    cos cosh cosine_distance cosine_distance_loss cosine_similarity
    count_nonzero count_zero crop_and_resize cross ctc_loss cube cumprod
    cumsum cyclic_shift_left cyclic_shift_right deconv2d depth_to_space
    depthwise_conv2d diag diag_part digamma divide dot dot_product_attention
    dropout dropout_bp dynamic_partition dynamic_stitch einsum elu
    embedding_bag embedding_lookup equals erf erfc erfinv euclidean_distance
    exp expand_dims expm1 extract_image_patches eye fill flash_attention
    flatten_2d floor floordiv floormod gather gather_nd gaussian_dropout
    gaussian_noise gelu gelu_exact global_avgpool greater greater_equal
    gru_cell gru_layer gru_layer_ra hamming_distance hardsigmoid hardtanh
    hinge_loss histogram_fixed_width hsv_to_rgb huber_loss identity igamma
    igammac im2col image_flip in_top_k isfinite isinf isnan jaccard_distance
    kld_loss layer_norm leakyrelu less less_equal lgamma linear linspace log
    log10 log1p log2 log_loss log_matrix_determinant log_sigmoid log_softmax
    lrn lstm_cell lstm_layer lstsq lu manhattan_distance matmul
    matrix_band_part matrix_determinant matrix_diag matrix_diag_part
    matrix_inverse matrix_set_diag maximum maxpool2d maxpool3d
    mean_pairwssqerr_loss mean_sqerr_loss meshgrid minimum mirror_pad mish mod
    moments multi_head_dot_product_attention multiply neg non_max_suppression
    norm normalize_moments not_equals nth_element one_hot ones_as outer pad
    percentile permute pinv pnormpool2d poisson_loss polygamma pow prelu qr
    random_bernoulli random_binomial random_crop random_exponential
    random_gamma random_lognormal random_multinomial random_normal
    random_poisson random_shuffle random_truncated_normal random_uniform range
    rank rationaltanh reciprocal rectifiedtanh reduce_amax reduce_amean
    reduce_amin reduce_logsumexp reduce_max reduce_mean reduce_min
    reduce_norm1 reduce_norm2 reduce_norm_max reduce_prod reduce_sqnorm
    reduce_stdev reduce_sum reduce_variance relu relu6 relu_layer repeat
    reshape resize_area resize_bicubic resize_bilinear resize_lanczos3
    resize_lanczos5 resize_mitchellcubic resize_nearest reverse reversedivide
    reversesubtract rgb_to_grayscale rgb_to_hsv rgb_to_yuv rint roll round
    rsqrt scatter_add scatter_div scatter_max scatter_min scatter_mul
    scatter_sub scatter_update sconv2d searchsorted segment_max segment_mean
    segment_min segment_prod segment_sum select self_adjoint_eig selu
    sequence_mask shape_of shift_left shift_right sigmoid
    sigmoid_cross_entropy sign simple_rnn_layer sin sinh size skipgram
    skipgram_hs slice softmax softmax_bp softmax_cross_entropy softplus
    softsign solve space_to_batch space_to_depth sparse_softmax_cross_entropy
    split split_v sqrt square squaredsubtract squeeze sru_layer stack
    standardize step stop_gradient strided_slice subtract
    sufficient_statistics svd swish tan tanh tensormmul tf_strided_slice
    thresholdedrelu tile top_k trace transpose triangular_solve truncatediv
    unique unsorted_segment_max unsorted_segment_mean unsorted_segment_min
    unsorted_segment_prod unsorted_segment_sqrt_n unsorted_segment_sum unstack
    upsampling2d upsampling3d where xw_plus_b yuv_to_rgb zero_fraction
    zeros_as zeta
""".split())


@dataclass
class OpDescriptor:
    name: str
    fn: Callable
    family: str
    # Differentiable through autograd (False for int/bool/shape-query ops).
    differentiable: bool = True
    doc: str = ""


_REGISTRY: Dict[str, OpDescriptor] = {}
_VALIDATED: Set[str] = set()


def op(name: str, family: str = "misc", differentiable: bool = True):
    """Decorator: register an op under ``name`` (one of :data:`JAX_OPS`)."""

    def wrap(fn: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"duplicate op registration: {name}")
        if name not in JAX_OPS:
            raise ValueError(f"{name!r} is not an op of the JAX registry")
        _REGISTRY[name] = OpDescriptor(
            name=name, fn=fn, family=family, differentiable=differentiable,
            doc=next(iter((fn.__doc__ or "").strip().splitlines()), ""),
        )
        return fn

    return wrap


def get_op(name: str) -> OpDescriptor:
    _ensure_loaded()
    if name not in _REGISTRY:
        if name in JAX_OPS:
            raise NotImplementedError(
                f"op {name!r} is registered in the JAX package but not "
                f"ported yet (see ROADMAP.md, queue A)")
        raise KeyError(f"unknown op: {name!r} (registered: {len(_REGISTRY)})")
    return _REGISTRY[name]


def has_op(name: str) -> bool:
    _ensure_loaded()
    return name in _REGISTRY


def all_ops() -> Dict[str, OpDescriptor]:
    _ensure_loaded()
    return dict(_REGISTRY)


def exec_op(name: str, *args, **kwargs):
    """Execute a registered op by name, recording it as validated. Numpy
    arguments become tensors (on the CPU)."""
    import numpy as _np
    import torch as _torch

    desc = get_op(name)
    _VALIDATED.add(name)
    args = tuple(_torch.from_numpy(_np.array(a)) if isinstance(a, _np.ndarray)
                 else a for a in args)
    return desc.fn(*args, **kwargs)


def mark_validated(name: str) -> None:
    _VALIDATED.add(name)


def validated_ops() -> Set[str]:
    return set(_VALIDATED)


def coverage_report() -> Dict[str, Any]:
    _ensure_loaded()
    missing = sorted(set(_REGISTRY) - _VALIDATED)
    return {
        "registered": len(_REGISTRY),
        "validated": len(_VALIDATED & set(_REGISTRY)),
        "missing": missing,
        "not_ported": len(JAX_OPS - set(_REGISTRY)),
    }


_loaded = False


def _ensure_loaded() -> None:
    """Import the op-family modules once (registration side effects)."""
    global _loaded
    if _loaded:
        return
    _loaded = True
    from . import (  # noqa: F401
        broadcastable,
        linalg,
        loss,
        recurrent,
        reduce,
        shape,
        transforms,
    )
