"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips where no card is
present. This file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_kernel_cuda.py -m cuda --noconftest -q

(``--noconftest`` because tests/conftest.py sets up JAX.) ``chip_smoke.py``
makes the same comparison at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import epilogue


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _case(shape, seed=3):
    rng = np.random.default_rng(seed)
    C = shape[1]
    x = rng.normal(size=shape).astype(np.float32)
    res = rng.normal(size=shape).astype(np.float32)
    stats = (rng.normal(size=C), rng.uniform(0.5, 2.0, size=C),
             rng.normal(size=C), rng.normal(size=C))
    return x, res, [s.astype(np.float32) for s in stats]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 65, 7, 5), (17, 130), (4, 256, 14, 14),
                                   (2, 64, 112, 112)])
@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("residual", [False, True])
def test_bn_act_kernel_matches_plain_version(dtype, shape, act, residual):
    dev = _card()
    x, res, stats = _case(shape)
    xt = torch.from_numpy(x).to(dev, dtype)
    rt = torch.from_numpy(res).to(dev, dtype) if residual else None
    scale, shift = epilogue.fold(*(torch.from_numpy(s).to(dev)
                                   for s in stats))
    before = epilogue.bn_act_launches
    got = epilogue.bn_act_cuda(xt, scale, shift, rt, act).float()
    want = epilogue.bn_act_reference(xt, scale, shift, rt, act).float()
    torch.cuda.synchronize()
    assert epilogue.bn_act_launches == before + 1
    err = (got - want).abs().max().item()
    if dtype == torch.float32:
        # fmaf vs two roundings: 2 ulp of the output scale
        assert err <= 2.0 ** -22 * (want.abs().max().item() + 1.0)
    else:
        # both round once to bf16 from f32 values that differ by the
        # kernel's fmaf (2 f32 ulp of the terms at most): 1 bf16 ulp
        # (2**-7 relative at most) plus that, elementwise
        shape_c = [1, -1] + [1] * (xt.ndim - 2)
        terms = (xt.float() * scale.reshape(shape_c)).abs() \
            + shift.abs().reshape(shape_c)
        if rt is not None:
            terms = terms + rt.float().abs()
        tol = torch.maximum(got.abs(), want.abs()) * 2.0 ** -7 \
            + 2.0 ** -22 * terms
        assert bool((got - want).abs().le(tol).all())


@pytest.mark.cuda
def test_bn_act_kernel_refuses_what_it_does_not_take():
    dev = _card()
    x = torch.zeros(2, 8, 3, 3, device=dev)
    s = torch.ones(8, device=dev)
    with pytest.raises(TypeError):
        epilogue.bn_act_cuda(x.half(), s, s)
    with pytest.raises(ValueError):
        epilogue.bn_act_cuda(x.transpose(2, 3), s, s)
    with pytest.raises(ValueError):
        epilogue.bn_act_cuda(x, s.half(), s)
    with pytest.raises(ValueError):
        epilogue.bn_act_cuda(x, s, s, residual=torch.zeros(2, 8, 3, 4,
                                                           device=dev))
