"""Card-only tests of the fleet's member-batched ``fused_update`` route:
every test is marked ``cuda`` and skips where no card is present. This
file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_fleet_cuda.py -m cuda --noconftest -q

The kernel against its plain version (parameters and float32 moments
within 2 float32 ulp, bfloat16 moments bitwise), each row bitwise the
single-bucket kernel on it, a masked row unchanged; and a fleet member on
the card bitwise its solo twin with one member-batched launch per step.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.learning import updaters
from deeplearning4j_tpu_torch.ops import update


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _updater(kind, state_dtype=None):
    u = {"sgd": updaters.Sgd(0.1), "nesterovs": updaters.Nesterovs(0.1, 0.9),
         "adam": updaters.Adam(1e-3)}[kind]
    u.state_dtype = state_dtype
    return u


@pytest.mark.cuda
@pytest.mark.parametrize("kind,bf16", [("sgd", False), ("nesterovs", False),
                                       ("nesterovs", True), ("adam", False),
                                       ("adam", True)])
@pytest.mark.parametrize("m,n", [(4, 4096), (3, 4097), (2, 1)])
def test_members_kernel_against_plain_solo_and_mask(kind, bf16, m, n):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(7)
    p = torch.randn((m, n), generator=gen, device=dev)
    g = torch.randn((m, n), generator=gen, device=dev) * 0.01
    sdt = torch.bfloat16 if bf16 else torch.float32
    slots = {s: (torch.rand((m, n), generator=gen, device=dev) * 1e-3).to(sdt)
             for s in update.SLOTS[kind]}
    bits = (torch.randint(-2 ** 31, 2 ** 31, (m, n), dtype=torch.int32,
                          generator=gen, device=dev)
            if bf16 and slots else None)
    lr = torch.linspace(0.01, 0.05, m, device=dev)
    live = torch.ones((m,), dtype=torch.int32, device=dev)
    if m > 1:
        live[1] = 0
    sr = torch.bfloat16 if bf16 else None
    sc = update._scalars(_updater(kind, "bfloat16" if bf16 else None), kind, 2)
    want_p, want_s = update.fused_update_members_reference(
        kind, sc, p, g, slots, bits, sr, lr, live)
    solo_p, solo_s = p.clone(), {k: v.clone() for k, v in slots.items()}
    for r in range(m):
        if live[r]:
            update.fused_update_cuda(
                kind, (float(lr[r]),) + tuple(sc[1:]), solo_p[r], g[r],
                {k: v[r] for k, v in solo_s.items()},
                None if bits is None else bits[r], sr)
    old_p = p.clone()
    update.reset_launches()
    update.fused_update_members_cuda(kind, sc, p, g, slots, bits, sr, lr,
                                     live)
    torch.cuda.synchronize()
    assert update.fused_update_member_launches == 1
    tol = 2.0 ** -22 * (want_p.abs().max().item() + 1.0)
    assert (p - want_p).abs().max().item() <= tol
    for k in slots:
        if bf16:
            assert torch.equal(slots[k], want_s[k])
        else:
            assert (slots[k] - want_s[k]).abs().max().item() <= \
                2.0 ** -22 * (want_s[k].abs().max().item() + 1.0)
    assert torch.equal(p, solo_p)
    assert all(torch.equal(slots[k], solo_s[k]) for k in slots)
    if m > 1:
        assert torch.equal(p[1], old_p[1])


@pytest.mark.cuda
def test_fleet_member_on_the_card_is_bitwise_its_solo_twin():
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.nn import (InputType, MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.parallel import FleetTrainer

    dev = _card()
    conf = (NeuralNetConfiguration.builder().seed(7)
            .updater(updaters.Adam(1e-3)).activation("tanh")
            .weight_init("xavier").fused_update().list()
            .layer(L.DenseLayer(n_out=32))
            .layer(L.OutputLayer(n_out=10, loss="mse", activation="identity"))
            .set_input_type(InputType.feed_forward(64)).build())
    fleet = FleetTrainer.from_sweep(MultiLayerNetwork(conf).init(device=dev),
                                    {"lr": [1e-3, 2e-3, 5e-3]})
    twin = fleet.solo_twin(2)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(16, 64).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randn(16, 10).astype(np.float32)).to(dev)
    update.reset_launches()
    for _ in range(4):
        fleet.step(x, y)
        twin.fit(DataSet(x, y))
    torch.cuda.synchronize()
    assert update.fused_update_member_launches == 4
    assert update.fused_update_launches == 4          # the twin's alone
    member = [t[2] for t in (fleet._P[k] for k in sorted(fleet._P))]
    solo = twin._flat.params
    assert all(torch.equal(a, solo[k]) for a, k in zip(member,
                                                       sorted(fleet._P)))
