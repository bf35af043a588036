"""Card-only tests of the model-parallel tier: every test is marked
``cuda`` and skips where no card is present. This file imports no JAX, so it
runs on a machine without it:

    python -m pytest tests/test_torch_model_parallel_cuda.py -m cuda \\
        --noconftest -q

A pipeline of self-attention blocks on ``["cuda:0"] * 2`` launches
``csrc/flash_attention.cu`` blocks x microbatches x (forward + recompute)
times a step, on the bf16 route under bf16 compute, bitwise across 1F1B
and GPipe; the ring on ``["cuda:0"] * 4`` against dense attention (atol
2e-5, rtol 1e-4, TF32 off); a sharded table's lookup on the card bitwise
the dense gather.
"""

import numpy as np
import pytest
import torch


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


class _Losses:
    def __init__(self):
        self.losses = []

    def iteration_done(self, model, iteration, score):
        self.losses.append(float(score))


def _stack(dev, blocks=4, width=64, heads=4, T=32):
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn import (InputType, MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    b = NeuralNetConfiguration.builder().seed(5).updater(Adam(1e-3)).list()
    for _ in range(blocks):
        b.layer(L.SelfAttentionLayer(n_out=width, n_heads=heads))
    conf = b.set_input_type(InputType.recurrent(width, T)).build()
    conf.global_conf.compute_dtype = "bfloat16"
    return MultiLayerNetwork(conf).init(device=dev)


@pytest.mark.cuda
def test_pipeline_launches_flash_at_stage_shapes():
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
    from deeplearning4j_tpu_torch.ops import attention
    from deeplearning4j_tpu_torch.parallel import PipelineTrainer

    dev = _card()
    blocks, M, steps, batch = 4, 4, 2, 16
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((steps * batch, 32, 64), generator=g, device=dev)
    y = torch.randn((steps * batch, 32, 64), generator=g, device=dev)
    seen = {}
    for schedule in ("1f1b", "gpipe"):
        model = _stack(dev, blocks)
        tr = PipelineTrainer(model, stages=2, n_micro=M, schedule=schedule,
                             devices=["cuda:0"] * 2)
        rec = _Losses()
        tr.set_listeners(rec)
        prof = OpProfiler.get()
        prof.reset()
        attention.reset_launches()
        tr.fit(NDArrayDataSetIterator(x.cpu().numpy(), y.cpu().numpy(),
                                      batch_size=batch), epochs=1,
               batch_size=batch)
        torch.cuda.synchronize()
        want = blocks * M * 2 * steps
        assert attention.flash_attention_launches == want
        assert prof.counter_value("attention/flash_bf16") == want
        assert prof.counter_value("attention/mha_dense") == 0
        seen[schedule] = (rec.losses, [t.clone() for k in sorted(
            model._params) for _, t in sorted(model._params[k].items())])
    assert seen["1f1b"][0] == seen["gpipe"][0]
    assert all(torch.equal(a, b) for a, b in zip(seen["1f1b"][1],
                                                 seen["gpipe"][1]))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_ring_on_four_slots_of_one_card(causal):
    from deeplearning4j_tpu_torch.ops import nn as tnn
    from deeplearning4j_tpu_torch.parallel import (make_mesh,
                                                   ring_self_attention)

    dev = _card()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g = torch.Generator(device=dev).manual_seed(4)
        B, T, F, H = 2, 256, 64, 4
        x = torch.randn((B, T, F), generator=g, device=dev)
        ws = [torch.randn((F, F), generator=g, device=dev) / F ** 0.5
              for _ in range(4)]
        mesh = make_mesh(data=4, devices=["cuda:0"] * 4)
        got = ring_self_attention(x, *ws, H, mesh, "data", causal=causal)

        def heads(w):
            return (x @ w).reshape(B, T, H, -1).permute(0, 2, 1, 3)

        mask = (torch.tril(torch.ones((T, T), dtype=torch.bool,
                                      device=dev))[None, None]
                if causal else None)
        ctx = tnn.dot_product_attention(heads(ws[0]), heads(ws[1]),
                                        heads(ws[2]), mask)
        want = ctx.permute(0, 2, 1, 3).reshape(B, T, -1) @ ws[3]
        assert got.device.type == "cuda"
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=2e-5, rtol=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
def test_sharded_rows_on_the_card():
    from deeplearning4j_tpu_torch.parallel import (ShardedEmbedding,
                                                   make_mesh)

    dev = _card()
    emb = ShardedEmbedding(vocab_size=1001, dim=16, mesh=make_mesh(
        data=1, model=4, devices=["cuda:0"] * 4), seed=2)
    assert all(t.device.type == "cuda" for t in emb.shards)
    ids = np.random.default_rng(0).integers(0, 1001, 300)
    assert torch.equal(emb.lookup(ids).cpu(),
                       torch.from_numpy(emb.to_numpy()[ids]))
    assert emb.lookup(ids).is_cuda
