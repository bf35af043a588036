"""The kernel ops' routing rule (``deeplearning4j_tpu_torch/ops/routing.py``)
and the routes it sends to the plain versions, against the JAX package, on
the CPU.

The JAX package launches a Pallas kernel only for the dtypes it takes and
never under a gradient; every other call goes through the same math in its
``xla`` mode, its default off the TPU. The port's rule gives the card the
same routes: the kernel for a CUDA tensor it takes with no gradient needed,
the plain version otherwise. On the CPU the port always takes the plain
version, so these tests hold the plain routes that the card now takes for
float64, bfloat16 and gradients to the JAX package; the card's own checks
are ``tests/test_torch_kernel_cuda.py``'s and chip_smoke's.

Tolerances, and why:
- float64 ``bn_act``: rtol 1e-12, atol 1e-12 (float64 rounding; float32
  math after the fold lands about 1e-7 of the output's size away).
- gradients of the two-block conv/BN net through the fused epilogue: rtol
  1e-4, atol 1e-6 (``tests/test_torch_multilayer.py``'s LeNet gradients).
- ``embedding_bag`` gradients and SameDiff's through it: 1e-6 absolute
  (``tests/test_torch_embeddings.py``'s bound against ``xla``).
- float64 buckets: 1e-12 relative. bfloat16 buckets: the JAX package's
  float32 scalars promote the math to float32, rounded once to bfloat16;
  XLA may contract a multiply-add into an FMA, so an element may land one
  bfloat16 ulp away (PyTorch rounds twice), and all but 1% must be
  bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import SameDiff as JSameDiff
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.learning import updaters as jupd
from deeplearning4j_tpu.ops import embeddings as jemb
from deeplearning4j_tpu.ops import pallas_epilogue, pallas_update
from deeplearning4j_tpu.parallel.sharding import Zero1Plan as JPlan
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.learning import updaters as tupd
from deeplearning4j_tpu_torch.ops import embeddings as temb
from deeplearning4j_tpu_torch.ops import epilogue, routing
from deeplearning4j_tpu_torch.ops import update as tupdate
from deeplearning4j_tpu_torch.parallel import sharding as tsharding
from test_torch_serving import cnn_twins

F32, BF16, F16, F64 = (torch.float32, torch.bfloat16, torch.float16,
                       torch.float64)

#: the dtypes each TPU kernel runs for in the JAX package: fused_apply
#: launches its kernel for a float32 bucket only (pallas_update.py:271);
#: the epilogue and the bag kernels take float32 and bfloat16
JAX_KERNEL_DTYPES = {"bn_act": (F32, BF16), "fused_update": (F32,),
                     "embedding_bag": (F32, BF16)}
PORT_KERNEL_DTYPES = {"bn_act": epilogue.KERNEL_DTYPES,
                      "fused_update": tupdate.KERNEL_DTYPES,
                      "embedding_bag": temb.KERNEL_DTYPES}


@pytest.fixture(autouse=True)
def _fresh_counters():
    OpProfiler.get().reset()
    yield


# --- the rule ----------------------------------------------------------------

@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [F32, BF16, F16, F64])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("op", sorted(JAX_KERNEL_DTYPES))
def test_routing_rule(op, device, dtype, grad):
    """device x dtype x gradient -> kernel or plain: the kernel only for a
    CUDA tensor of a dtype the JAX kernel takes, with no gradient."""
    want = device == "cuda" and not grad and dtype in JAX_KERNEL_DTYPES[op]
    leaf = torch.zeros(2, requires_grad=grad)
    assert routing.use_kernel(torch.device(device),
                              dtype in PORT_KERNEL_DTYPES[op], None,
                              leaf) is want


def test_other_devices_raise_and_needs_grad():
    with pytest.raises(ValueError, match="no implementation for meta"):
        routing.use_kernel(torch.device("meta"), True)
    leaf = torch.zeros(2, requires_grad=True)
    assert routing.needs_grad(None, torch.zeros(2), leaf)
    assert not routing.needs_grad(None, torch.zeros(2))
    with torch.no_grad():
        assert not routing.needs_grad(leaf)
        assert routing.use_kernel(torch.device("cuda"), True, leaf)


def _spy(monkeypatch):
    """Record each question the dispatchers put to the rule."""
    asked = []
    real = routing.use_kernel

    def use_kernel(device, takes, *grad_inputs):
        asked.append((device.type, takes, routing.needs_grad(*grad_inputs)))
        return real(device, takes, *grad_inputs)

    monkeypatch.setattr(routing, "use_kernel", use_kernel)
    return asked


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [F32, BF16, F16, F64])
def test_dispatchers_ask_the_rule(monkeypatch, dtype, grad):
    """bn_act_apply, the bag and update_bucket each ask the rule once, with
    the tensor's device, whether the kernel takes its dtype, and whether a
    gradient is needed (never, for the in-place update)."""
    asked = _spy(monkeypatch)
    x = torch.randn(2, 3, 4, 4, dtype=dtype, requires_grad=grad)
    scale, shift = torch.rand(3), torch.rand(3)
    epilogue.bn_act_apply(x, scale, shift, None, "relu")
    table = torch.randn(7, 5, dtype=dtype, requires_grad=grad)
    temb.embedding_bag(table, torch.zeros(2, 3, dtype=torch.int32))
    p = torch.randn(6, dtype=dtype)
    tupdate.update_bucket("sgd", (0.5,), p, torch.randn(6, dtype=dtype), {},
                          None, None)
    takes = {op: dtype in JAX_KERNEL_DTYPES[op] for op in JAX_KERNEL_DTYPES}
    assert asked == [("cpu", takes["bn_act"], grad),
                     ("cpu", takes["embedding_bag"], grad),
                     ("cpu", takes["fused_update"], False)]
    prof = OpProfiler.get()
    assert prof.counter_value("precision/fused_buckets_plain") == 1
    for name in ("precision/epilogue_plain_on_card",
                 "precision/fused_buckets_plain_on_card",
                 "nlp/embedding_bag_plain_on_card"):
        assert prof.counter_value(name) == 0


def test_bn_act_kernel_refuses_a_gradient_first():
    """The wrapper refuses an input that needs a gradient before any other
    check (its output would have no grad_fn: silent zero gradients)."""
    x = torch.randn(2, 3, 4, 4)
    scale, shift = torch.rand(3), torch.rand(3)
    for args in ((x.requires_grad_(True), scale, shift),
                 (x.detach(), scale.requires_grad_(True), shift)):
        with pytest.raises(RuntimeError, match="no backward"):
            epilogue.bn_act_cuda(*args)
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            epilogue.bn_act_cuda(*args)
    assert epilogue.bn_act_launches == 0


# --- bn_act in float64 -------------------------------------------------------

#: variances whose float32 fold is exact (``rsqrt`` of a power of four,
#: epsilon 0): XLA's and PyTorch's float32 ``rsqrt`` are each within an
#: ulp, and differ in about a third of random channels, which moves a
#: float64 output by 1e-7 of its size whatever the math after the fold
EXACT_FOLD_VARS = np.array([0.0625, 0.25, 1.0, 4.0, 16.0], np.float32)


def _bn_case(shape, residual, seed=11):
    rng = np.random.default_rng(seed)
    C = shape[1]
    x = rng.normal(scale=3.0, size=shape)
    res = rng.normal(size=shape) if residual else None
    stats = [rng.normal(size=C), EXACT_FOLD_VARS[rng.integers(0, 5, C)],
             rng.normal(1.0, 0.1, size=C), rng.normal(size=C)]
    return x, res, [s.astype(np.float32) for s in stats]


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("shape", [(2, 128, 5, 5), (7, 256)])
def test_float64_bn_act_matches_jax_xla(shape, act, residual):
    """scale and shift folded in float32 and cast up, the math in float64,
    as the JAX package's xla mode computes it (float32 math after the
    fold misses by about 1e-7 of the output's size)."""
    x, res, stats = _bn_case(shape, residual)
    want = np.asarray(pallas_epilogue.bn_act(
        jnp.asarray(x), *map(jnp.asarray, stats), epsilon=0.0, act=act,
        residual=None if res is None else jnp.asarray(res), mode="xla"))
    got = epilogue.bn_act(
        torch.from_numpy(x), *map(torch.from_numpy, stats), epsilon=0.0,
        act=act, residual=None if res is None else torch.from_numpy(res))
    assert want.dtype == np.float64 and got.dtype == F64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [F32, BF16, F16, F64])
def test_fold_is_one_rsqrt_on_the_kernels_dtypes(dtype):
    """The kernel's dtypes (the main path) fold with one float32 ``rsqrt``,
    as the JAX package does; the others take ``1/sqrt`` in float64 rounded
    once to float32, the same on the card and on the CPU."""
    rng = np.random.default_rng(13)
    var = torch.from_numpy(rng.uniform(0.5, 2.0, 64).astype(np.float32))
    mean = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 64, 3, 3))).to(dtype)
    kernel = dtype in epilogue.KERNEL_DTYPES
    scale = (torch.rsqrt(var + 1e-5) if kernel else
             (1.0 / torch.sqrt((var + 1e-5).double())).float())
    assert torch.equal(epilogue.fold(mean, var, exact=not kernel)[0], scale)
    want = epilogue.bn_act_reference(x, scale, -mean * scale, None, "relu")
    assert torch.equal(epilogue.bn_act(x, mean, var, act="relu"), want)


# --- gradients through the fused BN epilogue ---------------------------------

def test_gradients_through_the_fused_epilogue_match_jax():
    """compute_gradient_and_score runs the loss in inference mode, so with
    fused_epilogue on both BNs take the epilogue: the gradients of the
    convolutions and of gamma/beta flow through its plain version."""
    jn, tn = cnn_twins()
    rng = np.random.default_rng(12)
    x = rng.normal(size=(4, 3, 6, 6)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)]
    jg, js = jn.compute_gradient_and_score(JDataSet(x, y))
    tg, ts = tn.compute_gradient_and_score(DataSet(x, y))
    assert OpProfiler.get().counter_value("precision/epilogue_hits") == 2
    assert abs(ts - js) <= 1e-5 * abs(js)
    assert len(tg) == len(jg) == 5
    for i, (jd, td) in enumerate(zip(jg, tg)):
        assert sorted(jd) == sorted(td)
        for k in jd:
            want = np.asarray(jd[k])
            np.testing.assert_allclose(td[k].numpy(), want, rtol=1e-4,
                                       atol=1e-6, err_msg=f"layer {i} {k}")
            if i < 4:      # below the head: zero only if the route detached
                assert np.abs(want).max() > 0 and td[k].abs().max() > 0


# --- embedding_bag gradients -------------------------------------------------

def _bag_case(B=9, W=5, V=13, D=6, seed=13):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, D)).astype(np.float32)
    idx = rng.integers(0, V, size=(B, W)).astype(np.int32)
    mask = (rng.random((B, W)) < 0.7).astype(np.float32)
    mask[3] = 0.0
    up = rng.normal(size=(B, D)).astype(np.float32)
    return table, idx, mask, up


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_embedding_bag_gradients_match_jax(mode):
    """The table's gradient against jax.grad through the JAX op's xla
    lowering, with a mask and a fully masked bag."""
    table, idx, mask, up = _bag_case()

    def jloss(t):
        return jnp.sum(jemb.embedding_bag(t, jnp.asarray(idx),
                                          jnp.asarray(mask), mode=mode,
                                          impl="xla") * up)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_(True)
    (temb.embedding_bag(t, torch.from_numpy(idx), torch.from_numpy(mask),
                        mode=mode) * torch.from_numpy(up)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=0, atol=1e-6)
    assert np.abs(want).max() > 0
    assert temb.embedding_bag_launches == 0


def _bag_graph(sd, table, idx, mask, up):
    t = sd.var("t", init=table)
    bag = sd.nn.embedding_bag(t, sd.constant("i", idx),
                              sd.constant("m", mask), mode="mean")
    return bag.mul(sd.constant("u", up)).sum().rename("loss")


def test_samediff_gradients_through_embedding_bag_match_jax():
    table, idx, mask, up = _bag_case(seed=14)
    jsd, tsd = JSameDiff.create(), SameDiff("cpu")
    for sd in (jsd, tsd):
        _bag_graph(sd, table, idx, mask, up)
    want = np.asarray(jsd.calculate_gradients({}, "loss", ["t"])["t"])
    got = tsd.calculate_gradients({}, "loss", ["t"])["t"]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert np.abs(want).max() > 0


# --- float64 and bfloat16 buckets of the fused update ------------------------

KINDS = {
    "sgd": (lambda m: m.Sgd(0.1)),
    "nesterovs": (lambda m: m.Nesterovs(0.1, momentum=0.9)),
    "adam": (lambda m: m.Adam(1e-3)),
    "adamw": (lambda m: m.AdamW(1e-3)),
}
SHAPES = {"c1": {"W": (8, 4, 3, 3)}, "bn": {"gamma": (8,), "beta": (8,)},
          "out": {"W": (8, 5), "b": (5,)}}


def _tree(rng, scale=1.0, positive=False):
    out = {}
    for n, d in SHAPES.items():
        out[n] = {}
        for k, s in d.items():
            v = rng.normal(size=s) * scale
            out[n][k] = np.abs(v) if positive else v
    return out


def _bits16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fused_apply_buckets_of_other_dtypes_match_jax(kind, dtype):
    """A float64 or bfloat16 network's bucket through fused_apply: the
    JAX package's xla mode against the port's plain route (the card's
    route for these buckets), written back in the stored dtypes."""
    rng = np.random.default_rng(15)
    params, grads = _tree(rng), _tree(rng, 0.01)
    state = {s: _tree(rng, 1e-3 if s == "v" and kind != "nesterovs"
                      else 0.1, positive=s == "v" and kind != "nesterovs")
             for s in tupdate.SLOTS[kind]}
    jdt = jnp.float64 if dtype == "float64" else jnp.bfloat16

    def jtree(t):
        return jax.tree.map(lambda a: jnp.asarray(a, jdt), t)

    plan = JPlan(jtree(params), 1)
    jf, js = pallas_update.fused_apply(
        KINDS[kind](jupd), plan.flatten(jtree(params)),
        plan.flatten(jtree(grads)),
        plan.flatten_state(jtree(state), xp=jnp) if state else {}, 3, None,
        mode="xla")
    tdt = getattr(torch, dtype)

    def ttree(t):
        return {n: {k: torch.from_numpy(np.asarray(jnp.asarray(v, jdt)).view(
            np.uint16).copy()).view(tdt) if tdt == BF16 else
                torch.from_numpy(v) for k, v in d.items()}
                for n, d in t.items()}

    tp = ttree(params)
    tplan = tsharding.Zero1Plan(tp, 1)
    fp = tplan.flatten(tp)
    fs = tplan.flatten_state({s: ttree(t) for s, t in state.items()})
    tupdate.fused_apply(KINDS[kind](tupd), fp, tplan.flatten(ttree(grads)),
                        fs, 3)
    key = f"flat::{dtype}"
    pairs = [(fp[key], jf[key])] + [(fs[s][key], js[s][key])
                                    for s in tupdate.SLOTS[kind]]
    for got, want in pairs:
        assert got.dtype == tdt and str(want.dtype) == dtype
        if tdt == F64:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-12, atol=0)
            continue
        w = np.asarray(want)
        gb, wb = _bits16(got), w.view(np.uint16)
        assert (gb != wb).mean() <= 0.01
        ulp = np.abs(np.asarray(want, np.float32)) * 2.0 ** -7
        np.testing.assert_array_less(
            np.abs(got.float().numpy() - np.asarray(w, np.float32)),
            ulp + 1e-30)
    assert OpProfiler.get().counter_value(
        "precision/fused_buckets_plain") == 1


@pytest.mark.parametrize("dtype", [F64, BF16])
def test_member_buckets_of_other_dtypes_are_rows_of_the_single_route(dtype):
    """The member-batched plain route on an [M, N] bucket of another dtype
    is, row by row, the single bucket's with the row's learning rate, and
    keeps a masked row's values."""
    gen = torch.Generator().manual_seed(16)
    M, N = 3, 37
    p = torch.randn(M, N, generator=gen).to(dtype)
    g = (torch.randn(M, N, generator=gen) * 0.01).to(dtype)
    v = (torch.randn(M, N, generator=gen) * 0.1).to(dtype)
    lr = torch.tensor([0.1, 0.05, 0.2])
    live = torch.tensor([1, 0, 1], dtype=torch.int32)
    sc = (0.1, 0.9, 1.9)
    rows = [tupdate.fused_update_reference(
        "nesterovs", (float(lr[m]),) + sc[1:], p[m], g[m], {"v": v[m]})
        for m in range(M)]
    p0, v0 = p.clone(), v.clone()
    tupdate.update_members_bucket("nesterovs", sc, p, g, {"v": v}, None,
                                  None, lr, live)
    for m, (rp, rs) in enumerate(rows):
        want_p, want_v = ((rp.to(dtype), rs["v"].to(dtype)) if live[m]
                          else (p0[m], v0[m]))
        assert torch.equal(p[m], want_p) and torch.equal(v[m], want_v)
    assert p.dtype == v.dtype == dtype
    assert OpProfiler.get().counter_value(
        "precision/fused_member_buckets_plain") == 1
