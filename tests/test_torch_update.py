"""The port's fused weight update and what it stands on, against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The JAX
side runs ``ops/pallas_update.fused_apply`` in its CPU default mode (``xla``)
and in ``interpret`` mode (the Pallas kernel through the interpreter); the
port runs the plain version of ``csrc/fused_update.cu``, which is what its
wrapper takes for CPU tensors. Where bfloat16 moments are rounded
stochastically, the port is fed the JAX package's own random bits
(``np.uint32(...).view(np.int32)``).

Tolerances, and why:
- ``stochastic_round``: bitwise (the same integer arithmetic).
- parameters: 2.4e-7 absolute, the JAX package's own bound between its modes
  (2 float32 ulp at these magnitudes, tests/test_precision.py:154-203):
  XLA may contract a multiply-add into an FMA where PyTorch rounds twice.
- bfloat16 moments: 1 bf16 ulp of the moment's magnitude elementwise, and
  equal bits in all but 0.1% of the elements (rounded down). A float32
  difference of 2 ulp moves a stochastically rounded value only when the
  pattern plus its 16 random bits lands within 2 of a 2^16 boundary, so
  about 1 element in 2^15 may differ; a rounding that ignored the bits or
  read the other halfword would differ in about half of them. Crafted bits
  pin each slot to its own halfword exactly. Float32 moments 2.4e-7 as the
  parameters.
- the port's fused plain path against its own per-leaf ``apply_updater``:
  bitwise (the same float32 operations in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.learning import precision as jprec
from deeplearning4j_tpu.learning import updaters as jupd
from deeplearning4j_tpu.nn import losses as jlosses
from deeplearning4j_tpu.ops import nn as jnn
from deeplearning4j_tpu.ops import pallas_update
from deeplearning4j_tpu.parallel.sharding import Zero1Plan as JPlan
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.learning import precision as tprec
from deeplearning4j_tpu_torch.learning import updaters as tupd
from deeplearning4j_tpu_torch.nn import losses as tlosses
from deeplearning4j_tpu_torch.ops import nn as tnn
from deeplearning4j_tpu_torch.ops import update as tupdate
from deeplearning4j_tpu_torch.parallel import sharding as tsharding
from torch_parity import modules

PARAM_TOL = 2.4e-7

KINDS = {
    "sgd": (lambda m: m.Sgd(0.1)),
    "nesterovs": (lambda m: m.Nesterovs(0.1, momentum=0.9)),
    "adam": (lambda m: m.Adam(1e-3)),
    "adamw": (lambda m: m.AdamW(1e-3)),
}


@pytest.fixture(autouse=True)
def _fresh_counters():
    OpProfiler.get().reset()
    yield


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _jax_bits16(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


def _t(a) -> torch.Tensor:
    """numpy (float32 or ml_dtypes bfloat16) → CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# --- stochastic rounding --------------------------------------------------


def test_stochastic_round_bitwise_vs_jax():
    rng = np.random.default_rng(0)
    special = np.array([0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
                        0x7FA00001, 0x7F7FFFFF, 0xFF7FFFFF, 0x3F7FFFFF,
                        0xBF7FFFFF, 0x00000001, 0x80000000, 0x00000000,
                        0x3F80FFFF, 0x477FFFFF], np.uint32).view(np.float32)
    normal = (rng.normal(size=4000) * 10.0 ** rng.integers(-30, 30, 4000)
              ).astype(np.float32)
    x = np.concatenate([special, -normal[:50], normal])
    bits = rng.integers(0, 2 ** 32, size=x.shape, dtype=np.uint64).astype(
        np.uint32)
    bits[:len(special)] = 0xFFFF        # the largest round-up: carries
    want = _jax_bits16(jprec.stochastic_round(jnp.asarray(x),
                                              jnp.asarray(bits)))
    got = _bf16_bits(tprec.stochastic_round(torch.from_numpy(x),
                                            torch.from_numpy(bits.view(
                                                np.int32))))
    assert np.array_equal(got, want)
    # the cases the bits above pin: overflow to inf, carry into the exponent
    assert got[5] == 0x7F80 and got[7] == 0x3F80 and got[12] == 0x3F81


def test_stochastic_round_high_halfword_and_refusal():
    x = torch.tensor([1.0 + 2 ** -9], dtype=torch.float32)
    # the high halfword of 0xFFFF0000 is 0xFFFF: rounds up; the low is 0
    bits = torch.tensor([np.uint32(0xFFFF0000).view(np.int32)])
    assert _bf16_bits(tprec.stochastic_round(x, bits))[0] == 0x3F80
    assert _bf16_bits(tprec.stochastic_round(
        x, (bits >> 16) & 0xFFFF))[0] == 0x3F81
    with pytest.raises(NotImplementedError):
        tprec.stochastic_round(x, bits, torch.float16)


# --- the fused update against the JAX package ------------------------------


def _leafy(rng, shapes):
    return {n: {k: rng.normal(size=s).astype(np.float32)
                for k, s in d.items()} for n, d in shapes.items()}


SHAPES = {"c1": {"W": (8, 4, 3, 3)}, "bn": {"gamma": (8,), "beta": (8,)},
          "pool": {}, "out": {"W": (8, 5), "b": (5,)}}


def _case(kind: str, state_dtype, seed: int = 1):
    """numpy params, grads and (nonzero) state in the dense layout."""
    rng = np.random.default_rng(seed)
    params = _leafy(rng, SHAPES)
    grads = {n: {k: (v * 0.01).astype(np.float32) for k, v in d.items()}
             for n, d in _leafy(rng, SHAPES).items()}
    slots = tupdate.SLOTS[kind]
    state = {}
    for s in slots:
        tree = _leafy(rng, SHAPES)
        if s == "v" and kind != "nesterovs":
            tree = {n: {k: np.abs(v) * 1e-3 for k, v in d.items()}
                    for n, d in tree.items()}
        else:
            tree = {n: {k: v * 0.1 for k, v in d.items()}
                    for n, d in tree.items()}
        if state_dtype:
            tree = {n: {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
                        for k, v in d.items()} for n, d in tree.items()}
        state[s] = tree
    return params, grads, state


def _jax_flat(kind, state_dtype, params, grads, state, iteration, mode):
    upd = KINDS[kind](jupd)
    upd.state_dtype = state_dtype
    jp = jax.tree.map(jnp.asarray, params)
    plan = JPlan(jp, 1)
    fs = plan.flatten_state(jax.tree.map(jnp.asarray, state), xp=jnp) \
        if state else {}
    key = jax.random.PRNGKey(5)
    nf, ns = pallas_update.fused_apply(
        upd, plan.flatten(jp), plan.flatten(jax.tree.map(jnp.asarray, grads)),
        fs, iteration, key if state_dtype else None, mode=mode)
    bits = {}
    if state_dtype and state:
        for bi, bkey in enumerate(sorted(nf)):
            sub = jax.random.fold_in(jax.random.fold_in(
                key, jprec.SR_STREAM_TAG), bi)
            bits[bkey] = torch.from_numpy(np.asarray(jax.random.bits(
                sub, nf[bkey].shape, jnp.uint32)).view(np.int32).copy())
    return nf, ns, bits


def _port_flat(kind, state_dtype, params, grads, state, iteration, bits):
    upd = KINDS[kind](tupd)
    upd.state_dtype = state_dtype
    tp = {n: {k: _t(v) for k, v in d.items()} for n, d in params.items()}
    plan = tsharding.Zero1Plan(tp, 1)
    fp = plan.flatten(tp)
    fs = plan.flatten_state({s: {n: {k: _t(v) for k, v in d.items()}
                                 for n, d in tree.items()}
                             for s, tree in state.items()})
    tupdate.fused_apply(upd, fp, plan.flatten(
        {n: {k: _t(v) for k, v in d.items()} for n, d in grads.items()}),
        fs, iteration, bits=bits or None)
    return fp, fs


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fused_apply_matches_jax(kind, state_dtype, mode):
    params, grads, state = _case(kind, state_dtype)
    nf, ns, bits = _jax_flat(kind, state_dtype, params, grads, state, 3,
                             mode)
    fp, fs = _port_flat(kind, state_dtype, params, grads, state, 3, bits)
    assert sorted(fp) == sorted(nf) == ["flat::float32"]
    for key in nf:
        err = np.abs(_np(fp[key]) - np.asarray(nf[key])).max()
        assert err <= PARAM_TOL, (key, err)
    for slot in tupdate.SLOTS[kind]:
        for key in nf:
            got, want = fs[slot][key], ns[slot][key]
            if state_dtype:
                assert got.dtype == torch.bfloat16
                want32 = np.asarray(want.astype(jnp.float32))
                ulp = np.exp2(np.floor(np.log2(np.maximum(
                    np.abs(want32), 1e-30))) - 7)
                assert np.all(np.abs(_np(got) - want32) <= ulp), slot
                differ = int(np.sum(_bf16_bits(got) != _jax_bits16(want)))
                assert differ <= got.numel() // 1000, (slot, differ)
            else:
                err = np.abs(_np(got) - np.asarray(want)).max()
                assert err <= PARAM_TOL, (slot, err)
    prof = OpProfiler.get()
    assert prof.counter_value("precision/fused_hits") == 1
    assert prof.counter_value("precision/fused_buckets_plain") == 1
    assert prof.counter_value("precision/fused_buckets_kernel") == 0


@pytest.mark.parametrize("low,high", [(0, 0xFFFF), (0xFFFF, 0)])
@pytest.mark.parametrize("kind", ["nesterovs", "adam", "adamw"])
def test_each_moment_rounds_with_its_own_halfword(kind, low, high):
    """Crafted bits: one halfword 0 (the magnitude truncates), the other
    0xFFFF (it rounds up, as every float32 moment here has nonzero low
    bits). The first slot must follow the low halfword and the second the
    high one, bitwise, in the plain math and through ``fused_apply``."""
    params, grads, state = _case(kind, "bfloat16", seed=11)
    upd = KINDS[kind](tupd)
    upd.state_dtype = "bfloat16"
    tree = lambda d: {n: {k: _t(v) for k, v in x.items()}  # noqa: E731
                      for n, x in d.items()}
    plan = tsharding.Zero1Plan(tree(params), 1)
    key = "flat::float32"
    fp, fg = plan.flatten(tree(params)), plan.flatten(tree(grads))
    fs = plan.flatten_state({s: tree(t) for s, t in state.items()})
    word = np.uint32((high << 16) | low).view(np.int32)
    bits = torch.full((fp[key].numel(),), int(word), dtype=torch.int32)
    sc = tupdate._scalars(upd, kind, 3)
    slots = {s: fs[s][key] for s in tupdate.SLOTS[kind]}
    _, exact = tupdate.fused_update_reference(kind, sc, fp[key], fg[key],
                                              slots)
    want = {}
    for i, s in enumerate(tupdate.SLOTS[kind]):
        u = exact[s].view(torch.int32).numpy().view(np.uint32).astype(
            np.uint64)
        assert np.all(u & 0xFFFF), s          # round-up != truncation
        r = (low, high)[i]
        want[s] = ((u + r) >> 16).astype(np.uint16)
    _, plain = tupdate.fused_update_reference(kind, sc, fp[key], fg[key],
                                              slots, bits, torch.bfloat16)
    tupdate.fused_apply(upd, fp, fg, fs, 3, bits={key: bits})
    for s in tupdate.SLOTS[kind]:
        assert np.array_equal(_bf16_bits(plain[s]), want[s]), s
        assert np.array_equal(_bf16_bits(fs[s][key]), want[s]), s


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fused_plain_bitwise_vs_per_leaf(kind, state_dtype):
    """The port's own rule: the fused plain path equals its per-leaf
    ``apply_updater`` bit for bit (parameters always; float32 moments too;
    bfloat16 moments draw other bits per leaf, so only their dtype)."""
    params, grads, state = _case(kind, state_dtype, seed=4)
    upd = KINDS[kind](tupd)
    upd.state_dtype = state_dtype
    tp = {n: {k: _t(v) for k, v in d.items()} for n, d in params.items()}
    tg = {n: {k: _t(v) for k, v in d.items()} for n, d in grads.items()}
    ts = {s: {n: {k: _t(v) for k, v in d.items()} for n, d in tree.items()}
          for s, tree in state.items()}
    gen = torch.Generator().manual_seed(0)
    ref_p, ref_s = tprec.apply_updater(upd, tg, ts, tp, 7, gen)
    plan = tsharding.Zero1Plan(tp, 1)
    fp, fs = plan.flatten(tp), plan.flatten_state(ts)
    tupdate.fused_apply(upd, fp, plan.flatten(tg), fs, 7,
                        torch.Generator().manual_seed(1))
    got_p = plan.unflatten(fp)
    for n, k in plan.paths:
        assert torch.equal(got_p[n][k], ref_p[n][k]), (n, k)
    for s in tupdate.SLOTS[kind]:
        dense = plan.unflatten(fs[s])
        for n, k in plan.paths:
            if state_dtype:
                assert dense[n][k].dtype == ref_s[s][n][k].dtype \
                    == torch.bfloat16
            else:
                assert torch.equal(dense[n][k], ref_s[s][n][k]), (s, n, k)


@pytest.mark.parametrize("kind", ["nesterovs", "adam"])
def test_per_leaf_updater_matches_jax(kind):
    params, grads, state = _case(kind, None, seed=6)
    jupdater = KINDS[kind](jupd)
    jp, js = jupdater.apply(jax.tree.map(jnp.asarray, grads),
                            jax.tree.map(jnp.asarray, state),
                            jax.tree.map(jnp.asarray, params), 2)
    tp, ts = KINDS[kind](tupd).apply(
        {n: {k: _t(v) for k, v in d.items()} for n, d in grads.items()},
        {s: {n: {k: _t(v) for k, v in d.items()} for n, d in tree.items()}
         for s, tree in state.items()},
        {n: {k: _t(v) for k, v in d.items()} for n, d in params.items()}, 2)
    for n, d in params.items():
        for k in d:
            assert np.abs(_np(tp[n][k]) - np.asarray(jp[n][k])).max() \
                <= PARAM_TOL
            for s in ts:
                assert np.abs(_np(ts[s][n][k])
                              - np.asarray(js[s][n][k])).max() <= PARAM_TOL


def test_scalars_match_jax():
    for kind, mk in KINDS.items():
        for it in (0, 3, 999):
            want = pallas_update._scalars(mk(jupd), kind, it)
            got = tupdate._scalars(mk(tupd), kind, it)
            assert [np.float32(w) for w in want] == \
                [np.float32(g) for g in got], (kind, it)
            assert all(float(np.float32(g)) == g for g in got)


def test_state_dtype_needs_a_generator_and_fallback_is_counted():
    params, grads, state = _case("adam", "bfloat16")
    upd = tupd.Adam(1e-3)
    upd.state_dtype = "bfloat16"
    tp = {n: {k: _t(v) for k, v in d.items()} for n, d in params.items()}
    plan = tsharding.Zero1Plan(tp, 1)
    fs = plan.flatten_state({s: {n: {k: _t(v) for k, v in d.items()}
                                 for n, d in tree.items()}
                             for s, tree in state.items()})
    with pytest.raises(ValueError, match="Generator"):
        tupdate.fused_apply(upd, plan.flatten(tp), plan.flatten(tp), fs, 0)

    class MyAdam(tupd.Adam):     # another type: no kernel of its own
        pass

    mine = MyAdam(1e-3)
    assert not tupdate.supports_fused(mine)
    fp = plan.flatten(tp)
    fs = plan.flatten_state({s: {n: {k: _t(v).float() for k, v in d.items()}
                                 for n, d in tree.items()}
                             for s, tree in state.items()})
    before = fp["flat::float32"].clone()
    out_p, _ = tupdate.apply_flat_updater(mine, fp, plan.flatten(tp), fs, 0)
    assert out_p["flat::float32"] is fp["flat::float32"]
    assert not torch.equal(before, fp["flat::float32"])
    assert OpProfiler.get().counter_value("precision/fused_fallbacks") == 1
    assert OpProfiler.get().counter_value("precision/fused_hits") == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        tupdate.fused_update_cuda("sgd", (0.1,), p, p.clone(), {})
    assert tupdate.fused_update_launches == 0


def test_in_place_update_of_views():
    """The parameters are views of the bucket, so they change with it."""
    params, grads, _ = _case("sgd", None)
    tp = {n: {k: _t(v) for k, v in d.items()} for n, d in params.items()}
    plan = tsharding.Zero1Plan(tp, 1)
    fp = plan.flatten(tp)
    views = plan.unflatten(fp)
    old = {(n, k): views[n][k].clone() for n, k in plan.paths}
    tupdate.fused_apply(tupd.Sgd(0.5), fp, plan.flatten(
        {n: {k: _t(v) for k, v in d.items()} for n, d in grads.items()}),
        {}, 0)
    for n, k in plan.paths:
        want = old[(n, k)] - torch.tensor(np.float32(0.5)) * _t(grads[n][k])
        assert torch.equal(views[n][k], want)


# --- Zero1Plan ------------------------------------------------------------


def _resnet_params():
    jz = modules("jax").zoo
    g = jz.ResNet50(num_classes=10, image_size=32).init()
    return {n: {k: np.asarray(v) for k, v in d.items()}
            for n, d in g._params.items()}


@pytest.mark.parametrize("n_shards", [1, 3])
def test_plan_matches_jax_on_resnet_params(n_shards):
    params = _resnet_params()
    # a bfloat16 leaf makes a second bucket, sorted ahead of float32
    params["stem_bn"]["gamma"] = np.asarray(
        jnp.asarray(params["stem_bn"]["gamma"], jnp.bfloat16))
    jp = JPlan(jax.tree.map(jnp.asarray, params), n_shards)
    tparams = {n: {k: _t(v) for k, v in d.items()} for n, d in params.items()}
    tp = tsharding.Zero1Plan(tparams, n_shards)
    assert [b.key for b in tp.buckets] == [b.key for b in jp.buckets] \
        == ["flat::bfloat16", "flat::float32"]
    for tb, jb in zip(tp.buckets, jp.buckets):
        assert (tb.leaf_idx, tb.sizes, tb.shapes, tb.total, tb.padded,
                tb.shard) == (jb.leaf_idx, jb.sizes, jb.shapes, jb.total,
                              jb.padded, jb.shard)
    paths = [tuple(p.key for p in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    assert tp.paths == paths and tp.n_leaves == 161
    jflat = jp.flatten(jax.tree.map(jnp.asarray, params))
    tflat = tp.flatten(tparams)
    for key in jflat:
        a = np.asarray(jflat[key])
        b = tflat[key]
        assert np.array_equal(
            a.view(np.uint16) if a.dtype.name == "bfloat16" else a,
            _bf16_bits(b) if b.dtype == torch.bfloat16 else b.numpy())
    back = tp.unflatten(tflat)
    for n, k in tp.paths:
        assert torch.equal(back[n][k], tparams[n][k])
        assert back[n][k].data_ptr() >= tflat[
            "flat::" + ("bfloat16" if back[n][k].dtype == torch.bfloat16
                        else "float32")].data_ptr()


def test_plan_state_round_trips():
    rng = np.random.default_rng(2)
    tp = {n: {k: _t(v) for k, v in d.items()}
          for n, d in _leafy(rng, SHAPES).items()}
    plan = tsharding.Zero1Plan(tp, 4)
    state = {"m": {n: {k: torch.randn(v.shape) for k, v in d.items()}
                   for n, d in tp.items()}, "note": 3}
    flat = plan.flatten_state(state)
    assert tsharding.is_flat_state(flat) and not tsharding.is_flat_state(
        state)
    assert flat["note"] == 3
    assert flat["m"]["flat::float32"].numel() == plan.buckets[0].padded
    for dense in (plan.unflatten_state_inplan(flat),
                  plan.unflatten_state(flat),
                  tsharding.unflatten_updater_state(flat, tp)):
        for n, k in plan.paths:
            assert torch.equal(dense["m"][n][k], state["m"][n][k])
    # a flat state padded for another shard count, as numpy arrays
    other = {"m": {"flat::float32": np.concatenate(
        [flat["m"]["flat::float32"].numpy()[:plan.buckets[0].total],
         np.zeros(7, np.float32)])}}
    dense = plan.unflatten_state(other)
    for n, k in plan.paths:
        assert np.array_equal(dense["m"][n][k], state["m"][n][k].numpy())
    short = {"m": {"flat::float32": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="does not match"):
        plan.unflatten_state(short)


# --- batchnorm_train --------------------------------------------------------


@pytest.mark.parametrize("offset", [0.0, 1000.0])
@pytest.mark.parametrize("shape", [(4, 6, 5, 3), (16, 7)])
def test_batchnorm_train_matches_jax_vjp(shape, offset):
    """Forward (out, batch mean, biased batch var) and the hand backward
    against ``jax.vjp`` in float32, including |mean| >> std (offset 1000:
    the pivot, the running mean, keeps the single-pass variance exact).
    Tolerance rtol 1e-5 plus 1e-5 of the output scale: the sums run in
    another order."""
    rng = np.random.default_rng(3)
    axis = 1
    c = shape[axis]
    x = (rng.normal(size=shape) * 2.0 + offset).astype(np.float32)
    gamma = rng.normal(1.0, 0.2, c).astype(np.float32)
    beta = rng.normal(0.0, 0.2, c).astype(np.float32)
    pivot = (rng.normal(size=c) * 0.5 + offset).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    eps = 1e-5

    def f(x, g, b):
        return jnn.batchnorm_train(x, g, b, epsilon=eps, axis=axis,
                                   pivot=jnp.asarray(pivot))

    (jo, jm, jv), vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(gamma),
                                jnp.asarray(beta))
    jdx, jdg, jdb = vjp((jnp.asarray(dy), jnp.zeros_like(jm),
                         jnp.zeros_like(jv)))
    tx, tg, tb = (torch.from_numpy(a.copy()).requires_grad_()
                  for a in (x, gamma, beta))
    to, tm, tv = tnn.batchnorm_train(tx, tg, tb, epsilon=eps, axis=axis,
                                     pivot=torch.from_numpy(pivot))
    assert not tm.requires_grad and not tv.requires_grad
    to.backward(torch.from_numpy(dy))

    def close(got, want):
        want = np.asarray(want)
        tol = 1e-5 * np.abs(want) + 1e-5 * (np.abs(want).max() + 1.0)
        assert np.all(np.abs(_np(got) - want) <= tol), \
            np.abs(_np(got) - want).max()

    close(to, jo)
    close(tm, jm)
    close(tv, jv)
    close(tx.grad, jdx)
    close(tg.grad, jdg)
    close(tb.grad, jdb)


def test_batchnorm_train_bf16_casts_like_jax():
    """In bfloat16 the output forms from bf16 mean, inv*gamma and beta, as
    the JAX package does: equal to a float32 recomputation with those
    roundings, within 1 bf16 ulp of the output."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(4, 3, 5, 5)).astype(
        np.float32)).to(torch.bfloat16)
    gamma = torch.from_numpy(rng.normal(1, 0.1, 3).astype(np.float32))
    beta = torch.from_numpy(rng.normal(0, 0.1, 3).astype(np.float32))
    out, mean, var = tnn.batchnorm_train(x, gamma, beta)
    assert out.dtype == torch.bfloat16 and mean.dtype == var.dtype \
        == torch.float32
    sh = (1, 3, 1, 1)
    inv = torch.rsqrt(var + 1e-5)
    want = ((x - mean.reshape(sh).to(torch.bfloat16))
            * (inv * gamma).reshape(sh).to(torch.bfloat16)
            + beta.reshape(sh).to(torch.bfloat16))
    assert torch.equal(out, want)


# --- loss ---------------------------------------------------------------------


@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_mcxent_matches_jax(masked, average):
    rng = np.random.default_rng(4)
    pre = rng.normal(size=(6, 5)).astype(np.float32) * 3
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32) if masked else None
    want = jlosses.LossMCXENT().compute_score(
        jnp.asarray(labels), jnp.asarray(pre), "softmax",
        None if mask is None else jnp.asarray(mask), average=average)
    got = tlosses.LossMCXENT().compute_score(
        torch.from_numpy(labels), torch.from_numpy(pre), "softmax",
        None if mask is None else torch.from_numpy(mask), average=average)
    assert abs(float(got) - float(want)) <= 1e-6 * (abs(float(want)) + 1)
    per_j = jlosses.LossMCXENT().score_array(
        jnp.asarray(labels), jnp.asarray(pre), "softmax")
    per_t = tlosses.LossMCXENT().score_array(
        torch.from_numpy(labels), torch.from_numpy(pre), "softmax")
    assert np.allclose(per_t.numpy(), np.asarray(per_j), rtol=1e-6,
                       atol=1e-6)
