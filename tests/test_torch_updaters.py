"""The port's 11 updaters and 7 learning-rate schedules against the JAX
package's, on the CPU.

- Schedules: each ``value_at`` rounded to float32 (what the update uses)
  bitwise against the JAX schedule traced with an int64 iteration, as the
  JAX step traces it, at iterations that cross every branch (the
  ``CycleSchedule`` boundaries among them); then 3 steps of ``Sgd`` leaf by
  leaf and of the fused ``Nesterovs`` (the kernel's plain version against
  the JAX ``xla`` mode) with each schedule as the rate.
- Updaters: 3 steps of each, leaf by leaf, float32 state, inside
  ``jax.jit`` as the JAX step runs them. Parameters and moments within 2
  float32 ulp of each leaf's largest magnitude (XLA may contract a
  multiply-add into an FMA where PyTorch rounds twice; the JAX package's
  own bound between its modes, tests/test_precision.py:154-203). AdaDelta's
  moments within 8: XLA rewrites its ``sqrt(a) / sqrt(b)`` as a product
  with ``rsqrt(b)`` (one more rounding in the step ``dx``), and ``msdx``
  accumulates ``dx * dx``, which doubles that relative error.
- bfloat16 state: the first step's parameters are bitwise those of the
  float32-state run (the moments start at 0), and every stored moment is
  one of the two bf16 neighbours of the float32 moment (stochastic
  rounding).
- ``AdaMax``, ``Nadam`` and ``AMSGrad`` under ``fused_update``: no kernel
  (the kind table matches the exact type), so the per-leaf math runs on
  the flat buckets, counted under ``precision/fused_fallbacks`` as in the
  JAX package, bitwise equal to the per-leaf path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.learning import schedules as js
from deeplearning4j_tpu.learning import updaters as ju
from deeplearning4j_tpu.ops import pallas_update as jpu
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.learning import precision as tprec
from deeplearning4j_tpu_torch.learning import schedules as ts
from deeplearning4j_tpu_torch.learning import updaters as tu
from deeplearning4j_tpu_torch.ops import update as tupd

SCHEDULES = {
    "constant": None,
    "FixedSchedule": {"value": 0.05},
    "StepSchedule": {"initial_value": 0.1, "decay_rate": 0.5, "step": 2},
    "ExponentialSchedule": {"initial_value": 0.1, "gamma": 0.9},
    "PolySchedule": {"initial_value": 0.1, "power": 2.0, "max_iter": 5},
    "InverseSchedule": {"initial_value": 0.1, "gamma": 0.3, "power": 0.75},
    "SigmoidSchedule": {"initial_value": 0.1, "gamma": 0.7, "step_size": 2},
    "CycleSchedule": {"initial_value": 0.01, "max_value": 0.1,
                      "cycle_length": 4, "annealing_cycles": 0.5},
}

UPDATERS = {
    "Sgd": {"learning_rate": 0.05},
    "NoOp": {},
    "Nesterovs": {"learning_rate": 0.05, "momentum": 0.9},
    "AdaGrad": {"learning_rate": 0.05},
    "AdaDelta": {},
    "RmsProp": {"learning_rate": 0.01},
    "Adam": {"learning_rate": 0.01},
    "AdamW": {"learning_rate": 0.01, "weight_decay": 0.05},
    "AdaMax": {"learning_rate": 0.01},
    "Nadam": {"learning_rate": 0.01},
    "AMSGrad": {"learning_rate": 0.01},
}
STEPS = 3


def _schedule(mod, name):
    kw = SCHEDULES[name]
    return 0.05 if kw is None else getattr(mod, name)(**kw)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": {"W": (rng.normal(size=(3, 5)) * scale).astype(np.float32),
                  "b": (rng.normal(size=(5,)) * scale).astype(np.float32)},
            "c": {"W": (rng.normal(size=(4, 2)) * scale).astype(np.float32)}}


def _jtree(t):
    return {n: {k: jnp.asarray(v) for k, v in d.items()} for n, d in t.items()}


def _ttree(t):
    return {n: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
            for n, d in t.items()}


def _np(tree):
    return {n: {k: np.asarray(v.float() if isinstance(v, torch.Tensor)
                              else v, np.float32)
                for k, v in d.items()} for n, d in tree.items()}


def _assert_ulp(got, want, what, ulps=2):
    for n, d in want.items():
        for k, v in d.items():
            g, w = got[n][k], np.asarray(v, np.float32)
            tol = ulps * np.spacing(np.float32(np.abs(w).max()))
            assert np.abs(g - w).max() <= tol, (what, n, k,
                                                np.abs(g - w).max(), tol)


def test_every_updater_and_schedule_is_ported():
    assert sorted(ju._BY_NAME) == sorted(tu._BY_NAME)
    for name, cls in ju._BY_NAME.items():
        assert type(tu.updater_from_name(name)).__name__ == cls.__name__
    jnames = {n for n, c in vars(js).items() if isinstance(c, type)
              and issubclass(c, js.ISchedule) and c is not js.ISchedule}
    assert jnames == set(SCHEDULES) - {"constant"}
    assert {n for n in jnames if hasattr(ts, n)} == jnames


@pytest.mark.parametrize("name", sorted(set(SCHEDULES) - {"constant"}))
def test_schedule_values_round_to_jax_float32(name):
    js_, ts_ = _schedule(js, name), _schedule(ts, name)
    for it in range(0, 13):
        want = np.float32(js_.value_at(jnp.asarray(it)))
        got = np.float32(ts_.value_at(it))
        assert got.tobytes() == want.tobytes(), (name, it, got, want)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("kind", ["sgd", "fused_nesterovs"])
def test_schedule_drives_three_steps_like_jax(name, kind):
    params, state = _tree(1), None
    grads = [_tree(10 + i, 0.5) for i in range(STEPS)]
    if kind == "sgd":
        ju_, tu_ = ju.Sgd(_schedule(js, name)), tu.Sgd(_schedule(ts, name))
        jstep = jax.jit(lambda p, g, it: ju_.apply(g, {}, p, it))
        jp, tp = _jtree(params), _ttree(params)
        for i in range(STEPS):
            jp, _ = jstep(jp, _jtree(grads[i]), jnp.asarray(i))
            tp, _ = tu_.apply(_ttree(grads[i]), {}, tp, i)
        _assert_ulp(_np(tp), _np(jp), "params")
        return
    ju_ = ju.Nesterovs(_schedule(js, name), momentum=0.9)
    tu_ = tu.Nesterovs(_schedule(ts, name), momentum=0.9)
    n = sum(v.size for d in params.values() for v in d.values())
    flat_p = np.concatenate([params[a][b].ravel() for a, b in
                             (("a", "W"), ("a", "b"), ("c", "W"))])
    jf = {"flat::float32": jnp.asarray(flat_p)}
    js_state = {"v": {"flat::float32": jnp.zeros(n, jnp.float32)}}
    tf = {"flat::float32": torch.from_numpy(flat_p.copy())}
    ts_state = {"v": {"flat::float32": torch.zeros(n)}}
    for i in range(STEPS):
        g = np.random.default_rng(20 + i).normal(size=n).astype(np.float32)
        jf, js_state = jpu.fused_apply(
            ju_, jf, {"flat::float32": jnp.asarray(g)}, js_state,
            jnp.asarray(i), jax.random.PRNGKey(0), mode="xla")
        tupd.fused_apply(tu_, tf, {"flat::float32": torch.from_numpy(g)},
                         ts_state, i)
    got = tf["flat::float32"].numpy()
    want = np.asarray(jf["flat::float32"])
    assert np.abs(got - want).max() <= 2 * np.spacing(
        np.float32(np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(UPDATERS))
def test_three_per_leaf_steps_match_jax(name):
    ju_ = getattr(ju, name)(**UPDATERS[name])
    tu_ = getattr(tu, name)(**UPDATERS[name])
    params = _tree(2)
    jp, tp = _jtree(params), _ttree(params)
    jst, tst = ju_.init(jp), tu_.init(tp)
    jstep = jax.jit(lambda p, g, s, it: ju_.apply(g, s, p, it))
    for i in range(STEPS):
        g = _tree(30 + i, 0.5)
        jp, jst = jstep(jp, _jtree(g), jst, jnp.asarray(i))
        tp, tst = tu_.apply(_ttree(g), tst, tp, i)
    _assert_ulp(_np(tp), _np(jp), "params")
    assert sorted(tst) == sorted(jst)
    for slot in jst:
        _assert_ulp(_np(tst[slot]), _np(jst[slot]), slot,
                    8 if name == "AdaDelta" else 2)


@pytest.mark.parametrize("name", sorted(set(UPDATERS) - {"Sgd", "NoOp"}))
def test_bf16_state_rounds_the_float32_moments(name):
    tu_ = getattr(tu, name)(**UPDATERS[name])
    params, g = _ttree(_tree(3)), _ttree(_tree(40, 0.5))
    p32, s32 = tprec.apply_updater(tu_, g, tu_.init(params), params, 0)
    tu_.state_dtype = "bfloat16"
    p16, s16 = tprec.apply_updater(tu_, g, tu_.init(params), params, 0,
                                   torch.Generator().manual_seed(0))
    for n, d in p32.items():
        for k, t in d.items():
            assert torch.equal(t, p16[n][k]), (n, k)
    for slot, tree in s32.items():
        for n, d in tree.items():
            for k, t in d.items():
                lo = t.bfloat16().float()
                s = s16[slot][n][k]
                assert s.dtype == torch.bfloat16
                # round-to-nearest lands on one neighbour; SR may take the
                # other, at most one bf16 ulp away
                ulp = torch.ldexp(torch.ones_like(t),
                                  torch.frexp(t.abs())[1] - 8)
                assert ((s.float() - t).abs() <= ulp).all(), (slot, n, k)
                assert ((s.float() - lo).abs() <= ulp).all()


@pytest.mark.parametrize("name", ["AdaMax", "Nadam", "AMSGrad"])
def test_adam_subclasses_fall_back_from_the_kernel(name):
    assert not tupd.supports_fused(getattr(tu, name)())
    assert not jpu.supports_fused(getattr(ju, name)())
    upd = getattr(tu, name)(**UPDATERS[name])
    params = _ttree(_tree(4))
    flat = {"flat::float32": torch.cat([params[n][k].reshape(-1) for n, k in
                                        (("a", "W"), ("a", "b"),
                                         ("c", "W"))])}
    n = flat["flat::float32"].numel()
    state = {s: {"flat::float32": torch.zeros(n)}
             for s in upd.init({"x": {"w": torch.zeros(n)}})}
    want_p, want_s = upd.apply({"x": {"w": torch.full((n,), 0.3)}},
                               {s: {"x": {"w": torch.zeros(n)}}
                                for s in state},
                               {"x": {"w": flat["flat::float32"].clone()}},
                               0)
    OpProfiler.get().reset()
    tupd.apply_flat_updater(upd, flat, {"flat::float32": torch.full((n,),
                                                                    0.3)},
                            state, 0)
    assert OpProfiler.get().counter_value("precision/fused_fallbacks") == 1
    assert torch.equal(flat["flat::float32"], want_p["x"]["w"])
    for s in state:
        assert torch.equal(state[s]["flat::float32"], want_s[s]["x"]["w"])
