"""The port's SameDiff ``cond``/``while_loop`` against the JAX package's.

A counterpart of each of the 15 cases of ``tests/test_samediff_controlflow.py``
(the same graph built in both packages; forwards compared, the training
cases fitted in full on the port with the JAX case's gates and held for 3
steps to the JAX package's losses and weights from the same start, zips
saved by either package loaded by the other), then the gradient through a
``cond`` (against ``jax.grad``, and finite where the untaken branch is
not), the refusal of a gradient through an unbounded loop (the JAX
package's ``ValueError``, in ``calculate_gradients`` and in ``fit``), and
the bounded loop's gradient against JAX's.
"""

from __future__ import annotations

import numpy as np
import pytest

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSD
from deeplearning4j_tpu.autodiff.samediff import TrainingConfig as JTC
from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.learning.updaters import Adam


def port_sd() -> SameDiff:
    return SameDiff(device="cpu")


def pv(t) -> np.ndarray:
    """A port output as numpy."""
    return t.detach().cpu().numpy()


def jv(nd) -> np.ndarray:
    return nd.to_numpy()


def _branchy(sd):
    x = sd.placeholder("x")
    pred = sd.math.greater(x.sum(), 0.0)
    return sd.cond(pred, lambda s, a: s.math.multiply(a, 2.0),
                   lambda s, a: s.math.multiply(a, -1.0), x, name="branchy")


# --- TestCond -------------------------------------------------------------------------


def test_both_branches_evaluate():
    t, j = _branchy(port_sd()), _branchy(JSD())
    for x, want in (([1.0, 2.0], [2, 4]), ([-1.0, -2.0], [1, 2])):
        feed = {"x": np.array(x)}
        np.testing.assert_allclose(pv(t.eval(feed)), want)
        np.testing.assert_allclose(pv(t.eval(feed)), jv(j.eval(feed)))


def test_multi_output_cond():
    def build(sd):
        x = sd.placeholder("x")
        return sd.cond(sd.math.greater(x.sum(), 0.0),
                       lambda s, v: (s.math.add(v, 1.0),
                                     s.math.multiply(v, 10.0)),
                       lambda s, v: (s.math.subtract(v, 1.0),
                                     s.math.multiply(v, 100.0)),
                       x)

    (a, b), (ja, jb) = build(port_sd()), build(JSD())
    np.testing.assert_allclose(pv(a.eval({"x": np.array(2.0)})), 3.0)
    np.testing.assert_allclose(pv(b.eval({"x": np.array(2.0)})), 20.0)
    np.testing.assert_allclose(pv(b.eval({"x": np.array(-2.0)})), -200.0)
    for x in (2.0, -2.0):
        for t, j in ((a, ja), (b, jb)):
            np.testing.assert_allclose(pv(t.eval({"x": np.array(x)})),
                                       jv(j.eval({"x": np.array(x)})))


def test_mismatched_branch_arity_raises():
    sd = port_sd()
    x = sd.placeholder("x")
    with pytest.raises(ValueError, match="different arity"):
        sd.cond(sd.math.greater(x, 0.0), lambda s, v: (v, v),
                lambda s, v: v, x)


def test_branch_cannot_return_outer_variable():
    sd = port_sd()
    x = sd.placeholder("x")
    outer = sd.constant("c", 1.0)
    with pytest.raises(ValueError, match="own scope"):
        sd.cond(sd.math.greater(x, 0.0), lambda s, v: outer,
                lambda s, v: v, x)


def _abs_graph(sd, tc, adam):
    x = sd.placeholder("x")
    y = sd.placeholder("y")
    w = sd.var("w", init=np.array([0.1], np.float32))
    absx = sd.cond(sd.math.greater(x.sum(), 0.0),
                   lambda s, v: s.math.identity(v),
                   lambda s, v: s.math.multiply(v, -1.0), x)
    pred = (absx * w).rename("pred")
    sd.math.square(pred - y).mean().rename("loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(tc(updater=adam(learning_rate=0.1),
                              loss_name="loss"))
    return sd


def _abs_batches(n):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        v = rng.randn(1).astype(np.float32) * 3
        out.append({"x": v, "y": 2 * np.abs(v)})
    return out


def test_cond_graph_trains():
    """The JAX case's fit on the port (40 batches, 10 epochs: loss below
    0.05, w near 2), and 3 steps held to the JAX package's."""
    sd = _abs_graph(port_sd(), TrainingConfig, Adam)
    history = sd.fit(_abs_batches(40), epochs=10)
    assert history.final_loss() < 0.05, history.loss_curve()[-3:]
    np.testing.assert_allclose(pv(sd.get_variable("w").arr()), [2.0],
                               atol=0.1)
    t = _abs_graph(port_sd(), TrainingConfig, Adam)
    j = _abs_graph(JSD(), JTC, JAdam)
    batches = _abs_batches(3)
    np.testing.assert_allclose(t.fit(batches, epochs=1).loss_curve(),
                               j.fit(batches, epochs=1).loss_curve(),
                               rtol=1e-5)
    np.testing.assert_allclose(pv(t.get_variable("w").arr()),
                               np.asarray(j.get_variable("w").arr().value),
                               rtol=1e-5)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cond_save_load_roundtrip(writer, tmp_path):
    """A graph with a ``cond`` saved by either package loads in both and
    evaluates as the original."""
    t, j = _branchy(port_sd()), _branchy(JSD())
    p = str(tmp_path / "cond.sdz")
    (t if writer == "port" else j).sd.save(p)
    t2 = SameDiff.load(p, device="cpu").get_variable("branchy")
    j2 = JSD.load(p).get_variable("branchy")
    for arr in ([1.0, 2.0], [-3.0, 1.0]):
        feed = {"x": np.array(arr)}
        np.testing.assert_allclose(pv(t2.eval(feed)), pv(t.eval(feed)))
        np.testing.assert_allclose(jv(j2.eval(feed)), pv(t.eval(feed)))


# --- TestWhileLoop ----------------------------------------------------------------------


def _count_to_ten(sd, max_iters=None):
    start = sd.placeholder("s")
    return sd.while_loop(lambda s, v: s.math.less(v, 10.0),
                         lambda s, v: s.math.add(v, 3.0), start,
                         max_iters=max_iters, name="looped")


def test_unbounded_while_forward():
    t, j = _count_to_ten(port_sd()), _count_to_ten(JSD())
    for s0, want in ((0.0, 12.0), (11.0, 11.0)):
        feed = {"s": np.array(s0)}
        np.testing.assert_allclose(pv(t.eval(feed)), want)
        np.testing.assert_allclose(pv(t.eval(feed)), jv(j.eval(feed)))


def test_multi_var_while():
    """5! with a (value, counter) loop-var pair."""
    def build(sd):
        one = sd.constant("one", 1.0)
        cnt = sd.constant("cnt", 1.0)
        return sd.while_loop(
            lambda s, v, c: s.math.less_equal(c, 5.0),
            lambda s, v, c: (s.math.multiply(v, c), s.math.add(c, 1.0)),
            one, cnt)[0]

    np.testing.assert_allclose(pv(build(port_sd()).eval()), 120.0)
    np.testing.assert_allclose(jv(build(JSD()).eval()), 120.0)


def test_bounded_while_matches_unbounded():
    for s0 in (0.0, 4.0, 11.0):
        sd = port_sd()
        start = sd.placeholder("s")
        r_u = sd.while_loop(lambda s, v: s.math.less(v, 10.0),
                            lambda s, v: s.math.add(v, 3.0), start)
        r_b = sd.while_loop(lambda s, v: s.math.less(v, 10.0),
                            lambda s, v: s.math.add(v, 3.0), start,
                            max_iters=8)
        feed = {"s": np.array(s0)}
        np.testing.assert_allclose(pv(r_b.eval(feed)), pv(r_u.eval(feed)))
        j = _count_to_ten(JSD(), max_iters=8)
        np.testing.assert_allclose(pv(r_b.eval(feed)), jv(j.eval(feed)))


def test_body_arity_checked():
    sd = port_sd()
    x = sd.placeholder("x")
    with pytest.raises(ValueError, match="loop vars"):
        sd.while_loop(lambda s, v: s.math.less(v, 1.0),
                      lambda s, v: (v, v), x)


def _cube_graph(sd, tc, adam, max_iters=4):
    x2 = sd.placeholder("x")
    y2 = sd.placeholder("y")
    w2 = sd.var("w", init=np.array([1.5], np.float32))
    zero2 = sd.constant("zero", 0.0)
    v_fin, _, _ = sd.while_loop(
        lambda s, v, c, ww: s.math.less(c, 3.0),
        lambda s, v, c, ww: (s.math.multiply(v, ww), s.math.add(c, 1.0),
                             s.math.identity(ww)),
        x2, zero2, w2, max_iters=max_iters)
    sd.math.square(v_fin.rename("pred") - y2).mean().rename("loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(tc(updater=adam(learning_rate=0.05),
                              loss_name="loss"))
    return sd


def _cube_batches(n):
    rng = np.random.RandomState(1)
    out = []
    for _ in range(n):
        v = rng.rand(1).astype(np.float32) + 0.5
        out.append({"x": v, "y": 8.0 * v})
    return out


def test_bounded_while_graph_trains():
    """The JAX case's fit on the port (w learns 2 through a 3-iteration
    masked loop of length 4), and 3 steps held to the JAX package's."""
    sd = _cube_graph(port_sd(), TrainingConfig, Adam)
    history = sd.fit(_cube_batches(30), epochs=20)
    assert history.final_loss() < 0.05, history.loss_curve()[-3:]
    np.testing.assert_allclose(pv(sd.get_variable("w").arr()), [2.0],
                               atol=0.1)
    t = _cube_graph(port_sd(), TrainingConfig, Adam)
    j = _cube_graph(JSD(), JTC, JAdam)
    batches = _cube_batches(3)
    np.testing.assert_allclose(t.fit(batches, epochs=1).loss_curve(),
                               j.fit(batches, epochs=1).loss_curve(),
                               rtol=1e-5)
    np.testing.assert_allclose(pv(t.get_variable("w").arr()),
                               np.asarray(j.get_variable("w").arr().value),
                               rtol=1e-5)


def _two_loops(sd):
    """The unbounded loop ``looped`` and the same loop bounded at 8."""
    start = sd.placeholder("s")
    for name, n in (("looped", None), ("bounded", 8)):
        sd.while_loop(lambda s, v: s.math.less(v, 10.0),
                      lambda s, v: s.math.add(v, 3.0), start, max_iters=n,
                      name=name)
    return sd


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_while_save_load_roundtrip(writer, tmp_path):
    t, j = _two_loops(port_sd()), _two_loops(JSD())
    p = str(tmp_path / "while.sdz")
    (t if writer == "port" else j).save(p)
    t2, j2 = SameDiff.load(p, device="cpu"), JSD.load(p)
    feed = {"s": np.array(1.0)}
    for name in ("looped", "bounded"):
        ref = t.get_variable(name)
        want = pv(ref.eval(feed))
        np.testing.assert_allclose(pv(t2.get_variable(name).eval(feed)),
                                   want)
        np.testing.assert_allclose(jv(j2.get_variable(name).eval(feed)),
                                   want)
    node = [n for n in t2._nodes if n.op_name == "__while__"]
    assert [n.max_iters for n in node] == [None, 8]


def test_random_ops_fresh_per_iteration():
    """A body drawing random values draws afresh each iteration: the
    running sum minus the last draw (the first draw) differs from it."""
    sd = port_sd()
    zero = sd.constant("z", np.zeros(4, np.float32))
    last0 = sd.constant("l0", np.zeros(4, np.float32))
    cnt = sd.constant("c0", 0.0)

    def body(s, v, last, c):
        draw = s.random_ops.random_normal((4,))
        return (s.math.add(v, draw), s.math.identity(draw),
                s.math.add(c, 1.0))

    total, last, _ = sd.while_loop(
        lambda s, v, last, c: s.math.less(c, 2.0), body, zero, last0, cnt,
        max_iters=2)
    vals, draw2 = pv(total.eval()), pv(last.eval())
    draw1 = vals - draw2
    assert not np.allclose(draw1, draw2), (draw1, draw2)
    # a second run draws afresh too
    assert not np.allclose(pv(last.eval()), draw2)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dropout_graph_serde_roundtrip(writer, tmp_path):
    def build(sd):
        x = sd.placeholder("x")
        return sd.nn.dropout(x, rate=0.5).rename("dropped")

    out = build(port_sd() if writer == "port" else JSD())
    p = str(tmp_path / "drop.sdz")
    out.sd.save(p)
    sd2 = SameDiff.load(p, device="cpu")
    arr = np.ones((4, 4), np.float32)
    np.testing.assert_allclose(pv(sd2.get_variable("dropped").eval(
        {"x": arr})), arr)
    dropped = pv(sd2.output({"x": arr}, ["dropped"],
                            training=True)["dropped"])
    assert np.isfinite(dropped).all()
    assert (dropped == 0).any()
    assert set(np.unique(dropped)) <= {0.0, 2.0}


def test_nested_cond_inside_while():
    """Collatz: 6 -> 3 -> 10 -> 5 -> 16 -> 8 -> 4 -> 2 -> 1."""
    def build(sd):
        start = sd.placeholder("s")

        def body(s, v):
            return s.cond(s.math.greater(s.math.mod(v, 2.0), 0.5),
                          lambda ss, a: ss.math.add(
                              ss.math.multiply(a, 3.0), 1.0),
                          lambda ss, a: ss.math.divide(a, 2.0), v)

        return sd.while_loop(lambda s, v: s.math.greater(v, 1.0), body,
                             start)

    feed = {"s": np.array(6.0)}
    np.testing.assert_allclose(pv(build(port_sd()).eval(feed)), 1.0)
    np.testing.assert_allclose(jv(build(JSD()).eval(feed)), 1.0)


# --- gradients ------------------------------------------------------------------------


def _log_or_square(sd):
    """cond(x > 0, log(x) * w, (x * w)^2): at x < 0 the untaken log is
    not finite."""
    x = sd.placeholder("x")
    w = sd.var("w", init=np.array([1.5], np.float32))
    out = sd.cond(sd.math.greater(x.sum(), 0.0),
                  lambda s, a, ww: s.math.multiply(s.math.log(a), ww),
                  lambda s, a, ww: s.math.square(s.math.multiply(a, ww)),
                  x, w)
    out.sum().rename("loss")
    return sd


@pytest.mark.parametrize("x", [2.0, -2.0])
def test_cond_gradient_through_the_taken_branch(x):
    feed = {"x": np.array([x], np.float32)}
    g = _log_or_square(port_sd()).calculate_gradients(feed, "loss", ["w"])
    jg = _log_or_square(JSD()).calculate_gradients(feed, "loss", ["w"])
    got = pv(g["w"])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jg["w"].to_numpy()
                                               if hasattr(jg["w"],
                                                          "to_numpy")
                                               else jg["w"]), rtol=1e-6)


def _unbounded_grad_graph(sd, tc=None, adam=None):
    x = sd.placeholder("x")
    w = sd.var("w", init=np.array([1.5], np.float32))
    v, _ = sd.while_loop(lambda s, a, c: s.math.less(c, 3.0),
                         lambda s, a, c: (s.math.multiply(a, 2.0),
                                          s.math.add(c, 1.0)),
                         w, sd.constant("c0", 0.0))
    sd.math.square(v - x).mean().rename("loss")
    sd.set_loss_variables("loss")
    if tc is not None:
        sd.set_training_config(tc(updater=adam(0.1), loss_name="loss"))
    return sd


def test_unbounded_while_refuses_a_gradient_as_jax_does():
    feed = {"x": np.ones(1, np.float32)}
    sd = _unbounded_grad_graph(port_sd(), TrainingConfig, Adam)
    jsd = _unbounded_grad_graph(JSD(), JTC, JAdam)
    with pytest.raises(ValueError, match="Reverse-mode differentiation"):
        jsd.calculate_gradients(feed, "loss")
    with pytest.raises(ValueError, match="Reverse-mode differentiation"):
        sd.calculate_gradients(feed, "loss")
    with pytest.raises(ValueError, match="Reverse-mode differentiation"):
        jsd.fit([feed], epochs=1)
    with pytest.raises(ValueError, match="Reverse-mode differentiation"):
        sd.fit([feed], epochs=1)
    # forward only, it runs: 1.5 doubled 3 times
    np.testing.assert_allclose(pv(sd.output(feed, ["loss"])["loss"]),
                               (12.0 - 1.0) ** 2)


def test_bounded_while_gradient_matches_jax():
    feed = {"x": np.array([0.7], np.float32), "y": np.array([5.0],
                                                            np.float32)}
    t = _cube_graph(port_sd(), TrainingConfig, Adam, max_iters=6)
    j = _cube_graph(JSD(), JTC, JAdam, max_iters=6)
    g = pv(t.calculate_gradients(feed, "loss", ["w"])["w"])
    jg = j.calculate_gradients(feed, "loss", ["w"])["w"]
    np.testing.assert_allclose(g, np.asarray(getattr(jg, "to_numpy",
                                                     lambda: jg)()),
                               rtol=1e-5)
