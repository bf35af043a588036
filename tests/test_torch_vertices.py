"""The port's 10 graph vertices and the graph configuration's JSON against
the JAX package's, on the CPU.

Each vertex's ``apply`` on the same numpy inputs (from a seed) within 1e-6
relative to the output's largest magnitude (a norm or a sum may run in
another order; the rest are single float32 operations, bitwise in
practice). A graph holding every vertex and both input adapters gives
the same outputs, and without ``DotProductVertex`` (which the JAX package's
JSON registry leaves out, ``graph.py:201-203``) writes the same JSON in
both packages, and each package reads the other's.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import modules, residual_conf

B = 4

# name: (constructor kwargs, input shapes)
CASES = {
    "MergeVertex": ({}, [(B, 3, 4, 4), (B, 2, 4, 4)]),
    "ElementWiseVertex": ({"op": "max"}, [(B, 6), (B, 6), (B, 6)]),
    "DotProductVertex": ({"normalize": True}, [(B, 6), (B, 6)]),
    "SubsetVertex": ({"from_idx": 1, "to_idx": 3}, [(B, 5, 2, 2)]),
    "ScaleVertex": ({"scale": 0.3}, [(B, 6)]),
    "ShiftVertex": ({"shift": -1.5}, [(B, 6)]),
    "L2NormalizeVertex": ({}, [(B, 3, 2, 2)]),
    "StackVertex": ({}, [(B, 6), (B, 6)]),
    "UnstackVertex": ({"from_idx": 1, "stack_size": 2}, [(B, 6)]),
    "ReshapeVertex": ({"shape": (2, 3)}, [(B, 6)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_vertex_apply_matches_jax(name):
    kwargs, shapes = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jv = getattr(modules("jax").graph, name)(**kwargs)
    tv = getattr(modules("torch").graph, name)(**kwargs)
    want = np.asarray(jv.apply(*[jnp.asarray(x) for x in xs]))
    got = tv.apply(*[torch.from_numpy(x) for x in xs]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_every_vertex_is_ported():
    jg, tg = modules("jax").graph, modules("torch").graph
    names = {n for n, c in vars(jg).items() if isinstance(c, type)
             and issubclass(c, jg.GraphVertex) and c is not jg.GraphVertex
             and not n.startswith("_")}
    assert names == set(CASES)
    assert all(issubclass(getattr(tg, n), tg.GraphVertex) for n in names)


def _all_vertices_conf(which: str, dot: bool = True):
    m = modules(which)
    G = m.graph
    b = m.NeuralNetConfiguration.builder().seed(5).updater(
        m.Nesterovs(0.02, momentum=0.9))
    gb = G.ComputationGraphConfiguration.graph_builder(b).add_inputs(
        "img", "vec")
    gb.add_layer("c", m.L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                           padding=(1, 1)), "img")
    gb.add_vertex("merge", G.MergeVertex(), "c", "img")
    gb.add_vertex("sub", G.SubsetVertex(from_idx=0, to_idx=3), "merge")
    gb.add_vertex("l2n", G.L2NormalizeVertex(), "sub")
    gb.add_layer("d1", m.L.DenseLayer(n_out=6, activation="tanh"), "l2n")
    gb.add_layer("d2", m.L.DenseLayer(n_out=6, activation="tanh"), "vec")
    if dot:
        gb.add_vertex("dot", G.DotProductVertex(normalize=True), "d1", "d2")
    else:
        gb.add_vertex("dot", G.ElementWiseVertex(op="subtract"), "d1", "d2")
    gb.add_vertex("scale", G.ScaleVertex(scale=2.0), "d1")
    gb.add_vertex("shift", G.ShiftVertex(shift=0.5), "scale")
    gb.add_vertex("ew", G.ElementWiseVertex(op="product"), "shift", "d2")
    gb.add_vertex("stack", G.StackVertex(), "ew", "d2")
    gb.add_vertex("unstack", G.UnstackVertex(from_idx=0, stack_size=2),
                  "stack")
    gb.add_vertex("reshape", G.ReshapeVertex(shape=(6,)), "unstack")
    gb.add_layer("out", m.L.OutputLayer(n_out=3, activation="softmax",
                                        loss="mcxent"), "reshape")
    gb.add_layer("reg", m.L.OutputLayer(n_out=1, activation="identity",
                                        loss="mse"), "dot")
    gb.set_outputs("out", "reg")
    gb.set_input_types(m.InputType.convolutional_flat(4, 4, 2),
                       m.InputType.feed_forward(5))
    return gb.build()


@pytest.mark.parametrize("which", ["residual", "all_vertices"])
def test_graph_configuration_json_in_the_jax_format(which):
    make = {"residual": lambda m: residual_conf(m, True, 8,
                                                fused_update=True),
            "all_vertices": lambda m: _all_vertices_conf(m, dot=False)}[which]
    jconf, tconf = make("jax"), make("torch")
    jd, td = json.loads(jconf.to_json()), json.loads(tconf.to_json())
    assert td == jd
    JC = modules("jax").graph.ComputationGraphConfiguration
    TC = modules("torch").graph.ComputationGraphConfiguration
    back = TC.from_json(jconf.to_json())
    assert json.loads(back.to_json()) == td
    assert back.node_output_types == tconf.node_output_types
    assert json.loads(JC.from_json(tconf.to_json()).to_json()) == jd


def test_all_vertices_graph_forward_matches_jax():
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
    from deeplearning4j_tpu_torch.util.convert import graph_state_from_numpy
    from torch_parity import numpy_tree

    jg = JGraph(_all_vertices_conf("jax")).init()
    tg = TGraph(_all_vertices_conf("torch")).init(device="cpu")
    graph_state_from_numpy(tg, numpy_tree(jg._params),
                           numpy_tree(jg._states))
    rng = np.random.default_rng(0)
    img = rng.normal(size=(B, 32)).astype(np.float32)
    vec = rng.normal(size=(B, 5)).astype(np.float32)
    want = [np.asarray(o) for o in jg.output(img, vec)]
    got = [o.numpy() for o in tg.output(img, vec)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
