"""The port's graph vectors (DeepWalk, Node2Vec) against the JAX package's,
on the CPU.

Tolerances: none for the walks and for the sentences handed to Word2Vec (the
same numpy sampler with the same seed, bit for bit); the learning gates of
tests/test_nlp_breadth.py::TestDeepWalk for the fits, as there.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.nlp import graph_vectors as jgv
from deeplearning4j_tpu_torch.nlp import graph_vectors as tgv
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)



def _two_communities(mod, k=8, bridge=1):
    """Two cliques of k vertices joined by ``bridge`` edges."""
    g = mod.Graph(2 * k)
    for base in (0, k):
        for i in range(k):
            for j in range(i + 1, k):
                g.add_edge(base + i, base + j)
    for b in range(bridge):
        g.add_edge(b, k + b)
    return g


def _random_graph(mod, n=60, m=200, seed=3, directed=False):
    rng = np.random.default_rng(seed)
    g = mod.Graph(n, directed=directed)
    for a, b in rng.integers(0, n, (m, 2)):
        if a != b:
            g.add_edge(int(a), int(b))
    return g


@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.5, 2.0), (2.0, 0.25)],
                         ids=["deepwalk", "node2vec-local", "node2vec-far"])
@pytest.mark.parametrize("directed", [False, True],
                         ids=["undirected", "directed"])
def test_random_walks_bitwise(p, q, directed):
    jw = jgv.random_walks(_random_graph(jgv, directed=directed), 3, 15,
                          seed=11, p=p, q=q)
    tw = tgv.random_walks(_random_graph(tgv, directed=directed), 3, 15,
                          seed=11, p=p, q=q)
    assert tw == jw and len(tw) > 100
    g = _random_graph(tgv, directed=directed)
    for w in tw:
        assert all(b in g.neighbors(a) for a, b in zip(w, w[1:]))


@pytest.mark.parametrize("cls", ["DeepWalk", "Node2Vec"])
def test_sentences_handed_to_word2vec_are_identical(cls, monkeypatch):
    """What each package's fit gives its Word2Vec: the same sentences and
    the same configuration."""
    got = {}
    for name, mod in (("jax", jgv), ("torch", tgv)):
        def capture(self, sents, _name=name):
            got[_name] = (list(sents), self.layer_size, self.window,
                          self.negative, self.learning_rate, self.epochs,
                          self.batch_size, self.seed,
                          self.min_word_frequency)

        monkeypatch.setattr(mod.Word2Vec, "set_sentence_iterator", capture)
        monkeypatch.setattr(mod.Word2Vec, "fit", lambda self: None)
        kw = dict(window_size=3, vector_size=8, walk_length=12, num_walks=4,
                  epochs=2, seed=5)
        if cls == "Node2Vec":
            kw.update(p=0.5, q=2.0)
        if mod is tgv:
            kw["device"] = "cpu"
        getattr(mod, cls)(**kw).fit(_two_communities(mod))
    assert got["torch"] == got["jax"]
    assert len(got["torch"][0]) == 4 * 16


def test_communities_separate():
    """tests/test_nlp_breadth.py::TestDeepWalk::test_communities_separate."""
    dw = (tgv.DeepWalk.builder().window_size(4).vector_size(16)
          .walk_length(30).num_walks(12).epochs(3).seed(1).device("cpu")
          .build())
    dw.fit(_two_communities(tgv))
    same = np.mean([dw.similarity(1, j) for j in range(2, 6)])
    diff = np.mean([dw.similarity(1, 8 + j) for j in range(2, 6)])
    assert same > diff + 0.3, (same, diff)
    near = dw.vertices_nearest(1, 5)
    assert sum(v < 8 for v in near) >= 4, near
    assert dw.get_vertex_vector(3).shape == (16,)
    assert dw.walk_seconds > 0 and dw._w2v.table_device.type == "cpu"


def test_node2vec_biased_walks_differ_and_learn():
    """tests/test_nlp_breadth.py::TestDeepWalk::
    test_node2vec_biased_walks_differ_and_learn."""
    g = _two_communities(tgv)
    n2v = tgv.Node2Vec(window_size=4, vector_size=16, walk_length=30,
                       num_walks=12, epochs=3, seed=1, p=0.5, q=2.0,
                       device="cpu")
    n2v.fit(g)
    same = np.mean([n2v.similarity(1, j) for j in range(2, 6)])
    diff = np.mean([n2v.similarity(1, 8 + j) for j in range(2, 6)])
    assert same > diff + 0.3, (same, diff)
    assert (tgv.random_walks(g, 2, 12, seed=7)
            != tgv.random_walks(g, 2, 12, seed=7, p=0.5, q=2.0))


def test_queries_before_fit_raise():
    with pytest.raises(ValueError, match="fit"):
        tgv.DeepWalk(device="cpu").similarity(0, 1)
