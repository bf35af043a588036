"""DeepWalk and Node2Vec: vertex vectors from random walks.

Counterpart of ``deeplearning4j_tpu/nlp/graph_vectors.py`` (the reference's
deeplearning4j-graph ``DeepWalk`` and ``RandomWalkIterator``). Walks are
sampled on the host with the JAX package's numpy code (:func:`random_walks`,
so one seed gives both packages the same walks) and become sentences of
vertex ids, which train the port's device-windowed skip-gram
(:class:`~.word2vec.Word2Vec`). Node2Vec biases the walk with Grover and
Leskovec's return and in-out parameters (p, q); p = q = 1 is DeepWalk's
uniform walk.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from ..common.environment import resolve_device
from .word2vec import Word2Vec


class Graph:
    """An adjacency-list graph."""

    def __init__(self, n_vertices: int, directed: bool = False):
        self.n = n_vertices
        self.directed = directed
        self._adj: List[List[int]] = [[] for _ in range(n_vertices)]

    def add_edge(self, a: int, b: int) -> None:
        self._adj[a].append(b)
        if not self.directed:
            self._adj[b].append(a)

    def neighbors(self, v: int) -> List[int]:
        return self._adj[v]

    def num_vertices(self) -> int:
        return self.n


def random_walks(graph: Graph, num_walks: int, walk_length: int,
                 seed: int = 42, p: float = 1.0, q: float = 1.0
                 ) -> List[List[int]]:
    """``num_walks`` walks of up to ``walk_length`` vertices from every
    vertex that has a neighbour, drawn with ``np.random.default_rng(seed)``.
    From (previous t, current v) the step to a neighbour x weighs 1/p when
    x is t, 1 when x neighbours t, 1/q otherwise; with p = q = 1 the step
    is uniform."""
    rng = np.random.default_rng(seed)
    walks = []
    biased = not (p == 1.0 and q == 1.0)
    adj_sets = [set(a) for a in graph._adj] if biased else None
    for _ in range(num_walks):
        for start in range(graph.num_vertices()):
            if not graph.neighbors(start):
                continue
            walk = [start]
            while len(walk) < walk_length:
                cur = walk[-1]
                nbrs = graph.neighbors(cur)
                if not nbrs:
                    break
                if len(walk) == 1 or not biased:
                    nxt = nbrs[rng.integers(len(nbrs))]
                else:
                    prev = walk[-2]
                    w = np.asarray(
                        [1.0 / p if x == prev
                         else (1.0 if x in adj_sets[prev] else 1.0 / q)
                         for x in nbrs])
                    w /= w.sum()
                    nxt = nbrs[rng.choice(len(nbrs), p=w)]
                walk.append(int(nxt))
            walks.append(walk)
    return walks


class DeepWalk:
    """Vertex vectors: ``fit(graph)`` samples the walks and trains
    skip-gram on them in one call, on the card unless ``device`` says
    otherwise."""

    class Builder:
        def __init__(self):
            self._kw = {}

        def window_size(self, v): self._kw["window_size"] = v; return self
        def vector_size(self, v): self._kw["vector_size"] = v; return self
        def walk_length(self, v): self._kw["walk_length"] = v; return self
        def num_walks(self, v): self._kw["num_walks"] = v; return self
        def learning_rate(self, v): self._kw["learning_rate"] = v; return self
        def epochs(self, v): self._kw["epochs"] = v; return self
        def negative_sample(self, v): self._kw["negative"] = int(v); return self
        def seed(self, v): self._kw["seed"] = v; return self
        def device(self, v): self._kw["device"] = v; return self

        def build(self) -> "DeepWalk":
            return DeepWalk(**self._kw)

    @staticmethod
    def builder() -> "DeepWalk.Builder":
        return DeepWalk.Builder()

    # Node2Vec's parameters; DeepWalk keeps the uniform walk
    p = 1.0
    q = 1.0

    def __init__(self, window_size: int = 5, vector_size: int = 64,
                 walk_length: int = 40, num_walks: int = 10,
                 learning_rate: float = 0.025, epochs: int = 1,
                 negative: int = 5, seed: int = 42, device=None):
        self.window_size = window_size
        self.vector_size = vector_size
        self.walk_length = walk_length
        self.num_walks = num_walks
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.negative = negative
        self.seed = seed
        self.device = resolve_device(device)
        #: seconds the last fit spent sampling walks on the host
        self.walk_seconds = 0.0
        self._w2v: Optional[Word2Vec] = None

    def fit(self, graph: Graph) -> "DeepWalk":
        """Sample the walks (``walk_seconds``) and fit skip-gram on them
        (min frequency 1, batch 1024)."""
        t0 = time.perf_counter()
        walks = random_walks(graph, self.num_walks, self.walk_length,
                             seed=self.seed, p=self.p, q=self.q)
        sentences = [" ".join(str(v) for v in walk) for walk in walks]
        self.walk_seconds = time.perf_counter() - t0
        w2v = Word2Vec(min_word_frequency=1, layer_size=self.vector_size,
                       window=self.window_size, negative=self.negative,
                       learning_rate=self.learning_rate, epochs=self.epochs,
                       batch_size=1024, seed=self.seed, device=self.device)
        w2v.set_sentence_iterator(sentences)
        w2v.fit()
        self._w2v = w2v
        return self

    def _fitted(self) -> Word2Vec:
        if self._w2v is None:
            raise ValueError("call fit(graph) first")
        return self._w2v

    def get_vertex_vector(self, v: int) -> np.ndarray:
        return self._fitted().get_word_vector(str(v))

    def similarity(self, a: int, b: int) -> float:
        return self._fitted().similarity(str(a), str(b))

    def verticies_nearest(self, v: int, top_n: int = 10) -> List[int]:
        return [int(w) for w in self._fitted().words_nearest(str(v), top_n)]

    vertices_nearest = verticies_nearest


class Node2Vec(DeepWalk):
    """DeepWalk with Grover and Leskovec's biased walk (p, q)."""

    def __init__(self, *args, p: float = 1.0, q: float = 1.0, **kw):
        super().__init__(*args, **kw)
        self.p = p
        self.q = q
