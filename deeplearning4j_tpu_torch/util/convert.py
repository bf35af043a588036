"""Weight carry-over from the JAX package.

``graph_state_from_numpy`` installs the JAX graph's parameters and state,
given as nested dicts of numpy arrays (``{node: {"W", "b", "gamma",
"beta"}}`` and ``{node: {"mean", "var"}}``, e.g. ``jax.device_get`` of the
JAX graph's ``_params`` and ``_states``), into a port graph. The layouts
agree (conv W OIHW, dense W ``[nIn, nOut]``), so this is a checked copy:
node names, entry names, shapes and dtypes must match the port graph's own,
or it raises. Nothing here imports JAX.

``updater_state_from_numpy`` installs the JAX graph's ``_updater_state`` the
same way, in either of the JAX package's layouts: the dense tree
(``{"v": {node: {...}}}``) or the flat ``flat::<dtype>`` buckets of
``Zero1Plan`` (padded for any shard count).

``word2vec_state_from_numpy`` carries a JAX Word2Vec's vocabulary (its words
in index order and their counts) and its ``syn0``/``syn1neg`` tables into a
port Word2Vec, with the same checks.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from ..common.dtypes import tensor_from_numpy
from ..nlp.lookup_table import InMemoryLookupTable
from ..nlp.vocab import VocabCache, VocabWord
from ..parallel.sharding import Zero1Plan, is_flat_state

NumpyTree = Mapping[str, Mapping[str, np.ndarray]]


def _checked_copy(kind: str, src: NumpyTree,
                  dst: Dict[str, Dict[str, torch.Tensor]],
                  device) -> Dict[str, Dict[str, torch.Tensor]]:
    src_nodes = {n for n, d in src.items() if len(d)}
    dst_nodes = {n for n, d in dst.items() if len(d)}
    if src_nodes != dst_nodes:
        raise ValueError(
            f"{kind}: node names differ; only in source "
            f"{sorted(src_nodes - dst_nodes)}, only in graph "
            f"{sorted(dst_nodes - src_nodes)}")
    out: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in dst}
    for node in sorted(dst_nodes):
        s, d = src[node], dst[node]
        if set(s) != set(d):
            raise ValueError(f"{kind}[{node!r}]: entries {sorted(s)} != "
                             f"{sorted(d)}")
        for key, ref in d.items():
            a = np.asarray(s[key])
            t = tensor_from_numpy(a)
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"{kind}[{node!r}][{key!r}]: shape "
                                 f"{tuple(t.shape)} != {tuple(ref.shape)}")
            if t.dtype != ref.dtype:
                raise ValueError(f"{kind}[{node!r}][{key!r}]: dtype "
                                 f"{t.dtype} != {ref.dtype}")
            out[node][key] = t.to(device).clone()
    return out


def graph_state_from_numpy(graph, params: NumpyTree, states: NumpyTree,
                           device=None):
    """Install ``params``/``states`` into the initialized port ``graph``
    (on ``device``, default the graph's own) and return the graph."""
    graph._check_init()
    device = graph.device if device is None else torch.device(device)
    new_params = _checked_copy("params", params, graph._params, device)
    new_states = _checked_copy("states", states, graph._states, device)
    graph._params, graph._states = new_params, new_states
    graph.device = device
    graph._cast_cache = None
    return graph


def updater_state_from_numpy(graph, state, device=None):
    """Install the JAX graph's updater state (numpy arrays, dense or flat
    layout) into the initialized port ``graph`` (on ``device``, default the
    graph's own) and return the graph. Slots, node names, entries, shapes
    and dtypes must match the state the graph's updater would make (in its
    ``state_dtype``), or it raises."""
    graph._check_init()
    device = graph.device if device is None else torch.device(device)
    want = graph.conf.global_conf.updater.init(graph._params)
    state = dict(state or {})
    if is_flat_state(state):
        state = Zero1Plan(graph._params, 1).unflatten_state(state)
    if set(state) != set(want):
        raise ValueError(f"updater state: slots {sorted(state)} != "
                         f"{sorted(want)}")
    graph._updater_state = {k: _checked_copy(f"updater_state[{k!r}]",
                                             state[k], want[k], device)
                            for k in want}
    return graph


def word2vec_state_from_numpy(w2v, words: Sequence[str], counts,
                              syn0: np.ndarray, syn1neg: np.ndarray):
    """Install a vocabulary (``words`` in index order, their ``counts``) and
    the ``syn0``/``syn1neg`` tables (numpy, ``[len(words), layer_size]``
    float32) into the port Word2Vec ``w2v`` and return it; its next ``fit``
    resumes from them. Raises when the words repeat or the shapes, lengths
    or dtypes do not match."""
    words = [str(w) for w in words]
    counts = np.asarray(counts)
    V, D = len(words), w2v.layer_size
    if len(set(words)) != V:
        raise ValueError("word2vec state: the words repeat")
    if counts.shape != (V,) or not np.issubdtype(counts.dtype, np.integer):
        raise ValueError(f"word2vec state: counts must be {V} integers, got "
                         f"{counts.dtype} {counts.shape}")
    for name, a in (("syn0", syn0), ("syn1neg", syn1neg)):
        a = np.asarray(a)
        if a.shape != (V, D):
            raise ValueError(f"word2vec state: {name} shape {a.shape} != "
                             f"{(V, D)}")
        if a.dtype != np.float32:
            raise ValueError(f"word2vec state: {name} dtype {a.dtype} != "
                             f"float32")
    vocab = VocabCache()
    for w, c in zip(words, counts.tolist()):
        vocab.add(VocabWord(w, int(c)))
    table = InMemoryLookupTable(V, D, seed=w2v.seed)
    table.syn0 = np.array(syn0, dtype=np.float32)
    table.syn1neg = np.array(syn1neg, dtype=np.float32)
    w2v.vocab, w2v.lookup_table = vocab, table
    return w2v
