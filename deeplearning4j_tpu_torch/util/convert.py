"""Weight carry-over from the JAX package.

``graph_state_from_numpy`` installs the JAX graph's parameters and state,
given as nested dicts of numpy arrays (``{node: {"W", "b", "gamma",
"beta"}}`` and ``{node: {"mean", "var"}}``, e.g. ``jax.device_get`` of the
JAX graph's ``_params`` and ``_states``), into a port graph. The layouts
agree (conv W OIHW, transposed-conv W ``[I, O, kH, kW]``, depthwise W
``[mult, C, kH, kW]``, separable ``dW`` (depthwise) and ``pW``
(pointwise, ``[O, C * mult, 1, 1]``), dense W ``[nIn, nOut]``, a center-loss
head's ``centers`` ``[nOut, nIn]``, embedding tables W ``[vocab, nOut]``,
LayerNormalization ``gain``/``bias``, self-attention ``Wq``/``Wk``/``Wv``
``[nIn, H*hs]`` and ``Wo`` ``[H*hs, nOut]``, a TimeDistributed layer's
inner ``{W, b}``, a Bidirectional layer's ``{"fwd": {...}, "bwd":
{...}}``), so this is a checked copy:
node names, entry names, shapes and dtypes must match the port graph's own,
or it raises. Nothing here imports JAX.

``updater_state_from_numpy`` installs the JAX graph's ``_updater_state`` the
same way, in either of the JAX package's layouts: the dense tree
(``{"v": {node: {...}}}``) or the flat ``flat::<dtype>`` buckets of
``Zero1Plan`` (padded for any shard count).

``multilayer_state_from_numpy`` does the same for a ``MultiLayerNetwork``:
the JAX network's ``_params`` and ``_states`` are lists with one dict per
layer (``{}`` for a layer without any), and its updater state mirrors the
list (``{"v": [{...}, ...]}``) or is flat. The port network keys its layers
``"0000"``, ``"0001"``, ... (``nn/multilayer.layer_key``), in the same leaf
order, so ``set_params`` with the JAX network's ``params()`` vector gives
the same network too.

``fleet_state_from_numpy`` does it for a ``parallel/fleet.FleetTrainer``:
the JAX fleet's ``stacked_state()`` (per-layer lists with a leading member
axis, as numpy) and, when given, its stacked ``_updater_state`` go into the
port fleet's ``[M, N]`` buckets in place, so both packages start from the
same members.

The model-parallel objects: ``sharded_embedding_from_numpy`` puts a JAX
``ShardedEmbedding``'s table (its ``to_numpy()``, or the padded table) into
a port ``ShardedEmbedding``'s row shards;
``pipeline_trainer_state_from_numpy`` carries a JAX ``PipelineTrainer``'s
stacked ``[stages * rows, ...]`` parameters (and its stacked updater
state), pad rows included, into the port trainer's model as per-layer
trees, rows read off ``stage_partition`` as the JAX trainer lays them out;
``heterogeneous_pipeline_state_from_numpy`` carries a JAX
``HeterogeneousPipeline``'s stage trees (its ``stage_params(s)``) into the
port pipeline's stages.

``samediff_state_from_numpy`` carries a JAX SameDiff's variable values
(``{name: ndarray}``) and its updater state into a port SameDiff, checked
against the port graph's own variables.

``word2vec_state_from_numpy`` carries a JAX Word2Vec's vocabulary (its words
in index order and their counts) and its ``syn0`` and output tables
(``syn1neg`` for negative sampling, ``syn1`` for hierarchical softmax) into a
port Word2Vec, with the same checks; ``fasttext_state_from_numpy`` does the
same for FastText (tables of V + bucket rows, the subword tables rebuilt from
the words) and ``glove_state_from_numpy`` for GloVe (w, w~ and the biases).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..common.dtypes import tensor_from_numpy
from ..common.tree import get_path, leaf_paths, set_path, skeleton
from ..nlp.lookup_table import InMemoryLookupTable
from ..nlp.vocab import VocabCache, VocabWord, build_huffman
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
        out[node] = _checked_entries(f"{kind}[{node!r}]", src[node],
                                     dst[node], device)
    return out


def _checked_entries(where: str, s: Mapping, d: Mapping, device) -> dict:
    """Copies of the entries of ``s`` onto ``device``, checked against
    ``d``'s names, shapes and dtypes; a subtree (a wrapper layer's
    ``{"fwd": {...}, "bwd": {...}}``) is checked entry by entry."""
    if set(s) != set(d):
        raise ValueError(f"{where}: entries {sorted(s)} != {sorted(d)}")
    out = {}
    for key, ref in d.items():
        here = f"{where}[{key!r}]"
        if isinstance(ref, dict) or isinstance(s[key], Mapping):
            if not (isinstance(ref, dict) and isinstance(s[key], Mapping)):
                raise ValueError(f"{here}: a subtree on one side only")
            out[key] = _checked_entries(here, s[key], ref, device)
            continue
        t = tensor_from_numpy(np.asarray(s[key]))
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{here}: shape {tuple(t.shape)} != "
                             f"{tuple(ref.shape)}")
        if t.dtype != ref.dtype:
            raise ValueError(f"{here}: dtype {t.dtype} != {ref.dtype}")
        out[key] = t.to(device).clone()
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


def _by_layer(tree):
    """A per-layer list (the JAX network's layout) as the port network's
    dict keyed by layer; dicts and flat buckets pass through."""
    from ..nn.multilayer import layer_key

    if isinstance(tree, (list, tuple)):
        return {layer_key(i): dict(d) for i, d in enumerate(tree)}
    return tree


def multilayer_state_from_numpy(net, params: Sequence[Mapping[str, np.ndarray]],
                                states: Sequence[Mapping[str, np.ndarray]],
                                updater_state=None, device=None):
    """Install the JAX network's per-layer ``params`` and ``states`` (lists
    of dicts of numpy arrays) and, when given, its ``updater_state`` into
    the initialized port ``net``, with the checks of
    :func:`graph_state_from_numpy`; returns ``net``."""
    if len(params) != len(net.layers) or len(states) != len(net.layers):
        raise ValueError(f"{len(params)} parameter and {len(states)} state "
                         f"dicts for {len(net.layers)} layers")
    graph_state_from_numpy(net, _by_layer(params), _by_layer(states), device)
    if updater_state is not None:
        state = {k: _by_layer(v) for k, v in dict(updater_state).items()}
        updater_state_from_numpy(net, state, device)
    return net


def sharded_embedding_from_numpy(emb, table: np.ndarray):
    """A ``[vocab, D]`` (or padded) numpy table into ``emb``'s shards, the
    pad rows zero; returns ``emb``."""
    a = np.asarray(table)
    if a.dtype != np.float32:
        raise ValueError(f"sharded table dtype {a.dtype} != float32")
    if a.ndim != 2 or a.shape[1] != emb.dim \
            or a.shape[0] not in (emb.vocab_size, emb._padded):
        raise ValueError(f"sharded table shape {a.shape} != "
                         f"({emb.vocab_size} or {emb._padded}, {emb.dim})")
    emb._place(a)
    return emb


def pipeline_trainer_state_from_numpy(trainer, stacked_params,
                                      stacked_updater=None):
    """Install a JAX ``PipelineTrainer``'s stacked state (numpy trees with
    a leading ``[stages * rows]`` axis: layer ``l`` of stage ``s``'s run
    ``[lo, hi)`` at row ``s * rows + l - lo``, ``rows`` the longest run)
    into the port ``trainer``'s model, checked as
    :func:`multilayer_state_from_numpy` checks; the trainer places it at
    its next fit. Returns ``trainer``."""
    from ..parallel.pipeline import stage_partition

    model = trainer.model
    runs = stage_partition(len(model.layers), trainer.stages_count)
    rows = max(hi - lo for lo, hi in runs)
    row_of = [s * rows + (i - lo) for s, (lo, hi) in enumerate(runs)
              for i in range(lo, hi)]

    def per_layer(tree):
        lead = {int(np.shape(get_path(tree, p))[0]) for p in leaf_paths(tree)}
        if lead != {len(runs) * rows}:
            raise ValueError(f"stacked leading axes {sorted(lead)} != "
                             f"{len(runs)} stages x {rows} rows")
        out = []
        for r in row_of:
            t = skeleton(tree)
            for p in leaf_paths(tree):
                set_path(t, p, np.ascontiguousarray(
                    np.asarray(get_path(tree, p))[r]))
            out.append(t)
        return out

    upd = None
    if stacked_updater is not None:
        upd = {k: per_layer(v) for k, v in dict(stacked_updater).items()}
    model._params = {k: dict(v) for k, v in model._params.items()}
    multilayer_state_from_numpy(model, per_layer(stacked_params),
                                [{} for _ in model.layers], upd)
    return trainer


def heterogeneous_pipeline_state_from_numpy(pp, stage_trees):
    """Install a JAX ``HeterogeneousPipeline``'s stage trees (``[{layer
    index: {name: array}}]``, its ``stage_params(s)``) into the port
    pipeline's stages, checked; returns ``pp``."""
    if len(stage_trees) != len(pp.params):
        raise ValueError(f"{len(stage_trees)} stage trees for "
                         f"{len(pp.params)} stages")
    for s, (src, dst) in enumerate(zip(stage_trees, pp.params)):
        _copy_stacked(f"stage {s}", src, dst)
    return pp


def _copy_stacked(kind: str, src, dst) -> None:
    """Checked in-place copy of a numpy tree into a tree of tensor views:
    the same paths, shapes and dtypes."""
    want, got = leaf_paths(dst), leaf_paths(src)
    if want != got:
        raise ValueError(f"{kind}: leaf paths {got} != the fleet's {want}")
    for p in want:
        t, a = get_path(dst, p), np.asarray(get_path(src, p))
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{kind} {p}: shape {a.shape} != "
                             f"{tuple(t.shape)}")
        v = tensor_from_numpy(np.ascontiguousarray(a), t.device)
        if v.dtype != t.dtype:
            raise ValueError(f"{kind} {p}: dtype {v.dtype} != {t.dtype}")
        with torch.no_grad():
            t.copy_(v)


def fleet_state_from_numpy(fleet, params: Sequence[Mapping[str, np.ndarray]],
                           states: Sequence[Mapping[str, np.ndarray]],
                           updater_state=None):
    """Install the JAX fleet's stacked ``params`` and ``states`` (per-layer
    lists of dicts of ``[M, ...]`` numpy arrays, its ``stacked_state()``)
    and, when given, its stacked dense ``updater_state`` (``{slot: [...]}``)
    into the port ``fleet``'s buffers, in place (no buffer is replaced);
    returns ``fleet``."""
    n = len(fleet.model.layers)
    if len(params) != n or len(states) != n:
        raise ValueError(f"{len(params)} parameter and {len(states)} state "
                         f"dicts for {n} layers")
    p_views, member_states, u_views = fleet.stacked_views()
    _copy_stacked("fleet params", _by_layer(params), p_views)
    st = _by_layer(states)
    for m, tree in enumerate(member_states):
        _copy_stacked("fleet states", _row_tree(st, m), tree)
    if updater_state is not None:
        upd = {k: _by_layer(v) for k, v in dict(updater_state).items()}
        if set(upd) != set(u_views):
            raise ValueError(f"fleet updater state slots {sorted(upd)} != "
                             f"{sorted(u_views)}")
        for k in upd:
            _copy_stacked(f"fleet updater state {k}", upd[k], u_views[k])
    return fleet


def _row_tree(tree, m: int):
    """Member ``m``'s slice of a stacked numpy tree."""
    out = skeleton(tree)
    for p in leaf_paths(tree):
        set_path(out, p, np.asarray(get_path(tree, p))[m])
    return out


def _vocab_from(kind: str, words: Sequence[str], counts) -> VocabCache:
    """A vocabulary of ``words`` in index order with their integer
    ``counts``; raises when the words repeat or the counts do not fit."""
    words = [str(w) for w in words]
    counts = np.asarray(counts)
    V = len(words)
    if len(set(words)) != V:
        raise ValueError(f"{kind} state: the words repeat")
    if counts.shape != (V,) or not np.issubdtype(counts.dtype, np.integer):
        raise ValueError(f"{kind} state: counts must be {V} integers, got "
                         f"{counts.dtype} {counts.shape}")
    vocab = VocabCache()
    for w, c in zip(words, counts.tolist()):
        vocab.add(VocabWord(w, int(c)))
    return vocab


def _checked_tables(kind: str, tables: Mapping[str, Optional[np.ndarray]],
                    shapes: Mapping[str, tuple]) -> Dict[str, np.ndarray]:
    """float32 copies of the given ``tables``, each of its ``shapes``
    entry; raises on another shape or dtype."""
    out = {}
    for name, a in tables.items():
        if a is None:
            continue
        a = np.asarray(a)
        if a.shape != shapes[name]:
            raise ValueError(f"{kind} state: {name} shape {a.shape} != "
                             f"{shapes[name]}")
        if a.dtype != np.float32:
            raise ValueError(f"{kind} state: {name} dtype {a.dtype} != "
                             f"float32")
        out[name] = np.array(a, dtype=np.float32)
    return out


def _install_tables(model, kind: str, words, counts, rows: int,
                    tables: Mapping[str, Optional[np.ndarray]]) -> None:
    """The shared part of the Word2Vec-family installs: vocabulary, the
    needed output tables present, every table ``[rows, layer_size]``."""
    vocab = _vocab_from(kind, words, counts)
    D = model.layer_size
    tables = dict(tables)
    for name, need in (("syn1neg", model.negative > 0),
                       ("syn1", model.use_hs)):
        if need and tables.get(name) is None:
            raise ValueError(f"{kind} state: this model needs {name}")
        if not need:
            tables[name] = None
    checked = _checked_tables(kind, tables,
                              dict.fromkeys(tables, (rows, D)))
    if model.use_hs:
        build_huffman(vocab)
    table = InMemoryLookupTable(rows, D, seed=model.seed)
    for name in ("syn0", "syn1neg", "syn1"):
        setattr(table, name, checked.get(name))
    model.vocab, model.lookup_table = vocab, table


def word2vec_state_from_numpy(w2v, words: Sequence[str], counts,
                              syn0: np.ndarray,
                              syn1neg: Optional[np.ndarray] = None,
                              syn1: Optional[np.ndarray] = None):
    """Install a vocabulary (``words`` in index order, their ``counts``) and
    the tables (numpy, ``[len(words), layer_size]`` float32) into the port
    Word2Vec ``w2v`` and return it; its next ``fit`` resumes from them.
    ``syn1neg`` is the negative-sampling output table (needed when
    ``w2v.negative > 0``), ``syn1`` the hierarchical-softmax one (needed
    when ``w2v.use_hs``; the Huffman tree is rebuilt from the counts, as
    the JAX package builds it). Raises when the words repeat, a needed
    table is missing, or the shapes, lengths or dtypes do not match."""
    _install_tables(w2v, "word2vec", words, counts, len(words),
                    {"syn0": syn0, "syn1neg": syn1neg, "syn1": syn1})
    return w2v


def fasttext_state_from_numpy(ft, words: Sequence[str], counts,
                              syn0: np.ndarray,
                              syn1neg: Optional[np.ndarray] = None,
                              syn1: Optional[np.ndarray] = None):
    """As :func:`word2vec_state_from_numpy` for the port FastText ``ft``:
    the tables have ``len(words) + ft.bucket`` rows (the words', then the
    hashed n-grams'), and the subword tables are built from the words, so
    queries (out-of-vocabulary words too) and a resumed ``fit`` follow."""
    _install_tables(ft, "fasttext", words, counts, len(words) + ft.bucket,
                    {"syn0": syn0, "syn1neg": syn1neg, "syn1": syn1})
    ft.build_subwords()
    return ft


def glove_state_from_numpy(glove, words: Sequence[str], counts,
                           w: np.ndarray, wc: np.ndarray, b: np.ndarray,
                           bc: np.ndarray):
    """Install a JAX Glove's vocabulary and its trained ``w``, ``w~``
    (``[V, layer_size]``) and biases (``[V]``), float32, into the port
    ``glove``: the query table is ``w + w~``, as after a fit. Returns
    ``glove``."""
    vocab = _vocab_from("glove", words, counts)
    V, D = len(vocab), glove.layer_size
    t = _checked_tables("glove", {"w": w, "wc": wc, "b": b, "bc": bc},
                        {"w": (V, D), "wc": (V, D), "b": (V,), "bc": (V,)})
    table = InMemoryLookupTable(V, D, seed=glove.seed)
    table.syn0 = t["w"] + t["wc"]
    glove.vocab, glove.lookup_table = vocab, table
    glove._w, glove._wc, glove._bias, glove._bias_c = (
        t["w"], t["wc"], t["b"], t["bc"])
    return glove


def samediff_state_from_numpy(sd, params: Mapping[str, np.ndarray],
                              updater_state=None):
    """Install a JAX SameDiff's trainable values (``{name: ndarray}``, e.g.
    ``jax.device_get(jax_sd._params())``) and, when given, its updater
    state (``{slot: {name: ndarray}}``, e.g. Adam's ``{"m": ..., "v":
    ...}``) into the port SameDiff ``sd``, on ``sd.device``; returns
    ``sd``. The names must be ``sd.variables()`` exactly, with the same
    shapes and dtypes, and the slots those ``sd``'s training config's
    updater makes, or it raises."""
    from ..autodiff.samediff import TREE

    want = {n: sd._vars[n].value for n in sd.variables()}
    values = _checked_copy("samediff params", {TREE: params}, {TREE: want},
                           sd.device)[TREE]
    if updater_state is not None:
        if sd._training_config is None:
            raise ValueError("samediff updater state: call "
                             "set_training_config first")
        ref = sd._training_config.updater.init({TREE: want})
        state = dict(updater_state)
        if set(state) != set(ref):
            raise ValueError(f"samediff updater state: slots {sorted(state)}"
                             f" != {sorted(ref)}")
        sd._updater_state = {k: _checked_copy(
            f"samediff updater_state[{k!r}]", {TREE: state[k]}, ref[k],
            sd.device) for k in ref}
    for n, t in values.items():
        sd._vars[n].value = t
    return sd
