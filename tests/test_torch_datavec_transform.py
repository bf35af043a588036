"""The rest of DataVec in the port against the JAX package, on the CPU:
``Schema``/``TransformProcess`` (``data/schema.py``), ``Reducer`` and
``Join`` (``data/reducers.py``), the sequence helpers
(``data/sequence.py``) and ``AnalyzeLocal`` (``data/analysis.py``).

The same records (made from a seed) go through the same builder calls in
both packages. Tolerance: bitwise (equal records, equal schemas as JSON,
equal analyses as JSON).
"""

import json

import numpy as np
import pytest

import deeplearning4j_tpu.data as J
import deeplearning4j_tpu_torch.data as T

BOTH = (J, T)


def schema(M):
    return (M.Schema.builder()
            .add_column_string("name")
            .add_column_categorical("color", ["red", "green", "blue"])
            .add_column_double("width")
            .add_column_integer("count")
            .add_column_long("big")
            .add_column_time("ts")
            .build())


def records(n=40, seed=0):
    rng = np.random.default_rng(seed)
    colors = ["red", "green", "blue"]
    return [[f"item{int(rng.integers(0, 5))}",
             colors[int(rng.integers(0, 3))],
             f"{rng.normal() * 3:.4f}", int(rng.integers(-5, 20)),
             int(rng.integers(0, 1 << 40)), int(rng.integers(0, 1000))]
            for _ in range(n)]


TRANSFORMS = {
    "onehot_math": lambda b: (b.remove_columns("name")
                              .categorical_to_one_hot("color")
                              .double_math_op("width", "multiply", 2.0)),
    "to_integer": lambda b: b.categorical_to_integer("color"),
    "minmax": lambda b: (b.convert_to_double("width")
                         .min_max_normalize("width", -10.0, 10.0)),
    "rename_reorder_dup": lambda b: (b.rename_column("width", "w")
                                     .duplicate_column("count", "count2")
                                     .reorder_columns("count2", "w", "name",
                                                      "color", "count", "big",
                                                      "ts")),
    "keep_only": lambda b: b.remove_all_columns_except("color", "count"),
    "filter": lambda b: b.filter(lambda r: int(r[3]) > 3),
    "filter_invalid": lambda b: b.filter_invalid_values("width"),
    "string_map": lambda b: (b.string_map_transform(
        "name", {"item1": "one", "item2": "two"})
        .convert_to_integer("count")),
    "math_ops": lambda b: (b.double_math_op("width", "add", 1.5)
                           .double_math_op("width", "subtract", 0.25)
                           .double_math_op("width", "divide", 3.0)),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_process_matches_jax(name):
    recs = records()
    recs[3][2] = "nan"
    recs[5][2] = "oops"
    out = []
    for M in BOTH:
        tp = TRANSFORMS[name](M.TransformProcess.builder(schema(M))).build()
        try:
            res = tp.execute([list(r) for r in recs])
        except (ValueError, TypeError) as e:
            res = ("raised", type(e).__name__)
        out.append((res, tp.final_schema().to_json()))
    assert out[0] == out[1]


def test_schema_json_roundtrip_across_packages():
    sj, st = schema(J), schema(T)
    assert sj.to_json() == st.to_json()
    assert T.Schema.from_json(sj.to_json()).to_json() == sj.to_json()
    assert J.Schema.from_json(st.to_json()).to_json() == st.to_json()


@pytest.mark.parametrize("err", ["unknown_column", "wrong_type",
                                 "unknown_state", "width"])
def test_transform_errors_match_jax(err):
    kinds = []
    for M in BOTH:
        try:
            if err == "unknown_column":
                M.TransformProcess.builder(schema(M)).remove_columns("nope")
            elif err == "wrong_type":
                schema(M).categorical_states("width")
            elif err == "unknown_state":
                s = M.Schema.builder().add_column_string("s").build()
                (M.TransformProcess.builder(s)
                 .string_to_categorical("s", ["a", "b"]).build()
                 .execute([["c"]]))
            else:
                M.TransformProcess.builder(schema(M)).build().execute(
                    [["too", "short"]])
        except Exception as e:      # noqa: BLE001 - the kind is compared
            kinds.append((type(e).__name__, str(e)))
    assert len(kinds) == 2 and kinds[0] == kinds[1]


def sales_schema(M):
    return (M.Schema.builder().add_column_string("store")
            .add_column_double("amount").add_column_integer("units")
            .build())


def sales(n=30, seed=1):
    rng = np.random.default_rng(seed)
    return [[f"s{int(rng.integers(0, 4))}", float(rng.normal() * 10),
             int(rng.integers(0, 9))] for _ in range(n)]


REDUCERS = {
    "sum_mean": lambda b: b.sum_columns("amount").mean_columns("units"),
    "min_count": lambda b: b.min_columns("amount").count_columns("units"),
    "max_range": lambda b: b.max_columns("amount").range_columns("units"),
    "stdev_unique": lambda b: (b.stdev_columns("amount")
                               .count_unique_columns("units")),
    "first_last": lambda b: b.first_columns("amount").last_columns("units"),
}


@pytest.mark.parametrize("name", sorted(REDUCERS))
def test_reducer_matches_jax(name):
    recs = sales()
    out = []
    for M in BOTH:
        r = REDUCERS[name](M.Reducer.builder().key_columns("store")).build()
        out.append((r.reduce(sales_schema(M), [list(x) for x in recs]),
                    r.output_schema(sales_schema(M)).to_json()))
    assert out[0] == out[1]


@pytest.mark.parametrize("default", ["sum", "mean", "max"])
def test_reducer_default_op_matches_jax(default):
    recs = sales(seed=2)
    out = [M.Reducer.builder(default).key_columns("store").build()
           .reduce(sales_schema(M), recs) for M in BOTH]
    assert out[0] == out[1]


@pytest.mark.parametrize("kind", ["INNER", "LEFT_OUTER", "RIGHT_OUTER",
                                  "FULL_OUTER"])
def test_join_matches_jax(kind):
    rng = np.random.default_rng(3)
    left = [[f"k{int(rng.integers(0, 6))}", float(rng.normal())]
            for _ in range(12)]
    right = [[f"k{int(rng.integers(2, 9))}", float(rng.normal())]
             for _ in range(10)]
    out = []
    for M in BOTH:
        ls = (M.Schema.builder().add_column_string("id")
              .add_column_double("x").build())
        rs = (M.Schema.builder().add_column_string("id")
              .add_column_double("y").build())
        j = (M.Join.builder(getattr(M.Join, kind)).set_join_columns("id")
             .set_schemas(ls, rs).build())
        out.append((j.execute(left, right), j.output_schema().to_json()))
    assert out[0] == out[1]


def seq_schema(M):
    return (M.Schema.builder().add_column_string("sensor")
            .add_column_integer("t").add_column_double("v").build())


def seq_records(seed=4):
    rng = np.random.default_rng(seed)
    return [[f"s{int(rng.integers(0, 3))}", int(t), float(rng.normal())]
            for t in rng.permutation(24)]


@pytest.mark.parametrize("window", [(4, None, True), (4, 2, True),
                                    (5, None, False), (3, 1, False)])
def test_sequence_helpers_match_jax(window):
    size, stride, drop = window
    out = []
    for M in BOTH:
        seqs = M.convert_to_sequence(seq_schema(M), seq_records(), "sensor",
                                     "t")
        wins = M.window_sequences(seqs, size, stride=stride,
                                  drop_partial=drop)
        one = M.window_sequence(seqs[0], size, stride=stride,
                                drop_partial=drop)
        red = (M.Reducer.builder().key_columns("sensor").mean_columns("v")
               .max_columns("t").build())
        reduced = [M.reduce_sequence(seq_schema(M), w, red) for w in wins]
        out.append((seqs, wins, one, reduced))
    assert out[0] == out[1]


def test_analyze_local_matches_jax():
    rng = np.random.default_rng(5)
    recs = [[float(rng.normal()) if i % 7 else None,
             ["p", "q", "r"][int(rng.integers(0, 3))],
             "x" * int(rng.integers(0, 9)), int(rng.integers(-3, 3))]
            for i in range(50)]
    out = []
    for M in BOTH:
        s = (M.Schema.builder().add_column_double("x")
             .add_column_categorical("c", ["p", "q", "r"])
             .add_column_string("s").add_column_integer("n").build())
        an = M.AnalyzeLocal.analyze(s, recs)
        out.append((an.to_json(), {n: an.column_analysis(n).to_dict()
                                   if hasattr(an.column_analysis(n),
                                              "to_dict") else
                                   vars(an.column_analysis(n))
                                   for n in ("x", "c", "s", "n")}))
    assert json.loads(out[0][0]) == json.loads(out[1][0])
    assert out[0][1] == out[1][1]
