"""SameDiff graph-structure log + UI rendering data.

Counterpart of ``deeplearning4j_tpu/ui/graph_log.py``, carried over whole.
Reference: nd4j ``org/nd4j/graph/ui/LogFileWriter``, whose static graph
structure the UI renders as its "SameDiff" tab. Here the structure
serializes as one JSON document (ops, variables, edges, topological depth
for layout), ``ui/server.UIServer`` serves it at ``/api/graph``, and
scalar events ride the same JSON-lines log.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


def graph_structure(sd) -> Dict[str, Any]:
    """Extract the renderable structure of a SameDiff graph: variables
    (with type/shape/dtype), ops (with inputs/outputs), and a layered
    topological depth per op for drawing."""
    vars_out: List[Dict[str, Any]] = []
    for name, v in sd._vars.items():
        vars_out.append({
            "name": name,
            "type": str(getattr(v.vtype, "name", v.vtype)),
            "shape": (list(v.shape) if v.shape is not None else None),
            "dtype": str(v.dtype) if getattr(v, "dtype", None) else None,
        })
    depth: Dict[str, int] = {}
    ops_out: List[Dict[str, Any]] = []
    for node in sd._nodes:
        d = 1 + max((depth.get(i, 0) for i in node.inputs), default=0)
        for o in node.outputs:
            depth[o] = d
        ops_out.append({
            "name": node.outputs[0] if node.outputs else f"op{node.id}",
            "op": node.op_name,
            "inputs": list(node.inputs),
            "outputs": list(node.outputs),
            "depth": d,
        })
    return {
        "variables": vars_out,
        "ops": ops_out,
        "placeholders": list(sd.placeholders()),
        "n_ops": len(ops_out),
        "n_vars": len(vars_out),
        "max_depth": max(depth.values(), default=0),
    }


class LogFileWriter:
    """Reference-shaped writer: ``write_graph_structure(sd)`` appends one
    static-structure record; ``write_scalar_event`` appends events (the
    dynamic half) — both as JSON lines so the file tails cleanly."""

    def __init__(self, path: str):
        self.path = str(path)
        self._f = open(self.path, "a", encoding="utf-8")

    def write_graph_structure(self, sd) -> None:
        rec = {"type": "graph", **graph_structure(sd)}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    # reference spelling
    writeGraphStructure = write_graph_structure

    def write_scalar_event(self, name: str, step: int,
                           value: float) -> None:
        self._f.write(json.dumps({"type": "event", "name": name,
                                  "step": int(step),
                                  "value": float(value)}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_graph_log(path: str) -> Dict[str, Any]:
    """Last graph record + all events from a log file (torn trailing
    lines skipped, like FileStatsStorage)."""
    graph: Optional[Dict[str, Any]] = None
    events: List[Dict[str, Any]] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("type") == "graph":
                    graph = rec
                elif rec.get("type") == "event":
                    events.append(rec)
    except OSError:
        pass
    return {"graph": graph, "events": events}
