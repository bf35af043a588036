"""Training-UI web server and the serving tier's HTTP front door.

Counterpart of ``deeplearning4j_tpu/ui/server.py`` (reference:
``deeplearning4j-ui`` ``VertxUIServer`` /
``UIServer.getInstance().attach(storage)``). A stdlib ``http.server`` on a
background thread serving:

- ``/``                 — single-page dashboard (inline HTML/JS/SVG)
- ``/api/tags``, ``/api/series?tag=t``, ``/api/sessions`` — the scalar
                          records of the attached stores
- ``/api/graph``        — an attached SameDiff graph's structure
                          (``ui/graph_log``)
- ``/healthz``          — liveness
- ``/api/health``       — uptime, sources, every profiler ledger (the
                          ``serving`` section is
                          ``parallel/serving.serving_health``), the
                          newest incident (``last_incident``), the
                          flight recorder's totals, the inference-pool
                          census and ``common/system_info.memory_summary``
- ``/api/metrics``      — Prometheus text exposition
                          (:func:`prometheus_text`)
- ``/api/trace``        — the flight recorder as a Chrome trace
                          (``?corr=`` narrows to one correlation id)
- ``/api/incidents``    — the installed watchtower's incident index
                          (``common/watchtower.py``; ``[]`` with none);
                          ``?id=`` serves one ``incident-<id>.json``
                          (404 for an unknown id)
- ``/api/infer``        — POST ``{"inputs": [[...], ...]}`` (optional
                          ``"slo_class"``) → the attached
                          ``parallel/serving.ServingEngine``; the response
                          carries the outputs and the server-side latency.
                          400 on a malformed body, 413 on an oversize
                          request under a reject ladder, 429 with
                          ``Retry-After`` when shed, 503 with no engine,
                          504 on an expired deadline.
- ``/api/post``         — POST scalar records
                          (:class:`RemoteUIStatsStorageRouter`)
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .stats import (FileStatsStorage, InMemoryStatsStorage,
                    StatsStorage)


def _prom_escape(value: Any) -> str:
    """Label-VALUE escaping per the text-exposition spec (0.0.4):
    backslash, double-quote and line-feed."""
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _prom_escape_help(text: str) -> str:
    """HELP-text escaping per the spec: only backslash and line-feed
    (quotes are legal in help text, unlike in label values)."""
    return str(text).replace("\\", r"\\").replace("\n", r"\n")


def prometheus_text() -> str:
    """The ``GET /api/metrics`` payload: Prometheus text exposition
    (format 0.0.4) of the whole observability surface — every
    ``OpProfiler`` counter (and the gauge-set subset as real gauges),
    every timing section, every derived ledger (``OpProfiler.LEDGERS`` —
    the same list ``/api/health`` and ``print_statistics`` render), the
    serving tier's rolling latency quantiles, and the flight recorder's
    own totals. Label values carry the repo-internal slash-names
    (``trace/mln_fit_step``) verbatim; metric names are fixed conformant
    families, so any Prometheus scraper ingests this without config."""
    from ..common import flightrec
    from ..common.profiler import OpProfiler

    prof = OpProfiler.get()
    lines: List[str] = []

    def family(name: str, mtype: str, help_text: str, samples) -> None:
        samples = list(samples)
        if not samples:
            return
        lines.append(f"# HELP {name} {_prom_escape_help(help_text)}")
        lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            if isinstance(value, float):
                value = round(value, 9)
            if labels:
                lab = ",".join(f'{k}="{_prom_escape(v)}"'
                               for k, v in sorted(labels.items()))
                lines.append(f"{name}{{{lab}}} {value}")
            else:
                lines.append(f"{name} {value}")

    counters = prof.get_counters()
    gauges = prof.gauge_names()
    family("dl4j_counter_total", "counter",
           "OpProfiler event counters, labeled by counter name",
           (({"name": k}, v) for k, v in sorted(counters.items())
            if k not in gauges))
    family("dl4j_gauge", "gauge",
           "OpProfiler level gauges (absolute, last-write-wins)",
           (({"name": k}, v) for k, v in sorted(counters.items())
            if k in gauges))
    sections = prof.get_statistics()
    family("dl4j_section_seconds_total", "counter",
           "cumulative wall time per OpProfiler section",
           (({"section": k}, s["total_s"])
            for k, s in sorted(sections.items())))
    family("dl4j_section_count_total", "counter",
           "entry count per OpProfiler section",
           (({"section": k}, s["count"])
            for k, s in sorted(sections.items())))
    family("dl4j_section_max_seconds", "gauge",
           "longest single entry per OpProfiler section",
           (({"section": k}, s["max_s"])
            for k, s in sorted(sections.items())))
    ledger_samples = []
    for label, stats in prof.ledger_stats().items():
        for k, v in sorted(stats.items()):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            ledger_samples.append(({"ledger": label, "key": k}, v))
    family("dl4j_ledger", "gauge",
           "derived ledger values (OpProfiler *_stats())", ledger_samples)
    try:
        from ..parallel.serving import serving_health

        health = serving_health()
    except Exception:          # serving tier absent/unimportable: no rows
        health = {}
    latency_samples: List[Tuple[Dict[str, str], float]] = []
    for q, key in (("0.5", "latency_p50_ms"), ("0.99", "latency_p99_ms")):
        if key in health:
            latency_samples.append(({"quantile": q}, health[key]))
    # per-SLO-class quantiles (class label values pass through
    # _prom_escape like every other label — class names are caller data)
    for cls, cl in sorted(health.get("class_latency", {}).items()):
        for q, key in (("0.5", "p50_ms"), ("0.99", "p99_ms")):
            if key in cl:
                latency_samples.append(
                    ({"class": cls, "quantile": q}, cl[key]))
    family("dl4j_serving_latency_ms", "gauge",
           "rolling serving latency quantiles across live engines "
           "(fleet-wide, and per SLO class when classified)",
           latency_samples)
    try:
        from ..common import watchtower

        alert_rows = sorted(watchtower.alert_states().items())
    except Exception:          # watchtower failure: no rows
        alert_rows = []
    family("dl4j_alert_state", "gauge",
           "watchtower SLO alert state (0 ok / 1 warn / 2 page)",
           [({"slo": slo}, state) for slo, state in alert_rows])
    fr = flightrec.stats()
    family("dl4j_flightrec_events_total", "counter",
           "flight-recorder events ever appended", [({}, fr["events_total"])])
    family("dl4j_flightrec_dropped_total", "counter",
           "flight-recorder events evicted by ring overflow",
           [({}, fr["dropped"])])
    family("dl4j_flightrec_enabled", "gauge",
           "1 when the flight recorder is recording",
           [({}, int(fr["enabled"]))])
    family("dl4j_flightrec_buffered", "gauge",
           "events currently held in the ring", [({}, fr["buffered"])])
    return "\n".join(lines) + "\n"


class _JsonlTailCache:
    """Parsed-record cache for attached JSONL stats files.

    Re-parsing the whole file on every ``/api/series`` poll is O(file) per
    request and the dashboard polls every 2 s — a long run's stats file
    would dominate the server. Entries are keyed on ``(mtime_ns, size)``:
    an exact match returns the cached records; growth of an append-only
    file (the ``FileStatsStorage`` contract) parses only the appended tail
    from the cached byte offset. A rewrite falls back to a full reparse —
    detected by a shrink below the cached offset OR a changed leading-
    bytes prefix (a restarted run recreating the path can reach a size
    past the old offset between polls; the prefix check catches it
    without hashing the file). A torn final line (mid-write, no trailing
    newline) is left unparsed with the offset NOT advanced past it, so it
    is retried complete on a later request."""

    PREFIX_LEN = 64

    def __init__(self) -> None:
        self._state: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.tail_reads = 0
        self.full_reads = 0

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "tail_reads": self.tail_reads,
                "full_reads": self.full_reads,
                "paths": len(self._state)}

    def read(self, path: str) -> List[dict]:
        st = os.stat(path)
        sig = (st.st_mtime_ns, st.st_size)
        with self._lock:
            ent = self._state.get(path)
            if ent is not None and ent["sig"] == sig:
                self.hits += 1
                return ent["records"]
            with open(path, "rb") as f:
                prefix = f.read(self.PREFIX_LEN)
                if ent is not None and st.st_size >= ent["offset"] \
                        and prefix == ent["prefix"]:
                    offset, records = ent["offset"], list(ent["records"])
                    self.tail_reads += 1
                else:
                    offset, records = 0, []
                    self.full_reads += 1
                f.seek(offset)
                data = f.read()
            end = data.rfind(b"\n") + 1
            for line in data[:end].splitlines():
                if not line.strip():
                    continue
                try:
                    records.append(json.loads(line.decode()))
                except (ValueError, UnicodeDecodeError):
                    continue
            self._state[path] = {"sig": sig, "offset": offset + end,
                                 "records": records, "prefix": prefix}
            return records

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>deeplearning4j UI</title>
<style>
 body{font-family:system-ui,sans-serif;margin:24px;background:#fafafa}
 h1{font-size:18px} .tag{margin:18px 0}
 svg{background:#fff;border:1px solid #ddd} .axis{stroke:#999}
 text{font-size:11px;fill:#555} polyline{fill:none;stroke:#2a6fdb;stroke-width:1.5}
 .latest{color:#2a6fdb;font-weight:600}
</style></head><body>
<h1>deeplearning4j training UI</h1>
<div id="health" style="color:#666;font-size:12px;margin:-8px 0 14px"></div>
<div id="charts"></div>
<div id="sdgraph"></div>
<script>
function esc(s){const d=document.createElement('div');d.textContent=s;return d.innerHTML;}
function mib(b){return (b/1048576).toFixed(0)+' MiB';}
async function health(){
  try{
    const h = await (await fetch('/api/health')).json();
    let parts = ['backend '+(h.backend||'?'),
                 'up '+(h.uptime_s||0)+'s',
                 (h.records||0)+' records'];
    for (const d of (h.devices||[])){
      if (d.bytes_in_use !== undefined)
        parts.push('dev'+d.id+' '+mib(d.bytes_in_use)+'/'+mib(d.bytes_limit));
    }
    if (h.live_buffers)
      parts.push(h.live_buffers.count+' live buffers ('+mib(h.live_buffers.bytes)+')');
    if (h.host && h.host.rss_bytes)
      parts.push('host rss '+mib(h.host.rss_bytes));
    document.getElementById('health').textContent = parts.join(' — ');
  }catch(e){}
}
health(); setInterval(health, 5000);
async function refresh(){
  const tags = await (await fetch('/api/tags')).json();
  const root = document.getElementById('charts');
  for (const tag of tags){
    const pts = await (await fetch('/api/series?tag='+encodeURIComponent(tag))).json();
    if (!pts.length) continue;
    let div = document.getElementById('c_'+tag);
    if (!div){
      div = document.createElement('div'); div.className='tag'; div.id='c_'+tag;
      root.appendChild(div);
    }
    const W=640,H=180,P=36;
    const xs=pts.map(p=>p[0]), ys=pts.map(p=>p[1]);
    const x0=Math.min(...xs), x1=Math.max(...xs)||1;
    const y0=Math.min(...ys), y1=Math.max(...ys);
    const sx=s=>P+(W-2*P)*(s-x0)/Math.max(x1-x0,1e-9);
    const sy=v=>H-P-(H-2*P)*(v-y0)/Math.max(y1-y0,1e-9);
    const line=pts.map(p=>sx(p[0]).toFixed(1)+','+sy(p[1]).toFixed(1)).join(' ');
    div.innerHTML = '<b>'+esc(tag)+'</b> <span class="latest">'+
      ys[ys.length-1].toPrecision(5)+'</span> (step '+xs[xs.length-1]+')<br>'+
      '<svg width="'+W+'" height="'+H+'">'+
      '<line class="axis" x1="'+P+'" y1="'+(H-P)+'" x2="'+(W-P)+'" y2="'+(H-P)+'"/>'+
      '<line class="axis" x1="'+P+'" y1="'+P+'" x2="'+P+'" y2="'+(H-P)+'"/>'+
      '<text x="'+P+'" y="'+(H-P+14)+'">'+x0+'</text>'+
      '<text x="'+(W-P-30)+'" y="'+(H-P+14)+'">'+x1+'</text>'+
      '<text x="2" y="'+(H-P)+'">'+y0.toPrecision(3)+'</text>'+
      '<text x="2" y="'+(P+4)+'">'+y1.toPrecision(3)+'</text>'+
      '<polyline points="'+line+'"/></svg>';
  }
}
refresh(); setInterval(refresh, 2000);
async function drawGraph(){
  const g = await (await fetch('/api/graph')).json();
  if (!g || !g.ops || !g.ops.length) return;
  const root = document.getElementById('sdgraph');
  const byDepth = {};
  for (const op of g.ops){
    (byDepth[op.depth] = byDepth[op.depth] || []).push(op);
  }
  let html = '<h1>SameDiff graph ('+g.n_ops+' ops, '+g.n_vars+
             ' vars)</h1><div class="glayers">';
  for (const d of Object.keys(byDepth).sort((a,b)=>a-b)){
    html += '<div class="glayer"><span class="gdepth">'+d+'</span>';
    for (const op of byDepth[d]){
      // escAttr: esc() covers text context only — attribute values also
      // need double quotes neutralized
      const t = esc(op.inputs.join(', ')).replace(/"/g,'&quot;');
      html += '<span class="gnode" title="in: '+t+
              '">'+esc(op.op)+' <i>'+esc(op.name)+'</i></span>';
    }
    html += '</div>';
  }
  root.innerHTML = html + '</div>';
}
drawGraph();
</script>
<style>
 .glayer{margin:3px 0}
 .gdepth{display:inline-block;width:26px;color:#999}
 .gnode{display:inline-block;background:#fff;border:1px solid #ccd;
        border-radius:4px;padding:2px 7px;margin:1px 3px;font-size:12px}
 .gnode i{color:#888;font-style:normal;font-size:10px}
</style>
</body></html>
"""


class UIServer:
    """Reference-shaped singleton: ``UIServer.get_instance().attach(...)``
    then ``enable()`` (reference ``attachUI``/port 9000 convention)."""

    _instance: Optional["UIServer"] = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._stores: List[Any] = []
        self._paths: List[str] = []
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._jsonl = _JsonlTailCache()
        self._t0 = time.time()
        # records POSTed by RemoteUIStatsStorageRouter clients
        self._remote = InMemoryStatsStorage()
        self._stores.append(self._remote)
        self._serving = None    # ServingEngine behind /api/infer

    @classmethod
    def get_instance(cls) -> "UIServer":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    getInstance = get_instance

    # -- wiring ----------------------------------------------------------
    def attach(self, storage) -> "UIServer":
        """Attach an InMemoryStatsStorage (live queries) or a JSONL stats
        path / FileStatsStorage (re-read per request)."""
        if isinstance(storage, str):
            self._paths.append(storage)
        elif isinstance(storage, FileStatsStorage):
            self._paths.append(storage.path)
        elif hasattr(storage, "records"):
            self._stores.append(storage)
        else:
            raise TypeError(
                f"cannot attach {type(storage).__name__}: need an "
                "InMemoryStatsStorage, a FileStatsStorage, or a JSONL "
                "path (TensorBoardStatsStorage is viewed with "
                "`tensorboard --logdir`, not this server)")
        return self

    def attach_graph(self, source) -> "UIServer":
        """Attach a SameDiff graph for the dashboard's SameDiff section
        (reference: LogFileWriter's uigraphstatic log rendered by the UI's
        SameDiff tab). ``source`` is a SameDiff instance, a structure dict
        from ``graph_structure()``, or a ``LogFileWriter`` log path
        (re-read per request — live like the JSONL stats)."""
        from .graph_log import graph_structure

        if isinstance(source, str):
            self._graph_path = source
            self._graph = None
        elif isinstance(source, dict):
            self._graph = source
            self._graph_path = None
        else:
            self._graph = graph_structure(source)
            self._graph_path = None
        return self

    def _graph_payload(self):
        path = getattr(self, "_graph_path", None)
        if path is not None:
            from .graph_log import read_graph_log

            return read_graph_log(path)["graph"] or {}
        return getattr(self, "_graph", None) or {}

    def attach_serving(self, engine) -> "UIServer":
        """Expose a :class:`parallel.serving.ServingEngine` (or any object
        with a deadline-bounded ``output(ndarray)`` giving a CPU tensor) on
        ``POST /api/infer``.
        Replica retirement/resurrection stays inside the engine — the
        endpoint never needs to know a replica died."""
        self._serving = engine
        return self

    def detach_all(self) -> None:
        self._stores = [self._remote]
        self._paths = []
        self._graph = None
        self._graph_path = None
        self._serving = None

    # -- data ------------------------------------------------------------
    def _records(self) -> List[Dict[str, Any]]:
        """All SCALAR records across attached stores and JSONL paths.
        JSONL files go through the tail cache (only the appended tail is
        parsed per request); histogram records (no "value" field — the
        TensorBoard backends render those) are filtered out here."""
        recs: List[Dict[str, Any]] = []
        for s in self._stores:
            recs.extend(getattr(s, "records", []))
        for p in self._paths:
            try:
                recs.extend(r for r in self._jsonl.read(p) if "value" in r)
            except (OSError, ValueError):
                pass
        return recs

    def health(self) -> Dict[str, Any]:
        """The /api/health payload: process uptime, attached-source census,
        JSONL-cache effectiveness, the live card/host memory telemetry
        from ``common.system_info.memory_summary`` (the caching
        allocator's and the driver's figures per card), every derived
        profiler ledger (fault injection, collectives, elastic, integrity,
        autoscale, ...), the flight recorder's totals, the inference-pool
        census (live/retired/resurrected replicas), and the serving ledger
        (requests/batches, bucket fill ratio, pad waste, queue-depth
        high-water, rolling p50/p99 latency, traces-after-warmup)."""
        from ..common.profiler import OpProfiler
        from ..common.system_info import memory_summary
        from ..parallel.inference import pool_health
        from ..parallel.serving import serving_health

        n = sum(len(getattr(s, "records", ())) for s in self._stores)
        for p in self._paths:
            try:
                # counts from the tail cache — no full-list materialization
                n += sum(1 for r in self._jsonl.read(p) if "value" in r)
            except (OSError, ValueError):
                pass
        from ..common import flightrec

        prof = OpProfiler.get()
        # every derived profiler ledger rides OpProfiler.LEDGERS — the
        # same list /api/metrics and print_statistics iterate, so a new
        # ledger can never be metrics-only by accident. The serving section stays the MERGED
        # view (counters + per-engine latency quantiles).
        ledgers = {label: getattr(prof, attr)()
                   for label, attr in OpProfiler.LEDGERS
                   if label != "serving"}
        ledgers["serving"] = serving_health()
        # operators find the evidence from here: the newest incident
        # report (or blackbox when no watchtower ever assembled one)
        try:
            from ..common import watchtower

            last_incident = watchtower.last_incident()
        except Exception:
            last_incident = None
        return {"status": "ok",
                "last_incident": last_incident,
                "uptime_s": round(time.time() - self._t0, 1),
                "stores": len(self._stores),
                "paths": len(self._paths),
                "records": n,
                "jsonl_cache": self._jsonl.stats(),
                **ledgers,
                "flightrec": flightrec.stats(),
                "inference": pool_health(),
                **memory_summary()}

    def sessions(self) -> List[str]:
        return sorted({str(r.get("session", "")) for r in self._records()})

    def tags(self) -> List[str]:
        """Tag list; session-qualified as "session/tag" when records from
        more than one session are attached (two workers posting the same
        tag must chart as two series, not one interleaved sawtooth —
        reference UI keys by session)."""
        recs = self._records()
        sessions = {str(r.get("session", "")) for r in recs}
        if len(sessions) > 1:
            return sorted({f"{r.get('session', '')}/{r['tag']}"
                           for r in recs})
        return sorted({r["tag"] for r in recs})

    def series(self, tag: str,
               session: Optional[str] = None) -> List[Tuple[int, float]]:
        """Step-sorted (step, value) series for a tag. ``session`` filters
        to one session; a "session/tag"-qualified tag (as emitted by
        ``tags()`` in multi-session mode) is split the same way."""
        recs = self._records()
        if session is None and "/" in tag \
                and tag not in {r["tag"] for r in recs}:
            # qualified, not literal: split at the longest KNOWN session
            # prefix (session ids may themselves contain "/")
            sessions = {str(r.get("session", "")) for r in recs}
            for cand in sorted(
                    (s for s in sessions if tag.startswith(s + "/")),
                    key=len, reverse=True):
                session, tag = cand, tag[len(cand) + 1:]
                break
        return sorted((r["step"], r["value"]) for r in recs
                      if r["tag"] == tag
                      and (session is None
                           or str(r.get("session", "")) == session))

    # -- server ----------------------------------------------------------
    def enable(self, port: int = 9000) -> int:
        """Start serving (reference default port 9000; pass 0 for an
        ephemeral port). Returns the bound port."""
        if self._httpd is not None:
            return self._httpd.server_address[1]
        ui = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):    # quiet
                pass

            def _send(self, body: bytes, ctype: str, code: int = 200,
                      headers: Optional[Dict[str, str]] = None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    self._send(_PAGE.encode(), "text/html; charset=utf-8")
                elif u.path == "/healthz":
                    self._send(b"ok", "text/plain")
                elif u.path == "/api/health":
                    self._send(json.dumps(ui.health()).encode(),
                               "application/json")
                elif u.path == "/api/metrics":
                    self._send(prometheus_text().encode(),
                               "text/plain; version=0.0.4; charset=utf-8")
                elif u.path == "/api/tags":
                    self._send(json.dumps(ui.tags()).encode(),
                               "application/json")
                elif u.path == "/api/sessions":
                    self._send(json.dumps(ui.sessions()).encode(),
                               "application/json")
                elif u.path == "/api/graph":
                    self._send(json.dumps(ui._graph_payload()).encode(),
                               "application/json")
                elif u.path == "/api/series":
                    q = parse_qs(u.query)
                    tag = q.get("tag", [""])[0]
                    session = q.get("session", [None])[0]
                    self._send(
                        json.dumps(ui.series(tag, session=session)).encode(),
                        "application/json")
                elif u.path == "/api/trace":
                    # the flight-recorder ring as a Perfetto-loadable
                    # Chrome trace; ?corr= narrows to one incident
                    from ..common import flightrec

                    q = parse_qs(u.query)
                    corr = q.get("corr", [None])[0]
                    self._send(
                        json.dumps(flightrec.chrome_trace(corr=corr)).encode(),
                        "application/json")
                elif u.path == "/api/incidents":
                    from ..common import watchtower

                    q = parse_qs(u.query)
                    iid = q.get("id", [None])[0]
                    if iid is None:
                        self._send(
                            json.dumps(watchtower.incidents()).encode(),
                            "application/json")
                    else:
                        match = [i for i in watchtower.incidents()
                                 if i["id"] == iid]
                        if not match:
                            self._send(f"no incident {iid!r}".encode(),
                                       "text/plain", 404)
                        else:
                            try:
                                with open(match[0]["path"], "rb") as f:
                                    body = f.read()
                            except OSError as e:
                                self._send(f"incident file unreadable: "
                                           f"{e}".encode(), "text/plain",
                                           500)
                            else:
                                self._send(body, "application/json")
                else:
                    self._send(b"not found", "text/plain", 404)

            def _infer(self):
                # the serving endpoint: one JSON request → one bucketed,
                # deadline-bounded engine call. Thread-per-request
                # (ThreadingHTTPServer) feeds the engine's continuous
                # batcher, so concurrent HTTP clients coalesce into
                # shared bucket dispatches exactly like direct callers.
                import math

                import numpy as np

                from ..parallel.serving import Overloaded, OversizeRequest

                engine = getattr(ui, "_serving", None)
                if engine is None:
                    self._send(b"no serving engine attached "
                               b"(UIServer.attach_serving)", "text/plain",
                               503)
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n).decode())
                    inputs = np.asarray(body["inputs"], dtype=np.float32)
                    slo = body.get("slo_class")
                except (ValueError, KeyError, TypeError) as e:
                    self._send(f"bad request: {e}".encode(), "text/plain",
                               400)
                    return
                t0 = time.monotonic()
                try:
                    # kwarg only when classified: a plain
                    # ParallelInference behind this endpoint accepts no
                    # slo_class, and must keep working unclassified
                    out = (engine.output(inputs, slo_class=slo)
                           if slo is not None else engine.output(inputs))
                except Overloaded as e:
                    # the load-shed contract: synchronous 429 with a
                    # Retry-After derived from the measured queue drain
                    # rate (integer seconds per RFC 9110, rounded up)
                    self._send(
                        str(e).encode(), "text/plain", 429,
                        headers={"Retry-After":
                                 str(max(1, math.ceil(e.retry_after_s)))})
                    return
                except OversizeRequest as e:
                    self._send(str(e).encode(), "text/plain", 413)
                    return
                except ValueError as e:      # shape/rank mismatch
                    self._send(str(e).encode(), "text/plain", 400)
                    return
                except TimeoutError as e:    # deadline expired in queue
                    self._send(str(e).encode(), "text/plain", 504)
                    return
                except RuntimeError as e:    # pool retired / shut down
                    self._send(str(e).encode(), "text/plain", 503)
                    return
                except Exception as e:
                    # a model/XLA failure scattered through the future
                    # must reach the client as a status code, not a
                    # dropped connection
                    self._send(f"inference failed: "
                               f"{type(e).__name__}: {e}".encode(),
                               "text/plain", 500)
                    return
                payload = {"outputs": out.numpy().tolist(),
                           "shape": list(out.shape),
                           "latency_ms": round(
                               (time.monotonic() - t0) * 1e3, 3)}
                self._send(json.dumps(payload).encode(),
                           "application/json")

            def do_POST(self):
                # remote stats ingestion (reference
                # RemoteUIStatsStorageRouter: workers POST their updates
                # to the UI server)
                u = urlparse(self.path)
                if u.path == "/api/infer":
                    self._infer()
                    return
                if u.path != "/api/post":
                    self._send(b"not found", "text/plain", 404)
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    recs = json.loads(self.rfile.read(n).decode())
                    if isinstance(recs, dict):
                        recs = [recs]
                    # validate the WHOLE batch before inserting any record
                    # (a 400 must mean nothing was stored, or a client
                    # retry would duplicate the good prefix)
                    parsed = [(str(rec.get("session", "")),
                               str(rec["tag"]), int(rec["step"]),
                               float(rec["value"])) for rec in recs]
                except (ValueError, KeyError, TypeError,
                        AttributeError) as e:
                    self._send(f"bad record: {e}".encode(), "text/plain",
                               400)
                    return
                for session, tag, step, value in parsed:
                    ui._remote.put_scalar(session, tag, step, value)
                self._send(b"ok", "text/plain")

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5.0)
            self._httpd = None
            self._thread = None


class RemoteUIStatsStorageRouter(StatsStorage):
    """StatsStorage that POSTs scalars to a remote :class:`UIServer`
    (reference ``RemoteUIStatsStorageRouter`` — how Spark workers fed the
    driver-hosted UI; here: how any process feeds a central dashboard).

    ``put_scalar`` only enqueues (never blocks the training loop); a
    daemon sender thread drains the bounded queue in small batches,
    best-effort — when the server is unreachable or the queue is full,
    records drop rather than stall training."""

    def __init__(self, url: str, queue_size: int = 4096,
                 timeout: float = 2.0):
        import queue
        import threading

        self.url = url.rstrip("/")
        self.timeout = float(timeout)
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._closed = False
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def put_scalar(self, session, tag, step, value) -> None:
        import queue

        try:
            self._q.put_nowait({"session": session, "tag": tag,
                                "step": int(step),
                                "value": float(value)})
        except queue.Full:
            pass    # best-effort: drop under backpressure

    def _drain(self) -> None:
        import queue
        import urllib.request

        while not self._closed:
            try:
                batch = [self._q.get(timeout=0.25)]
            except queue.Empty:
                continue
            while len(batch) < 256:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            req = urllib.request.Request(
                self.url + "/api/post", data=json.dumps(batch).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=self.timeout):
                    pass
            except OSError:
                pass    # server down: drop the batch

    def flush(self, deadline: float = 5.0) -> None:
        """Best-effort wait for the queue to drain (tests/shutdown)."""
        import time

        t0 = time.time()
        while not self._q.empty() and time.time() - t0 < deadline:
            time.sleep(0.02)
        time.sleep(0.1)     # let the in-flight batch land

    def close(self) -> None:
        self.flush()
        self._closed = True
