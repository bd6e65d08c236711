"""Metrics exposition — Prometheus text rendering + the ops HTTP
exporter.

The port's copy of the JAX package's ``obs/export.py`` (standard library only).

Everything the obs stack knows is, until this module, reachable only
from INSIDE the process (``driver.health()``) or post-hoc from dump
files. The exporter opens the standard pull surface an operator (or a
Prometheus scraper, or the fleet console) points at from OUTSIDE:

* ``/metrics`` — the registry in Prometheus text format v0.0.4
  (counters/gauges as-is, histograms as cumulative ``_bucket{le=}`` +
  ``_sum`` + ``_count``).
* ``/metrics.json`` — the raw registry ``snapshot()`` (the bundle's
  telemetry section; every ``device_*`` series rides here).
* ``/healthz`` — the attached ``health_fn()`` as JSON; HTTP 503 when
  the health document carries a truthy ``loop_error`` (a dead poll
  loop must fail the probe, not smile through it).
* ``/series`` — the attached :class:`~rdma_paxos_tpu_torch.obs.series.
  TimeSeriesStore` retained state.
* ``/alerts`` — the attached ``AlertEngine`` per-rule state + the
  currently-firing list.

Deliberately boring transport: stdlib ``ThreadingHTTPServer`` bound to
localhost, ``port=0`` = OS-assigned ephemeral (the tests' and benches'
mode), serving threads are daemons. The exporter runs BESIDE the
drivers' readback thread and touches only thread-safe read surfaces
(registry snapshot, engine state, series rings, ``health()``) — it is
never on the dispatch path, touches no CUDA tensor, and attaching it
changes no step.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from rdma_paxos_tpu_torch.obs.metrics import parse_key as _split

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _prom_labels(pairs, extra: str = "") -> str:
    parts = [f'{_prom_name(k)}="{_escape(v)}"' for k, v in pairs]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def render_prometheus(snap: dict) -> str:
    """Render a registry ``snapshot()`` dict as Prometheus text
    exposition format v0.0.4. Histogram buckets become CUMULATIVE
    ``le=`` counts (the registry stores per-bucket counts). All
    samples of one metric family are emitted as one uninterrupted
    group under one ``# TYPE`` header (a format MUST — enforced here
    by grouping rather than trusting input ordering, so any snapshot
    dict renders validly)."""
    families: dict = {}     # base -> (kind, [sample lines])

    def fam(base: str, kind: str):
        return families.setdefault(base, (kind, []))[1]

    for key, v in snap["counters"].items():
        base, pairs = _split(key)
        base = _prom_name(base)
        fam(base, "counter").append(f"{base}{_prom_labels(pairs)} {v}")
    for key, v in snap["gauges"].items():
        base, pairs = _split(key)
        base = _prom_name(base)
        fam(base, "gauge").append(f"{base}{_prom_labels(pairs)} {v}")
    for key, h in snap["histograms"].items():
        base, pairs = _split(key)
        base = _prom_name(base)
        out = fam(base, "histogram")
        ex = h.get("exemplars") or {}

        def tail(bound: str) -> str:
            # OpenMetrics exemplar syntax: append the bucket's most
            # recent sampled trace to its `_bucket` line. Absent
            # exemplars leave the v0.0.4 line byte-identical.
            res = ex.get(bound)
            if not res:
                return ""
            tid, v = res[-1]
            return f' # {{trace_id="{_escape(tid)}"}} {v}'

        cum = 0
        for bound, c in h["buckets"].items():
            if bound == "+Inf":
                continue
            cum += c
            le = _prom_labels(pairs, extra=f'le="{bound}"')
            out.append(f"{base}_bucket{le} {cum}{tail(bound)}")
        inf = _prom_labels(pairs, extra='le="+Inf"')
        out.append(f"{base}_bucket{inf} {h['count']}{tail('+Inf')}")
        out.append(f"{base}_sum{_prom_labels(pairs)} {h['sum']}")
        out.append(f"{base}_count{_prom_labels(pairs)} {h['count']}")
    lines = []
    for base in sorted(families):
        kind, samples = families[base]
        lines.append(f"# TYPE {base} {kind}")
        lines.extend(samples)
    return "\n".join(lines) + "\n"


class OpsExporter:
    """Opt-in localhost HTTP exposition of one process's ops plane
    (registry / health / series / alerts). ``port=0`` binds an
    OS-assigned ephemeral port — read it back from :attr:`port`."""

    def __init__(self, *, registry,
                 health_fn: Optional[Callable[[], dict]] = None,
                 alerts=None, series=None,
                 host: str = "127.0.0.1", port: int = 0):
        self.registry = registry
        self.health_fn = health_fn
        self.alerts = alerts
        self.series = series
        self._thread: Optional[threading.Thread] = None
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):    # noqa: N802 — stdlib name
                pass                      # never spam the serving logs

            def _reply(self, code: int, body: bytes,
                       ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, doc, code: int = 200) -> None:
                self._reply(code, json.dumps(doc).encode(),
                            "application/json")

            def do_GET(self):             # noqa: N802 — stdlib name
                try:
                    exporter._route(self)
                except BrokenPipeError:
                    pass                  # client went away mid-write
                except Exception as exc:  # noqa: BLE001 — the probe
                    # surface must answer, never kill its own thread
                    try:
                        self._json(dict(error=repr(exc)), code=500)
                    except OSError:
                        pass

        self._server = ThreadingHTTPServer((host, int(port)), Handler)
        self._server.daemon_threads = True

    # one routing table, testable without sockets
    def _route(self, h) -> None:
        path = h.path.split("?", 1)[0]
        if path == "/metrics":
            h._reply(200, render_prometheus(
                self.registry.snapshot()).encode(),
                "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/metrics.json":
            h._json(self.registry.snapshot())
        elif path == "/healthz":
            if self.health_fn is None:
                h._json(dict(ok=True))
                return
            doc = self.health_fn()
            h._json(doc, code=503 if doc.get("loop_error") else 200)
        elif path == "/series":
            if self.series is None:
                h._json(dict(error="no series store attached"), 404)
            else:
                h._json(self.series.to_dict())
        elif path == "/alerts":
            if self.alerts is None:
                h._json(dict(error="no alert engine attached"), 404)
            else:
                h._json(dict(state=self.alerts.state(),
                             firing=self.alerts.firing()))
        else:
            h._json(dict(error=f"unknown path {path!r}",
                         endpoints=["/metrics", "/metrics.json",
                                    "/healthz", "/series",
                                    "/alerts"]), 404)

    # ---------------- lifecycle ----------------

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "OpsExporter":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                name="ops-exporter", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        t, self._thread = self._thread, None
        if t is not None:
            self._server.shutdown()
            t.join(timeout=5.0)
        self._server.server_close()
