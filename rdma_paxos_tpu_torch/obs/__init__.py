"""Cluster observability: metrics registry, protocol trace ring, spans.

The port's copy of the JAX package's ``obs`` host modules that the
driver reads, all host-side and stdlib-only:

* :mod:`~rdma_paxos_tpu_torch.obs.metrics` — thread-safe counters,
  gauges and fixed-bucket histograms with per-replica labels;
* :mod:`~rdma_paxos_tpu_torch.obs.trace` — a bounded ring of typed
  protocol events, dumpable on failure;
* :mod:`~rdma_paxos_tpu_torch.obs.spans` — sampled command spans, the
  step-phase profiler, the Chrome-trace export and its CLI;
* :mod:`~rdma_paxos_tpu_torch.obs.clock` — the ``(monotonic, wall)``
  anchor every dump is stamped with;
* :mod:`~rdma_paxos_tpu_torch.obs.audit` — the audit ledger, flight
  recorder, artifacts and first-divergence CLI of the ``audit=`` step
  variant;
* :mod:`~rdma_paxos_tpu_torch.obs.device` — the device telemetry: the
  ``telemetry=`` step variant's host side, the ``torch.profiler``
  capture manager, the merged timeline and the dispatch reports;
* :mod:`~rdma_paxos_tpu_torch.obs.alerts` — declarative SLO alert
  rules (digest mismatch, leaderless, latency burn rates, election
  storms, repair escalation) evaluated by the drivers' host loops;
* :mod:`~rdma_paxos_tpu_torch.obs.series` — the registry sampled on
  the alert cadence into bounded per-series rings (the window-domain
  rules' substrate), persisted as append-only JSONL;
* :mod:`~rdma_paxos_tpu_torch.obs.health` — per-replica and cluster
  health documents and their periodic files;
* :mod:`~rdma_paxos_tpu_torch.obs.export` — the Prometheus text
  renderer and the localhost ops exporter (``/metrics`` ``/healthz``
  ``/series`` ``/alerts``);
* :mod:`~rdma_paxos_tpu_torch.obs.tracectx` — subsystem traces (the
  facade's ``tracectx``), the merged timeline and the blame report;
* :mod:`~rdma_paxos_tpu_torch.obs.console` — the fleet table and the
  postmortem bundles (``python -m rdma_paxos_tpu_torch.obs.console``),
  and ``python -m rdma_paxos_tpu_torch.obs`` (``merge``, ``blame``).

Nothing here runs inside the replica step.
"""

from __future__ import annotations

from typing import Optional

from rdma_paxos_tpu_torch.obs import (
    alerts, clock, export, health, metrics, series, spans, trace,
    tracectx)
from rdma_paxos_tpu_torch.obs.alerts import AlertEngine
from rdma_paxos_tpu_torch.obs.export import OpsExporter
from rdma_paxos_tpu_torch.obs.health import HealthReporter
from rdma_paxos_tpu_torch.obs.metrics import MetricsRegistry
from rdma_paxos_tpu_torch.obs.series import TimeSeriesStore
from rdma_paxos_tpu_torch.obs.spans import SpanRecorder, StepPhaseProfiler
from rdma_paxos_tpu_torch.obs.trace import TraceRing
from rdma_paxos_tpu_torch.obs.tracectx import TraceContext


class Observability:
    """Facade bundling one registry + one trace ring + one span
    recorder + one trace context — the unit the driver threads through
    every layer. Each :class:`ClusterDriver` gets its own (isolated,
    test-friendly); module-level code with no driver in scope records
    against :func:`default`."""

    def __init__(self, metrics_registry: Optional[MetricsRegistry] = None,
                 trace_ring: Optional[TraceRing] = None,
                 span_recorder: Optional[SpanRecorder] = None,
                 trace_context: Optional[TraceContext] = None):
        self.metrics = (metrics_registry if metrics_registry is not None
                        else MetricsRegistry())
        self.trace = (trace_ring if trace_ring is not None
                      else TraceRing())
        self.spans = (span_recorder if span_recorder is not None
                      else SpanRecorder())
        self.tracectx = (trace_context if trace_context is not None
                         else TraceContext())

    def snapshot(self) -> dict:
        """Combined point-in-time export: the metrics snapshot, the
        trace ring's retained events and the span dump, stamped with
        the shared clock anchor. Subsystem traces ride as ``traces``
        only when some exist, so trace-free snapshots keep the
        trace-free schema."""
        out = {"anchor": clock.anchor(),
               "metrics": self.metrics.snapshot(),
               "trace": self.trace.dump(),
               "spans": self.spans.dump()}
        traces = self.tracectx.dump()
        if traces["traces"]:
            out["traces"] = traces
        return out

    def reset(self) -> None:
        self.metrics.reset()
        self.trace.clear()
        self.spans.reset()
        self.tracectx.reset()


_default: Optional[Observability] = None


def default() -> Observability:
    """The process-global facade over the module-level default registry
    and ring (shared with all module-level instrumentation)."""
    global _default
    if _default is None:
        _default = Observability(metrics.default_registry(),
                                 trace.default_ring())
    return _default


# ``audit`` and ``device`` need numpy and torch: resolved on first use,
# so that the stdlib-only modules above import without them
_LAZY = {"audit": ("audit", None), "device": ("device", None),
         "AuditLedger": ("audit", "AuditLedger"),
         "FlightRecorder": ("audit", "FlightRecorder"),
         "ProfilerSession": ("device", "ProfilerSession")}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        m = importlib.import_module(f"{__name__}.{mod}")
        return m if attr is None else getattr(m, attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Observability", "MetricsRegistry", "TraceRing",
           "HealthReporter", "SpanRecorder", "StepPhaseProfiler",
           "AuditLedger", "FlightRecorder", "AlertEngine",
           "ProfilerSession", "TimeSeriesStore", "OpsExporter",
           "TraceContext", "default", "metrics", "trace", "health",
           "spans", "clock", "audit", "alerts", "device", "series",
           "export", "tracectx"]
