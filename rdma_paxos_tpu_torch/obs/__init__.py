"""Cluster observability: metrics registry, protocol trace ring, spans.

The port's copy of the JAX package's ``obs`` host modules that the
driver reads, all host-side and stdlib-only:

* :mod:`~rdma_paxos_tpu_torch.obs.metrics` — thread-safe counters,
  gauges and fixed-bucket histograms with per-replica labels;
* :mod:`~rdma_paxos_tpu_torch.obs.trace` — a bounded ring of typed
  protocol events, dumpable on failure;
* :mod:`~rdma_paxos_tpu_torch.obs.spans` — sampled command spans and
  the step-phase profiler (the Chrome-trace export and its CLI are not
  copied yet);
* :mod:`~rdma_paxos_tpu_torch.obs.clock` — the ``(monotonic, wall)``
  anchor every dump is stamped with;
* :mod:`~rdma_paxos_tpu_torch.obs.audit` — the audit ledger, flight
  recorder, artifacts and first-divergence CLI of the ``audit=`` step
  variant;
* :mod:`~rdma_paxos_tpu_torch.obs.device` — the counter half of the
  device telemetry (the ``telemetry=`` step variant's host side).

The facade's ``tracectx`` member, the ``alerts``, ``series``,
``health`` and ``export`` modules and the profiler half of ``device``
come with ROADMAP Queue 1, item 13.

Nothing here runs inside the replica step.
"""

from __future__ import annotations

from typing import Optional

from rdma_paxos_tpu_torch.obs import clock, metrics, spans, trace
from rdma_paxos_tpu_torch.obs.metrics import MetricsRegistry
from rdma_paxos_tpu_torch.obs.spans import SpanRecorder, StepPhaseProfiler
from rdma_paxos_tpu_torch.obs.trace import TraceRing


class Observability:
    """Facade bundling one registry + one trace ring + one span
    recorder — the unit the driver threads through every layer. Each
    :class:`ClusterDriver` gets its own (isolated, test-friendly);
    module-level code with no driver in scope records against
    :func:`default`."""

    def __init__(self, metrics_registry: Optional[MetricsRegistry] = None,
                 trace_ring: Optional[TraceRing] = None,
                 span_recorder: Optional[SpanRecorder] = None):
        self.metrics = (metrics_registry if metrics_registry is not None
                        else MetricsRegistry())
        self.trace = (trace_ring if trace_ring is not None
                      else TraceRing())
        self.spans = (span_recorder if span_recorder is not None
                      else SpanRecorder())

    def snapshot(self) -> dict:
        """Combined point-in-time export: the metrics snapshot, the
        trace ring's retained events and the span dump, stamped with
        the shared clock anchor."""
        return {"anchor": clock.anchor(),
                "metrics": self.metrics.snapshot(),
                "trace": self.trace.dump(),
                "spans": self.spans.dump()}

    def reset(self) -> None:
        self.metrics.reset()
        self.trace.clear()
        self.spans.reset()


_default: Optional[Observability] = None


def default() -> Observability:
    """The process-global facade over the module-level default registry
    and ring (shared with all module-level instrumentation)."""
    global _default
    if _default is None:
        _default = Observability(metrics.default_registry(),
                                 trace.default_ring())
    return _default


__all__ = ["Observability", "MetricsRegistry", "TraceRing",
           "SpanRecorder", "StepPhaseProfiler", "default", "metrics",
           "trace", "spans", "clock"]
