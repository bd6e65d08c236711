"""Per-replica observability log — the ``debug.h`` analog.

The reference writes timestamped protocol events to a per-server file
(``info/info_wtime`` macros, ``src/include/dare/debug.h:24-106``; file from
env ``dare_log_file``, ``proxy.c:57-69``), and the benchmark driver finds
the leader by grepping ``"] LEADER"`` from those logs
(``benchmarks/run.sh:47-70``, printed at ``dare_server.c:1396``). The exact
same grep works against these files: on winning an election the driver
writes ``[T<term>] LEADER``.

Routed through :mod:`rdma_paxos_tpu_torch.obs` when an ``obs`` facade is
attached: the greppable ``"[T%d] LEADER"`` FILE line is preserved
verbatim (the run.sh contract), while every event additionally lands as
a structured trace event (and ``leader_elected`` as an
``elections_won_total`` counter) — so operators keep their grep and the
harness gets typed data.
"""

from __future__ import annotations

import time
from typing import Optional, TextIO

from rdma_paxos_tpu_torch.obs.metrics import LATENCY_BUCKETS_US


class ReplicaLog:
    def __init__(self, path: Optional[str] = None, *,
                 replica: int = -1, obs=None):
        self._f: Optional[TextIO] = open(path, "a") if path else None
        self._t0 = time.time()
        self.replica = replica
        self.obs = obs            # Observability facade or None

    def info(self, msg: str) -> None:
        if self.obs is not None:
            from rdma_paxos_tpu_torch.obs import trace as _trace
            self.obs.trace.record(_trace.LOG_LINE, replica=self.replica,
                                  msg=msg)
        if self._f is None:
            return
        self._f.write(msg + "\n")
        self._f.flush()

    def _write_wtime(self, msg: str) -> None:
        if self._f is None:
            return
        now = time.time()
        self._f.write(f"[{now:.6f} +{now - self._t0:8.3f}s] {msg}\n")
        self._f.flush()

    def info_wtime(self, msg: str) -> None:
        """Wall-clock-stamped event line (info_wtime analog)."""
        if self.obs is not None:
            from rdma_paxos_tpu_torch.obs import trace as _trace
            self.obs.trace.record(_trace.LOG_LINE, replica=self.replica,
                                  msg=msg)
        self._write_wtime(msg)

    def leader_elected(self, term: int) -> None:
        """The exact greppable leader line of the reference
        (``"[T%d] LEADER"``, dare_server.c:1396, grepped by run.sh) —
        preserved byte-for-byte in the file; the structured twin is an
        ``election_win`` trace event + ``elections_won_total``
        counter."""
        if self.obs is not None:
            from rdma_paxos_tpu_torch.obs import trace as _trace
            self.obs.trace.record(_trace.ELECTION_WIN,
                                  replica=self.replica, term=int(term))
            self.obs.metrics.inc("elections_won_total",
                                 replica=self.replica)
        # the trace above must not swallow the grep contract: the FILE
        # line below is what run.sh (and test_runtime_aux) greps
        self._write_wtime(f"[T{term}] LEADER")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class StepTimer:
    """rdtsc-style section timing (timer.h TIMER_START/STOP analog) with
    µs resolution, accumulated per label — and, when a registry is
    attached, observed into per-label ``timer_<label>_us`` histograms
    (per-replica labeled) so section timings export with every metrics
    snapshot instead of living only in ad-hoc report() strings."""

    # the shared µs ladder — spans sub-dispatch (~10µs) to
    # cold-compile stalls; one definition (obs.metrics) so timer
    # histograms stay comparable with the bench dispatch histograms
    BUCKETS_US = LATENCY_BUCKETS_US

    def __init__(self, metrics=None, replica: int = -1):
        self.acc = {}
        self._open = {}
        self.metrics = metrics    # MetricsRegistry or None
        self.replica = replica

    def start(self, label: str) -> None:
        self._open[label] = time.perf_counter_ns()

    def stop(self, label: str) -> None:
        t0 = self._open.pop(label, None)
        if t0 is not None:
            us = (time.perf_counter_ns() - t0) / 1e3
            n, tot, mx = self.acc.get(label, (0, 0.0, 0.0))
            self.acc[label] = (n + 1, tot + us, max(mx, us))
            if self.metrics is not None:
                self.metrics.observe(f"timer_{label}_us", us,
                                     buckets=self.BUCKETS_US,
                                     replica=self.replica)

    def report(self) -> str:
        lines = []
        for label, (n, tot, mx) in sorted(self.acc.items()):
            lines.append(f"{label}: n={n} mean={tot / max(n, 1):.1f}us "
                         f"max={mx:.1f}us")
        return "\n".join(lines)
