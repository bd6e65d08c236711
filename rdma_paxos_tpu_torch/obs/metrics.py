"""Process-local metrics registry — counters, gauges, fixed-bucket
histograms.

The reference's only telemetry is per-replica text logs (``debug.h``
``info_wtime`` macros) grepped by ``run.sh``; that answers "who is the
leader" but not the questions the ROADMAP's north-star demands at
production scale: commit latency distributions, replication throughput,
election churn, log-rebase headroom, replay backpressure. This registry
is the exported-signal layer those answers come from.

Design constraints (deliberate):

* **Zero dependencies** — stdlib only, importable from any layer
  (proxy, consensus host side, elastic control plane) without pulling
  in JAX or numpy.
* **Cheap enough for the driver hot loop** — one lock acquisition and
  a dict store per operation; histograms bisect a fixed bucket list.
  Instrumentation is HOST-SIDE ONLY: nothing in this module may be
  called from inside a jitted/``shard_map``ped function (verified by
  ``tests/test_obs.py`` — compiled-step cache keys are unchanged by
  instrumentation).
* **Thread-safe** — proxy link threads, the poll thread, and app
  threads all record concurrently.

Series are keyed by ``name`` plus sorted ``label=value`` pairs (the
per-replica label being the ubiquitous one); ``snapshot()`` renders
them as ``name{k=v,...}`` strings, JSON-exportable for the bench
harness and BENCH_* rounds.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# Default bucket ladders. Latency buckets span the p99<50µs device
# frontier (BASELINE.md) up to election-timeout scale; batch buckets
# are powers of two matching slot-ring geometry.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    1e-5, 2e-5, 5e-5, 1e-4, 2e-4, 5e-4, 1e-3, 2e-3, 5e-3,
    1e-2, 2e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)
# the single µs ladder (StepTimer sections, bench dispatch latencies):
# one definition so histograms stay comparable across BENCH_* rounds
LATENCY_BUCKETS_US: Tuple[float, ...] = (
    10, 20, 50, 100, 200, 500, 1000, 2000, 5000,
    10000, 50000, 100000, 1000000)
BATCH_BUCKETS: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)


def _key(name: str, labels: dict) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render(key: Tuple[str, Tuple[Tuple[str, str], ...]]) -> str:
    name, labels = key
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


def parse_key(key: str) -> Tuple[str, List[Tuple[str, str]]]:
    """Inverse of the rendered-key grammar: ``"name{k=v,...}"`` ->
    ``(name, [(k, v), ...])``. The ONE parser every consumer of
    rendered keys shares (alert matching, series sub-keys, Prometheus
    rendering) — the grammar lives here, next to :func:`_render`."""
    base, sep, rest = key.partition("{")
    pairs: List[Tuple[str, str]] = []
    if sep:
        for part in rest.rstrip("}").split(","):
            if part:
                k, _, v = part.partition("=")
                pairs.append((k, v))
    return base, pairs


# per-bucket exemplar reservoir bound: enough to hand a pager a few
# concrete slow traces, small enough that a histogram stays a few
# hundred bytes
EXEMPLARS_PER_BUCKET = 4


class _Hist:
    __slots__ = ("bounds", "counts", "count", "sum", "min", "max",
                 "exemplars")

    def __init__(self, bounds: Sequence[float]):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)   # +1 = overflow
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        # bucket index -> bounded [(trace_id, value)] reservoir; lazy
        # (None until the first exemplar) so exemplar-free histograms
        # cost nothing and snapshot byte-identically to before
        self.exemplars: Optional[Dict[int, list]] = None

    def observe(self, value: float,
                exemplar: Optional[str] = None) -> None:
        b = bisect.bisect_left(self.bounds, value)
        self.counts[b] += 1
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if exemplar is not None:
            if self.exemplars is None:
                self.exemplars = {}
            res = self.exemplars.setdefault(b, [])
            if len(res) < EXEMPLARS_PER_BUCKET:
                res.append((exemplar, value))
            else:
                # deterministic replacement (no RNG): the slot cycles
                # with the observation count, so the reservoir keeps a
                # moving sample of recent exemplars per bucket
                res[self.count % EXEMPLARS_PER_BUCKET] = (exemplar,
                                                          value)

    def _bucket_label(self, b: int) -> str:
        return repr(self.bounds[b]) if b < len(self.bounds) else "+Inf"

    def as_dict(self) -> dict:
        buckets = {repr(b): c for b, c in zip(self.bounds, self.counts)}
        buckets["+Inf"] = self.counts[-1]
        out = dict(buckets=buckets, count=self.count, sum=self.sum,
                   min=(self.min if self.count else None),
                   max=(self.max if self.count else None))
        if self.exemplars:
            # only when exemplars exist: exemplar-free snapshots keep
            # the pre-exemplar schema byte-for-byte
            out["exemplars"] = {
                self._bucket_label(b): [[tid, v] for tid, v in res]
                for b, res in sorted(self.exemplars.items()) if res}
        return out


class MetricsRegistry:
    """Thread-safe counters / gauges / fixed-bucket histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict = {}
        self._gauges: Dict = {}
        self._hists: Dict = {}

    # ---------------- recording ----------------

    def inc(self, name: str, value: float = 1, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0) + value

    def set(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = value

    def observe(self, name: str, value: float,
                buckets: Optional[Sequence[float]] = None,
                exemplar: Optional[str] = None, **labels) -> None:
        """Record ``value`` into histogram ``name``. ``buckets`` fixes
        the bucket upper bounds on FIRST use of a series; later calls
        reuse the established ladder (fixed-bucket by design — merges
        and snapshots never re-bin). ``exemplar`` attaches a trace id
        to the value's bucket (bounded reservoir) — the join between a
        latency histogram and the span that produced its tail."""
        k = _key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = _Hist(buckets if buckets is not None
                          else LATENCY_BUCKETS_S)
                self._hists[k] = h
            h.observe(float(value), exemplar)

    # ---------------- reading ----------------

    def get(self, name: str, **labels):
        """Current value of a counter or gauge series (0 if absent), or
        the histogram's dict form when ``name`` is a histogram."""
        k = _key(name, labels)
        with self._lock:
            if k in self._hists:
                return self._hists[k].as_dict()
            if k in self._gauges:
                return self._gauges[k]
            return self._counters.get(k, 0)

    def snapshot(self) -> dict:
        """Point-in-time copy: ``{"counters": {...}, "gauges": {...},
        "histograms": {...}}`` with ``name{label=value,...}`` keys —
        plain data, JSON-serializable."""
        with self._lock:
            return {
                "counters": {_render(k): v
                             for k, v in sorted(self._counters.items())},
                "gauges": {_render(k): v
                           for k, v in sorted(self._gauges.items())},
                "histograms": {_render(k): h.as_dict()
                               for k, h in sorted(self._hists.items())},
            }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def write_json(self, path: str) -> None:
        """Atomic (tmp + rename) JSON export — safe to read while the
        process keeps recording."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_json(indent=2))
        os.replace(tmp, path)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


# process-global default — the sink for module-level instrumentation
# (consensus/snapshot.py, runtime/elastic.py, proxy quiesce) that has no
# driver instance to hang a registry off
_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default
