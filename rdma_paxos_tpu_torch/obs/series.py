"""Time-series retention — bounded per-series rings sampled from the
metrics registry.

The port's copy of the JAX package's ``obs/series.py`` (standard library only;
``tests/test_torch_alerts.py`` holds its points and documents equal to
the reference's).

The registry (obs/metrics.py) is a point-in-time surface: counters
only ever grow, gauges hold the last value, histograms accumulate
forever. Operating a long-running fleet needs the TIME dimension —
"how fast is this counter moving *now*", "what fraction of the last
minute's commits blew the latency budget" — which is exactly what the
window-domain alert rules (``rate_window`` / ``burn_rate`` in
obs/alerts.py) and the fleet console consume. This module is that
retention layer: a :class:`TimeSeriesStore` samples a registry
snapshot on the existing alert cadence into bounded per-series rings
of ``(step_index, wall, value)`` points.

Per-sample transformation (one point per series per call):

* **counters** — the point's ``value`` is the WINDOWED RATE over the
  sampling interval (``delta / dt`` per second); the raw cumulative
  total rides along (4th tuple slot) so window deltas stay exact.
* **gauges** — last value, as-is.
* **histograms** — decomposed into sub-series under the parent key:
  ``|p50`` / ``|p99`` quantile points (bucket-upper-bound estimate),
  ``|count`` / ``|sum`` cumulative (counter-shaped, rate + cum), and
  one ``|le|<bound>`` cumulative series per finite bucket bound (the
  CDF counts the burn-rate SLO rules difference over their windows).

Every store is stamped with the process's shared ``(monotonic, wall)``
anchor pair (obs/clock.py) and — when given a ``path`` — persists each
sample as ONE append-only JSONL line, so merging series from N hosts
is a file concat: every line carries its ``src`` tag and the loader
(:func:`read_jsonl` / :func:`merge_docs`) groups by it.

Host-side only: nothing here runs inside the replica step, and
attaching a store changes no step.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

from rdma_paxos_tpu_torch.obs.clock import anchor as clock_anchor
from rdma_paxos_tpu_torch.obs.metrics import parse_key

SCHEMA = 1

# histogram quantiles exported as sub-series points
QUANTILES: Tuple[float, ...] = (0.5, 0.99)

# sub-key separator — never appears in metric names or rendered label
# pairs, so ``key.partition("|")`` recovers the parent registry key
SUB = "|"


def split_series_key(key: str) -> Tuple[str, Dict[str, str], str]:
    """``"name{k=v}|le|0.25"`` -> ``("name", {"k": "v"}, "le|0.25")``
    — the parent metric name, its label pairs, and the sub-series
    suffix (empty for plain counter/gauge series)."""
    parent, _, sub = key.partition(SUB)
    base, pairs = parse_key(parent)
    return base, dict(pairs), sub


def _hist_quantile(h: dict, q: float) -> Optional[float]:
    """Upper bound of the bucket containing the q-th observation of
    ONE histogram dict (the obs/alerts.py estimate, single-histogram
    form)."""
    total = h["count"]
    if total == 0:
        return None
    need = q * total
    cum = 0
    for bound, c in h["buckets"].items():
        if bound == "+Inf":
            continue
        cum += c
        if cum >= need:
            return float(bound)
    return float("inf")


class TimeSeriesStore:
    """Bounded per-series rings of ``(step, wall, value, cum)`` points
    sampled from registry snapshots; optionally persisted as
    append-only JSONL."""

    def __init__(self, capacity: int = 512, path: Optional[str] = None,
                 source: str = "proc"):
        if capacity < 2:
            raise ValueError("capacity must be >= 2 (window math needs "
                             "at least two points)")
        self.capacity = int(capacity)
        self.source = source
        self.path = path
        self.anchor = clock_anchor()
        self.samples = 0
        self._lock = threading.Lock()
        self._series: Dict[str, collections.deque] = {}
        self._last_wall: Optional[float] = None
        self._last_step: int = 0
        self._fh = None
        if path is not None:
            # append-only by contract: a restarted process (or a second
            # store on the same path) extends the log, never rewrites
            # it. A missing/unwritable workdir costs the LOG, never the
            # caller — retention keeps working in memory (the drivers'
            # "observability I/O must never kill the data path" rule;
            # before this store, all workdir I/O was lazy + tolerated).
            try:
                self._fh = open(path, "a", buffering=1)
                self._fh.write(json.dumps(dict(
                    kind="header", schema=SCHEMA, src=self.source,
                    anchor=self.anchor, capacity=self.capacity)) + "\n")
            except OSError:
                self._fh = None

    # ---------------- recording ----------------

    def _push(self, key: str, step: int, wall: float, value: float,
              cum: Optional[float]) -> None:
        ring = self._series.get(key)
        if ring is None:
            ring = collections.deque(maxlen=self.capacity)
            self._series[key] = ring
        ring.append((step, wall, value, cum))

    def _counter_point(self, key: str, step: int, wall: float,
                       cum: float) -> None:
        ring = self._series.get(key)
        rate = 0.0
        if ring:
            _, pw, _, pc = ring[-1]
            dt = wall - pw
            if dt > 0 and pc is not None:
                rate = max(0.0, (cum - pc) / dt)
        self._push(key, step, wall, rate, cum)

    def sample(self, snap: dict, *, step: int,
               wall: Optional[float] = None) -> int:
        """Record one point per live series from a registry
        ``snapshot()`` dict; returns the number of series touched.
        ``wall`` is injectable for deterministic tests — production
        callers omit it."""
        wall = time.time() if wall is None else float(wall)
        step = int(step)
        n = 0
        row: Dict[str, object] = {}
        with self._lock:
            for key, v in snap["counters"].items():
                self._counter_point(key, step, wall, float(v))
                row[key] = [self._series[key][-1][2], float(v)]
                n += 1
            for key, v in snap["gauges"].items():
                self._push(key, step, wall, float(v), None)
                row[key] = float(v)
                n += 1
            for key, h in snap["histograms"].items():
                for q in QUANTILES:
                    est = _hist_quantile(h, q)
                    if est is not None:
                        sk = f"{key}{SUB}p{int(q * 100)}"
                        self._push(sk, step, wall, est, None)
                        row[sk] = est
                        n += 1
                for sk, cum in ((f"{key}{SUB}count", float(h["count"])),
                                (f"{key}{SUB}sum", float(h["sum"]))):
                    self._counter_point(sk, step, wall, cum)
                    row[sk] = [self._series[sk][-1][2], cum]
                    n += 1
                running = 0.0
                for bound, c in h["buckets"].items():
                    if bound == "+Inf":
                        continue
                    running += c
                    sk = f"{key}{SUB}le{SUB}{bound}"
                    self._counter_point(sk, step, wall, running)
                    row[sk] = [self._series[sk][-1][2], running]
                    n += 1
            self.samples += 1
            self._last_wall = wall
            self._last_step = step
            fh = self._fh
        if fh is not None:
            try:
                fh.write(json.dumps(dict(
                    kind="sample", src=self.source, step=step,
                    wall=wall, points=row)) + "\n")
            except (OSError, ValueError):
                pass    # retention I/O must never kill the caller
        return n

    # ---------------- reading ----------------

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def points(self, key: str) -> List[Tuple[int, float, float]]:
        """Retained ``(step, wall, value)`` points, oldest first."""
        with self._lock:
            ring = self._series.get(key)
            return [(s, w, v) for (s, w, v, _c) in ring] if ring else []

    def latest(self, key: str) -> Optional[float]:
        with self._lock:
            ring = self._series.get(key)
            return ring[-1][2] if ring else None

    def match(self, base: str, labels: Optional[dict] = None,
              sub: str = "") -> List[str]:
        """Series keys whose parent metric is ``base``, restricted to
        exact ``labels`` pairs when given, with sub-suffix ``sub``
        (``""`` = plain counter/gauge series)."""
        out = []
        with self._lock:
            keys = list(self._series)
        for key in keys:
            b, pairs, s = split_series_key(key)
            if b != base or s != sub:
                continue
            if labels and any(pairs.get(k) != str(v)
                              for k, v in labels.items()):
                continue
            out.append(key)
        return out

    def le_bounds(self, key_prefix: str) -> List[float]:
        """The ``|le|`` bucket bounds retained for one parent series
        key (``"name{labels}"``), ascending."""
        pre = f"{key_prefix}{SUB}le{SUB}"
        with self._lock:
            bs = [float(k[len(pre):]) for k in self._series
                  if k.startswith(pre)]
        return sorted(bs)

    def _window(self, ring, *, wall_s: Optional[float],
                steps: Optional[int]):
        """-> (baseline_point, last_point) bracketing the trailing
        window, anchored at the series' LAST sample (step+wall domain
        of the data — deterministic, not the realtime clock). The
        baseline is the newest point at-or-before the window start.

        When retained history does not reach back to the window start
        there are two cases: a ring that already dropped its tail
        (saturated — full retention IS all we can know, evaluate over
        it) and a cold-start ring that simply hasn't lived that long
        yet — the latter returns None, because letting 10 s of boot
        history masquerade as a 300 s window would turn every startup
        blip into a multi-window page (the exact transient the slow
        window exists to suppress)."""
        if not ring or len(ring) < 2:
            return None
        last = ring[-1]
        if wall_s is not None:
            cutoff = last[1] - float(wall_s)
            sel = lambda p: p[1] <= cutoff           # noqa: E731
        elif steps is not None:
            cutoff = last[0] - int(steps)
            sel = lambda p: p[0] <= cutoff           # noqa: E731
        else:
            raise ValueError("window needs wall_s= or steps=")
        base = None
        for p in ring:
            if sel(p):
                base = p
            else:
                break
        if base is None:
            if len(ring) < (ring.maxlen or 0):
                return None          # cold start: too little history
            base = ring[0]           # saturated: full retention
        if base is last:
            return None
        return base, last

    def window_delta(self, key: str, *, wall_s: Optional[float] = None,
                     steps: Optional[int] = None) -> Optional[float]:
        """Cumulative-value delta over the trailing window (counter
        and histogram ``|count``/``|sum``/``|le|`` series); None for
        gauge-shaped series or too-short history."""
        with self._lock:
            ring = self._series.get(key)
            w = self._window(ring, wall_s=wall_s, steps=steps)
            if w is None:
                return None
            (_, _, _, c0), (_, _, _, c1) = w
            if c0 is None or c1 is None:
                return None
            return max(0.0, c1 - c0)

    def window_rate(self, key: str, *, wall_s: Optional[float] = None,
                    steps: Optional[int] = None) -> Optional[float]:
        """Average per-second rate over the trailing window, from the
        cumulative totals (exact — independent of sampling jitter)."""
        with self._lock:
            ring = self._series.get(key)
            w = self._window(ring, wall_s=wall_s, steps=steps)
            if w is None:
                return None
            (_, w0, _, c0), (_, w1, _, c1) = w
            if c0 is None or c1 is None or w1 <= w0:
                return None
            return max(0.0, (c1 - c0) / (w1 - w0))

    # ---------------- export ----------------

    def to_dict(self) -> dict:
        """Full retained state, JSON-serializable (the ``/series``
        endpoint body and the postmortem bundle's series section)."""
        with self._lock:
            series = {k: [[s, w, v, c] for (s, w, v, c) in ring]
                      for k, ring in sorted(self._series.items())}
        return dict(schema=SCHEMA, kind="series", src=self.source,
                    anchor=self.anchor, capacity=self.capacity,
                    samples=self.samples, series=series)

    def close(self) -> None:
        with self._lock:
            fh, self._fh = self._fh, None
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# JSONL loading / cross-host merge (file concat IS the merge)
# ---------------------------------------------------------------------------

def read_jsonl(path: str) -> List[dict]:
    """Parse one series JSONL file (possibly a concat of several
    hosts' files — every line is self-describing); unparseable lines
    are skipped, truncated tails tolerated."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def merge_docs(lines: List[dict]) -> Dict[str, dict]:
    """Group loaded JSONL lines by source tag: ``{src: {"anchor":
    ..., "series": {key: [[step, wall, value, cum|None], ...]}}}`` —
    N hosts' concatenated logs come apart cleanly because every
    sample line names its ``src``."""
    out: Dict[str, dict] = {}
    for ln in lines:
        src = ln.get("src", "?")
        doc = out.setdefault(src, dict(anchor=None, series={}))
        if ln.get("kind") == "header":
            doc["anchor"] = ln.get("anchor")
        elif ln.get("kind") == "sample":
            step, wall = ln.get("step", 0), ln.get("wall", 0.0)
            for key, v in (ln.get("points") or {}).items():
                if isinstance(v, list):
                    rate, cum = float(v[0]), float(v[1])
                else:
                    rate, cum = float(v), None
                doc["series"].setdefault(key, []).append(
                    [step, wall, rate, cum])
    return out
