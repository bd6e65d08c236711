"""SLO alerting — a small declarative rule engine over the metrics
registry.

The port's copy of the JAX package's ``obs/alerts.py`` (standard library only;
``tests/test_torch_hygiene.py`` pins the default rule names against the
reference, and ``tests/test_torch_alerts.py`` its transitions).

The registry (obs/metrics.py) answers "what is the value"; nothing
before this module answers "should someone be paged". Rules are plain
dicts (JSON-serializable — they ride health snapshots verbatim), each
naming a metric, an evaluation ``kind``, a threshold, a ``severity``
(``page`` | ``warn``) and an optional ``for_evals`` hysteresis (the
condition must hold for N consecutive evaluations before the alert
fires — transient blips don't page). The engine is evaluated from the
driver/daemon host loops on a cadence; it never runs inside the
replica step and never blocks the data path.

Rule kinds:

* ``counter_nonzero`` — fires while the summed counter is > 0 (a
  latched condition: digest divergence never un-happens).
* ``counter_rate`` — fires when the counter's delta since the previous
  evaluation exceeds ``threshold`` (e.g. ``rebase_stalled`` ticking).
* ``gauge_cmp`` — compares a gauge against ``value`` with ``op`` in
  ``< > == != <= >=`` (e.g. ``cluster_leader == -1`` = leaderless).
* ``hist_quantile`` — estimates quantile ``q`` from the fixed-bucket
  histogram (bucket upper bound containing the q-th observation;
  series with the same name are merged — same ladder by design) and
  compares it against ``threshold`` with ``op``.

Two WINDOW-DOMAIN kinds evaluate against the attached
:class:`~rdma_paxos_tpu_torch.obs.series.TimeSeriesStore` (``series=``)
instead of the instantaneous snapshot — without a store they are
silent, the same contract the telemetry-backed rules use when the
device series don't exist:

* ``rate_window`` — the counter's average per-second rate over the
  trailing ``window_s`` (or ``window_steps``) exceeds ``threshold``
  (windows anchor at the series' last sample — step+wall domain of
  the DATA, deterministic, not the realtime clock).
* ``burn_rate`` — multi-window SLO burn rate over a latency
  histogram: the fraction of observations above ``bound`` (a bucket
  boundary) in a window, divided by the error budget
  ``1 - objective``. Fires only when BOTH the fast window
  (``fast_window_s``) and the slow window (``slow_window_s``) burn
  faster than ``burn_threshold`` — the fast window catches the
  regression quickly, the slow window keeps a transient blip from
  paging (the classic multi-window burn-rate pager), and
  ``for_evals`` hysteresis still applies on top.

Metric matching aggregates across label sets by default (counters are
summed, gauges take the configured ``agg`` — max by default);
``labels={...}`` restricts a rule to exact label pairs.

Firing state is exported two ways: ``alert_firing{alert=<name>}``
gauges in the registry (scrapable like any other series) and
:meth:`AlertEngine.state` (embedded in health snapshots). Transitions
emit ``alert_fired`` / ``alert_resolved`` trace events when a trace
ring is attached.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

PAGE = "page"
WARN = "warn"

KINDS = ("counter_nonzero", "counter_rate", "gauge_cmp",
         "hist_quantile", "rate_window", "burn_rate")

_OPS = {
    "<": lambda a, b: a < b,
    ">": lambda a, b: a > b,
    "<=": lambda a, b: a <= b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}


def default_rules(*, commit_p99_ceiling_s: float = 0.5,
                  leaderless_evals: int = 5,
                  election_storm_rate: int = 3,
                  log_headroom_floor: int = 16,
                  commit_slo_bound_s: float = 0.25,
                  read_slo_bound_us: float = 5000.0,
                  slo_objective: float = 0.99,
                  burn_fast_s: float = 30.0,
                  burn_slow_s: float = 300.0,
                  burn_threshold: float = 6.0,
                  cdc_lag_ceiling: int = 4096,
                  txn_abort_rate: int = 3) -> List[dict]:
    """The stock SLO rule set: digest mismatch pages immediately (a
    correctness violation, not a performance blip); sustained
    leaderlessness pages; commit-latency p99 above the ceiling and a
    ticking rebase stall warn.

    Two rules read the DEVICE-telemetry series (``telemetry=True``
    clusters — obs/device.py; without telemetry the series don't
    exist, so the rules are silent):

    * ``election_storm`` (``counter_rate``, page) — more than
      ``election_storm_rate`` elections started ON DEVICE between two
      evaluations, sustained for 2 evals: leadership is churning
      faster than timers should ever fire (flapping links, a wedged
      leader host, timeout skew).
    * ``log_headroom_low`` (``gauge_cmp`` with ``agg="min"``, warn) —
      some replica's ring reported fewer than ``log_headroom_floor``
      free slots inside a dispatch: appends are about to stall on
      ring capacity (pruning/apply is falling behind).

    ``repair_failed`` (``counter_nonzero``, page, LATCHED — the
    counter never decrements) fires when the self-healing pipeline
    (``runtime/repair.py``) exhausted its bounded donor retries for a
    quarantined replica and escalated: automated repair gave up, an
    operator must act. Silent on clusters that never escalate (the
    metric does not exist until the first escalation).

    Two ``burn_rate`` rules page on the serving SLOs — the
    window-domain replacement for eyeballing instantaneous p99s
    (which the ``commit_latency_p99`` warn rule still does, for
    continuity): ``commit_latency_slo_burn`` pages when more than
    ``burn_threshold`` times the error budget (``1 - slo_objective``
    of commits slower than ``commit_slo_bound_s``) burns in BOTH the
    fast and slow windows; ``read_latency_slo_burn`` is the same over
    ``read_latency_us`` (the read path). Both bounds sit on
    bucket boundaries of their ladders by construction. Silent
    without an attached ``series=`` store (``AlertEngine(series=)``)
    — the drivers always attach one.
    """
    return [
        dict(name="digest_divergence", severity=PAGE,
             kind="counter_nonzero", metric="audit_divergence_total"),
        dict(name="leaderless", severity=PAGE, kind="gauge_cmp",
             metric="cluster_leader", op="==", value=-1,
             for_evals=leaderless_evals),
        dict(name="commit_latency_p99", severity=WARN,
             kind="hist_quantile", metric="commit_latency_seconds",
             q=0.99, op=">", threshold=commit_p99_ceiling_s,
             for_evals=2),
        dict(name="rebase_stalled", severity=WARN, kind="counter_rate",
             metric="rebase_stalled", threshold=0),
        dict(name="election_storm", severity=PAGE, kind="counter_rate",
             metric="device_elections_started_total",
             threshold=election_storm_rate, for_evals=2),
        dict(name="log_headroom_low", severity=WARN, kind="gauge_cmp",
             metric="device_log_headroom", op="<",
             value=log_headroom_floor, agg="min"),
        dict(name="repair_failed", severity=PAGE,
             kind="counter_nonzero", metric="repair_escalated_total"),
        dict(name="commit_latency_slo_burn", severity=PAGE,
             kind="burn_rate", metric="commit_latency_seconds",
             bound=commit_slo_bound_s, objective=slo_objective,
             fast_window_s=burn_fast_s, slow_window_s=burn_slow_s,
             burn_threshold=burn_threshold, for_evals=2),
        dict(name="read_latency_slo_burn", severity=PAGE,
             kind="burn_rate", metric="read_latency_us",
             bound=read_slo_bound_us, objective=slo_objective,
             fast_window_s=burn_fast_s, slow_window_s=burn_slow_s,
             burn_threshold=burn_threshold, for_evals=2),
        # streams backpressure: the CDC/watch pump is falling
        # behind the committed frontier on some group — consumers are
        # about to hit overflow-and-resume. Sustained (2 evals): a
        # one-step burst backlog is normal. Silent without a streams
        # hub (the gauge does not exist until one is attached).
        dict(name="cdc_backpressure", severity=WARN, kind="gauge_cmp",
             metric="cdc_lag_entries", op=">", value=cdc_lag_ceiling,
             agg="max", for_evals=2),
        # more than txn_abort_rate transaction aborts (any reason —
        # conflict, timeout, failover) between two evaluations,
        # sustained: the commit lane is thrashing (hot-key contention
        # or leadership churn eating the 2PC window). Silent on
        # clusters without a coordinator (counter never exists).
        dict(name="txn_abort_rate", severity=WARN, kind="counter_rate",
             metric="txn_aborted_total", threshold=txn_abort_rate,
             for_evals=2),
    ]


def _split_key(key: str) -> Tuple[str, Dict[str, str]]:
    from rdma_paxos_tpu_torch.obs.metrics import parse_key
    base, pairs = parse_key(key)
    return base, dict(pairs)


def _match(section: dict, metric: str,
           labels: Optional[dict]) -> List:
    out = []
    for key, val in section.items():
        base, pairs = _split_key(key)
        if base != metric:
            continue
        if labels and any(pairs.get(k) != str(v)
                          for k, v in labels.items()):
            continue
        out.append(val)
    return out


def _quantile(hists: Sequence[dict], q: float) -> Optional[float]:
    """Upper bound of the bucket containing the q-th observation across
    merged fixed-bucket histograms (same ladder by design)."""
    total = sum(h["count"] for h in hists)
    if total == 0:
        return None
    merged: Dict[str, int] = {}
    for h in hists:
        for bound, c in h["buckets"].items():
            merged[bound] = merged.get(bound, 0) + c
    finite = sorted(((float(b), c) for b, c in merged.items()
                     if b != "+Inf"))
    need = q * total
    cum = 0
    for bound, c in finite:
        cum += c
        if cum >= need:
            return bound
    return float("inf")


def _validate_rule(r: dict, seen_names) -> None:
    """Reject an incomplete/unknown rule at registration time — the
    one place a bad rule may raise (see the engine constructor)."""
    if "name" not in r or "metric" not in r:
        raise ValueError(f"rule missing name/metric: {r}")
    if r.get("kind") not in KINDS:
        raise ValueError(
            f"rule {r['name']!r}: unknown kind {r.get('kind')!r}"
            f" (known: {KINDS})")
    if r["name"] in seen_names:
        raise ValueError(f"duplicate rule name {r['name']!r}")
    kind = r["kind"]
    if kind == "gauge_cmp":
        if r.get("op") not in _OPS or "value" not in r:
            raise ValueError(
                f"rule {r['name']!r}: gauge_cmp needs op in "
                f"{sorted(_OPS)} and a value")
    elif kind == "hist_quantile":
        if "threshold" not in r:
            raise ValueError(
                f"rule {r['name']!r}: hist_quantile needs a "
                "threshold")
        if r.get("op", ">") not in _OPS:
            raise ValueError(
                f"rule {r['name']!r}: bad op {r.get('op')!r}")
    elif kind == "rate_window":
        if "threshold" not in r:
            raise ValueError(
                f"rule {r['name']!r}: rate_window needs a "
                "threshold")
        if not (r.get("window_s") or r.get("window_steps")):
            raise ValueError(
                f"rule {r['name']!r}: rate_window needs "
                "window_s or window_steps")
        if r.get("op", ">") not in _OPS:
            raise ValueError(
                f"rule {r['name']!r}: bad op {r.get('op')!r}")
    elif kind == "burn_rate":
        for field in ("bound", "objective", "fast_window_s",
                      "slow_window_s"):
            if field not in r:
                raise ValueError(
                    f"rule {r['name']!r}: burn_rate needs "
                    f"{field}")
        if not 0.0 < float(r["objective"]) < 1.0:
            raise ValueError(
                f"rule {r['name']!r}: objective must be in "
                "(0, 1)")
        if float(r["slow_window_s"]) <= float(
                r["fast_window_s"]):
            raise ValueError(
                f"rule {r['name']!r}: slow_window_s must "
                "exceed fast_window_s")


class AlertEngine:
    """Evaluates a declarative rule list against registry snapshots,
    with per-rule hysteresis and firing-state export."""

    def __init__(self, registry, rules: Optional[Sequence[dict]] = None,
                 *, trace=None, series=None):
        self.registry = registry
        self.trace = trace
        # the TimeSeriesStore the window-domain kinds (rate_window /
        # burn_rate) evaluate against; without one those rules are
        # silent — never an error (same contract as telemetry rules
        # on telemetry-off clusters)
        self.series = series
        self.rules = [dict(r) for r in (rules if rules is not None
                                        else default_rules())]
        seen = set()
        for r in self.rules:
            # kind-specific completeness is checked HERE, not at
            # evaluation time: the engine runs inside the driver poll
            # loop, where a KeyError would be a fatal step crash that
            # fails every inflight commit — construction (and
            # add_rule, the same gate) is the only place a bad rule
            # may raise
            _validate_rule(r, seen)
            seen.add(r["name"])
        self._lock = threading.Lock()
        # alert→action hooks: fn(name, severity) called on each FIRE
        # transition (outside the engine lock; exceptions are swallowed
        # — an acting hook must never kill the evaluating poll loop).
        # The repair pipeline registers here so a digest-divergence
        # page triggers quarantine immediately.
        self._hooks: List = []
        self._st: Dict[str, dict] = {
            r["name"]: dict(severity=r.get("severity", WARN),
                            firing=False, pending=0, value=None,
                            since_eval=None, since=None,
                            duration_s=None, fired_count=0)
            for r in self.rules}
        self._prev_counter: Dict[str, float] = {}
        self.evals = 0

    # ---------------- evaluation ----------------

    def _eval_rule(self, rule: dict, snap: dict):
        kind = rule["kind"]
        metric, labels = rule["metric"], rule.get("labels")
        if kind == "counter_nonzero":
            total = sum(_match(snap["counters"], metric, labels))
            return total, total > 0
        if kind == "counter_rate":
            total = sum(_match(snap["counters"], metric, labels))
            prev = self._prev_counter.get(rule["name"])
            self._prev_counter[rule["name"]] = total
            if prev is None:
                return 0, False      # first sighting: establish baseline
            delta = total - prev
            return delta, delta > rule.get("threshold", 0)
        if kind == "gauge_cmp":
            vals = _match(snap["gauges"], metric, labels)
            if not vals:
                return None, False
            agg = rule.get("agg", "max")
            value = (min(vals) if agg == "min" else
                     max(vals) if agg == "max" else vals[0])
            return value, _OPS[rule["op"]](value, rule["value"])
        if kind == "hist_quantile":
            hists = _match(snap["histograms"], metric, labels)
            value = _quantile(hists, rule.get("q", 0.99)) \
                if hists else None
            if value is None:
                return None, False
            return value, _OPS[rule.get("op", ">")](value,
                                                    rule["threshold"])
        if kind == "rate_window":
            rate = self._window_rate(rule)
            if rate is None:
                return None, False
            return rate, _OPS[rule.get("op", ">")](rate,
                                                   rule["threshold"])
        if kind == "burn_rate":
            fast = self._burn(rule, float(rule["fast_window_s"]))
            slow = self._burn(rule, float(rule["slow_window_s"]))
            if fast is None or slow is None:
                return fast, False
            thresh = float(rule.get("burn_threshold", 1.0))
            return fast, fast > thresh and slow > thresh
        raise AssertionError(kind)

    # ---------------- window-domain evaluation (series store) ----------

    def _window_rate(self, rule: dict) -> Optional[float]:
        """Summed per-second rate of every matching counter series
        over the rule's trailing window; None until the store holds
        enough history."""
        if self.series is None:
            return None
        kw = (dict(wall_s=float(rule["window_s"]))
              if rule.get("window_s")
              else dict(steps=int(rule["window_steps"])))
        total, found = 0.0, False
        for key in self.series.match(rule["metric"],
                                     rule.get("labels")):
            r = self.series.window_rate(key, **kw)
            if r is not None:
                total += r
                found = True
        return total if found else None

    def _burn(self, rule: dict, window_s: float) -> Optional[float]:
        """SLO burn rate over one window: the fraction of histogram
        observations ABOVE ``bound`` across all matching label sets,
        divided by the error budget ``1 - objective``. The bound must
        sit on a bucket boundary; when it doesn't exactly (float
        drift), the largest retained bound <= it is used — which can
        only OVERcount the bad fraction (conservative paging)."""
        if self.series is None:
            return None
        metric, labels = rule["metric"], rule.get("labels")
        total = good = 0.0
        saw_total = saw_good = False
        for key in self.series.match(metric, labels, sub="count"):
            d = self.series.window_delta(key, wall_s=window_s)
            if d is not None:
                total += d
                saw_total = True
                # the parent key ("name{labels}") indexes the le
                # ladder this histogram retained; repr(float) is
                # stable through the store's float round-trip, so
                # rebuilding the sub-key from the parsed bound hits
                # the exact retained series
                parent = key.rsplit("|", 1)[0]
                bounds = [b for b in self.series.le_bounds(parent)
                          if b <= float(rule["bound"]) + 1e-12]
                if bounds:
                    g = self.series.window_delta(
                        f"{parent}|le|{bounds[-1]!r}",
                        wall_s=window_s)
                    if g is not None:
                        good += g
                        saw_good = True
        if not saw_total or total <= 0.0:
            return None
        bad_frac = max(0.0, (total - (good if saw_good else 0.0))
                       / total)
        return bad_frac / max(1e-12, 1.0 - float(rule["objective"]))

    @staticmethod
    def _exemplars(snap: dict, rule: dict, limit: int = 8) -> List[str]:
        """Exemplar trace ids for a firing rule, harvested from its
        metric's histogram reservoirs — slowest buckets first, because
        the tail is what the page is ABOUT. Empty when the metric has
        no histogram (counter/gauge rules) or no exemplars recorded."""
        def _bound(label: str) -> float:
            return float("inf") if label == "+Inf" else float(label)

        ids: List[str] = []
        for h in _match(snap.get("histograms", {}), rule["metric"],
                        rule.get("labels")):
            ex = h.get("exemplars")
            if not ex:
                continue
            for label in sorted(ex, key=_bound, reverse=True):
                for tid, _v in ex[label]:
                    if tid not in ids:
                        ids.append(tid)
        return ids[:limit]

    def evaluate(self,
                 snap: Optional[dict] = None) -> Dict[str, List[str]]:
        """One evaluation pass; returns the transitions
        ``{"fired": [...], "resolved": [...]}``. Firing gauges
        (``alert_firing{alert=name}``) are refreshed every pass.
        ``snap`` lets the caller share one registry snapshot with the
        series-store sampling it just did (the drivers' cadence)."""
        if snap is None:
            snap = self.registry.snapshot()
        fired: List[str] = []
        resolved: List[str] = []
        with self._lock:
            self.evals += 1
            for rule in self.rules:
                value, cond = self._eval_rule(rule, snap)
                st = self._st[rule["name"]]
                st["value"] = value
                if cond:
                    st["pending"] += 1
                    if (not st["firing"]
                            and st["pending"]
                            >= int(rule.get("for_evals", 1))):
                        st["firing"] = True
                        st["since_eval"] = self.evals
                        st["since"] = time.time()
                        st["fired_count"] += 1
                        ex = self._exemplars(snap, rule)
                        if ex:
                            # the firing carries concrete evidence:
                            # trace ids from the metric's histogram
                            # reservoir, slowest buckets first —
                            # resolvable in the postmortem bundle's
                            # span dump / merged Perfetto timeline
                            st["exemplars"] = ex
                        fired.append(rule["name"])
                else:
                    st["pending"] = 0
                    if st["firing"]:
                        st["firing"] = False
                        st["since_eval"] = None
                        st["since"] = None
                        resolved.append(rule["name"])
                self.registry.set("alert_firing",
                                  1 if st["firing"] else 0,
                                  alert=rule["name"])
        if self.trace is not None:
            from rdma_paxos_tpu_torch.obs import trace as _trace
            for n in fired:
                kw = dict(alert=n,
                          severity=self._st[n]["severity"],
                          value=self._st[n]["value"])
                if self._st[n].get("exemplars"):
                    kw["exemplars"] = self._st[n]["exemplars"]
                self.trace.record(_trace.ALERT_FIRED, **kw)
            for n in resolved:
                self.trace.record(_trace.ALERT_RESOLVED, alert=n)
        for n in fired:
            for hook in self._hooks:
                try:
                    hook(n, self._st[n]["severity"])
                except Exception:  # noqa: BLE001 — hooks never kill
                    pass           # the evaluating poll loop
        return dict(fired=fired, resolved=resolved)

    def add_hook(self, fn) -> None:
        """Register an alert→action hook ``fn(name, severity)`` —
        invoked on every fire transition, after state/trace export."""
        self._hooks.append(fn)

    def add_rule(self, rule: dict) -> None:
        """Register one more rule after construction — the attach path
        for subsystems that ship their own stock rules (topology skew).
        Same validation gate as the constructor; duplicate names are
        rejected so a double attach can't shadow state."""
        r = dict(rule)
        _validate_rule(r, {x["name"] for x in self.rules})
        with self._lock:
            self.rules.append(r)
            self._st[r["name"]] = dict(
                severity=r.get("severity", WARN), firing=False,
                pending=0, value=None, since_eval=None, since=None,
                duration_s=None, fired_count=0)

    # ---------------- state export ----------------

    def severity(self, name: str) -> str:
        return self._st[name]["severity"]

    def firing(self, severity: Optional[str] = None) -> List[str]:
        with self._lock:
            return [n for n, st in self._st.items()
                    if st["firing"]
                    and (severity is None or st["severity"] == severity)]

    def state(self) -> dict:
        """Per-rule firing state for health snapshots (plain data).
        Firing rules carry ``since`` (wall time the fire transition
        happened) and a live ``duration_s`` — the age the console
        renders next to each firing alert."""
        now = time.time()
        with self._lock:
            out = {}
            for n, st in self._st.items():
                d = dict(st)
                d["duration_s"] = (round(now - d["since"], 3)
                                   if d["firing"] and d["since"]
                                   is not None else None)
                out[n] = d
            return out
