"""Fleet console — a live cluster view merged from N hosts, and
one-command postmortem bundles.

The port's copy of the JAX package's ``obs/console.py`` (standard
library only).

Until this module, watching a deployed cluster meant tailing R
greppable replica logs and cat-ing per-replica ``*.health.json``
files by hand, and a postmortem meant collecting five
differently-shaped dump files (series JSONL, span dump, audit
artifact, trace ring, metrics snapshot). This CLI is the operator
surface over all of it:

``python -m rdma_paxos_tpu_torch.obs.console [--once] SOURCES``
    Renders a per-group fleet table — leader, leaseholder, term,
    commit/apply frontiers, reads by path, repair/quarantine state,
    firing alerts with age — merged from any mix of sources:

    * ``--scrape http://host:port`` — a live ops exporter
      (``/healthz`` + ``/alerts``; obs/export.py), one per driver or
      NodeDaemon host;
    * ``--health PATH_OR_GLOB`` — health snapshot files
      (``replica<r>.health.json`` from N hosts, or a saved cluster
      health document).

    Default is a watch loop (``--interval`` seconds, reads/s computed
    between refreshes); ``--once`` prints a single table and exits
    (CI mode). ``--json`` emits the merged view as JSON instead.

``python -m rdma_paxos_tpu_torch.obs.console bundle --out FILE ...``
    Assembles ONE verified postmortem artifact from a workdir
    (``--workdir`` scans the drivers' conventional file names), a
    live endpoint (``--scrape``), and/or explicit per-section flags.
    Sections: ``series`` (time-series retention), ``spans`` (causal
    command traces), ``audit`` (digest ledger artifacts), ``trace``
    (protocol event ring), ``telemetry`` (the full registry snapshot
    — every ``device_*`` series rides here), ``alerts`` (per-rule
    firing state), ``health``. Every section is sha256-manifested;
    ``bundle --verify FILE`` recomputes the digests and exits 0 iff
    the bundle is untampered AND carries the five core sections
    (series, spans, audit, telemetry, alerts).

Stdlib only (urllib for scraping) — the console must run on a bare
operator box with no torch installed.
"""

from __future__ import annotations

import argparse
import glob as _glob
import hashlib
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple
from urllib.error import HTTPError
from urllib.request import urlopen

from rdma_paxos_tpu_torch.obs.clock import anchor as clock_anchor

BUNDLE_SCHEMA = 1
BUNDLE_KIND = "postmortem_bundle"
# the sections bundle --verify demands (trace/health ride along when
# available but their absence does not fail verification)
REQUIRED_SECTIONS = ("series", "spans", "audit", "telemetry", "alerts")

# consensus/state.py Role.LEADER — hardcoded so the console stays
# importable on a bare operator box (tests pin it against the enum)
ROLE_LEADER = 3


# ---------------------------------------------------------------------------
# source collection
# ---------------------------------------------------------------------------

def _fetch_json(url: str, timeout: float = 3.0):
    try:
        with urlopen(url, timeout=timeout) as r:
            return json.loads(r.read().decode())
    except HTTPError as exc:
        # an error STATUS can still carry a JSON body — /healthz
        # answers 503 with the full health document when the poll
        # loop died, which is exactly the row the console must show
        body = exc.read().decode()
        try:
            return json.loads(body)
        except json.JSONDecodeError:
            raise exc from None


def scrape_source(base_url: str) -> dict:
    """One exporter endpoint -> a normalized source doc. ``/healthz``
    is the backbone; ``/alerts`` rides along when served (a 503
    healthz — dead poll loop — still parses: its body is the health
    document)."""
    base = base_url.rstrip("/")
    try:
        health = _fetch_json(base + "/healthz")
    except Exception as exc:            # noqa: BLE001 — a dead host is
        return dict(src=base, error=repr(exc))   # a row, not a crash
    doc = dict(src=base, health=health)
    try:
        doc["alerts"] = _fetch_json(base + "/alerts").get("state")
    except Exception:                   # noqa: BLE001
        pass
    return doc


def load_health_files(patterns: List[str]) -> List[dict]:
    out = []
    for pat in patterns:
        paths = sorted(_glob.glob(pat)) or [pat]
        for path in paths:
            try:
                with open(path) as f:
                    out.append(dict(src=path, health=json.load(f)))
            except (OSError, json.JSONDecodeError) as exc:
                out.append(dict(src=path, error=repr(exc)))
    return out


# ---------------------------------------------------------------------------
# fleet view (merge sources -> per-group rows)
# ---------------------------------------------------------------------------

def _imax(vals) -> Optional[int]:
    vals = [v for v in vals if v is not None]
    return max(int(v) for v in vals) if vals else None


def _reads_by_path(health: dict) -> Dict[str, float]:
    reads = health.get("reads") or {}
    served = reads.get("served") or {}
    return {str(k): float(v) for k, v in served.items()}


def _repair_state(health: dict) -> str:
    rep = health.get("repair")
    if not rep:
        return "-"
    active = rep.get("active") or {}
    if not active:
        n = rep.get("repairs_done", 0)
        return f"ok({n} healed)" if n else "ok"
    return ",".join(f"{k}:{st.get('phase', st.get('state', '?'))}"
                    for k, st in sorted(active.items()))


def _txn_state(health: dict) -> str:
    """Coordinator column: lifetime committed/aborted totals plus the
    in-flight count (``txn`` health entry — absent on clusters
    without a coordinator)."""
    txn = health.get("txn")
    if not txn:
        return "-"
    aborts = sum((txn.get("aborted_total") or {}).values())
    s = f"{txn.get('committed_total', 0)}c/{aborts}a"
    if txn.get("active"):
        s += f" {txn['active']}live"
    return s


def _topo_state(health: dict) -> str:
    """Elastic-topology column: current epoch + lifetime transitions,
    plus the live window phase while one is open (``topology`` health
    entry — absent on clusters without a controller)."""
    topo = health.get("topology")
    if not topo:
        return "-"
    s = f"e{topo.get('epoch', 0)}/{topo.get('transitions_total', 0)}t"
    phase = topo.get("phase")
    if phase and phase != "idle":
        s += f" {topo.get('direction', '?')}:{phase}"
    return s


def _blame_state(health: dict) -> str:
    """Critical-path blame column: the dominant latency phase at p99
    (``blame`` health entry — the tracectx blame summary, None while
    span sampling is off or no command completed)."""
    bl = health.get("blame")
    if not bl:
        return "-"
    s = f"p99:{bl.get('p99', '?')}"
    us = bl.get("p99_us")
    if us is not None:
        s += f" {us:.0f}us"
    return s


def _firing_alerts(state: Optional[dict]) -> List[dict]:
    out = []
    for name, st in (state or {}).items():
        if st.get("firing"):
            out.append(dict(name=name, severity=st.get("severity"),
                            value=st.get("value"),
                            duration_s=st.get("duration_s")))
    return sorted(out, key=lambda a: a["name"])


def fleet_view(sources: List[dict]) -> dict:
    """Merge collected source docs into the per-group fleet view:
    ``{"groups": [row...], "alerts": [...], "hosts": [...]}``.
    Cluster health documents (a driver's ``/healthz`` or a saved
    ``health()``) contribute whole groups; bare replica snapshots
    (``replica<r>.health.json`` — one file per NodeDaemon host) are
    merged into one cluster row, leader = the highest-term replica
    claiming LEADER."""
    rows: List[dict] = []
    alerts: List[dict] = []
    hosts: List[dict] = []
    members: List[Tuple[str, dict]] = []    # bare replica snapshots
    now = time.time()

    for doc in sources:
        src = doc.get("src", "?")
        if "error" in doc:
            hosts.append(dict(src=src, kind="error",
                              error=doc["error"]))
            continue
        h = doc["health"]
        age = (round(now - h["ts"], 1) if isinstance(h.get("ts"),
                                                     (int, float))
               else None)
        alerts.extend(_firing_alerts(doc.get("alerts")
                                     or h.get("alerts")))
        if isinstance(h.get("groups"), list):       # sharded cluster
            hosts.append(dict(src=src, kind="sharded", age_s=age,
                              loop_error=h.get("loop_error")))
            leases = (h.get("leases") or {}).get("holders") or []
            leaders = h.get("leaders") or []
            reads = _reads_by_path(h)
            for g, grp in enumerate(h["groups"]):
                rows.append(dict(
                    src=src, group=grp.get("group", g),
                    leader=(leaders[g] if g < len(leaders)
                            else grp.get("leader")),
                    lease=(leases[g] if g < len(leases) else None),
                    term=_imax(grp.get("term") or []),
                    commit=_imax(grp.get("commit") or []),
                    apply=_imax(grp.get("apply") or []),
                    reads=(reads if g == 0 else {}),
                    repair=_repair_state(h),
                    txn=(_txn_state(h) if g == 0 else "-"),
                    topo=(_topo_state(h) if g == 0 else "-"),
                    blame=(_blame_state(h) if g == 0 else "-")))
        elif isinstance(h.get("replicas"), list):   # single-group
            hosts.append(dict(src=src, kind="cluster", age_s=age,
                              loop_error=h.get("loop_error")))
            reps = h["replicas"]
            holders = (h.get("leases") or {}).get("holders") or []
            rows.append(dict(
                src=src, group=0, leader=h.get("leader"),
                lease=(holders[0] if holders else None),
                term=_imax(r.get("term") for r in reps),
                commit=_imax(r.get("commit") for r in reps),
                apply=_imax(r.get("apply") for r in reps),
                reads=_reads_by_path(h),
                repair=_repair_state(h),
                txn=_txn_state(h),
                topo=_topo_state(h),
                blame=_blame_state(h)))
        elif "replica" in h:                        # one member file
            hosts.append(dict(src=src, kind="replica",
                              replica=h.get("replica"), age_s=age))
            members.append((src, h))
        else:
            hosts.append(dict(src=src, kind="unknown"))

    if members:
        # N per-host member snapshots = one cluster seen from N sides
        # (key on term only: two stale files can claim the same term,
        # and tuple-max would fall through to comparing dicts)
        claims = [(int(h.get("term", -1)), h) for _, h in members
                  if h.get("role") == ROLE_LEADER]
        lead = (max(claims, key=lambda c: c[0])[1].get("replica")
                if claims else None)
        rows.append(dict(
            src="+".join(src for src, _ in members), group=0,
            leader=lead, lease=None,
            term=_imax(h.get("term") for _, h in members),
            commit=_imax(h.get("commit") for _, h in members),
            apply=_imax(h.get("apply") for _, h in members),
            reads={}, repair="-", txn="-", topo="-", blame="-",
            members=len(members)))

    # dedupe alerts by name, keeping the longest-firing instance
    best: Dict[str, dict] = {}
    for a in alerts:
        cur = best.get(a["name"])
        if cur is None or (a.get("duration_s") or 0) > (
                cur.get("duration_s") or 0):
            best[a["name"]] = a
    return dict(groups=sorted(rows, key=lambda r: (str(r["src"]),
                                                   r["group"])),
                alerts=sorted(best.values(), key=lambda a: a["name"]),
                hosts=hosts, ts=now)


def _fmt_reads(reads: Dict[str, float],
               prev: Optional[Dict[str, float]] = None,
               dt: Optional[float] = None) -> str:
    if not reads:
        return "-"
    if prev is not None and dt and dt > 0:
        return " ".join(
            f"{k}:{max(0.0, (v - prev.get(k, 0.0))) / dt:.0f}/s"
            for k, v in sorted(reads.items()))
    return " ".join(f"{k}:{v:.0f}" for k, v in sorted(reads.items()))


def render_table(view: dict, prev: Optional[dict] = None) -> str:
    """The operator table. With a previous view (watch mode), read
    counters render as per-second rates over the refresh interval."""
    dt = (view["ts"] - prev["ts"]) if prev else None
    prev_reads = {}
    if prev:
        for r in prev["groups"]:
            prev_reads[(r["src"], r["group"])] = r["reads"]
    hdr = (f"{'GROUP':<6} {'LEADER':<7} {'LEASE':<6} {'TERM':<6} "
           f"{'COMMIT':<10} {'APPLY':<10} {'REPAIR':<14} "
           f"{'TXN':<12} {'TOPO':<12} {'BLAME':<18} READS")
    lines = [hdr, "-" * len(hdr)]
    for r in view["groups"]:
        def cell(v, dash="-"):
            return dash if v is None else str(v)
        lines.append(
            f"{cell(r['group']):<6} {cell(r['leader']):<7} "
            f"{cell(r['lease']):<6} {cell(r['term']):<6} "
            f"{cell(r['commit']):<10} {cell(r['apply']):<10} "
            f"{str(r['repair']):<14} "
            f"{str(r.get('txn', '-')):<12} "
            f"{str(r.get('topo', '-')):<12} "
            f"{str(r.get('blame', '-')):<18} "
            + _fmt_reads(r["reads"],
                         prev_reads.get((r["src"], r["group"])), dt))
    if view["alerts"]:
        lines.append("")
        lines.append("FIRING ALERTS")
        for a in view["alerts"]:
            age = (f"{a['duration_s']:.0f}s"
                   if a.get("duration_s") is not None else "?")
            lines.append(f"  [{a.get('severity', '?'):<4}] "
                         f"{a['name']} (for {age}, "
                         f"value={a.get('value')})")
    lines.append("")
    lines.append("SOURCES")
    for hst in view["hosts"]:
        extra = ""
        if hst.get("loop_error"):
            extra = f"  LOOP ERROR: {hst['loop_error']}"
        elif hst.get("error"):
            extra = f"  UNREACHABLE: {hst['error']}"
        age = (f" age={hst['age_s']}s"
               if hst.get("age_s") is not None else "")
        lines.append(f"  {hst['src']} [{hst['kind']}]{age}{extra}")
    return "\n".join(lines)


def collect(scrapes: List[str], healths: List[str]) -> List[dict]:
    return ([scrape_source(u) for u in scrapes]
            + load_health_files(healths))


# ---------------------------------------------------------------------------
# postmortem bundles
# ---------------------------------------------------------------------------

def _canonical(section) -> bytes:
    return json.dumps(section, sort_keys=True,
                      separators=(",", ":")).encode()


def _sha256(section) -> str:
    return hashlib.sha256(_canonical(section)).hexdigest()


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def _series_lines(paths: List[str]) -> List[dict]:
    from rdma_paxos_tpu_torch.obs.series import read_jsonl
    lines: List[dict] = []
    for p in paths:
        lines.extend(read_jsonl(p))
    return lines


def assemble_bundle(*, reason: str = "",
                    workdir: Optional[str] = None,
                    scrape: Optional[str] = None,
                    series: Optional[str] = None,
                    spans: Optional[str] = None,
                    audit: Optional[str] = None,
                    trace: Optional[str] = None,
                    metrics: Optional[str] = None,
                    alerts: Optional[str] = None,
                    health: Optional[List[str]] = None) -> dict:
    """Gather every section from the given inputs (explicit flags win
    over the workdir scan, which wins over the live scrape) and
    return the manifest-stamped bundle document. Missing sections
    stay absent — assembly is best-effort, verification is strict."""
    sections: Dict[str, object] = {}

    if scrape:
        base = scrape.rstrip("/")
        for name, path in (("series", "/series"),
                           ("telemetry", "/metrics.json"),
                           ("health", "/healthz")):
            try:
                sections[name] = _fetch_json(base + path)
            except Exception:       # noqa: BLE001 — best-effort gather
                pass
        try:
            sections["alerts"] = _fetch_json(base + "/alerts")["state"]
        except Exception:           # noqa: BLE001
            pass

    if workdir:
        wd = workdir
        jl = (sorted(_glob.glob(os.path.join(wd, "series.jsonl")))
              + sorted(_glob.glob(os.path.join(
                  wd, "replica*.series.jsonl"))))
        if jl:
            sections["series"] = dict(kind="series_jsonl",
                                      files=[os.path.basename(p)
                                             for p in jl],
                                      lines=_series_lines(jl))
        for name, pats in (
                ("spans", ["spans.json"]),
                ("traces", ["traces.json"]),
                ("audit", ["audit_dump.json", "replica*.audit.json"]),
                ("trace", ["trace_dump.json"]),
                ("telemetry", ["metrics.json"])):
            docs = []
            for pat in pats:
                for p in sorted(_glob.glob(os.path.join(wd, pat))):
                    try:
                        docs.append(_read_json(p))
                    except (OSError, json.JSONDecodeError):
                        continue
            if docs:
                sections[name] = docs[0] if len(docs) == 1 else docs
        hfiles = (sorted(_glob.glob(os.path.join(
            wd, "cluster.health.json")))
            + sorted(_glob.glob(os.path.join(
                wd, "replica*.health.json"))))
        if hfiles:
            hdocs = []
            for p in hfiles:
                try:
                    hdocs.append(_read_json(p))
                except (OSError, json.JSONDecodeError):
                    continue
            if hdocs:
                # workdir beats scrape for EVERY section (the
                # documented precedence) — health included
                sections["health"] = hdocs
        # a cluster health document (or a daemon replica snapshot)
        # carries the alert firing state — the workdir-derived state
        # overrides a scraped one, same precedence as above
        docs = sections.get("health")
        for d in (docs if isinstance(docs, list) else []):
            if isinstance(d, dict) and d.get("alerts"):
                sections["alerts"] = d["alerts"]
                break

    for name, path in (("series", series), ("spans", spans),
                       ("audit", audit), ("trace", trace),
                       ("telemetry", metrics), ("alerts", alerts)):
        if path:
            if name == "series" and path.endswith(".jsonl"):
                sections[name] = dict(kind="series_jsonl",
                                      files=[os.path.basename(path)],
                                      lines=_series_lines([path]))
            else:
                sections[name] = _read_json(path)
    if health:
        sections["health"] = [_read_json(p) for p in health]

    if "spans" in sections:
        # pre-merge the Perfetto timeline (spans + subsystem traces on
        # the shared clock) so the bundle is directly loadable in
        # https://ui.perfetto.dev — an alert exemplar's trace id
        # resolves here without re-running the merge CLI
        try:
            from rdma_paxos_tpu_torch.obs.tracectx import merge_timeline
            sd = sections["spans"]
            td = sections.get("traces", [])
            sections["perfetto"] = merge_timeline(
                sd if isinstance(sd, list) else [sd],
                td if isinstance(td, list) else [td])
        except Exception:           # noqa: BLE001 — best-effort gather
            pass

    manifest = {name: dict(sha256=_sha256(sec),
                           bytes=len(_canonical(sec)))
                for name, sec in sorted(sections.items())}
    return dict(schema=BUNDLE_SCHEMA, kind=BUNDLE_KIND,
                reason=reason, created=time.time(),
                anchor=clock_anchor(),
                sections=sections, manifest=manifest)


def write_bundle(doc: dict, path: str) -> str:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2)
    os.replace(tmp, path)
    return path


def verify_bundle(doc: dict) -> List[str]:
    """-> list of problems (empty = verified): wrong kind, a missing
    or empty core section, a manifest entry whose digest no longer
    matches its section (tamper/corruption), or an unmanifested
    section."""
    problems = []
    if doc.get("kind") != BUNDLE_KIND:
        return [f"not a postmortem bundle (kind={doc.get('kind')!r})"]
    sections = doc.get("sections") or {}
    manifest = doc.get("manifest") or {}
    for name in REQUIRED_SECTIONS:
        if name not in sections or sections[name] in (None, [], {}):
            problems.append(f"missing core section: {name}")
    for name, sec in sections.items():
        ent = manifest.get(name)
        if ent is None:
            problems.append(f"section {name} not in manifest")
        elif ent.get("sha256") != _sha256(sec):
            problems.append(f"section {name} digest mismatch "
                            "(tampered or corrupted)")
    for name in manifest:
        if name not in sections:
            problems.append(f"manifest names absent section {name}")
    return problems


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _watch(args) -> int:
    prev = None
    while True:
        view = fleet_view(collect(args.scrape, args.health))
        if args.json:
            print(json.dumps(view, indent=2))
        else:
            if not args.once:
                print("\x1b[2J\x1b[H", end="")   # clear + home
            stamp = time.strftime("%H:%M:%S")
            print(f"rdma_paxos_tpu_torch fleet console  {stamp}  "
                  f"({len(view['hosts'])} source(s))")
            print(render_table(view, prev))
        if args.once:
            # CI contract: exit 1 when any source is dead or any page
            # fires, so a scripted check can gate on the console
            dead = any(h.get("kind") == "error"
                       or h.get("loop_error")
                       for h in view["hosts"])
            paged = any(a.get("severity") == "page"
                        for a in view["alerts"])
            return 1 if (dead or paged) and args.strict else 0
        prev = view
        time.sleep(args.interval)


def _bundle(args) -> int:
    if args.verify:
        try:
            doc = _read_json(args.verify)
        except (OSError, json.JSONDecodeError) as exc:
            print(f"bundle unreadable: {exc}")
            return 1
        problems = verify_bundle(doc)
        sections = sorted((doc.get("sections") or {}))
        if problems:
            print(f"bundle INVALID ({args.verify}):")
            for p in problems:
                print(f"  - {p}")
            return 1
        print(f"bundle OK ({args.verify}): sections="
              f"{','.join(sections)} reason={doc.get('reason')!r}")
        return 0
    if not args.out:
        print("bundle needs --out FILE (or --verify FILE)")
        return 2
    doc = assemble_bundle(
        reason=args.reason, workdir=args.workdir, scrape=args.scrape,
        series=args.series, spans=args.spans, audit=args.audit,
        trace=args.trace, metrics=args.metrics, alerts=args.alerts,
        health=args.health or None)
    write_bundle(doc, args.out)
    missing = [n for n in REQUIRED_SECTIONS
               if n not in doc["sections"]]
    print(f"bundle written: {args.out} "
          f"(sections={','.join(sorted(doc['sections']))})")
    if missing:
        print(f"  warning: core sections missing: "
              f"{','.join(missing)} (bundle --verify will fail)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "bundle":
        ap = argparse.ArgumentParser(
            prog="rdma_paxos_tpu_torch.obs.console bundle",
            description="assemble / verify a postmortem bundle")
        ap.add_argument("--out", default=None,
                        help="write the assembled bundle here")
        ap.add_argument("--verify", default=None, metavar="FILE",
                        help="verify an existing bundle (exit 0 iff "
                             "untampered + all core sections present)")
        ap.add_argument("--workdir", default=None,
                        help="scan a driver/daemon workdir for the "
                             "conventional dump files")
        ap.add_argument("--scrape", default=None,
                        help="pull series/telemetry/alerts/health "
                             "from a live ops exporter URL")
        ap.add_argument("--reason", default="operator request")
        ap.add_argument("--series", default=None,
                        help="series JSONL (or JSON) file")
        ap.add_argument("--spans", default=None,
                        help="span dump JSON file")
        ap.add_argument("--audit", default=None,
                        help="audit artifact / ledger dump JSON file")
        ap.add_argument("--trace", default=None,
                        help="trace-ring dump JSON file")
        ap.add_argument("--metrics", default=None,
                        help="registry snapshot JSON file "
                             "(the telemetry section)")
        ap.add_argument("--alerts", default=None,
                        help="alert-state JSON file")
        ap.add_argument("--health", action="append", default=[],
                        help="health snapshot JSON file (repeatable)")
        return _bundle(ap.parse_args(argv[1:]))

    ap = argparse.ArgumentParser(
        prog="rdma_paxos_tpu_torch.obs.console",
        description="live fleet view merged from health files and/or "
                    "scraped ops endpoints")
    ap.add_argument("--scrape", action="append", default=[],
                    metavar="URL",
                    help="ops exporter base URL (repeatable)")
    ap.add_argument("--health", action="append", default=[],
                    metavar="PATH_OR_GLOB",
                    help="health snapshot file(s) (repeatable, glob "
                         "ok)")
    ap.add_argument("--once", action="store_true",
                    help="render one table and exit (CI mode)")
    ap.add_argument("--strict", action="store_true",
                    help="with --once: exit 1 when a source is dead "
                         "or a page-severity alert is firing")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="watch refresh period (seconds)")
    ap.add_argument("--json", action="store_true",
                    help="emit the merged view as JSON")
    args = ap.parse_args(argv)
    if not args.scrape and not args.health:
        ap.error("need at least one --scrape URL or --health PATH")
    try:
        return _watch(args)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
