"""``python -m rdma_paxos_tpu_torch.obs`` — the unified trace-plane CLI.

The port's copy of the JAX package's ``obs/__main__.py``.

Two commands over any mix of dump files (raw span dumps, subsystem
trace dumps, combined ``Observability.snapshot()`` documents, or whole
postmortem bundles — inputs are classified by shape, so you can point
either command at whatever a chaos run or ``console bundle`` left
behind):

* ``merge`` — one Perfetto-loadable Chrome trace JSON with command
  spans AND subsystem traces (txn / topology / watch) on the shared
  clock, cross-host dumps aligned by their ``(monotonic, wall)``
  anchors.
* ``blame`` — the critical-path blame report: per-command latency
  decomposed into admission / txn_lock / topology_freeze / dispatch /
  quorum / apply / ack, with the dominant phase named per percentile.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence

from rdma_paxos_tpu_torch.obs.tracectx import blame, format_blame, merge_timeline


def _classify(doc, span_dumps: List[dict],
              trace_dumps: List[dict]) -> None:
    """Sort a loaded JSON document into span dumps and subsystem trace
    dumps by shape — lists are raw dumps, dicts are containers
    (snapshots nest dumps under the same keys; bundles nest whole
    documents under ``sections``)."""
    if not isinstance(doc, dict):
        return
    sections = doc.get("sections")
    if isinstance(sections, dict):
        for v in sections.values():
            if isinstance(v, list):
                for item in v:
                    _classify(item, span_dumps, trace_dumps)
            else:
                _classify(v, span_dumps, trace_dumps)
        return
    spans = doc.get("spans")
    if isinstance(spans, list):
        span_dumps.append(doc)
    elif isinstance(spans, dict):
        _classify(spans, span_dumps, trace_dumps)
    traces = doc.get("traces")
    if isinstance(traces, list):
        trace_dumps.append(doc)
    elif isinstance(traces, dict):
        _classify(traces, span_dumps, trace_dumps)


def _load(paths: Sequence[str]):
    span_dumps: List[dict] = []
    trace_dumps: List[dict] = []
    for p in paths:
        try:
            with open(p) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise SystemExit(f"{p}: {e}")
        _classify(doc, span_dumps, trace_dumps)
    return span_dumps, trace_dumps


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rdma_paxos_tpu_torch.obs",
        description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser("merge", help="merge span dumps + subsystem "
                        "trace dumps into ONE Perfetto-loadable "
                        "Chrome trace on the shared clock")
    mp.add_argument("files", nargs="+", help="span/trace/snapshot/"
                    "bundle JSONs")
    mp.add_argument("-o", "--out", required=True,
                    help="Chrome trace JSON output path")
    bp = sub.add_parser("blame", help="print the critical-path blame "
                        "report (phase shares + dominant phase per "
                        "latency percentile)")
    bp.add_argument("files", nargs="+")
    bp.add_argument("--json", action="store_true",
                    help="emit the raw report document instead of the "
                    "table")
    args = ap.parse_args(argv)

    span_dumps, trace_dumps = _load(args.files)
    if not span_dumps and not trace_dumps:
        raise SystemExit("no span or trace dumps found in the inputs "
                         "(need 'spans' or 'traces' keys)")
    if args.cmd == "merge":
        doc = merge_timeline(span_dumps, trace_dumps)
        with open(args.out, "w") as f:
            json.dump(doc, f)
        print(f"wrote {args.out}: {len(doc['traceEvents'])} events "
              f"({doc['otherData']['spans']} spans, "
              f"{doc['otherData']['traces']} subsystem traces) — load "
              f"it in https://ui.perfetto.dev")
    else:
        doc = blame(span_dumps, trace_dumps)
        if args.json:
            print(json.dumps(doc, indent=2, sort_keys=True))
        else:
            print(format_blame(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
