"""Self-contained reproducer artifacts for chaos/fuzz failures.

The port's copy of the JAX package's ``chaos/artifact.py`` (standard library
and numpy only).

Before this subsystem, a fuzz failure printed ``(seed, step, replica)``
and nothing else — no way to replay the failing schedule. A reproducer
artifact is ONE JSON file holding everything a replay needs plus the
post-mortem evidence an operator wants:

* ``seed`` + ``schedule`` (the FaultSchedule's JSON events, or the
  fuzzer's recorded action list) — enough to re-run deterministically;
* ``history`` — the client-op history as JSONL (when a KVS workload
  ran);
* ``trace`` — the obs trace ring dump (protocol-event post-mortem);
* ``metrics`` — the metrics registry snapshot;
* ``spans`` — the causal span dump (obs.spans): every traced
  command's submit→append→quorum→commit→apply→ack timeline with its
  ``(term, index)`` correlation;
* ``violation`` / ``reason`` — what failed.

Written atomically (tmp + rename, same discipline as
``TraceRing.dump_on_failure``) so a crashing harness never leaves a
truncated artifact.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

_SCHEMA = 1


def write_reproducer(path: Optional[str] = None, *, seed: int,
                     schedule, reason: str,
                     config: Optional[dict] = None,
                     history: Optional[str] = None,
                     violation: Optional[dict] = None,
                     obs=None, extra: Optional[dict] = None) -> str:
    """Persist a reproducer; returns the path (auto-generated under the
    system temp dir when ``path`` is None — callers embed it in their
    assertion message so a CI failure is replayable from the log line).

    ``schedule`` may be a FaultSchedule, a JSON string, or a plain
    list; ``history`` is a JSONL string; ``obs`` an Observability
    facade (defaults to the process-global one so module-level
    instrumentation is captured too)."""
    if obs is None:
        from rdma_paxos_tpu_torch.obs import default
        obs = default()
    if hasattr(schedule, "events"):
        schedule = schedule.events
    elif isinstance(schedule, str):
        schedule = json.loads(schedule)
    doc = dict(
        schema=_SCHEMA,
        reason=reason,
        seed=seed,
        config=config or {},
        schedule=schedule,
        history=history,
        violation=violation,
        trace=obs.trace.dump(),
        metrics=obs.metrics.snapshot(),
        spans=(obs.spans.dump()
               if getattr(obs, "spans", None) is not None else None),
        extra=extra or {},
    )
    tctx = getattr(obs, "tracectx", None)
    if tctx is not None:
        traces = tctx.dump()
        if traces["traces"]:
            # subsystem traces (txn/topology/watch) ride along only
            # when some were recorded — trace-free artifacts keep the
            # schema-1 shape byte-for-byte
            doc["traces"] = traces
    if path is None:
        fd, path = tempfile.mkstemp(prefix="chaos_repro_",
                                    suffix=".json")
        os.close(fd)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2)
    os.replace(tmp, path)
    return path


def load_reproducer(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != _SCHEMA:
        raise ValueError(f"unknown reproducer schema: "
                         f"{doc.get('schema')!r}")
    return doc
