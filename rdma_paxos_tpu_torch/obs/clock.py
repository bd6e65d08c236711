"""Shared obs timebase — one ``(monotonic, wall)`` anchor per process.

The obs surfaces historically mixed clocks: the trace ring records
``time.monotonic()`` (ordering-safe, never steps backwards) while
health snapshots record ``time.time()`` (operator-meaningful, but
steppable). Cross-replica exports — merging span dumps from several
host processes into one Perfetto timeline — need BOTH: monotonic for
intra-process ordering and wall for inter-process alignment.

This module pins the bridge: the anchor pair is captured ONCE per
process (first use), and every dump (trace ring, health snapshot, span
dump, bench report) stamps it verbatim. A reader aligns any monotonic
timestamp ``ts`` from a dump onto the shared wall timebase as::

    wall = anchor["wall"] + (ts - anchor["monotonic"])

which is exact within the process and accurate across processes to
host clock sync (the same budget any distributed tracing system has).

Stdlib only — importable from any layer without JAX.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

_ANCHOR: Optional[Dict[str, float]] = None


def anchor() -> Dict[str, float]:
    """The process's ``{"monotonic": m, "wall": w}`` anchor pair,
    captured back-to-back once on first use and returned (as a copy)
    forever after — every dump from this process carries the SAME
    pair, so all of them align onto one timebase."""
    global _ANCHOR
    if _ANCHOR is None:
        _ANCHOR = {"monotonic": time.monotonic(), "wall": time.time()}
    return dict(_ANCHOR)


def to_wall(ts_monotonic: float,
            anchor_pair: Optional[Dict[str, float]] = None) -> float:
    """Project a monotonic timestamp onto the wall timebase using
    ``anchor_pair`` (a dump's stamped anchor; defaults to this
    process's own)."""
    a = anchor_pair if anchor_pair is not None else anchor()
    return a["wall"] + (ts_monotonic - a["monotonic"])
