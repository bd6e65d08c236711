"""Device telemetry: the on-device protocol counters of the
``telemetry=True`` replica step, reduced and accumulated on the host.

The port's copy of the counter half of the JAX package's
``obs/device.py``: :data:`COUNTERS`, :data:`GAUGES`, :data:`NAMES`,
:data:`WIDTH`, :data:`INDEX`, :func:`zeros`, :func:`reduce_steps`,
:func:`accumulate`, :func:`export` and :func:`ingest`. The step emits one
u32 vector per replica per step — elections started, votes
granted/denied, appends accepted, commit-frontier advance, unheard
links, quorum width, log headroom — reduced in the step so the readback
is O(counters), never O(log). The engine ingests the vectors in
``finish`` (the readback thread under the pipelined driver) into a host
accumulator and, when an obs facade is attached, into ``device_*``
registry series.

The other half of the reference module — the ``jax.profiler`` capture
session, ``merge_timeline`` and ``program_report`` — is specific to JAX
and comes with ROADMAP Queue 1, item 13 (the rest of ``obs``).

Layout contract: :data:`COUNTERS` + :data:`GAUGES` name the vector
columns in order. ``consensus/step.py`` carries its own matching ``T_*``
index constants and does not import this module;
``tests/test_torch_telemetry.py`` pins the two layouts against each
other, and ``tests/test_torch_hygiene.py`` pins :data:`NAMES` against
the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# counter-vector layout (mirrors consensus/step.py T_* — pinned by test)
# ---------------------------------------------------------------------------

# monotone per-step counts: accumulated (summed) across steps/bursts
COUNTERS = (
    "elections_started",    # this replica began a candidacy
    "votes_granted",        # granted another replica's candidacy
    "votes_denied",         # heard candidacies it did not grant
    "accepted_entries",     # client entries appended from the batch
    "committed_entries",    # commit-frontier advance
    "links_unheard",        # peers masked by partition/link model
)
# point-in-time values: latest step wins (min across a fused burst
# for log_headroom — the tightest the ring got inside the dispatch)
GAUGES = (
    "quorum_width",         # replicas that acked this replica's window
    "log_headroom",         # free ring slots: (n_slots-1) - (end-head)
)
NAMES: Tuple[str, ...] = COUNTERS + GAUGES
WIDTH = len(NAMES)
INDEX: Dict[str, int] = {n: i for i, n in enumerate(NAMES)}

_N_COUNTERS = len(COUNTERS)
_I_QUORUM = INDEX["quorum_width"]
_I_HEADROOM = INDEX["log_headroom"]


def zeros(*lead_shape: int) -> np.ndarray:
    """The host-side telemetry accumulator: int64 ``[..., WIDTH]``."""
    return np.zeros(tuple(lead_shape) + (WIDTH,), np.int64)


def reduce_steps(stacked: np.ndarray) -> np.ndarray:
    """Reduce a fused burst's per-step vectors ``[K, ..., WIDTH]`` to
    one ``[..., WIDTH]`` vector: counters sum over the K steps,
    ``quorum_width`` takes the final step's value, ``log_headroom``
    the minimum across the burst (the tightest the ring got)."""
    out = stacked.sum(axis=0).astype(np.int64)
    out[..., _I_QUORUM] = stacked[-1, ..., _I_QUORUM]
    out[..., _I_HEADROOM] = stacked[..., _I_HEADROOM].min(axis=0)
    return out


def accumulate(acc: np.ndarray, vec: np.ndarray) -> np.ndarray:
    """Fold one finish()'s reduced vector into the running host
    accumulator: counter columns add, gauge columns overwrite."""
    acc[..., :_N_COUNTERS] += vec[..., :_N_COUNTERS]
    acc[..., _N_COUNTERS:] = vec[..., _N_COUNTERS:]
    return acc


def export(metrics, vec: np.ndarray, *, replica: int,
           group: Optional[int] = None) -> None:
    """Push one replica's reduced vector into the registry:
    ``device_<counter>_total`` counters (incremented by this finish's
    delta) and ``device_<gauge>`` gauges, labelled ``{replica=}`` (+
    ``{group=}`` for sharded engines). Host-side only — runs on the
    readback thread, never inside the replica step."""
    labels = dict(replica=replica)
    if group is not None:
        labels["group"] = group
    for i, name in enumerate(COUNTERS):
        v = int(vec[i])
        if v:
            metrics.inc("device_%s_total" % name, v, **labels)
    for name in GAUGES:
        metrics.set("device_%s" % name, int(vec[INDEX[name]]), **labels)


def ingest(obs, vec: np.ndarray, *, group_offset: int = 0) -> None:
    """Registry export for a whole reduced vector array: ``[R, WIDTH]``
    (single group) or ``[G, R, WIDTH]`` (sharded — ``group_offset``
    shifts the group label for multi-host shards)."""
    if obs is None:
        return
    m = obs.metrics
    if vec.ndim == 2:
        for r in range(vec.shape[0]):
            export(m, vec[r], replica=r)
    else:
        for g in range(vec.shape[0]):
            for r in range(vec.shape[1]):
                export(m, vec[g, r], replica=r, group=g + group_offset)
