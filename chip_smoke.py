#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # one card; no arguments

Phase 14c starts three more Python processes that import this file and
call :func:`host_rank`, phase 15a three that call :func:`node_rank` and
two sets of three launchers with their apps, phase 15b three
supervisors with their workers and apps; every one of them is stopped
before the phase ends. Two worker processes run CPU twins for the whole
run (:class:`Twins`) and are stopped at its end, also when it fails.
While this process, or a card rank of 14c or 15a, is inside a timed
window (:func:`alone`), the twins beside it are stopped (SIGSTOP) and
continued after, so no time the script reports is taken beside a twin.

Phases, one printed line each (a failed check raises and the script
exits non-zero without its result line):

1. the device: torch's name and count, and ``nvidia-smi``'s name and
   power limit;
2. build every kernel of ``rdma_paxos_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, on seeded
   random batches and edge cases — exact equality (integer protocol
   state: no tolerance);
4. the replicated write path at full width, for two log geometries:
   elect, a seeded stream of SEND entries through ``step()`` then
   ``step_burst()``, then a ``ClientSession`` workload of 1500
   operations on ``ReplicatedKVS(cap=65536)``. Every acknowledged write must read back
   from all 3 replicas and through the leader's read-index ``get``; the
   same seeded run on the CPU must give bit-equal replay streams,
   replica state and KVS tables; the commit-window kernel must have been
   launched exactly once per protocol step, and the stand-alone
   commit-scan kernel never;
5. launches and times at geometry (a), with the card's name and power
   limit: CUDA kernels per ``step()``, each kernel's device time beside
   its bound and its plain version (the commit window also at 64 groups
   x 3 replicas), steps/s and entries/s, the device and host profiles;
6. the front door, at geometry (a): (6a) a pre-queued record of 20480
   SEND events of 100 bytes on 8 connections through the leader's shim
   handler of a pipelined ``ClusterDriver`` on the card — every event
   acked once with status 0, the committed stream in submit order and
   equal to a serial run on the CPU, ``max_inflight_dispatches >= 2``,
   one ``commit_window`` launch per protocol step; acked events/s,
   commit latency, dispatches, kernels per step, the card's idle share,
   the readback thread's ``_post_step`` time per event and a cProfile of
   the serial loop's post-step stages; (6b) three
   ``native/toyserver`` apps under ``LD_PRELOAD=native/interpose.so``
   served by the driver on the card: election by the timers, 1000 SETs
   from 4 clients read back from both followers' apps, every replica's
   stable store holding the CONNECT/SEND/CLOSE stream, and a failover
   that serves a write to the remaining follower; requests/s and
   request latency;
7. recovery: (7a) at geometry (a), gather, a partitioned laggard left
   more than a ring behind (stuck after heal: the gap reject) recovers
   by ``take_snapshot``/``recover_vote``/``install_snapshot`` on the card
   and catches up, then a fresh learner bootstraps from a snapshot, is
   admitted and keeps its membership config across a second install; at
   geometry (b) one install into a partitioned laggard and its catch-up;
   replica state and replay streams bit-equal to the same script on the
   CPU; (7b) three toy apps with stores and app checkpoint hooks:
   ``checkpoint_app`` compacts a follower's store, ``recover_replica``
   rebuilds a restarted app, ``reset_app`` rebuilds another from its
   checkpoint plus suffix, and the driver recovers a follower force-
   pruned past its wedged apply into its live app, exactly once (COUNT
   and keys equal the leader's); install, catch-up, admin and recovery
   times;
8. the audit digest chain and device telemetry, at geometry (a): (8a)
   phase 4's seeded SEND stream on an ``audit=True, telemetry=True``
   cluster, its ledger dump and summary, flight ring and device counters
   equal to the same run on the CPU, zero findings and every committed
   index digested by every replica; CUDA kernels and wall ms per
   ``step()`` with neither variant (equal to phase 5's count), audit
   only, telemetry only and both; (8b) one payload word of replica 2's
   slot at its last applied index corrupted on the card: the ledger names
   that index and replica within 3 steps, replica 2's digest-carrying
   snapshot is refused by ``install_snapshot(ledger=)`` with the state
   untouched, replica 0's installs into replica 2, and ``redigest``
   backfills replica 0's committed range with no new finding, all equal
   to the CPU run; (8c) the (6a) record through a pipelined
   ``ClusterDriver(audit=True, telemetry=True)`` with a workdir: every
   event acked once with status 0 in submit order, a clean ledger,
   ``device_committed_entries_total`` equal to the committed count, the
   audit artifact written under the workdir and reported clean by
   ``python -m rdma_paxos_tpu_torch.obs.audit``; acked events/s with
   both variants on and both off, two alternating pairs;
9. the chaos judge on the card: seeded ``NemesisRunner`` runs, each on
   the card and again with ``device="cpu"`` in this process, with equal
   verdicts (without ``artifact``), history JSONL byte for byte, audit
   ledger and flight dumps; every verdict ``ok`` with every key decided
   and one ``commit_window`` launch per protocol step (counted by the
   wrapper; for one run ``torch.profiler``'s count, which may drop
   records, must not exceed the steps). (9a) the runner's
   defaults (``DEFAULT_KV_CFG``: 128 slots, so rings recycle and
   rebase; gather; ``audit=True``; ``leases=True``; the six default
   fault kinds): seeds 7 and 13, seed 3 with a leaseholder crash in a
   read burst (lease and read-index reads served, two grants, a
   revocation), ``pipeline=2`` and ``scan=True``; (9b) geometry (a)
   with :data:`CHAOS_A`'s clients and keys over 200 steps; (9c) the
   dedup bug (the fold's duplicate skip removed) caught as a
   linearizability violation with no invariant violation, its artifact
   replayed on the card to the same violations, and the unpatched run
   clean. Protocol steps, launches, wall seconds and steps/s per run,
   and the reads served by lease and by read-index;
10. groups, R = 3, gather fan-out, each run on the card and again with
    ``device="cpu"`` in this process, equal, with one ``commit_window``
    launch per protocol step over N = G·R instances: (10a)
    ``ShardedCluster(G=1)`` at geometry (a) equal to the ``SimCluster``
    on the card, with as many CUDA kernels per ``step()``; (10b) G = 8 at
    geometry (a) (24 rings of 1.25 MiB) and (10c) G = 64 at
    ``benchmarks/shard_bench.py``'s geometry: ``place_leaders()``, each
    group's seeded SEND stream through ``step()``, ``step_burst()`` and
    the scan tier, every group equal to the CPU run and the last group
    to its ``SimCluster`` twin on the card; steps/s and aggregate
    committed entries/s, kernels per ``step()``, the idle share, the
    commit_window kernel's device time at N = 192 beside phase 5's, and
    the host ms of ``begin_step`` and ``finish``; (10d)
    ``ShardNemesisRunner`` seeds 0 and 2 at G = 4: verdict ``ok`` and
    equal to the CPU run, the other groups' frontiers advancing, the
    target group recovered; (10e) ``ShardedKVS`` at G = 4, geometry
    (a): 256 session puts read back from every replica of each owning
    group and linearizably from the leaseholders; (10f)
    ``ShardedClusterDriver`` at G = 4, geometry (a): pre-queued SENDs
    through all three replicas' shim handlers acked once each with
    status 0 in per-group order, the per-group streams equal to a CPU
    serial run; acked events/s;
11. transactions, R = 3, gather, each run on the card and again with
    ``device="cpu"`` in this process, equal, with one ``commit_window``
    launch per protocol step and no ``commit_scan`` launch: (11a) a
    ``ShardedCluster(txn=True)`` of 8 groups at geometry (a): every
    group's leader gets a prepare, watched at once (PENDING, then
    PREPARED), while group 0's leader, partitioned alone, has its
    prepare overwritten by a failover leader (CONFLICT, everywhere after
    the heal) — every step's ``[G, R]`` votes, results and the state
    equal to the CPU run; PyTorch ops dispatched and CUDA kernels per
    ``step()`` with ``txn=False`` and ``txn=True`` and their wall ms;
    (11b) ``ShardedKVS`` + ``attach_coordinator`` on that geometry:
    12 cross-group put-pair transactions driven serially to completion
    and 12 single-key puts, protocol dispatches and ms per commit (equal
    dispatch counts and KVS tables on the CPU), the INCR merge fast path
    against plain puts in alternating rounds, and the coordinator's host
    ms per step; (11c) the txn nemesis (``run_txn_chaos``'s runner)
    seeds 0 and 1 at the JAX defaults: verdict ``ok`` with the
    straddling transaction aborted, verdict, history and merge summary
    equal to the CPU run; (11d) ``ShardedClusterDriver(txn=True,
    pipeline=2)`` at geometry (a), G = 2: a put-pair and an INCR-pair
    transaction through its poll loop, ``health()['txn']``, and
    ``ClusterDriver(txn=True)`` elected and stepped;
12. repair and the governor, R = 3, gather, geometry (a), each run on
    the card and again with ``device="cpu"`` in this process, equal,
    with one ``commit_window`` launch per protocol step and no
    ``commit_scan`` launch: (12a) an audited ``SimCluster`` with a
    ``RepairController``: a follower's committed slot flipped is
    quarantined, installed from a majority donor, backfilled and
    re-admitted after probation; the corrupted-donor retry; escalation
    latched after ``max_attempts`` with ``repair_failed`` firing — every
    step's outputs, ``repair.status()``, the ledger and the alerts equal
    to the CPU run; protocol steps from the flip to re-admission, install
    and ``run_redigest`` ms, wall ms per audited step with a repair in
    flight against one without; (12b) the repair nemesis
    (``NemesisRunner(repair=True, pipeline=2)``), seeds 3 and 5: verdict
    ``ok``, verdict, history and ledger equal to the CPU run; (12c)
    ``ShardedCluster(G=8, audit=True)``: group 1's replica repaired while
    every other group's commit frontier advances strictly; (12d) a
    governed ``SimCluster`` under a seeded trickle/burst/trickle arrival
    trace, ``ShardedCluster(G=8)``'s per-group rungs, and the SLO shed
    through ``on_alert`` (serial while the burn-rate pager fires, a
    fused tier again once it resolves) — decisions and outputs equal to
    the CPU run; committed entries/s governed, fixed serial and fixed
    ``max(K_TIERS)`` in alternating rounds on the card; (12e)
    ``ClusterDriver(audit=True, repair=True)`` with its leader corrupted
    (deposed, repaired, ``digest_divergence`` fired, the audit artifact
    written, ``health()`` valid, ``/healthz`` and ``/metrics`` scraped
    from ``serve_metrics(0)``), ``ClusterDriver(governor=True,
    pipeline=2)`` serving a queued workload through its live loop with
    fused ``dispatch_tier`` counters, and ``ShardedClusterDriver(G=2,
    audit=True, repair=True)`` repairing a group leader while group 0
    commits;
13. streams and elastic topology, R = 3, each run on the card and again
    with ``device="cpu"`` in this process, equal, with one
    ``commit_window`` launch per protocol step and no ``commit_scan``
    launch: (13a) a streams hub on an audited ``SimCluster`` at geometry
    (a), gather, with the read path and ``ReplicatedKVS(cap=4096)``: 16
    session clients write 2048 keys under a whole-range watch that
    resumes twice from its token (every put delivered once), a paged
    scan whose leader is cut off between two pages (every item the
    cut's value), the CDC export verified against the ledger and a
    flipped byte named; step outputs and ops per ``step()`` equal to a
    twin without the hub; the pump's lag, ms per scan page, the table
    walk, CDC records/s, and committed entries/s attached and detached
    in alternating rounds; (13b) ``ClusterDriver(streams=True,
    pipeline=2)`` on (6a)'s record (health valid, the watcher closed at
    stop) and ``NemesisRunner(streams=True)`` seeds 0 and 1 (0 dups, 0
    gaps); (13c) ``ShardedKVS`` at G = 4, geometry (a), 2048 keys: the
    upper half of group 0's keys split into group 1 while puts continue
    and merged back — router, epoch, ``health()['topology']``, each
    group's table and the trace's phases equal to the CPU run, ops per
    ``step()`` equal to a twin without the controller, steps and ms per
    window; (13d) ``run_topology_chaos`` seeds 0 and 1, and a pipelined
    ``ShardedClusterDriver`` at G = 2 that cuts a split over with load in
    flight (the donor's waiters failed and sent again, every event acked
    once with status 0); (13e) the console's fleet table over (13c)'s
    health document with its ``TOPO`` column;
14. the profiler, interposed apps under the sharded driver, and one
    replica per process: (14a) ``ClusterDriver.start_profile`` around
    (6a)'s record, then ``stop_profile`` and ``merge_timeline`` — the
    merged timeline holds spans, host phases and at most one
    ``commit_window`` kernel event per protocol step (more than none);
    ``program_report`` for (8a)'s four variant settings, its ops of a
    stable step equal to ``op_count`` and its kernels per variant no
    more than 8a's (and phase 5's) count per ``step()``; one capture
    started by an alert page with ``profile_on_page``, none by a second;
    (14b) three ``native/toyserver`` apps under ``LD_PRELOAD`` behind
    ``ShardedClusterDriver`` at G = 2, geometry (a), gather, the serial
    loop: 1000 SETs from 4 clients on every replica's app over key
    prefixes of both groups; group 0's leader isolated in its group and
    its election timer fired on a survivor while group 1 serves 100
    writes; group 0's new leader serving a write; after the heal every
    acknowledged key read back from every replica's app; requests/s,
    latency and the failover time; (14c) three processes, each a
    ``HostReplicaDriver(device="cuda")`` rank on the one card under gloo
    (explicit host copies around each collective): election, 32 full
    batches from the leader (timed), bursts at K = 2 and 4, a K = 2
    scan, the rollovers they cross, and a leader change (a partition
    through ``peer_mask`` under gather; a timer under psum, which refuses
    the partition), at geometry (a) under psum and gather and at (b)
    for a few steps, all three in one world; every call's outputs and each rank's final row
    equal to the same script at ``device="cpu"``, ``fetch_local_window``
    returning the committed payloads, one ``commit_window`` launch per
    protocol step per rank; steps/s, committed entries/s and ms per
    exchange;
15. the per-host daemon and the elastic plane: (15a) three ``python -m
    rdma_paxos_tpu_torch.runtime.launch_node --device cuda`` processes
    each with a toy app under ``LD_PRELOAD``, 2000 pipelined SETs
    through the leader's app read back from every app, at geometry (a)
    with ``RP_BURST=1`` and at (b) with ``RP_BURST=0`` (requests/s, p50,
    p99); three ``NodeDaemon(device="cuda")`` rank processes of
    :func:`node_rank` given (6a)'s record through rank 0's ``_on_event``
    (rank 0's timer forced) with bursts on, then a second record with
    them off, in one world: every iteration's outputs, the events'
    statuses, the stores, the hard state, ``meta()`` and the rows equal
    to the same script at ``device="cpu"``, one ``commit_window`` launch
    per protocol step per rank (acked events/s, iterations/s); (15b) a
    ``GroupController`` here and three ``python -m
    rdma_paxos_tpu_torch.runtime.elastic`` supervisors whose workers run
    on the card at (a), with toy apps: acked SETs, the leader's
    supervisor stopped and its worker SIGKILLed, a generation cut from
    the two survivors with the donor the ``(last_log_term, end)`` order
    names, more SETs, the stopped supervisor killed and restarted and
    its host rejoining in a later generation, every acked write read
    back from all three apps; the generations, the time to recover (the
    SIGKILL to the first acked write), the time to rejoin, the ms per
    iteration in ``write_rowdump``, and each worker's protocol steps and
    ``commit_window`` launches (equal);
16. the single-controller engines over a device list, the layouts
    repeating the one card and printed with their repeats: (16a)
    ``SimCluster(mode="spmd")`` on ``[cuda:0] * 3`` at geometry (a) with
    a rollover point the run crosses, psum and gather: election, 16 full
    batches through ``step()`` (timed), a burst, a scan, the catch-up —
    every dispatch's results, the streams and the rows equal to the
    stacked engine on the card and to the same script on
    ``["cpu"] * 3``, three ``commit_window`` launches per protocol step
    (one per entry, N = 1); steps/s and committed entries/s beside the
    stacked engine's, exchanges per step and ms per exchange; at
    geometry (b) four batches, equal to the stacked engine; (16b)
    ``ShardedCluster(mesh=(2, 3))`` at G = 8, geometry (a), and
    ``mesh=(4, 3)`` at G = 64 on ``benchmarks/shard_bench.py``'s
    geometry: (10b/10c)'s step, burst and scan drive, every dispatch
    equal to the stacked group engine on the card and to the CPU twin,
    one launch per entry per protocol step (6 over N = 4, 12 over
    N = 16), aggregate entries/s beside the stacked engine's; one
    audit+telemetry+txn step at G = 8 equal to the stacked engine's;
    (16c) ``ShardedClusterDriver(mesh=(2, 3))`` at G = 4, geometry (a),
    pipelined: (6a)'s 20480 SENDs of 100 B on 8 connections,
    key-prefix routed, acked once each with status 0, in per-group
    order, equal to the stacked driver's acks and streams, two
    dispatches in flight at once (``max_inflight_dispatches >= 2``);
    acked events/s beside the stacked driver's;
17. graftlint and the runtime lock sanitizer: (17a) ``python -m
    rdma_paxos_tpu_torch.analysis --json`` in a subprocess on the card's
    machine, exit 0 with no live finding and no unused suppression;
    (17b) with ``RP_SANITIZE=1`` for the phase (restored after),
    ``ClusterDriver(pipeline=2)`` at geometry (a) on (6a)'s record: the
    engine ``SimCluster+sanitized``, every event acked once with status
    0 in order, the streams equal to unsanitized runs on the card and to
    a sanitized serial CPU twin, ``max_inflight_dispatches >= 2``, one
    ``commit_window`` launch per protocol step, an off-lock write of
    ``cluster.pending`` raising ``LockDisciplineError`` (and not
    unsanitized); acked events/s sanitized and unsanitized in
    alternating turns; (17c) sanitized: (10f)'s sharded driver at G = 4,
    pipelined; a streams hub on a ``SimCluster`` at (a) whose cluster,
    read hub, hub, watch and scans are all ``+sanitized`` (session puts
    watched once each in order, then scanned); four full batches of
    (16a)'s spmd engine on ``[cuda:0] * 3`` — each equal to its
    sanitized CPU twin. An exception raised on any thread fails the
    phase; nothing falls back to the CPU or to an unsanitized run;
18. the scalar host data plane (``hostpath.set_vectorized(False)``):
    (18a) (6a)'s record, 20480 SENDs, through a pipelined
    ``ClusterDriver`` with a workdir, the plane off and on in turns
    (off, on, on, off): every event acked once with status 0 in order,
    the committed streams and the stable stores' bytes equal across the
    planes and to one serial run on the CPU, one ``commit_window``
    launch per protocol step; acked events/s per plane, and the host ms
    per ``step()`` of ``decode_window`` and ``pack_rows`` per plane
    (cProfile); (18b) ``ShardedCluster(G=8)`` at (a): two steps of a
    full batch per group with the plane off equal to the same with it
    on; (18c) ``consensus.step.group_step`` called directly at G = 8
    equal to ``parallel.mesh.build_sim_group_step``, one launch per
    step each;
19. the ``kernels`` JSON line, then ``{"ok": true, "device": ...}`` last.

Each phase prints ``phase N start`` before it runs and its wall time
after, so a failure names its phase. The CPU twins of phases 4, 7a, 9
(but 9c's patched run), 10b-10f, 11c, 11d, 12b, 12d, 13, 16 and 17 run
in worker processes (:class:`Twins`) while the card runs, and
the twin worlds of 14c and 15a beside the card's worlds at the lowest
CPU priority; the other twins run here. Host rates printed by those
phases are taken with a twin running beside them.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

R = 3
SEED = 1234
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (data sheet)
ALU_OPS_PER_S = 67e12        # H100 SXM non-tensor 32-bit peak (data sheet)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def load_port():
    sys.path.insert(0, str(ROOT))
    import rdma_paxos_tpu_torch
    where = Path(rdma_paxos_tpu_torch.__file__).resolve().parent.parent
    check(where == ROOT, f"rdma_paxos_tpu_torch imported from {where}, "
                         f"not from beside chip_smoke.py ({ROOT})")
    return rdma_paxos_tpu_torch


# ---------------------------------------------------------------------------
# CPU twins in worker processes
# ---------------------------------------------------------------------------

TWIN_WORKERS = 2            # processes running CPU twins beside the card
TWIN_THREADS = 2            # torch threads of each
TWIN_TIMEOUT = 900          # seconds a phase waits for one twin
TWIN_NICE = 19              # CPU priority of a twin's rank processes
PAUSE_ENV = "RP_SMOKE_PAUSE"  # pids of the twin world a card rank stops


def _twin_init() -> None:
    load_port()
    torch.set_num_threads(TWIN_THREADS)


def _twin_call(name: str, args: tuple, kw: dict, env: dict):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        out = globals()[name](*args, **kw)
        return out, time.perf_counter() - t0
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Twin:
    """A CPU twin started in a worker process; :meth:`get` waits for its
    result (re-raising its failure) and sets ``seconds``, its own wall
    time in the worker."""

    def __init__(self, fut):
        self.fut, self.seconds = fut, None

    def get(self):
        out, self.seconds = self.fut.result(timeout=TWIN_TIMEOUT)
        return out


class Twins:
    """A pool of :data:`TWIN_WORKERS` spawned processes that run CPU twins
    (module functions called with ``torch.device("cpu")``) while this
    process drives the card, so a twin costs the phase its excess over
    the card's run rather than its whole time. ``_env`` sets environment
    switches in the worker for the call; a twin that needs a
    monkeypatch of this process runs here. :meth:`close` stops every
    worker."""

    def __init__(self):
        import concurrent.futures
        import multiprocessing
        self.pool = concurrent.futures.ProcessPoolExecutor(
            TWIN_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_twin_init)

    def submit(self, fn, *args, _env=None, **kw) -> Twin:
        return Twin(self.pool.submit(_twin_call, fn.__name__, args, kw,
                                     dict(_env or {})))

    def pids(self) -> list:
        return [p.pid for p in list((self.pool._processes or {}).values())]

    def close(self) -> None:
        procs = list((self.pool._processes or {}).values())
        self.pool.shutdown(wait=False, cancel_futures=True)
        for p in procs:
            with contextlib.suppress(ProcessLookupError):
                os.kill(p.pid, signal.SIGCONT)
            p.terminate()
            p.join(10)


TWINS: Optional[Twins] = None      # set by main()
CPU = torch.device("cpu")
_ALONE = [0]                       # depth of the open timed windows


def descendants(roots) -> list:
    """``roots`` and every live process below them (one /proc walk)."""
    kids = {}
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                stat = (d / "stat").read_text()
            except OSError:
                continue
            kids.setdefault(int(stat.rsplit(")", 1)[1].split()[1]),
                            []).append(int(d.name))
    out, todo = [], list(roots)
    while todo:
        p = todo.pop()
        out.append(p)
        todo += kids.get(p, [])
    return out


def _stopped(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1]
    except OSError:
        return True                     # gone
    return state.split()[0] in ("T", "t")


@contextlib.contextmanager
def alone():
    """A timed window of this process: every CPU twin beside it (the
    :class:`Twins` workers here, the twin world whose pids
    :data:`PAUSE_ENV` names in a card rank), with its children, is
    stopped when the window opens and continued when it closes, so no
    time reported from the window is taken beside a twin. Windows nest;
    where no twin runs beside (in a twin itself) it does nothing."""
    _ALONE[0] += 1
    pids = []
    try:
        if _ALONE[0] == 1:
            roots = [int(p) for p in os.environ.get(PAUSE_ENV, "").split(",")
                     if p]
            if TWINS is not None:
                roots += TWINS.pids()
            pids = descendants(roots) if roots else []
            for p in pids:
                with contextlib.suppress(ProcessLookupError):
                    os.kill(p, signal.SIGSTOP)
            deadline = time.monotonic() + 2.0
            while (not all(map(_stopped, pids))
                   and time.monotonic() < deadline):
                time.sleep(0.001)
        yield
    finally:
        _ALONE[0] -= 1
        for p in pids:
            with contextlib.suppress(ProcessLookupError):
                os.kill(p, signal.SIGCONT)


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain
# ---------------------------------------------------------------------------

def scan_cases(rng, N: int, W: int):
    """Seeded random commit-scan instances ``(ends, terms, scal)``."""
    from rdma_paxos_tpu_torch.ops.quorum import R_PAD
    nrep = rng.integers(1, 14, N)
    commit = rng.integers(0, 5000, N).astype(np.int64)
    ends = np.zeros((N, R_PAD), np.int64)
    for n in range(N):
        ends[n, :nrep[n]] = commit[n] + rng.integers(-4, W + 6, nrep[n])
        ends[n, :nrep[n]] *= rng.random(nrep[n]) < 0.9    # some unheard
    bm_old = rng.integers(0, 1 << 13, N)
    bm_new = rng.integers(0, 1 << 13, N)
    hi = rng.random(N) < 0.2                      # bits >= 13, up to 31
    bm_new[hi] |= 1 << rng.integers(13, 32, int(hi.sum()))
    transit = (rng.random(N) < 0.3).astype(np.int64)
    maj_old = np.array([bin(int(b)).count("1") // 2 + 1 for b in bm_old])
    maj_new = np.array([bin(int(b)).count("1") // 2 + 1 for b in bm_new])
    my_term = rng.integers(1, 4, N)
    terms = rng.integers(0, 4, (N, W))
    my_end = commit + rng.integers(0, W + 8, N)
    scal = np.stack([commit, my_term, my_end, bm_old, bm_new, transit,
                     maj_old, maj_new], 1)
    return ends, terms, scal


def edge_cases(W: int):
    """Hand-made instances: transit, term guard, my_end cap, high
    bitmask bits, zero prefix, i32 wrap of commit + j."""
    from rdma_paxos_tpu_torch.ops.quorum import R_PAD
    rows = []

    def add(ends_list, commit, my_term, my_end, terms, bm_old=0b111,
            bm_new=0b111, transit=0, maj_old=2, maj_new=2):
        e = np.zeros(R_PAD, np.int64)
        e[:len(ends_list)] = ends_list
        t = np.zeros(W, np.int64)
        t[:len(terms)] = terms
        t[len(terms):] = terms[-1] if terms else 0
        rows.append((e, t, [commit, my_term, my_end, bm_old, bm_new,
                            transit, maj_old, maj_new]))
    add([5, 5, 2], 0, 3, 5, [3])                       # simple majority
    add([7, 0, 0], 0, 3, 7, [3])                       # minority
    add([9, 9, 9], 0, 3, 6, [3])                       # my_end cap
    add([3, 3, 3], 0, 5, 3, [2, 2, 2, 0])              # term guard: none
    add([3, 3, 3], 0, 5, 3, [2, 2, 5, 0])              # term guard: all 3
    add([4, 4, 0, 0, 0], 0, 7, 4, [7], 0b00111, 0b11001, 1, 2, 2)
    add([4, 4, 0, 4, 0], 0, 7, 4, [7], 0b00111, 0b11001, 1, 2, 2)
    add([8, 8, 3], 3, 4, 8, [4])
    add([9] * 13, 0, 1, 9, [1], 0, 0xFFFFFFFF, 0, 1, 17)   # bits >= 13
    add([9] * 13, 0, 1, 9, [1], 0, 1 << 31, 0, 1, 1)       # bit 31 only
    add([9, 9, 9], 0, 1, 9, [1], 0b111, 0b111, 0, 2, 4)    # zero prefix
    big = (1 << 31) - 4
    add([-(1 << 31) + 8] * 3, big, 1, -(1 << 31) + 8, [1])  # commit + j wraps
    ends = np.stack([r[0] for r in rows])
    terms = np.stack([r[1] for r in rows])
    scal = np.array([r[2] for r in rows], np.int64)
    return ends, terms, scal


def i32(a: np.ndarray, dev) -> torch.Tensor:
    """int64 numpy -> int32 tensor holding the same bit pattern."""
    return torch.from_numpy(
        (np.asarray(a, np.int64) & 0xFFFFFFFF).astype(np.uint32)
        .view(np.int32)).to(dev).contiguous()


def phase_kernel_checks(dev) -> dict:
    from rdma_paxos_tpu_torch.ops.quorum import (
        commit_scan_cuda, commit_scan_ref)
    rng = np.random.default_rng(SEED)
    errs, n_inst = 0, 0
    cases = [scan_cases(rng, N, W) for N in (3, 13, 3 * 64)
             for W in (16, 128, 2048)]
    cases += [edge_cases(W) for W in (16, 2048)]
    for ends, terms, scal in cases:
        e, t, s = i32(ends, dev), i32(terms, dev), i32(scal, dev)
        got = commit_scan_cuda(e, t, s)
        want = commit_scan_ref(e, t, s)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        check(bad == 0, f"commit_scan kernel != plain on {bad} of "
                        f"{len(got)} instances (W={t.shape[1]}): "
                        f"{got[got != want][:8].tolist()} vs "
                        f"{want[got != want][:8].tolist()}")
        errs += bad
        n_inst += len(got)
    print(f"kernel check: commit_scan == commit_scan_ref on {n_inst} "
          f"instances in {len(cases)} batches (N in 3/13/192, W in "
          f"16/128/2048, edge cases), max_abs_err 0", flush=True)
    return dict(max_abs_err=0, instances=n_inst)


def wrap(a) -> np.ndarray:
    """int64 values -> the i32 values they wrap to."""
    return ((np.asarray(a, np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def window_case(rng, dev, *, G: int, R: int, W: int, n_slots: int,
                commit=None, lead_p=0.6, cfg_p=0.15, transit_p=0.3,
                bit31=False):
    """Seeded commit-window instances, N = G groups x R replicas, on
    ``dev``: a ring (128-byte payloads, as the main path's) whose window
    rows carry terms near ``my_term`` and CONFIG rows, most stamped with
    their own index; acks near the window. Returns the positional and
    keyword arguments of ``commit_window``."""
    from rdma_paxos_tpu_torch.consensus.log import (
        EntryType, M_GIDX, M_TERM, M_TYPE, META_W)
    N, sw = G * R, 32
    buf = np.zeros((N, n_slots, sw + META_W), np.int32)
    buf[..., sw:] = rng.integers(-50, 50, (N, n_slots, META_W), np.int32)
    commit = (rng.integers(0, 4 * n_slots, N) if commit is None
              else np.full(N, commit, np.int64))
    my_term = rng.integers(1, 4, N)
    g = wrap(commit[:, None] + np.arange(W))                  # [N, W]
    at = (np.arange(N)[:, None], g & (n_slots - 1))
    buf[at + (sw + M_TERM,)] = my_term[:, None] + rng.integers(-1, 2, (N, W))
    buf[at + (sw + M_TYPE,)] = np.where(rng.random((N, W)) < cfg_p,
                                        int(EntryType.CONFIG),
                                        int(EntryType.SEND))
    buf[at + (sw + M_GIDX,)] = wrap(np.where(rng.random((N, W)) < 0.8,
                                             g, g + n_slots))
    full = (1 << R) - 1
    bm_old = full & rng.integers(0, 1 << R, N) | (rng.random(N) < 0.5) * full
    bm_new = full & rng.integers(0, 1 << R, N) | (rng.random(N) < 0.5) * full
    if bit31:
        bm_new |= (rng.random(N) < 0.7).astype(np.int64) << 31
        bm_old |= (rng.random(N) < 0.3).astype(np.int64) << 31

    def maj(bm):
        return np.array([bin(int(b)).count("1") // 2 + 1 for b in bm])
    kw = {k: i32(v, dev) for k, v in dict(
        commit=commit, my_term=my_term,
        my_end=wrap(commit + rng.integers(0, W + 6, N)),
        transit=rng.random(N) < transit_p, maj_old=maj(bm_old),
        maj_new=maj(bm_new),
        commit1=wrap(commit + rng.integers(0, W, N))).items()}
    kw.update(bm_old=torch.from_numpy(bm_old).to(dev),
              bm_new=torch.from_numpy(bm_new).to(dev),
              i_lead=torch.from_numpy(rng.random(N) < lead_p).to(dev))
    args = (torch.from_numpy(buf).to(dev),
            torch.from_numpy(rng.random((N, R)) < 0.8).to(dev),
            i32(wrap(commit + rng.integers(-3, W + 4, N)), dev))
    return args, kw


def entry_call(args, kw, R: int, groups: range, r: int):
    """A device-list entry's commit-window call cut from a stacked
    :func:`window_case`: replica ``r`` of each group in ``groups``, one
    instance per group, each reading its own group's R gathered acks (the
    row layout, ``my_ack [N * R]``). Returns the call and the stacked
    instances it covers."""
    idx = torch.tensor([g * R + r for g in groups], device=args[0].device)
    acks = args[2].view(-1, R)[groups.start:groups.stop].reshape(-1)
    return ((args[0][idx].contiguous(), args[1][idx].contiguous(),
             acks.contiguous()),
            {k: v[idx].contiguous() for k, v in kw.items()}), idx


# edge cases of the commit window (see tests/test_torch_window.py)
WINDOW_EDGES = {
    "ring wrap": lambda n_slots: dict(commit=2 * n_slots - 7),
    "i32 wrap": lambda n_slots: dict(commit=(1 << 31) - 9),
    "transit": lambda n_slots: dict(transit_p=1.0),
    "bit 31": lambda n_slots: dict(bit31=True),
    "no leader": lambda n_slots: dict(lead_p=0.0),
    "no CONFIG": lambda n_slots: dict(cfg_p=0.0),
    "all CONFIG": lambda n_slots: dict(cfg_p=1.0),
}


def phase_window_checks(dev) -> dict:
    from rdma_paxos_tpu_torch.ops.quorum import (
        commit_window_cuda, commit_window_ref)
    rng = np.random.default_rng(SEED + 2)
    cases = [(dict(G=G, R=r, W=W, n_slots=max(64, 4 * W)), {})
             for G, r in ((1, 3), (1, 13), (64, 3)) for W in (16, 128, 2048)]
    cases += [(dict(G=4, R=3, W=W, n_slots=4 * W), edge(4 * W))
              for W in (16, 2048) for edge in WINDOW_EDGES.values()]
    n_inst, found, lone, rows = 0, 0, 0, 0
    for shape, extra in cases:
        args, kw = window_case(rng, dev, **shape, **extra)
        calls = [(args, kw)]
        G, R = shape["G"], shape["R"]
        if G > 1 and R == 3:
            # the device-list entries' calls: replica r of a group
            # shard's groups (1, 4 or 16 of them), the acks as rows; each
            # must also equal the stacked call's instances
            want_all = commit_window_ref(*args, w=shape["W"], **kw)
            for gl in sorted({1, min(G, 16), G // 4}):
                for s0 in range(0, G, gl)[:2]:
                    for r in range(R):
                        call, idx = entry_call(args, kw, R,
                                               range(s0, s0 + gl), r)
                        want = commit_window_ref(*call[0], w=shape["W"],
                                                 **call[1])
                        for a, b in zip(want, want_all):
                            check(torch.equal(a, b[idx]),
                                  "commit_window_ref: the row layout "
                                  "disagrees with the stacked call")
                        calls.append(call)
                        rows += gl
        if shape["G"] == 1 and shape["R"] == 3:
            # the process-group step's call: each instance alone (N = 1)
            # with its group's R gathered acks
            calls += [((args[0][n:n + 1].contiguous(),
                        args[1][n:n + 1].contiguous(), args[2]),
                       {k: v[n:n + 1].contiguous() for k, v in kw.items()})
                      for n in range(3)]
            lone += 3
        for a_, k_ in calls:
            got = commit_window_cuda(*a_, w=shape["W"], **k_)
            want = commit_window_ref(*a_, w=shape["W"], **k_)
            torch.cuda.synchronize()
            for name, a, b in zip(("commit2", "xpos"), got, want):
                bad = int((a != b).sum())
                check(bad == 0, f"commit_window kernel != plain in {name} "
                                f"on {bad} of {len(a)} instances ({shape}, "
                                f"{extra}): {a[a != b][:8].tolist()} vs "
                                f"{b[a != b][:8].tolist()}")
            n_inst += len(got[0])
            found += int((want[1] >= 0).sum())
    check(0 < found < n_inst, "the crossing search was never exercised")
    print(f"kernel check: commit_window == commit_window_ref on {n_inst} "
          f"instances in {len(cases)} batches (N in 3/13/192, W in "
          f"16/128/2048, {lone} lone N = 1 instances reading their "
          f"group's 3 acks, {rows} instances of device-list entries "
          f"(N = 1, 4 or 16) reading their own groups' acks as rows; edge "
          f"cases: {', '.join(WINDOW_EDGES)}; "
          f"{found} with a crossing CONFIG row), max_abs_err 0", flush=True)
    return dict(max_abs_err=0, instances=n_inst)


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

# ClientSession operations of phase 4's KVS workload
MAIN_KVS_OPS = 1500

GEOMETRIES = {
    # the repo's measured geometry (bench.py:37), psum fan-out
    "a": (dict(n_slots=8192, slot_bytes=128, window_slots=2048,
               batch_slots=2048), "psum"),
    # the reference's log size: 2^19 slots x 128 B = 64 MiB of payload
    # per replica (80 MiB with the metadata), gather fan-out
    "b": (dict(n_slots=524288, slot_bytes=128, window_slots=2048,
               batch_slots=2048), "gather"),
}


def kvs_model(stream):
    """Independent plain-Python fold of a committed stream: session
    dedup by (conn, req) high-water mark, PUT/RM/INCR on 8 i32 words."""
    from rdma_paxos_tpu_torch.models.kvs import (
        CMD_W, KEY_W, OP_INCR, OP_PUT, OP_RM)
    table, last = {}, {}
    for etype, conn, req, payload in stream:
        if etype != 3 or len(payload) != CMD_W * 4:
            continue
        if req > 0 and conn > 0:
            if req <= last.get(conn, 0):
                continue
            last[conn] = req
        w = np.frombuffer(payload, "<i4")
        op, key, val = int(w[0]), w[1:1 + KEY_W].tobytes(), w[1 + KEY_W:]
        if op == OP_PUT:
            table[key] = val.copy()
        elif op == OP_RM:
            table.pop(key, None)
        elif op == OP_INCR:
            base = table.get(key, np.zeros(8, "<i4"))
            table[key] = (base.astype(np.int64) + val).astype("<i4")
    return table, last


def send_stream(c, lead: int, rng) -> list:
    """The seeded SEND stream of the main path: two full batches through
    ``step()``, eight through bursts (lengths of a KVS command or a txn
    record are skipped: the KVS fold would read such SEND payloads as
    commands). Returns the payloads."""
    from rdma_paxos_tpu_torch.models.kvs import CMD_W
    from rdma_paxos_tpu_torch.models.replicated_kvs import TXN_CMD_W
    B = c.cfg.batch_slots
    lens = rng.integers(1, 129, 10 * B)
    lens += np.isin(lens, (CMD_W * 4, TXN_CMD_W * 4))
    sends = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
             for n in lens]
    c.submit_many(lead, [(3, 1 + i % 64, 0, p)
                         for i, p in enumerate(sends[:2 * B])])
    while c.pending[lead]:
        c.step()
    c.submit_many(lead, [(3, 1 + i % 64, 0, p)
                         for i, p in enumerate(sends[2 * B:])])
    while c.pending[lead]:
        c.step_burst()
    return sends


def drive(port, geo: str, dev, kvs_ops: int) -> dict:
    """The seeded main-path run on ``dev``; returns what the caller
    compares across devices."""
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.models.kvs import OP_INCR, decode_val
    from rdma_paxos_tpu_torch.models.replicated_kvs import ReplicatedKVS
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    geom, fanout = GEOMETRIES[geo]
    cfg = LogConfig(**geom)
    rng = np.random.default_rng(SEED)
    c = SimCluster(cfg, R, fanout=fanout, device=dev)
    kv = ReplicatedKVS(c, cap=65536)
    launches0, steps0 = (commit_window.launches,
                         commit_scan.launches), c.step_index
    with alone():
        t0 = time.perf_counter()

        lead = c.run_until_elected(0)
        sends = send_stream(c, lead, rng)

        # ClientSession workload: one outstanding request per session
        n_sess = 256
        sessions = [kv.session(client_id=1000 + i) for i in range(n_sess)]
        # the table's FNV-style hash mixes the LOW bits of each key word
        # into the bucket, so the keys vary there (b"key-00001"-style keys
        # would pile onto a few buckets and overflow the probe depth)
        keys = [(i + 1).to_bytes(4, "little") + b"-key" for i in range(1024)]
        counters = [(i + 1).to_bytes(4, "little") + b"-ctr" for i in range(64)]
        outstanding, acked, issued, rounds = {}, [], 0, 0
        while issued < kvs_ops or outstanding:
            rounds += 1
            check(rounds <= 4 * (kvs_ops // n_sess + 2),
                  "KVS workload stopped making progress")
            for i, s in enumerate(sessions):
                if i in outstanding or issued >= kvs_ops:
                    continue
                u = rng.random()
                if u < 0.6:
                    s.put(lead, keys[int(rng.integers(len(keys)))],
                          b"v%d-%d" % (issued, int(rng.integers(1 << 30))))
                elif u < 0.85:
                    s.merge(lead, OP_INCR, counters[int(rng.integers(64))],
                            np.array([int(rng.integers(1, 100))] + [0] * 7,
                                     "<i4").tobytes())
                else:
                    s.remove(lead, keys[int(rng.integers(len(keys)))])
                outstanding[i] = s.req_id
                issued += 1
            c.step()
            kv.get_many(lead, [keys[0]])          # fold the leader's table
            done = [i for i, rq in outstanding.items()
                    if kv.last_req[lead].get(1000 + i, 0) >= rq]
            for i in done:
                acked.append((1000 + i, outstanding.pop(i)))
        for _ in range(3):                        # followers catch up
            c.step()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = c.step_index - steps0
    launches = (commit_window.launches - launches0[0],
                commit_scan.launches - launches0[1])

    # every acknowledged write reads back, from all 3 replicas and
    # through the leader's read-index path
    table, last = kvs_model(c.replayed[lead])
    check(all(last.get(cid, 0) >= rq for cid, rq in acked),
          "an acknowledged request is missing from the committed stream")
    all_keys = keys + counters
    want = [decode_val(table[k]) or None if k in table else None
            for k in (k.ljust(32, b"\x00") for k in all_keys)]
    for r in range(R):
        check(c.applied[r] == c.last["commit"][r] == c.last["commit"][lead],
              f"replica {r} did not catch up")
        check(kv.get_many(r, all_keys) == want,
              f"replica {r}'s table disagrees with the committed stream")
    lin = [kv.get(lead, k, linearizable=True) for k in all_keys[:64]]
    check(lin == want[:64], "read-index get on the leader disagrees")
    check(all(list(c.replayed[r]) == list(c.replayed[lead])
              for r in range(R)), "replay streams differ across replicas")
    check(sum(1 for e in c.replayed[lead] if e[2] == 0) == len(sends),
          "SEND stream lost or duplicated entries")

    from rdma_paxos_tpu_torch import convert
    return dict(
        steps=steps, launches=launches, wall=wall,
        acked=len(acked),
        replayed=[list(s) for s in c.replayed],
        state=convert.replica_state_to_numpy(c.state),
        tables=[convert.kv_state_to_numpy(t) for t in kv.tables])


def phase_main_path(port, geo: str, dev, kvs_ops: int, twin: Twin) -> dict:
    """Geometry ``geo``'s seeded run on the card against ``twin``, the
    same run on the CPU."""
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    commit_window.launches = commit_scan.launches = 0
    gpu = drive(port, geo, dev, kvs_ops)
    launches = commit_window.launches
    check(gpu["launches"] == (launches, commit_scan.launches)
          and launches == gpu["steps"] > 0 and commit_scan.launches == 0,
          f"commit_window launched {launches} times and commit_scan "
          f"{commit_scan.launches} times in {gpu['steps']} protocol steps")
    cpu = twin.get()
    for k in ("steps", "acked", "replayed"):
        check(cpu[k] == gpu[k], f"CPU run differs in {k}")
    for k, v in gpu["state"].items():
        check(np.array_equal(v, cpu["state"][k]),
              f"CPU run differs in state field {k}")
    for a, b in zip(gpu["tables"], cpu["tables"]):
        for k in a:
            check(np.array_equal(a[k], b[k]),
                  f"CPU run differs in KVS table {k}")
    same = f"bit-equal ({twin.seconds:.1f} s on the CPU)"
    geom, fanout = GEOMETRIES[geo]
    print(f"main path ({geo}) {geom} fanout={fanout}: "
          f"{gpu['steps']} protocol steps, {launches} commit_window "
          f"launches, 0 commit_scan launches, "
          f"{sum(1 for _ in gpu['replayed'][0])} committed entries, "
          f"{gpu['acked']} acked KVS ops read back on 3/3 replicas, "
          f"{gpu['wall']:.2f} s on the card; CPU replay {same}", flush=True)
    return dict(launches=launches, steps=gpu["steps"])


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------

def cuda_time_ms(fn, iters: int, warmup: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with alone():
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_events(prof) -> dict:
    """``{name: (count, device us)}`` of what ran on the card (kernels and
    copies) in a finished ``torch.profiler`` capture, summed from its raw
    kineto events: the per-event Python objects that ``key_averages()``
    builds cost seconds for a capture of a few hundred steps."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            n, us = out.get(e.name(), (0, 0.0))
            out[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    return out


def device_profile(fn):
    """Run ``fn`` under ``torch.profiler`` (CUDA activity only): the wall
    time in ms and ``{name: (count, device us)}`` of what ran on the
    card (kernels and copies)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, alone():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, device_events(prof)


def launch_profile(fn):
    """:func:`device_profile` of ``fn`` with its totals: wall ms, the
    per-name profile, device busy ms, CUDA kernels and copies/memsets."""
    wall_ms, sprof = device_profile(fn)
    busy_ms = sum(us for _, us in sprof.values()) / 1e3
    n_kern = sum(n for k, (n, _) in sprof.items()
                 if not k.startswith(("Memcpy", "Memset")))
    n_copy = sum(n for _, (n, _) in sprof.items()) - n_kern
    return wall_ms, sprof, busy_ms, n_kern, n_copy


# the host-side stages of one engine step, for the host profile
HOST_STAGES = ("step", "submit_many", "begin_step", "pack_rows", "_dev",
               "replica_step", "commit_window", "finish", "_readback",
               "_replay_committed", "decode_window")


def host_profile(fn, stages=HOST_STAGES) -> dict:
    """Inclusive wall ms of each of the ``stages`` functions over
    ``fn()`` under cProfile."""
    import cProfile
    import pstats
    pr = cProfile.Profile()
    with alone():
        pr.enable()
        fn()
        torch.cuda.synchronize()
        pr.disable()
    out = dict.fromkeys(stages, 0.0)
    for (_file, _line, name), row in pstats.Stats(pr).stats.items():
        if name in out and "rdma_paxos_tpu_torch" in _file:
            out[name] += row[3] * 1e3
    return out


def kernel_time(kname: str, launch, plain, nbytes: int, nops: int) -> dict:
    """One kernel at one shape. ``ms`` is its own device time from the
    profiler, or None (not measured) when the profiler sees no kernel of
    that name; ``call_ms`` the wrapper's per-call rate back to back (CUDA
    events; host-bound: ctypes, checks, the output allocation); the
    bound is the larger of ``nbytes`` over the memory rate and ``nops``
    over the 32-bit ALU rate."""
    call_ms = cuda_time_ms(launch, 2000)
    plain_ms = cuda_time_ms(plain, 50)
    _, kprof = device_profile(lambda: [launch() for _ in range(500)])
    kern = [(n, us) for k, (n, us) in kprof.items() if f"{kname}_kernel" in k]
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = nops / ALU_OPS_PER_S * 1e3
    return dict(ms=kern[0][1] / kern[0][0] / 1e3 if kern else None,
                call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=max(b_bytes, b_ops), b_bytes=b_bytes, b_ops=b_ops,
                bound_by="operations" if b_ops >= b_bytes else "bytes")


def kernel_line(name: str, t: dict) -> str:
    own = (f"{t['ms'] * 1e3:.2f} us device time" if t["ms"] is not None
           else "not measured (the profiler saw no kernel)")
    return (f"{name} kernel {own} ({t['call_ms'] * 1e3:.2f} us per wrapper "
            f"call back to back), plain {t['plain_ms'] * 1e3:.2f} us, bound "
            f"{t['bound_ms'] * 1e3:.4f} us by {t['bound_by']} (bytes "
            f"{t['b_bytes'] * 1e3:.4f} us, ops {t['b_ops'] * 1e3:.4f} us)")


def named_members(bm_old, bm_new) -> list:
    """Per instance: the columns its two u32 member bitmasks name."""
    return [bin((int(a) | int(b)) & 0xFFFFFFFF).count("1")
            for a, b in zip(bm_old, bm_new)]


def phase_kernel_times(dev, card: str) -> dict:
    """The kernels at the main path's shapes (geometry (a): W = 2048 rows,
    N = R = 3 instances), the commit window also at N = 64 x 3."""
    from rdma_paxos_tpu_torch.ops.quorum import (
        R_PAD, commit_scan_cuda, commit_scan_ref, commit_window_cuda,
        commit_window_ref)
    geom, _ = GEOMETRIES["a"]
    W, n_slots = geom["window_slots"], geom["n_slots"]
    rng = np.random.default_rng(SEED + 1)
    ends, terms, scal = scan_cases(rng, R, W)
    e, t, s = i32(ends, dev), i32(terms, dev), i32(scal, dev)
    # bytes: every input read once, the output written once. Operations:
    # what this run's data needs — per row, a compare and an add for each
    # column its two member bitmasks name, and six fixed tests (two
    # majorities, my_end, transit, the prefix, the term guard)
    scan = kernel_time(
        "commit_scan", lambda: commit_scan_cuda(e, t, s),
        lambda: commit_scan_ref(e, t, s),
        R * (R_PAD + W + 8) * 4 + R * 4,
        sum(W * (2 * m + 6) for m in named_members(scal[:, 3], scal[:, 4])))
    print(f"times at geometry (a) on {card}, N = {R}, W = {W}: "
          + kernel_line("commit_scan", scan), flush=True)

    window = {}
    for G in (1, 64):
        args, kw = window_case(rng, dev, G=G, R=R, W=W, n_slots=n_slots)
        N = G * R
        # bytes: three metadata words of each window row (type, term,
        # gidx), the acks, the scalars, the [2, N] output. Operations: the
        # scan's per row, plus four for the crossing search (type, gidx,
        # g < commit2, the max)
        window[N] = kernel_time(
            "commit_window",
            lambda: commit_window_cuda(*args, w=W, **kw),
            lambda: commit_window_ref(*args, w=W, **kw),
            N * W * 12 + N * R + N * 4 + N * (7 * 4 + 2 * 8 + 1) + 2 * N * 4,
            sum(W * (2 * m + 10) for m in named_members(
                kw["bm_old"].tolist(), kw["bm_new"].tolist())))
        print(f"times at geometry (a) on {card}, N = {N} ({G} group(s) x "
              f"{R}), W = {W}: " + kernel_line("commit_window", window[N]),
              flush=True)
    return dict(commit_scan=scan, commit_window=window[R],
                commit_window_192=window[64 * R])


def phase_times(dev, card: str):
    """End to end at geometry (a): full batches through the stable step
    and through bursts, then the device and host profiles of ``step()``.
    Returns the CUDA kernels per ``step()`` and the profile they were
    counted in."""
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    geom, fanout = GEOMETRIES["a"]
    cfg = LogConfig(**geom)
    B = cfg.batch_slots
    c = SimCluster(cfg, R, fanout=fanout, device=dev)
    lead = c.run_until_elected(0)
    payload = b"x" * 16

    def feed(n):
        c.submit_many(lead, [(3, 1, 0, payload)] * n)

    feed(4 * B)
    for _ in range(4):
        c.step()
    rates = {}
    for mode in ("step", "burst"):
        n_disp = 40 if mode == "step" else 10
        torch.cuda.synchronize()
        s0 = c.step_index
        c0 = int(c.last["commit"][lead]) + c.rebased_total
        with alone():
            t0 = time.perf_counter()
            for _ in range(n_disp):
                feed(B if mode == "step" else 4 * B)
                c.step() if mode == "step" else c.step_burst()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        steps = c.step_index - s0
        committed = int(c.last["commit"][lead]) + c.rebased_total - c0
        rates[mode] = (steps / dt, committed / dt)

    def ten_steps():
        for _ in range(10):
            feed(B)
            c.step()
    wall_ms, sprof, busy_ms, n_kern, n_copy = launch_profile(ten_steps)
    print(f"launches per step() at geometry (a) on {card} (torch.profiler, "
          f"10 steps): {n_kern / 10:.1f} CUDA kernels, {n_copy / 10:.1f} "
          f"copies and memsets", flush=True)
    host = host_profile(ten_steps)
    top = sorted(sprof.items(), key=lambda kv: -kv[1][1])[:6]
    print(f"end to end at geometry (a) on {card}: step(): "
          f"{rates['step'][0]:.1f} steps/s {rates['step'][1]:.0f} committed "
          f"entries/s; step_burst(): {rates['burst'][0]:.1f} steps/s "
          f"{rates['burst'][1]:.0f} committed entries/s", flush=True)
    busy = (f"device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall, idle "
            f"share {1 - busy_ms / wall_ms:.3f}" if sprof else
            "device time not measured (the profiler saw none)")
    print(f"profile of 10 step() at geometry (a) on {card}: {busy}; top: "
          + "; ".join(f"{k[:60]} x{n} {us / 1e3:.3f} ms"
                      for k, (n, us) in top), flush=True)
    print(f"host profile of 10 step() at geometry (a) on {card} (cProfile, "
          f"inclusive ms per step; inflates Python-heavy code): "
          + ", ".join(f"{k} {v / 10:.2f}" for k, v in host.items()),
          flush=True)
    return n_kern / 10, sprof


# ---------------------------------------------------------------------------
# phase 6: the front door
# ---------------------------------------------------------------------------

FRONT_CONNS = 8
FRONT_EVENTS = 20480         # past one fused burst (an 8191-entry ring)
FRONT_BYTES = 100
TIMERS_OFF = dict(elec_timeout_low=1e9, elec_timeout_high=2e9)


def front_record(n: int, size: int, seed: int = SEED) -> list:
    """``n`` seeded payloads of ``size`` bytes."""
    rows = np.random.default_rng(seed).integers(0, 256, (n, size), np.uint8)
    return [r.tobytes() for r in rows]


# the driver's post-step host stages, for the host profile of (6a)
POST_STAGES = (("driver.py", "_post_step"),
               ("driver.py", "_apply_new_entries"),
               ("hostpath.py", "plan_segment"), ("proxy.py", "release"),
               ("metrics.py", "observe"), ("spans.py", "ack_release"),
               ("driver.py", "_observe_step"),
               ("driver.py", "_failure_detector"),
               ("driver.py", "_update_leader_view"))


def post_stages(pr) -> dict:
    """Inclusive ms of each :data:`POST_STAGES` function in a cProfile
    (the outermost of same-named functions of one file)."""
    import pstats
    out = dict.fromkeys(POST_STAGES, 0.0)
    for (f, _line, name), row in pstats.Stats(pr).stats.items():
        key = (Path(f).name, name)
        if key in out and "rdma_paxos_tpu_torch" in f:
            out[key] = max(out[key], row[3] * 1e3)
    return out


def drive_front_door(dev, geom: dict, fanout: str, payloads: list,
                     n_conns: int, pipeline: int, profile: str = "",
                     workdir=None, probe=None, stores: bool = False,
                     **variants) -> dict:
    """The pre-queued record through the leader's shim handler of a
    ``ClusterDriver`` on ``dev`` (the JAX idiom of
    ``tests/test_pipeline.py``): elect replica 0, queue a CONNECT per
    connection and every payload as a SEND, then run the loop until all
    are acked. Commit-window launches are counted from just before the
    loop starts to just after it stops. ``profile="device"`` runs the
    loop under ``torch.profiler``; ``profile="host"`` steps the serial
    loop on the calling thread under cProfile instead of running the
    loop threads (from Python 3.12 on, cProfile sees every thread, and
    its per-function times mix when two run Python at once).
    ``workdir`` and ``variants`` (``audit=``, ``telemetry=``) go to the
    driver; an audited run also reports its ledger and writes its audit
    artifact, a run with telemetry its device counters.
    ``profile="session"`` wraps the loop in the driver's own capture
    (``start_profile``/``stop_profile``, spans sampled and host phases
    recorded) and returns the merged timeline as ``merged``. ``probe``,
    when given, is called with the stopped driver and its result returned
    as ``probe``. ``stores`` (with a ``workdir``) waits until every
    replica's stable store holds the whole record and returns their bytes
    as ``stores``."""
    from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.proxy.proxy import PendingEvent
    from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
    d = ClusterDriver(LogConfig(**geom), R, fanout=fanout, pipeline=pipeline,
                      timeout_cfg=TimeoutConfig(**TIMERS_OFF), device=dev,
                      workdir=workdir, **variants)
    out = {}
    try:
        d.prewarm()
        d.runtimes[0].timer._deadline = 0.0
        d.step()
        check(d.leader() == 0, "replica 0 was not elected")
        hub = d.cluster.streams
        sub = hub.subscribe(0) if hub is not None else None
        bursts = []
        begin_burst = d.cluster.begin_burst

        def counted_burst(*a, **k):
            bursts.append(1)
            return begin_burst(*a, **k)
        d.cluster.begin_burst = counted_burst
        pr = None
        if profile == "host":
            import cProfile
            pr = cProfile.Profile()
        post_step, post_s = d._post_step, [0.0]

        def timed_post_step(res):
            t = time.perf_counter()
            try:
                return post_step(res)
            finally:
                post_s[0] += time.perf_counter() - t
        d._post_step = timed_post_step
        h = d._make_handler(0)
        conns = [(0 << 24) | (100 + i) for i in range(n_conns)]
        for c in conns:
            check(isinstance(h(2, c, b""), PendingEvent),
                  "the leader did not replicate a CONNECT")
        evs = [h(3, conns[i % n_conns], p) for i, p in enumerate(payloads)]
        check(all(isinstance(e, PendingEvent) for e in evs),
              "the leader refused a SEND")
        rel = np.zeros(len(evs))
        fired = np.zeros(len(evs), np.int64)

        def mark(i, _status):
            rel[i] = time.perf_counter()
            fired[i] += 1
        for i, e in enumerate(evs):
            e.attach(functools.partial(mark, i))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        commit_window.launches = 0
        steps0, bursts[:], post_s[0] = d.cluster.step_index, [], 0.0
        d._phase_prof.acc.clear()
        session = None
        if profile == "session":
            d._phase_prof.enable_events()
            session = d.start_profile(seconds=600, log_dir=os.path.join(
                workdir, "profile"))
        prof = None
        if profile == "device":
            from torch.profiler import ProfilerActivity, profile as tprof
            prof = tprof(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        with alone():
            t0 = time.perf_counter()
            if pr is not None:
                pr.enable()
                while not evs[-1].done.is_set():
                    check(time.perf_counter() - t0 < 300, "the record stalled")
                    d.step()
                pr.disable()
            else:
                d.run(period=0.001)
            for i, e in enumerate(evs):
                check(e.done.wait(300), f"event {i} was never acked")
            wall = float(rel.max()) - t0
            if prof is not None:
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
                prof.__exit__(None, None, None)
            if session is not None:
                t_stop = time.perf_counter()
                d.stop_profile()
                from rdma_paxos_tpu_torch.obs.device import merge_timeline
                out.update(
                    stop_s=time.perf_counter() - t_stop,
                    trace_mb=sum(os.path.getsize(f) for f in
                                 session.trace_files) / 2 ** 20,
                    merged=merge_timeline(
                        [d.obs.spans.dump()],
                        phase_events=list(d._phase_prof.events),
                        profiler=session))
            time.sleep(0.2)          # let the follower frontiers settle
        if stores:
            n_rec = n_conns + len(payloads)
            wait_for(lambda: all(len(rt.store) >= n_rec
                                 for rt in d.runtimes),
                     "every replica's store holding the record", 60)
            out["stores"] = [rt.store.dump() for rt in d.runtimes]
        if hub is not None:
            check(hub.watch.wait_caught_up({0: hub.tails[0].length()}),
                  "the watch pump never caught up")
            h = d.health()
            from rdma_paxos_tpu_torch.obs.health import validate_cluster
            out.update(health=h, missing=validate_cluster(h))
        d.stop()
        check(d.loop_error is None, f"the loop crashed: {d.loop_error!r}")
        if sub is not None:
            out.update(sub_closed=(sub.closed, sub.fail_reason),
                       hub=hub.status())
        out.update(
            launches=commit_window.launches,
            steps=d.cluster.step_index - steps0, bursts=len(bursts),
            wall=wall, fired=fired, statuses=[e.status for e in evs],
            latency=rel - np.array([e.t0 for e in evs]),
            hist=d.obs.metrics.get("commit_latency_seconds", replica=0),
            max_inflight=d.cluster.max_inflight_dispatches,
            post_step_ms=post_s[0] * 1e3, phases=d._phase_prof.sums(),
            streams=[list(s) for s in d.cluster.replayed],
            engine=type(d.cluster).__name__)
        if probe is not None:
            out["probe"] = probe(d)
        c = d.cluster
        out["commit_abs"] = (c.last["commit"].astype(np.int64)
                             + c.rebased_total).tolist()
        if c.auditor is not None:
            out["audit"] = c.auditor.summary()
            out["artifact"] = d._dump_audit_artifact("chip smoke (8c)")
        if c.device_counters is not None:
            out["device_committed"] = [d.obs.metrics.get(
                "device_committed_entries_total", replica=r)
                for r in range(R)]
        if pr is not None:
            out["host_ms"] = post_stages(pr)
        if prof is not None:
            kern = device_events(prof)
            out["kernels"] = sum(n for k, (n, _us) in kern.items()
                                 if not k.startswith(("Memcpy", "Memset")))
            out["busy_ms"] = sum(us for _n, us in kern.values()) / 1e3
            out["prof_wall_ms"] = prof_wall * 1e3
    finally:
        d.stop()
    return out


def hist_quantile(h: dict, q: float) -> float:
    """Upper bound of the bucket holding quantile ``q`` of a registry
    histogram (its ``as_dict`` form)."""
    total, acc = h["count"], 0
    for bound, n in h["buckets"].items():
        acc += n
        if acc >= q * total:
            return float("inf") if bound == "+Inf" else float(bound)
    return float("inf")


def phase_front_driver(dev, card: str) -> dict:
    """(6a): the pipelined driver at geometry (a) on the card."""
    geom, fanout = GEOMETRIES["a"]
    payloads = front_record(FRONT_EVENTS, FRONT_BYTES)
    runs = {}
    for name, d_, pl, prof in (("pipelined", dev, 2, ""),
                               ("serial", dev, 0, ""),
                               ("device-profiled", dev, 2, "device"),
                               ("host-profiled", dev, 0, "host"),
                               ("cpu serial", torch.device("cpu"), 0, "")):
        t = time.perf_counter()
        runs[name] = drive_front_door(d_, geom, fanout, payloads,
                                      FRONT_CONNS, pl, profile=prof)
        runs[name]["elapsed"] = time.perf_counter() - t
    ref = runs["cpu serial"]
    for name, r in runs.items():
        check(r["statuses"] == [0] * FRONT_EVENTS and (r["fired"] == 1).all(),
              f"{name}: not every event was acked once with status 0")
        sends = [p for (t, _c, _q, p) in r["streams"][0] if t == 3]
        check(sends == payloads,
              f"{name}: the committed SENDs are not the record in order")
        check(r["streams"][0] == ref["streams"][0],
              f"{name}: the committed stream differs from the CPU serial run")
        check(all(s == r["streams"][0] for s in r["streams"]),
              f"{name}: replicas committed different streams")
        # the CPU reference runs the plain version: no launch to count
        check(r["launches"] == r["steps"] > 0 or name == "cpu serial",
              f"{name}: {r['launches']} commit_window launches in "
              f"{r['steps']} protocol steps")
    for name in ("pipelined", "device-profiled"):
        check(runs[name]["max_inflight"] >= 2,
              f"{name}: the pipeline never overlapped dispatches")
    for name in ("pipelined", "serial"):
        r = runs[name]
        lat = np.sort(r["latency"])
        print(f"front door (6a) on {card}, geometry (a) fanout={fanout}, "
              f"{name} driver (pipeline={2 if name == 'pipelined' else 0}):"
              f" {FRONT_EVENTS} SEND events of {FRONT_BYTES} B on "
              f"{FRONT_CONNS} connections acked in {r['wall'] * 1e3:.1f} ms"
              f" = {FRONT_EVENTS / r['wall']:.0f} acked events/s; commit "
              f"latency (intake -> ack, pre-queued record) p50 "
              f"{lat[len(lat) // 2] * 1e3:.1f} ms p99 "
              f"{lat[int(len(lat) * 0.99)] * 1e3:.1f} ms exact, "
              f"commit_latency_seconds buckets p50 <= "
              f"{hist_quantile(r['hist'], 0.5)} s p99 <= "
              f"{hist_quantile(r['hist'], 0.99)} s; {r['bursts']} bursts "
              f"and {r['steps']} protocol steps dispatched, "
              f"{r['launches']} commit_window launches, "
              f"max_inflight_dispatches {r['max_inflight']}; _post_step "
              f"{r['post_step_ms'] * 1e3 / FRONT_EVENTS:.2f} us per acked "
              f"event (wall, on the "
              f"{'readback' if name == 'pipelined' else 'loop'} thread); "
              f"phases ms: " + ", ".join(
                  f"{k} {v['total_us'] / 1e3:.1f}"
                  for k, v in r["phases"].items()), flush=True)
    p = runs["device-profiled"]
    print(f"front door (6a) device profile on {card}: "
          f"{p['kernels'] / p['steps']:.1f} CUDA kernels per protocol step "
          f"({p['kernels']} in {p['steps']} steps, torch.profiler, "
          f"pipeline=2); device busy {p['busy_ms']:.2f} ms of "
          f"{p['prof_wall_ms']:.2f} ms wall, idle share "
          f"{1 - p['busy_ms'] / p['prof_wall_ms']:.3f}", flush=True)
    h = runs["host-profiled"]
    print(f"front door (6a) host profile on {card} (cProfile of the serial "
          f"loop stepped on one thread, inclusive us per acked event; "
          f"inflates Python): "
          + ", ".join(f"{k[1]} {v * 1e3 / FRONT_EVENTS:.2f}"
                      for k, v in h["host_ms"].items()), flush=True)
    print(f"front door (6a): committed streams of the card's runs equal the "
          f"CPU serial run's ({ref['elapsed']:.1f} s on the CPU)", flush=True)
    return dict(launches=runs["pipelined"]["launches"],
                steps=runs["pipelined"]["steps"])


NATIVE = ROOT / "native"
NATIVE_TARGETS = ("interpose.so", "libstablestore.so", "toyserver")


# The shim hooks read(); a C compiler that fortifies by default turns
# the toy app's reads into __read_chk, which the shim does not see (the
# app would then serve every request unreplicated), so the app is built
# unfortified.
APP_CC = "cc -U_FORTIFY_SOURCE"


def build_native() -> None:
    """Build the shim, the store and the toy app from ``native/`` (always
    rebuilt: a copied tree may carry binaries of another machine). Without
    ``make`` the Makefile's compile lines run directly."""
    tools = {t: shutil.which(t) for t in ("make", "g++", "cc")}
    print("native build tools: " + ", ".join(
        f"{t} {p or 'missing'}" for t, p in tools.items()), flush=True)
    if tools["make"]:
        cmds = [["make", "-B", "-C", str(NATIVE), f"CC={APP_CC}",
                 *NATIVE_TARGETS]]
    else:
        cxx = ["g++", "-O2", "-Wall", "-Wextra", "-fPIC", "-std=c++17",
               "-shared"]
        cmds = [cxx + ["-o", "interpose.so", "interpose.cpp", "-ldl",
                       "-lpthread"],
                cxx + ["-o", "libstablestore.so", "stablestore.cpp"],
                APP_CC.split() + ["-O2", "-Wall", "-pthread", "-o",
                                  "toyserver", "toyserver.c"]]
    for cmd in cmds:
        r = subprocess.run(cmd, cwd=NATIVE, capture_output=True, text=True)
        check(r.returncode == 0, f"{' '.join(cmd)} failed:\n{r.stderr}")


class AppClient:
    """A line-protocol TCP client of the toy app."""

    def __init__(self, port: int):
        self.s = socket.create_connection(("127.0.0.1", port), timeout=30)
        self.f = self.s.makefile("rb")

    def cmd(self, line: str) -> bytes:
        self.s.sendall(line.encode() + b"\n")
        return self.f.readline().strip()

    def close(self) -> None:
        for h in (self.f, self.s):
            h.close()


def app_get(port: int, key: str, want: bytes, timeout: float = 30.0):
    """GET ``key`` from the app on ``port`` until it answers ``want``."""
    deadline = time.time() + timeout
    got = None
    while time.time() < deadline:
        try:
            c = AppClient(port)
            got = c.cmd(f"GET {key}")
            c.close()
            if got == want:
                return got
        except OSError:
            pass
        time.sleep(0.05)
    return got


_HANDED_OUT: set = set()


def free_ports(n: int) -> list:
    """``n`` free localhost ports, none handed out before in this run (a
    world started beside another must not draw its port)."""
    ports: list = []
    while len(ports) < n:
        socks = [socket.socket() for _ in range(n - len(ports))]
        for s in socks:
            s.bind(("127.0.0.1", 0))
        ports += [p for p in (s.getsockname()[1] for s in socks)
                  if p not in _HANDED_OUT]
        for s in socks:
            s.close()
        _HANDED_OUT.update(ports)
    return ports


APP_CLIENTS = 4
APP_SETS = 1000


def front_state(d, apps, wd: str) -> str:
    """What the driver and the apps hold, for a failed check of (6b)."""
    c = d.cluster
    last = c.last or {}
    lines = [f"leader {d.leader()} loop_error {d.loop_error!r} "
             f"stepped_down {sorted(d.stepped_down)} need_recovery "
             f"{sorted(c.need_recovery)} steps {c.step_index}"]
    for k in ("role", "term", "commit", "end", "head"):
        lines.append(f"{k} {list(map(int, last.get(k, [])))}")
    for rt in d.runtimes:
        try:
            store = len(rt.store)
        except ValueError:                   # closed by stop()
            store = "closed"
        alive = (apps[rt.idx].poll() is None if rt.idx < len(apps)
                 else "not started")
        lines.append(
            f"replica {rt.idx}: applied {int(c.applied[rt.idx])} replayed "
            f"{len(c.replayed[rt.idx])} cursor {rt.replay_cursor} store "
            f"{store} app_dirty {rt.app_dirty} replay conns "
            f"{len(rt.replay.conns)} spec {rt.proxy.spec_mode} inflight "
            f"{len(rt.inflight)} app alive {alive}")
    snap = d.obs.metrics.snapshot()["counters"]
    lines.append("counters: " + ", ".join(
        f"{k}={v}" for k, v in snap.items() if "proxy" in k or "refused" in k
        or "failed" in k or "election" in k))
    for r in range(len(apps)):
        err = Path(wd, f"app{r}.err")
        if err.exists():
            lines.append(f"app {r} stderr: {err.read_text()[-400:]!r}")
    return "\n".join(lines)


def phase_front_apps(dev, card: str) -> dict:
    """(6b): interposed toy apps served by the driver on the card."""
    from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
    build_native()
    geom, _ = GEOMETRIES["a"]
    wd = tempfile.mkdtemp(prefix="rp-front-")
    ports = free_ports(R)
    d = ClusterDriver(LogConfig(**geom), R, workdir=wd, app_ports=ports,
                      fanout="gather", device=dev,
                      timeout_cfg=TimeoutConfig(elec_timeout_low=1.0,
                                                elec_timeout_high=2.0))
    apps = []
    try:
        d.prewarm()
        for r, port in enumerate(ports):
            env = dict(os.environ, LD_PRELOAD=str(NATIVE / "interpose.so"),
                       RP_PROXY_SOCK=os.path.join(wd, f"proxy{r}.sock"))
            with open(os.path.join(wd, f"app{r}.err"), "w") as err:
                apps.append(subprocess.Popen(
                    [str(NATIVE / "toyserver"), str(port)], env=env,
                    stderr=err))
        time.sleep(0.3)                      # let the apps bind
        commit_window.launches = 0
        steps0 = d.cluster.step_index
        d.run(period=0.002)
        deadline = time.time() + 60
        while d.leader() < 0 and time.time() < deadline:
            time.sleep(0.02)
        lead = d.leader()
        check(lead >= 0, "no leader was elected by the timers")
        lat, errors = [], []

        def client(k: int) -> None:
            try:
                c = AppClient(ports[lead])
                for i in range(APP_SETS // APP_CLIENTS):
                    t = time.perf_counter()
                    got = c.cmd(f"SET k{k}-{i} v{k}-{i}")
                    lat.append(time.perf_counter() - t)
                    if got != b"+OK":
                        errors.append((k, i, got))
                c.close()
            except OSError as exc:
                errors.append((k, exc))
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(APP_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        check(not errors and len(lat) == APP_SETS,
              f"client SETs failed: {errors[:4]}")
        followers = [r for r in range(R) if r != lead]
        n_each = APP_SETS // APP_CLIENTS
        # the committed stream reaches every replica's store and replay
        deadline = time.time() + 30
        while time.time() < deadline:
            lens = [len(rt.store) for rt in d.runtimes]
            if min(lens) == max(lens) and min(lens) >= APP_SETS + APP_CLIENTS:
                break
            time.sleep(0.05)
        for r in followers:
            for k in range(APP_CLIENTS):
                for i in (0, n_each // 2, n_each - 1):
                    want = f"v{k}-{i}".encode()
                    got = app_get(ports[r], f"k{k}-{i}", want)
                    check(got == want, f"replica {r}'s app answered {got} "
                                       f"for k{k}-{i}")
        # every replica persisted the same CONNECT/SEND/CLOSE stream
        deadline = time.time() + 30
        while time.time() < deadline:
            lens = [len(rt.store) for rt in d.runtimes]
            if min(lens) == max(lens) and min(lens) >= APP_SETS + 2 * APP_CLIENTS:
                break
            time.sleep(0.05)
        dumps = [rt.store.dump() for rt in d.runtimes]
        check(all(x == dumps[0] for x in dumps),
              f"replica stores differ (records {lens})")
        st = d.runtimes[lead].store
        kinds = [st.read(i)[0] for i in range(len(st))]
        counts = {k: kinds.count(k) for k in (2, 3, 4)}
        check(counts[2] >= APP_CLIENTS and counts[3] >= APP_SETS
              and counts[4] >= APP_CLIENTS,
              f"store record kinds {counts} lack the client stream")
        # failover: isolate the leader; the majority elects and serves
        d.cluster.partition([[lead], followers])
        deadline = time.time() + 60
        while time.time() < deadline and d.leader() in (-1, lead):
            time.sleep(0.02)
        new = d.leader()
        check(new in followers, "no failover after isolating the leader")
        c = AppClient(ports[new])
        check(c.cmd("GET k0-0") == b"v0-0", "the new leader lost a write")
        check(c.cmd("SET after failover-ok") == b"+OK",
              "the new leader did not serve a write")
        c.close()
        other = next(r for r in followers if r != new)
        check(app_get(ports[other], "after", b"failover-ok")
              == b"failover-ok", "the write did not reach the follower")
        d.stop()
        check(d.loop_error is None, f"the loop crashed: {d.loop_error!r}")
        launches = commit_window.launches
        steps = d.cluster.step_index - steps0
        check(launches == steps > 0, f"{launches} commit_window launches in "
                                     f"{steps} protocol steps")
    except Exception:
        print(front_state(d, apps, wd), flush=True)
        raise
    finally:
        d.stop()
        for a in apps:
            a.kill()
            a.wait()
        shutil.rmtree(wd, ignore_errors=True)
    lat = np.sort(np.array(lat))
    print(f"front door (6b) on {card}: 3 toyserver apps under "
          f"LD_PRELOAD=native/interpose.so, geometry (a) fanout=gather; "
          f"leader {lead} elected by the timers; {APP_SETS} SETs from "
          f"{APP_CLIENTS} clients in {wall:.2f} s = {APP_SETS / wall:.1f} "
          f"requests/s, request latency p50 {lat[len(lat) // 2] * 1e3:.2f} "
          f"ms p99 {lat[int(len(lat) * 0.99)] * 1e3:.2f} ms; read back from "
          f"replicas {followers}; {len(dumps[0])} store bytes equal on 3/3 "
          f"replicas (record kinds {counts}); failover to replica {new} "
          f"served a write that reached replica {other}; {launches} "
          f"commit_window launches in {steps} protocol steps", flush=True)
    return dict(launches=launches, steps=steps)


# ---------------------------------------------------------------------------
# phase 7: recovery
# ---------------------------------------------------------------------------

def state_digest(c) -> dict:
    """Per-field digests of a cluster's replica state (the 80 MiB ring
    rows of geometry (b) included) and its replay streams."""
    import hashlib
    from rdma_paxos_tpu_torch.convert import replica_state_to_numpy
    out = {k: hashlib.sha256(v.tobytes()).hexdigest()
           for k, v in replica_state_to_numpy(c.state).items()}
    out["replayed"] = [hashlib.sha256(repr(list(s)).encode()).hexdigest()
                       for s in c.replayed]
    out["applied"] = c.applied.tolist()
    return out


def catch_up(c, r: int, lead: int, limit: int = 40) -> int:
    """Step until replica ``r``'s end and commit equal the leader's;
    returns the protocol steps it took."""
    for k in range(1, limit + 1):
        res = c.step()
        if (int(res["end"][r]) == int(res["end"][lead])
                and int(res["commit"][r]) == int(res["commit"][lead])):
            return k
    raise RuntimeError(f"check failed: replica {r} did not catch up in "
                       f"{limit} steps (end {res['end'].tolist()}, commit "
                       f"{res['commit'].tolist()})")


def timed(dev, fn):
    """``fn()`` and its wall ms, the card synchronized on both sides."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    with alone():
        t = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
    return out, ms


def drive_recovery(dev, geom: dict, fanout: str, n_entries: int,
                   learner: bool) -> dict:
    """(7a) on ``dev``: a partitioned laggard falls ``n_entries`` behind
    (past the ring when ``n_entries > n_slots``: the gap reject leaves
    it stuck after heal); a healthy donor's snapshot is installed into
    it with its vote recovered from the peers, it catches up, and a
    later SEND replays on it. With ``learner``, a fresh learner (R + 1
    replicas, group of R) bootstraps from a snapshot of a scrolled ring,
    is admitted by a membership change, and keeps that config across a
    second install. Returns the state digests at each mark, the counts
    and the times."""
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.consensus.membership import MembershipManager
    from rdma_paxos_tpu_torch.consensus.snapshot import (
        install_snapshot, recover_vote, take_snapshot)
    from rdma_paxos_tpu_torch.runtime.hostpath import stream_copy
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    cfg = LogConfig(**geom)
    payloads = front_record(n_entries, 64, seed=SEED + 7)
    out = dict(marks=[], steps=0, catch_up=[], install_ms=[],
               catch_up_ms=[])

    def mark(c, tag):
        out["marks"].append((tag, state_digest(c)))

    def install(c, r, donor):
        vt, vf = recover_vote(c.state, r)
        snap = take_snapshot(c.state, donor, index=int(c.applied[donor]))
        c.state = install_snapshot(c.state, r, snap, voted_term=vt,
                                   voted_for=vf)
        c.applied[r] = snap.index
        # the host restored the donor's event history
        c.replayed[r] = stream_copy(c.replayed[donor])
        return snap

    c = SimCluster(cfg, R, fanout=fanout, device=dev)
    lag = R - 1
    c.run_until_elected(0)
    c.partition([list(range(R - 1)), [lag]])
    c.submit_many(0, [(3, 1 + i % 64, 0, p)
                      for i, p in enumerate(payloads)])
    while c.pending[0]:
        c.step_burst()
    for _ in range(2):
        c.step()
    pruned = n_entries > cfg.n_slots
    if pruned:
        check(int(c.last["head"][0]) > int(c.last["end"][lag]),
              "the leader's head did not pass the laggard's end")
    c.heal()
    for _ in range(4):
        res = c.step()
    check(int(res["end"][lag]) < int(res["end"][0]),
          f"the laggard was not left behind (end {res['end'].tolist()})")
    _, ms = timed(dev, lambda: install(c, lag, 1))
    out["install_ms"].append(ms)
    mark(c, "laggard install")
    k, ms = timed(dev, lambda: catch_up(c, lag, 0))
    out["catch_up"].append(k)
    out["catch_up_ms"].append(ms)
    c.submit(0, b"fresh-after-install")
    c.step()
    c.step()
    check(c.replayed[lag][-1][3] == b"fresh-after-install",
          "a SEND after the install did not replay on the laggard")
    check(all(list(s) == list(c.replayed[0]) for s in c.replayed),
          "replay streams differ after the laggard's catch-up")
    mark(c, "laggard catch-up")
    out["steps"] += c.step_index
    out["pruned"] = pruned

    if learner:
        c = SimCluster(cfg, R + 1, R, fanout=fanout, device=dev)
        mm = MembershipManager(c)
        c.run_until_elected(0)
        c.submit_many(0, [(3, 1 + i % 64, 0, p)
                          for i, p in enumerate(payloads)])
        while c.pending[0]:
            c.step_burst()
        c.step()
        check(int(c.last["head"][0]) > 0, "the ring never scrolled")
        _, ms = timed(dev, lambda: install(c, R, 0))
        out["install_ms"].append(ms)
        mark(c, "learner install")
        k, ms = timed(dev, lambda: catch_up(c, R, 0))
        out["catch_up"].append(k)
        out["catch_up_ms"].append(ms)
        full = (1 << (R + 1)) - 1
        mm.change(0, full)                    # admit the learner
        check(mm.current(R)["bitmask_new"] == full,
              "the learner did not adopt the membership change")
        install(c, R, 0)                      # a crash-restarted member
        check(mm.current(R)["bitmask_new"] == full,
              "the install lost the committed membership config")
        mark(c, "member re-install")
        catch_up(c, R, 0)
        c.submit(0, b"seen-by-learner")
        c.step()
        c.step()
        check(c.replayed[R][-1][3] == b"seen-by-learner",
              "a SEND after the install did not replay on the learner")
        mark(c, "learner catch-up")
        out["steps"] += c.step_index
    return out


def phase_recovery_engine(dev, card: str) -> dict:
    """(7a): snapshot recovery of the engine on the card, held bit-equal
    against the same seeded script on the CPU."""
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    launches = steps = 0
    cases = (("a", 3 * 8192 + 1000, True), ("b", 4 * 2048, False))
    twins = [TWINS.submit(drive_recovery, CPU, GEOMETRIES[geo][0], "gather",
                          n_entries, learner)
             for geo, n_entries, learner in cases]
    for (geo, n_entries, learner), twin in zip(cases, twins):
        geom, _ = GEOMETRIES[geo]
        commit_window.launches = commit_scan.launches = 0
        gpu = drive_recovery(dev, geom, "gather", n_entries, learner)
        check(commit_window.launches == gpu["steps"] > 0
              and commit_scan.launches == 0,
              f"({geo}): commit_window launched {commit_window.launches} "
              f"times and commit_scan {commit_scan.launches} times in "
              f"{gpu['steps']} protocol steps")
        launches += commit_window.launches
        steps += gpu["steps"]
        cpu = twin.get()
        check(cpu["steps"] == gpu["steps"]
              and cpu["catch_up"] == gpu["catch_up"],
              f"({geo}): the CPU run took {cpu['steps']} steps "
              f"(catch-up {cpu['catch_up']}), the card {gpu['steps']} "
              f"({gpu['catch_up']})")
        for (tag, g), (_, cp) in zip(gpu["marks"], cpu["marks"]):
            bad = [k for k in g if g[k] != cp[k]]
            check(not bad, f"({geo}) {tag}: the card's run differs from "
                           f"the CPU's in {bad}")
        print(f"recovery (7a) at geometry ({geo}) {geom} fanout=gather on "
              f"{card}: laggard {n_entries} entries behind "
              f"({'pruned past, gap reject checked' if gpu['pruned'] else 'within the ring'})"
              f"; install (take_snapshot + recover_vote + install_snapshot) "
              f"ms " + ", ".join(f"{x:.2f}" for x in gpu["install_ms"])
              + "; catch-up protocol steps "
              + ", ".join(map(str, gpu["catch_up"])) + " in ms "
              + ", ".join(f"{x:.2f}" for x in gpu["catch_up_ms"])
              + (" (laggard, learner)" if learner else " (laggard)")
              + f"; {commit_window.launches} commit_window launches in "
              f"{gpu['steps']} protocol steps, 0 commit_scan; replica state "
              f"and replay streams bit-equal to the CPU run at "
              f"{len(gpu['marks'])} marks ("
              + ", ".join(t for t, _ in gpu["marks"])
              + f"; {twin.seconds:.1f} s on the CPU)", flush=True)
    return dict(launches=launches, steps=steps)


def toy_dump(sock) -> bytes:
    """App checkpoint of the toy app: its DUMPALL listing."""
    sock.sendall(b"DUMPALL\n")
    f = sock.makefile("rb")
    out = []
    while True:
        ln = f.readline()
        if not ln or ln == b".\n":
            return b"".join(out)
        out.append(ln)


def toy_restore(sock, blob: bytes) -> None:
    """Rebuild the toy app from a DUMPALL listing with SETs."""
    f = sock.makefile("rb")
    for ln in blob.splitlines():
        if not ln.strip():
            continue
        sock.sendall(b"SET " + ln + b"\n")
        check(f.readline().strip() == b"+OK", "a checkpoint SET failed")


def toy_probe(sock) -> None:
    """Processed-input barrier: ECHO a unique token and wait for its
    reply, discarding replies to earlier replayed commands."""
    import uuid
    tok = uuid.uuid4().hex.encode()
    sock.sendall(b"ECHO " + tok + b"\n")
    buf = b""
    want = b"=" + tok
    while want not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            raise OSError("app closed during barrier probe")
        buf += chunk


def pipelined_sets(port: int, items, chunk: int = 256):
    """SET each ``(key, value)`` (bytes) on one connection, a chunk of
    lines at a time, then the chunk's replies. Returns the wall seconds
    and each reply's latency from its chunk's send, sorted."""
    c = AppClient(port)
    lat = []
    try:
        t = time.perf_counter()
        for i in range(0, len(items), chunk):
            part = items[i:i + chunk]
            t0 = time.perf_counter()
            c.s.sendall(b"".join(b"SET %s %s\n" % kv for kv in part))
            for k, _v in part:
                got = c.f.readline().strip()
                check(got == b"+OK", f"SET {k!r} answered {got!r}")
                lat.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t
    finally:
        c.close()
    return wall, np.sort(np.array(lat))


def wait_for(cond, what: str, timeout: float = 60.0) -> float:
    """Poll ``cond()`` until true; returns the seconds it took."""
    t = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t < timeout, f"timed out: {what}")
        time.sleep(0.02)
    return time.perf_counter() - t


def app_count(port: int) -> int:
    c = AppClient(port)
    try:
        return int(c.cmd("COUNT"))
    finally:
        c.close()


RECOVERY_SETS = 2000


def phase_recovery_apps(dev, card: str) -> dict:
    """(7b): checkpoint, recover_replica, reset_app and the automatic
    recovery of a force-pruned follower, with three interposed toy apps
    served by the driver on the card."""
    from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
    geom, _ = GEOMETRIES["a"]
    wd = tempfile.mkdtemp(prefix="rp-recovery-")
    ports = free_ports(R)
    # the drill intends no election after the first, which replica 0's
    # expired timer forces: every recovery runs inside the loop, and the
    # automatic one (a delta of ~17000 records into a live app) held the
    # loop past a 2 s timeout on a loaded host, deposing the leader
    d = ClusterDriver(LogConfig(**geom), R, workdir=wd, app_ports=ports,
                      fanout="gather", device=dev,
                      timeout_cfg=TimeoutConfig(elec_timeout_low=30.0,
                                                elec_timeout_high=60.0),
                      app_snapshot=(toy_dump, toy_restore, toy_probe))
    apps = [None] * R

    def spawn(r: int) -> None:
        env = dict(os.environ, LD_PRELOAD=str(NATIVE / "interpose.so"),
                   RP_PROXY_SOCK=os.path.join(wd, f"proxy{r}.sock"))
        with open(os.path.join(wd, f"app{r}.err"), "a") as err:
            apps[r] = subprocess.Popen([str(NATIVE / "toyserver"),
                                        str(ports[r])], env=env, stderr=err)

        def accepting() -> bool:
            try:
                socket.create_connection(("127.0.0.1", ports[r]),
                                         timeout=1).close()
                return True
            except OSError:
                return False
        wait_for(accepting, f"app {r} to accept", 30)

    def restart(r: int) -> None:
        apps[r].kill()
        apps[r].wait()
        spawn(r)

    def stores_settled() -> bool:
        lens = [len(rt.store) for rt in d.runtimes]
        return min(lens) == max(lens)

    def same_keys(r: int, keys) -> None:
        for k, v in keys:
            got = app_get(ports[r], k.decode(), v)
            check(got == v, f"replica {r}'s app answered {got} for {k!r}")

    out = {}
    try:
        d.prewarm()
        for r in range(R):
            spawn(r)
        commit_window.launches = 0
        steps0 = d.cluster.step_index
        d.runtimes[0].timer._deadline = 0.0
        d.run(period=0.002)
        wait_for(lambda: d.leader() >= 0, "a leader to be elected")
        lead = d.leader()
        f1, f2 = [r for r in range(R) if r != lead]

        def same_leader(what: str) -> None:
            check(d.leader() == lead, f"the leader moved from {lead} to "
                                      f"{d.leader()} during {what}")
        items = [(b"a%05d" % i, b"v%05d" % i) for i in range(RECOVERY_SETS)]
        sample = items[::397] + items[-1:]
        out["sets_s"] = pipelined_sets(ports[lead], items)[0]
        wait_for(stores_settled, "the stores to settle")
        for r in (f1, f2):
            same_keys(r, items[-1:])

        same_leader("the first SETs")
        # 2. checkpoint a follower: its store compacts behind the dump
        _, out["ckpt_ms"] = timed(dev, lambda: d.checkpoint_app(f1))
        st1 = d.runtimes[f1].store
        check(st1.base > 0, "the checkpoint did not compact the store")
        out["ckpt_bytes"] = len(d._read_ckpt(f1)[1])
        out["ckpt_base"] = st1.base

        # 3. a fresh app on f2, rebuilt by recover_replica
        restart(f2)
        _, out["recover_ms"] = timed(dev, lambda: d.recover_replica(f2))
        check(app_count(ports[f2]) == app_count(ports[lead]),
              "recover_replica: the rebuilt app's COUNT differs")
        same_keys(f2, sample)
        wait_for(stores_settled, "the stores to settle")
        st2 = d.runtimes[f2].store
        check(all(st2.read(i) == st1.read(i)
                  for i in range(st1.base, len(st1))),
              "f2's store differs from f1's past f1's checkpoint")
        out["store_bytes"] = len(st2.dump())

        # 4. a fresh app on f1, rebuilt from its checkpoint + suffix
        restart(f1)
        _, out["reset_ms"] = timed(dev, lambda: d.reset_app(f1))
        check(not d.runtimes[f1].app_dirty, "reset_app left the app dirty")
        check(app_count(ports[f1]) == app_count(ports[lead]),
              "reset_app: the rebuilt app's COUNT differs")
        same_keys(f1, sample)

        # 5. f2's apply wedges; the leader writes past twice the ring
        # (each SET line spans a 128-byte slot), forced pruning passes
        # f2, and on unwedge the driver recovers it into its live app
        d.cluster.wedge_apply(f2)
        n_big = 2 * geom["n_slots"] + 512
        big = [(b"b%06d" % i, b"%06d" % i + b"x" * 120)
               for i in range(n_big)]
        out["big_s"] = pipelined_sets(ports[lead], big)[0]
        out["big_sets"] = n_big
        t_unwedge = time.perf_counter()
        d.cluster.unwedge_apply(f2)
        wait_for(lambda: f2 not in d.cluster.need_recovery
                 and d.cluster.applied[f2] >= d.cluster.applied[lead] - 4,
                 "the automatic recovery of the force-pruned follower")
        out["auto_ms"] = (time.perf_counter() - t_unwedge) * 1e3
        same_leader("the automatic recovery")
        want = app_count(ports[lead])
        wait_for(lambda: app_count(ports[f2]) == want,
                 "the recovered app's COUNT to equal the leader's", 30)
        out["auto_app_ms"] = (time.perf_counter() - t_unwedge) * 1e3
        check(not d.runtimes[f2].app_dirty,
              "the automatic recovery quarantined the app")
        same_keys(f2, big[::4001] + big[-1:] + sample[:2])
        same_leader("the drill")
        d.stop()
        check(d.loop_error is None, f"the loop crashed: {d.loop_error!r}")
        out["launches"] = commit_window.launches
        out["steps"] = d.cluster.step_index - steps0
        check(out["launches"] == out["steps"] > 0,
              f"{out['launches']} commit_window launches in "
              f"{out['steps']} protocol steps")
        out.update(lead=lead, f1=f1, f2=f2)
    except Exception:
        print(front_state(d, [a for a in apps if a is not None], wd),
              flush=True)
        raise
    finally:
        d.stop()
        for a in apps:
            if a is not None:
                a.kill()
                a.wait()
        shutil.rmtree(wd, ignore_errors=True)
    print(f"recovery (7b) on {card}: 3 toyserver apps, geometry (a) "
          f"fanout=gather, leader {out['lead']}; {RECOVERY_SETS} pipelined "
          f"SETs in {out['sets_s']:.2f} s = "
          f"{RECOVERY_SETS / out['sets_s']:.0f} requests/s; "
          f"checkpoint_app({out['f1']}) {out['ckpt_ms']:.1f} ms (blob "
          f"{out['ckpt_bytes']} B, store compacted to record "
          f"{out['ckpt_base']}); recover_replica({out['f2']}) into a fresh "
          f"app {out['recover_ms']:.1f} ms (store {out['store_bytes']} B); "
          f"reset_app({out['f1']}) from checkpoint + suffix "
          f"{out['reset_ms']:.1f} ms; automatic recovery of force-pruned "
          f"replica {out['f2']} after {out['big_sets']} pipelined SETs "
          f"({out['big_s']:.2f} s = {out['big_sets'] / out['big_s']:.0f} "
          f"requests/s): {out['auto_ms']:.1f} ms from unwedge to the "
          f"driver's recovery done, {out['auto_app_ms']:.1f} ms to an equal "
          f"COUNT; every rebuilt app's COUNT equals the leader's; "
          f"{out['launches']} commit_window launches in {out['steps']} "
          f"protocol steps", flush=True)
    return dict(launches=out["launches"], steps=out["steps"])


# ---------------------------------------------------------------------------
# phase 8: the audit digest chain and device telemetry
# ---------------------------------------------------------------------------

def no_anchor(doc: dict) -> dict:
    """A dump without its process clock anchor (which differs by run)."""
    return {k: v for k, v in doc.items() if k != "anchor"}


def drive_audited(dev) -> dict:
    """(8a) on ``dev``: the main path's seeded SEND stream at geometry
    (a) on an ``audit=True, telemetry=True`` cluster; returns its ledger
    and flight dumps (without the anchor), ledger summary, device
    counters, absolute commits and protocol steps."""
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    geom, fanout = GEOMETRIES["a"]
    c = SimCluster(LogConfig(**geom), R, fanout=fanout, audit=True,
                   telemetry=True, device=dev)
    lead = c.run_until_elected(0)
    t0 = time.perf_counter()
    send_stream(c, lead, np.random.default_rng(SEED))
    for _ in range(3):                        # followers catch up
        c.step()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return dict(
        steps=c.step_index, wall=time.perf_counter() - t0,
        dump=no_anchor(c.auditor.dump()), summary=c.auditor.summary(),
        flight=no_anchor(c.flight.dump()),
        counters=c.device_counters.copy(), history=c.auditor.history,
        commit=c.last["commit"].astype(np.int64) + c.rebased_total)


# the host stages of an audited step with telemetry, for its profile
VARIANT_STAGES = ("step", "begin_step", "replica_step", "digest_fold",
                  "finish", "_readback", "_ingest_audit", "record_window",
                  "_record_flight", "reduce_steps", "ingest")

VARIANTS = (("neither", {}), ("audit", dict(audit=True)),
            ("telemetry", dict(telemetry=True)),
            ("both", dict(audit=True, telemetry=True)))


def variant_costs(dev) -> dict:
    """CUDA kernels, device busy ms and wall ms per ``step()`` at
    geometry (a) for each of :data:`VARIANTS`: phase 5's recipe (full
    batches through the stable step, ten steps under ``torch.profiler``,
    the larger count of two such windows),
    then 20 timed steps per setting in two rounds of alternating order,
    and a host profile of ten steps with both variants on."""
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    geom, fanout = GEOMETRIES["a"]
    cfg = LogConfig(**geom)
    B = cfg.batch_slots
    payload = b"x" * 16
    runs, rows = {}, {}
    for name, kw in VARIANTS:
        c = SimCluster(cfg, R, fanout=fanout, device=dev, **kw)
        lead = c.run_until_elected(0)

        def ten_steps(c=c, lead=lead):
            for _ in range(10):
                c.submit_many(lead, [(3, 1, 0, payload)] * B)
                c.step()
        c.submit_many(lead, [(3, 1, 0, payload)] * (4 * B))
        for _ in range(4):
            c.step()
        # two windows: the profiler's count has come one kernel short in
        # a window, never over (PERF.md §6)
        wins = [launch_profile(ten_steps) for _ in range(2)]
        _, sprof, busy_ms, n_kern, _ = max(wins, key=lambda w: w[3])
        runs[name] = ten_steps
        rows[name] = dict(kernels=n_kern / 10, busy_ms=busy_ms / 10, ms=[],
                          windows=[w[3] / 10 for w in wins], prof=sprof)
    names = [n for n, _ in VARIANTS]
    for order in (names, names[::-1]):
        for name in order:
            torch.cuda.synchronize()
            t = time.perf_counter()
            runs[name]()
            runs[name]()
            torch.cuda.synchronize()
            rows[name]["ms"].append((time.perf_counter() - t) * 1e3 / 20)
    rows["both"]["host"] = host_profile(runs["both"], VARIANT_STAGES)
    return rows


def drive_corruption(dev) -> dict:
    """(8b) on ``dev``: corrupt one payload word of replica 2's slot at
    its last applied index; the ledger must name that index and replica
    within 3 steps; replica 2's digest-carrying snapshot is refused by
    the verified install with the state untouched; replica 0's installs
    into replica 2, which catches up; ``redigest`` backfills replica 0's
    committed range with no new finding."""
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.consensus.snapshot import (
        SnapshotVerifyError, install_snapshot, recover_vote, take_snapshot)
    from rdma_paxos_tpu_torch.convert import replica_state_to_numpy
    from rdma_paxos_tpu_torch.runtime.hostpath import stream_copy
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    geom, fanout = GEOMETRIES["a"]
    cfg = LogConfig(**geom)
    c = SimCluster(cfg, R, fanout=fanout, audit=True, device=dev)
    lead = c.run_until_elected(0)
    payloads = front_record(2 * cfg.batch_slots, FRONT_BYTES, seed=SEED + 8)
    c.submit_many(lead, [(3, 1 + i % 8, 0, p)
                         for i, p in enumerate(payloads)])
    while c.pending[lead]:
        c.step()
    for _ in range(2):
        c.step()
    out = {}
    target = int(c.applied[2]) - 1
    c.state.log.buf[2, target & (cfg.n_slots - 1), 0] += 1
    for k in range(1, 4):
        c.step()
        first = c.auditor.first_divergence()
        if first is not None:
            out["found_in"] = k
            break
    check(first is not None, "the corruption was not found in 3 steps")
    check(first["index"] == target + c.rebased_total
          and first["got_replicas"] == [2],
          f"the ledger named index {first['index']} of replicas "
          f"{first['got_replicas']}, not {target} of [2]")
    n_find = len(c.auditor.findings)
    kw = dict(digests=True, rebased_total=c.rebased_total)
    bad = take_snapshot(c.state, 2, index=int(c.applied[2]), **kw)
    before = replica_state_to_numpy(c.state)
    t = time.perf_counter()
    try:
        install_snapshot(c.state, 1, bad, ledger=c.auditor)
        refused = None
    except SnapshotVerifyError as e:
        refused = str(e)
    out["refuse_ms"] = (time.perf_counter() - t) * 1e3
    check(refused is not None and "contradicts" in refused,
          f"the corrupted donor was not refused ({refused})")
    after = replica_state_to_numpy(c.state)
    check(all(np.array_equal(before[k], after[k]) for k in before),
          "the refused install touched the state")
    good = take_snapshot(c.state, 0, index=int(c.applied[0]), **kw)
    vt, vf = recover_vote(c.state, 2)

    def install():
        c.state = install_snapshot(c.state, 2, good, voted_term=vt,
                                   voted_for=vf, ledger=c.auditor)
        c.applied[2] = good.index
        c.replayed[2] = stream_copy(c.replayed[0])
    _, out["install_ms"] = timed(dev, install)
    out["catch_up"] = catch_up(c, 2, lead)
    lo, hi = int(c.last["head"][0]), int(c.last["commit"][0])
    b0 = c.auditor.summary()["backfilled"]
    n, out["redigest_ms"] = timed(dev, lambda: c.redigest(0, lo, hi))
    check(n == hi - lo > 0 and len(c.auditor.findings) == n_find
          and c.auditor.summary()["backfilled"] == b0 + n,
          f"redigest of [{lo}, {hi}) recorded {n}, findings "
          f"{n_find} -> {len(c.auditor.findings)}")
    out.update(
        steps=c.step_index, first=first, redigested=n, target=target,
        chains=[(s.audit_start, s.audit_digests.tolist())
                for s in (bad, good)],
        dump=no_anchor(c.auditor.dump()), state=state_digest(c))
    return out


def kernel_names_differ(a: dict, b: dict) -> dict:
    """``{name: (count in a, count in b)}`` of the CUDA kernels two
    profiles count differently."""
    names = {k for k in list(a) + list(b)
             if not k.startswith(("Memcpy", "Memset"))}
    return {k[:70]: (a.get(k, (0, 0))[0], b.get(k, (0, 0))[0])
            for k in sorted(names)
            if a.get(k, (0, 0))[0] != b.get(k, (0, 0))[0]}


def phase_audit(dev, card: str, kernels_per_step: float,
                ref_prof: dict) -> list:
    """Phase 8 on the card, each part against the same run on the CPU
    where it has one; returns the protocol steps and commit_window
    launches of its driven paths."""
    from rdma_paxos_tpu_torch.ops import quorum
    from rdma_paxos_tpu_torch.obs import device as obs_device
    runs = []
    geom, fanout = GEOMETRIES["a"]

    # (8a) the engine
    quorum.commit_window.launches = quorum.commit_scan.launches = 0
    gpu = drive_audited(dev)
    launches = quorum.commit_window.launches
    check(launches == gpu["steps"] > 0 and quorum.commit_scan.launches == 0,
          f"(8a): {launches} commit_window launches in {gpu['steps']} "
          f"protocol steps")
    runs.append(dict(launches=launches, steps=gpu["steps"]))
    t = time.perf_counter()
    cpu = drive_audited(torch.device("cpu"))
    for k in ("steps", "dump", "summary", "flight"):
        check(gpu[k] == cpu[k], f"(8a): the card's {k} differs from the CPU")
    check(np.array_equal(gpu["counters"], cpu["counters"]),
          "(8a): the card's device counters differ from the CPU's")
    s = gpu["summary"]
    check(s["findings"] == 0, f"(8a): {s['findings']} findings")
    # every replica digested every committed index once as new, and the
    # ledger retains the top of the chain
    check(s["indices_checked"] == int(gpu["commit"].sum()),
          f"(8a): {s['indices_checked']} indices checked for commits "
          f"{gpu['commit'].tolist()}")
    top = int(gpu["commit"].min())
    kept = {int(i) for i in gpu["dump"]["groups"][0]["indices"]}
    check(set(range(max(0, top - gpu["history"]), top)) <= kept,
          "(8a): a committed index below the frontier is not tracked")
    col = obs_device.INDEX["committed_entries"]
    check(np.array_equal(gpu["counters"][:, col], gpu["commit"]),
          "(8a): the committed_entries counters are not the commits")
    print(f"audit and telemetry (8a) at geometry (a) {geom} fanout={fanout} "
          f"on {card}: {gpu['steps']} protocol steps ({launches} "
          f"commit_window launches) in {gpu['wall']:.2f} s; "
          f"{s['indices_checked']} indices digested over {s['windows']} "
          f"windows, 0 findings; ledger dump and summary, flight ring and "
          f"device counters equal to the CPU run "
          f"({time.perf_counter() - t:.1f} s on the CPU); counters per "
          f"replica: " + "; ".join(
              ", ".join(f"{n} {int(v)}" for n, v in zip(obs_device.NAMES,
                                                        row))
              for row in gpu["counters"][:1]), flush=True)
    rows = variant_costs(dev)
    VARIANT_KERNELS.update({n: rows[n]["kernels"] for n, _ in VARIANTS})
    off = rows["neither"]
    diff = kernel_names_differ(ref_prof, off["prof"])
    # within the profiler's resolution: one kernel in the ten steps
    check(abs(off["kernels"] - kernels_per_step) <= 0.1 + 1e-9,
          f"(8a): {off['kernels']} kernels per step() with the variants "
          f"off, phase 5 counted {kernels_per_step}; differing kernel "
          f"counts (phase 5, 8a): {diff}")
    print(f"variants (8a): with the variants off {off['kernels']:.1f} CUDA "
          f"kernels per step() (windows " + ", ".join(
              f"{x:.1f}" for x in off["windows"]) + f"), phase 5 "
          f"{kernels_per_step:.1f}" + (f"; kernel counts that differ "
                                       f"(phase 5, 8a): {diff}" if diff
                                       else ""), flush=True)
    print(f"variants (8a) per step() at geometry (a) on {card} "
          f"(torch.profiler, the larger of two 10-step windows; wall ms "
          f"over 20 steps, two "
          f"rounds in alternating order): " + "; ".join(
              f"{n}: {r['kernels']:.1f} CUDA kernels, device busy "
              f"{r['busy_ms']:.3f} ms, wall ms "
              + ", ".join(f"{x:.2f}" for x in r["ms"])
              for n, r in rows.items()), flush=True)
    print(f"host profile (8a) of 10 step() with both variants at geometry "
          f"(a) on {card} (cProfile, inclusive ms per step; inflates "
          f"Python-heavy code): " + ", ".join(
              f"{k} {v / 10:.2f}" for k, v in rows["both"]["host"].items()),
          flush=True)

    # (8b) corruption and the verified install
    quorum.commit_window.launches = 0
    gpu = drive_corruption(dev)
    launches = quorum.commit_window.launches
    check(launches == gpu["steps"] > 0,
          f"(8b): {launches} commit_window launches in {gpu['steps']} "
          f"protocol steps")
    runs.append(dict(launches=launches, steps=gpu["steps"]))
    t = time.perf_counter()
    cpu = drive_corruption(torch.device("cpu"))
    for k in ("steps", "found_in", "first", "catch_up", "redigested",
              "chains", "dump", "state"):
        check(gpu[k] == cpu[k], f"(8b): the card's {k} differs from the CPU")
    print(f"audit (8b) at geometry (a) on {card}: a word of replica 2's "
          f"slot at index {gpu['target']} corrupted on the card, named "
          f"(index {gpu['first']['index']}, replicas "
          f"{gpu['first']['got_replicas']}, mode {gpu['first']['mode']}) "
          f"after {gpu['found_in']} step(s); replica 2's snapshot "
          f"({len(gpu['chains'][0][1])}-digest chain) refused in "
          f"{gpu['refuse_ms']:.2f} ms, state untouched; replica 0's "
          f"installed in {gpu['install_ms']:.2f} ms, caught up in "
          f"{gpu['catch_up']} step(s); redigest of {gpu['redigested']} "
          f"entries in {gpu['redigest_ms']:.2f} ms, no new finding; equal "
          f"to the CPU run ({time.perf_counter() - t:.1f} s on the CPU)",
          flush=True)

    # (8c) the driver
    payloads = front_record(FRONT_EVENTS, FRONT_BYTES)
    rates = {True: [], False: []}
    launches = steps = 0
    for on in (True, False, True, False):
        wd = tempfile.mkdtemp(prefix="rp-audit-")
        try:
            r = drive_front_door(dev, geom, fanout, payloads, FRONT_CONNS, 2,
                                 workdir=wd, audit=on, telemetry=on)
            tag = f"(8c) variants {'on' if on else 'off'}"
            check(r["statuses"] == [0] * FRONT_EVENTS
                  and (r["fired"] == 1).all(),
                  f"{tag}: not every event was acked once with status 0")
            sends = [p for (t_, _c, _q, p) in r["streams"][0] if t_ == 3]
            check(sends == payloads,
                  f"{tag}: the committed SENDs are not the record in order")
            check(r["launches"] == r["steps"] > 0,
                  f"{tag}: {r['launches']} commit_window launches in "
                  f"{r['steps']} protocol steps")
            if on:
                check(r["audit"]["findings"] == 0
                      and r["audit"]["indices_checked"] > 0,
                      f"{tag}: ledger {r['audit']}")
                check(r["device_committed"] == r["commit_abs"],
                      f"{tag}: device_committed_entries_total "
                      f"{r['device_committed']} for commits "
                      f"{r['commit_abs']}")
                art = r["artifact"]
                check(art is not None and Path(art).parent == Path(wd)
                      and Path(art).exists(),
                      f"{tag}: the audit artifact is {art}")
                cli = subprocess.run(
                    [sys.executable, "-m", "rdma_paxos_tpu_torch.obs.audit",
                     "report", art], cwd=ROOT, capture_output=True,
                    text=True, timeout=120)
                check(cli.returncode == 0,
                      f"{tag}: the audit CLI exited {cli.returncode}: "
                      f"{cli.stdout[-300:]} {cli.stderr[-300:]}")
                report = cli.stdout.strip().splitlines()[-1]
            rates[on].append(FRONT_EVENTS / r["wall"])
            launches += r["launches"]
            steps += r["steps"]
        finally:
            shutil.rmtree(wd, ignore_errors=True)
    runs.append(dict(launches=launches, steps=steps))

    def spread(xs):
        return (f"{', '.join(f'{x:.0f}' for x in xs)} (mean "
                f"{np.mean(xs):.0f}, spread {(max(xs) - min(xs)) / np.mean(xs):.3f})")
    print(f"audit and telemetry (8c) at geometry (a) on {card}: the (6a) "
          f"record ({FRONT_EVENTS} SENDs of {FRONT_BYTES} B, pipeline=2, "
          f"with a workdir) through ClusterDriver, runs in order on, off, "
          f"on, off: acked events/s with audit and telemetry on "
          f"{spread(rates[True])}; both off {spread(rates[False])}; every "
          f"event acked once with status 0 in submit order, ledger clean, "
          f"device_committed_entries_total equal to the commits, audit "
          f"artifact under the workdir, CLI: {report}", flush=True)
    return runs


# ---------------------------------------------------------------------------
# phase 9: the chaos judge on the card
# ---------------------------------------------------------------------------

# the read burst and the leaseholder crash of tests/test_reads.py
READ_BURST = dict(p_holder_read=0.9, p_follower_read=0.9)
CRASH_MID_READ = [dict(step=20, op="crash", replica=0),
                  dict(step=40, op="restart", replica=0)]
# (9b): geometry (a) with 16 clients on 16 keys. The JAX runner on the
# CPU decides every key at seed 7 over 200 steps for 8, 16, 32, 64,
# 128, 256 and 512 clients (as many keys; the slow-marked test
# tests/test_torch_chaos.py::test_geometry_a_jax_runner_decides_every_key
# repeats this search), so the phase's time budget
# bounds the size: the card folds each committed command into each
# replica's table with ~70 small launches, and at 64 clients the run
# took 56.8 s on an H100 80GB HBM3 at 700 W and its CPU twin 25.4 s
CHAOS_A = dict(seed=7, steps=200, n_clients=16, n_keys=16,
               kvs_cap=65536)
# tests/test_chaos.py:_BUG_RUN
BUG_RUN = dict(n_replicas=3, steps=80, n_keys=2,
               workload_opts=dict(dup_msg_p=0.9, dup_delay=6, p_write=0.6),
               fault_kinds=("partition", "crash"))


def buggy_fold(self, r):
    """``ReplicatedKVS._fold`` with the dedup skip removed (the bug
    under test of ``tests/test_chaos.py:_buggy_fold``): ``last_req`` is
    still tracked, but a duplicated PUT re-applies."""
    from rdma_paxos_tpu_torch.consensus.log import EntryType
    from rdma_paxos_tpu_torch.models.kvs import CMD_W, apply_cmd
    stream = self.c.replayed[r]
    while self._cursor[r] < len(stream):
        etype, conn, req, payload = stream[self._cursor[r]]
        self._cursor[r] += 1
        if etype != int(EntryType.SEND) or len(payload) != CMD_W * 4:
            continue
        if req > 0 and conn > 0:
            self.last_req[r][conn] = max(self.last_req[r].get(conn, 0),
                                         req)
        cmd = torch.from_numpy(np.frombuffer(payload, "<i4").copy()).to(
            self.device)
        self.tables[r], _ = apply_cmd(self.tables[r], cmd)


def chaos_run(dev, replay: Optional[str] = None, **kw) -> dict:
    """One seeded ``NemesisRunner`` run on ``dev`` (or the replay of an
    artifact); returns what is compared across devices, with its
    protocol steps, commit_window launches and wall time."""
    from rdma_paxos_tpu_torch.chaos.runner import NemesisRunner
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    launches0 = commit_window.launches, commit_scan.launches
    with alone():
        t0 = time.perf_counter()
        if replay is not None:
            runner = None
            v = NemesisRunner.replay(replay, device=dev)
        else:
            runner = NemesisRunner(device=dev, **kw)
            v = runner.run()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = dict(verdict={k: x for k, x in v.items() if k != "artifact"},
               artifact=v.get("artifact"), wall=wall,
               launches=commit_window.launches - launches0[0],
               scan_launches=commit_scan.launches - launches0[1])
    if runner is not None:
        c = runner.cluster
        out.update(steps=c.step_index, scan_dispatches=c.scan_dispatches,
                   inflight=c.max_inflight_dispatches,
                   history=runner.history.to_jsonl(),
                   ledger=json.dumps(no_anchor(c.auditor.dump()),
                                     sort_keys=True),
                   flight=json.dumps(no_anchor(c.flight.dump()),
                                     sort_keys=True))
    return out


def chaos_pair(dev, tag: str, card: str, profile: bool = False,
               **kw) -> dict:
    """:func:`chaos_run` on the card and on the CPU: equal verdicts,
    histories, ledgers and flight rings, one commit_window launch per
    protocol step on the card (and in the profiler's count when
    ``profile``); prints the run's line."""
    cuda_kernels = None
    twin = TWINS.submit(chaos_run, CPU, **kw)
    if profile:
        box = {}
        wall_ms, kprof = device_profile(lambda: box.update(
            gpu=chaos_run(dev, **kw)))
        gpu = box["gpu"]
        busy_ms = sum(us for _, us in kprof.values()) / 1e3
        cuda_kernels = sum(n for k, (n, _) in kprof.items()
                           if "commit_window_kernel" in k)
        if kprof:                    # else the profiler saw no kernel
            # the profiler may drop records (one run in twenty lost one
            # of 80), which only lowers its count: an extra launch still
            # shows, and the wrapper's exact count is checked below
            check(cuda_kernels <= gpu["steps"],
                  f"(9) {tag}: torch.profiler counted {cuda_kernels} "
                  f"commit_window kernels in {gpu['steps']} protocol "
                  f"steps")
    else:
        gpu = chaos_run(dev, **kw)
    check(gpu["launches"] == gpu["steps"] > 0
          and gpu["scan_launches"] == 0,
          f"(9) {tag}: {gpu['launches']} commit_window and "
          f"{gpu['scan_launches']} commit_scan launches in "
          f"{gpu['steps']} protocol steps")
    v = gpu["verdict"]
    check(v["ok"] is True and v["linearizability"]["undecided"] == [],
          f"(9) {tag}: verdict {v}")
    cpu = twin.get()
    for k in ("verdict", "history", "ledger", "flight", "steps"):
        check(gpu[k] == cpu[k], f"(9) {tag}: the card's {k} differs from "
                                f"the CPU run")
    reads = v["reads"]
    prof = ("the profiler saw no kernel" if profile and not cuda_kernels
            else f"{cuda_kernels} counted by torch.profiler, which also "
                 f"times this run: device busy {busy_ms:.1f} ms of "
                 f"{wall_ms:.1f}, idle share {1 - busy_ms / wall_ms:.3f}"
            if profile else None)
    print(f"chaos (9) {tag} on {card}: ok, {v['linearizability']['ops']} "
          f"checked ops, 0 undecided, {v['schedule_events']} fault "
          f"events; {gpu['steps']} protocol steps, {gpu['launches']} "
          f"commit_window launches" + (f" ({prof})" if prof else "")
          + f", {gpu['wall']:.2f} s, {gpu['steps'] / gpu['wall']:.1f} "
          f"steps/s on the card; reads by lease {reads['lease']}, by "
          f"read-index {reads['read_index']}; lease grants "
          f"{reads['leases']['grants']}, revocations "
          f"{reads['leases']['revocations']}; verdict, history, ledger "
          f"and flight ring equal to the CPU run "
          f"({twin.seconds:.1f} s on the CPU)", flush=True)
    return gpu


def driver_reads(dev, card: str) -> dict:
    """(9a) the driver's read queue on the card: a pipelined
    ``ClusterDriver`` with its default read path serves linearizable
    reads of a ``ReplicatedKVS`` on its readback thread (the serve
    callback runs torch ops there) without a ring slot."""
    from rdma_paxos_tpu_torch.chaos.runner import DEFAULT_KV_CFG
    from rdma_paxos_tpu_torch.config import TimeoutConfig
    from rdma_paxos_tpu_torch.models.replicated_kvs import ReplicatedKVS
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
    d = ClusterDriver(DEFAULT_KV_CFG, R, timeout_cfg=TimeoutConfig(
        elec_timeout_low=0.3, elec_timeout_high=0.6), pipeline=2,
        device=dev)
    kv = ReplicatedKVS(d.cluster, cap=256)
    d.prewarm()
    launches0 = commit_window.launches
    window = alone()
    window.__enter__()
    t0 = time.perf_counter()
    d.run(period=0.002)
    try:
        wait_for(lambda: d.leader() >= 0, "(9a) driver: a leader")
        lead = d.leader()
        sess = kv.session(client_id=5)
        commit0 = int(d.cluster.last["commit"][lead])
        keys = [b"key%d" % i for i in range(16)]
        for i, k in enumerate(keys):
            sess.put(lead, k, b"v%d" % i)
        wait_for(lambda: int(d.cluster.applied[lead]) >= commit0 + 16,
                 "(9a) driver: the puts applied on the leader")
        end0 = int(d.cluster.last["end"].max())
        tickets = []
        t1 = time.perf_counter()
        for k in keys:
            r = d.read_replica()
            tickets.append(d.read(lambda r=r, k=k: kv.serve_local(r, k),
                                  replica=r))
        read_s = time.perf_counter() - t1
        end1 = int(d.cluster.last["end"].max())
    finally:
        d.stop()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        window.__exit__(None, None, None)
    check(d.loop_error is None, f"(9a) driver: {d.loop_error!r}")
    got = [(t.status, t.value) for t in tickets]
    check(got == [("ok", b"v%d" % i) for i in range(16)],
          f"(9a) driver: reads {got}")
    paths = [t.path for t in tickets]
    check(set(paths) <= {"lease", "read_index"} and end1 == end0,
          f"(9a) driver: paths {paths}, end {end0} -> {end1}")
    steps = d.cluster.step_index
    launches = commit_window.launches - launches0
    check(launches == steps > 0, f"(9a) driver: {launches} commit_window "
                                 f"launches in {steps} protocol steps")
    print(f"chaos (9a) driver read queue on {card}: {len(tickets)} "
          f"linearizable reads of a ReplicatedKVS served on the readback "
          f"thread ({paths.count('lease')} by lease, "
          f"{paths.count('read_index')} by read-index) in {read_s:.3f} s, "
          f"every value the acknowledged put's, no ring slot (end "
          f"{end0} -> {end1}); {steps} protocol steps, {launches} "
          f"commit_window launches in {wall:.2f} s", flush=True)
    return dict(launches=launches, steps=steps)


def phase_chaos(dev, card: str) -> list:
    """Phase 9: the chaos judge on the card; returns the protocol steps
    and commit_window launches of its runs."""
    from rdma_paxos_tpu_torch.chaos.faults import FaultSchedule
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.models.replicated_kvs import ReplicatedKVS
    runs = []

    # (9a) the runner's defaults
    cases = [("(9a) seed 7", dict(seed=7, steps=50), True),
             ("(9a) seed 13", dict(seed=13, steps=50), False),
             ("(9a) seed 3, leaseholder crash in a read burst",
              dict(seed=3, steps=55, workload_opts=dict(READ_BURST),
                   schedule=CRASH_MID_READ), False),
             ("(9a) seed 7, pipeline=2", dict(seed=7, steps=50,
                                              pipeline=2), False),
             ("(9a) seed 13, scan=True", dict(seed=13, steps=50,
                                              scan=True), False)]
    for tag, kw, prof in cases:
        if "schedule" in kw:
            kw = dict(kw, schedule=FaultSchedule(kw["schedule"]))
        r = chaos_pair(dev, tag, card, profile=prof, **kw)
        reads = r["verdict"]["reads"]
        if "schedule" in kw:
            check(reads["lease"] > 0 and reads["read_index"] > 0
                  and reads["leases"]["grants"] >= 2
                  and reads["leases"]["revocations"] >= 1,
                  f"(9a) {tag}: reads {reads}")
        if kw.get("scan"):
            check(r["scan_dispatches"] > 0, f"(9a) {tag}: no scan dispatch")
        if kw.get("pipeline"):
            check(r["inflight"] >= 2, f"(9a) {tag}: never two dispatches "
                                      f"in flight")
        runs.append(r)
    runs.append(driver_reads(dev, card))

    # (9b) geometry (a)
    geom, _ = GEOMETRIES["a"]
    runs.append(chaos_pair(
        dev, f"(9b) geometry (a) {geom}, {CHAOS_A['n_clients']} clients "
             f"on {CHAOS_A['n_keys']} keys, seed {CHAOS_A['seed']}, "
             f"{CHAOS_A['steps']} steps", card,
        cfg=LogConfig(**geom), **CHAOS_A))

    # (9c) the dedup bug, caught on the card
    wd = tempfile.mkdtemp(prefix="rp-chaos-")
    fold = ReplicatedKVS._fold
    try:
        ReplicatedKVS._fold = buggy_fold
        art = os.path.join(wd, "dedup_bug.json")
        bug = chaos_run(dev, seed=1, artifact_path=art, **BUG_RUN)
        v = bug["verdict"]
        check(v["ok"] is False and v["invariant_violations"] == []
              and v["linearizability"]["ok"] is False
              and bug["artifact"] == art and os.path.exists(art),
              f"(9c): the dedup bug was not caught: {v}")
        cpu = chaos_run(torch.device("cpu"), seed=1, **BUG_RUN)
        for k in ("verdict", "history", "ledger", "flight", "steps"):
            check(bug[k] == cpu[k], f"(9c): the card's {k} differs from "
                                    f"the CPU run")
        rep = chaos_run(dev, replay=art)
        check(rep["verdict"]["linearizability"]["violations"]
              == v["linearizability"]["violations"],
              f"(9c): the replay found {rep['verdict']['linearizability']}")
    finally:
        ReplicatedKVS._fold = fold
        shutil.rmtree(wd, ignore_errors=True)
    clean = chaos_run(dev, seed=1, **BUG_RUN)
    check(clean["verdict"]["ok"] is True,
          f"(9c): the unpatched run is not clean: {clean['verdict']}")
    for r in (bug, clean):
        check(r["launches"] == r["steps"] > 0,
              f"(9c): {r['launches']} commit_window launches in "
              f"{r['steps']} protocol steps")
    check(rep["launches"] == bug["steps"],
          f"(9c): the replay launched commit_window {rep['launches']} "
          f"times for {bug['steps']} protocol steps")
    runs += [bug, dict(launches=rep["launches"], steps=bug["steps"]), clean]
    print(f"chaos (9c) on {card}: the dedup bug caught as a "
          f"linearizability violation on keys "
          f"{v['linearizability']['violations']} with no invariant "
          f"violation; verdict, history, ledger and flight ring equal to "
          f"the CPU run; the artifact replayed on the card to the same "
          f"violations; the unpatched run ok; {bug['steps']} + "
          f"{bug['steps']} + {clean['steps']} protocol steps, "
          f"{bug['launches'] + rep['launches'] + clean['launches']} "
          f"commit_window launches, {bug['wall']:.2f} + "
          f"{rep['wall']:.2f} + {clean['wall']:.2f} s on the card",
          flush=True)
    return [dict(launches=r["launches"], steps=r["steps"]) for r in runs]


# ---------------------------------------------------------------------------
# phase 10: groups
# ---------------------------------------------------------------------------

# benchmarks/shard_bench.py:53's geometry, the N = 64 x 3 = 192 case
SHARD_GEOM = dict(n_slots=2048, slot_bytes=128, window_slots=256,
                  batch_slots=256)
GROUP_FANOUT = "gather"
GROUP_KV_PUTS = 256
GROUP_CONNS_PER_REPLICA = 4
GROUP_EVENTS_PER_CONN = 2048


def group_sends(G: int, B: int) -> list:
    """Each group's seeded SEND stream: six full batches of payloads of
    1-128 bytes (lengths of a KVS command or a txn record skipped, as in
    :func:`send_stream`), from its own seed."""
    from rdma_paxos_tpu_torch.models.kvs import CMD_W
    from rdma_paxos_tpu_torch.models.replicated_kvs import TXN_CMD_W
    out = []
    for g in range(G):
        rng = np.random.default_rng(SEED + 100 + g)
        lens = rng.integers(1, 129, 6 * B)
        lens += np.isin(lens, (CMD_W * 4, TXN_CMD_W * 4))
        out.append([bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
                    for n in lens])
    return out


def drive_groups(dev, geom: dict, G: int, mesh=None,
                 batches: int = 2) -> dict:
    """(10a-10c) the group engine's main path on ``dev``: place the
    leaders round-robin, then every group's seeded SEND stream —
    ``batches`` batches through ``step()``, as many through
    ``step_burst()`` and through the scan tier — and three catch-up
    steps. Returns what the
    caller compares (with the launches counted from 0 over the run, and
    every dispatch's results). With ``mesh=(group_shards, R)`` the
    engine is the mesh engine on a list repeating ``dev`` (16b)."""
    from rdma_paxos_tpu_torch import convert
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.shard import ShardedCluster
    cfg = LogConfig(**geom)
    B = cfg.batch_slots
    sends = [s[:3 * batches * B] for s in group_sends(G, B)]
    c = ShardedCluster(cfg, R, G, fanout=GROUP_FANOUT, mesh=mesh,
                       device=dev if mesh is None
                       else [dev] * (mesh[0] * mesh[1]))
    results = []
    for name in ("step", "step_burst"):
        def recorded(*a, _fn=getattr(c, name), **k):
            res = _fn(*a, **k)
            results.append({k_: np.array(res[k_]) for k_ in c.RES_KEYS})
            return res
        setattr(c, name, recorded)
    commit_window.launches = commit_scan.launches = 0
    with alone():
        t0 = time.perf_counter()
        leaders = c.place_leaders()
        n_place = c.step_index
        check(leaders == [g % R for g in range(G)] and c.leaders() == leaders,
              f"G={G}: leader placement gave {c.leaders()}")

        def feed(lo, hi):
            for g in range(G):
                c.submit_many(g, leaders[g], [(3, 1 + i % 64, 0, p) for i, p in
                                              enumerate(sends[g][lo:hi], lo)])

        def busy():
            return any(q for row in c.pending for q in row)
        n = batches * B
        feed(0, n)
        while busy():
            c.step()
        feed(n, 2 * n)
        while busy():
            c.step_burst()
        c.scan = True
        feed(2 * n, 3 * n)
        while busy():
            c.step_burst()
        c.scan = False
        check(c.scan_dispatches > 0, f"G={G}: no scan dispatch")
        for _ in range(3):
            c.step()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, scans = commit_window.launches, commit_scan.launches
    for g in range(G):
        s0 = list(c.replayed[g][0])
        check(all(list(c.replayed[g][r]) == s0 for r in range(R)),
              f"G={G}: group {g}'s replicas committed different streams")
        check([p for (t, _c, _q, p) in s0 if t == 3] == sends[g],
              f"G={G}: group {g}'s committed SENDs are not its stream")
        check((c.applied[g] == c.last["commit"][g]).all(),
              f"G={G}: group {g} did not catch up")
    out = dict(steps=c.step_index, launches=launches, scans=scans,
               wall=wall, n_place=n_place, sends=sends,
               entries=int(sum(len(s) for s in sends)), results=results,
               replayed=[[list(s) for s in row] for row in c.replayed],
               state=convert.replica_state_to_numpy(c.state))
    c.close()
    return out


def drive_twin(dev, geom: dict, g: int, n_place: int, sends: list) -> dict:
    """Group ``g`` of :func:`drive_groups` as a single-group
    ``SimCluster`` fed only that group's inputs, dispatch for
    dispatch."""
    from rdma_paxos_tpu_torch import convert
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    cfg = LogConfig(**geom)
    B = cfg.batch_slots
    s = SimCluster(cfg, R, fanout=GROUP_FANOUT, device=dev)
    lead = g % R
    for _ in range(n_place):
        s.step(timeouts=[lead] if s.last is None or s.leader() != lead
               else [])
    for lo, mode in ((0, "step"), (2 * B, "burst"), (4 * B, "scan")):
        s.submit_many(lead, [(3, 1 + i % 64, 0, p) for i, p in
                             enumerate(sends[lo:lo + 2 * B], lo)])
        s.scan = mode == "scan"
        while s.pending[lead]:
            s.step() if mode == "step" else s.step_burst()
    s.scan = False
    for _ in range(3):
        s.step()
    return dict(replayed=[list(x) for x in s.replayed],
                state=convert.replica_state_to_numpy(s.state))


def compare_runs(tag: str, a: dict, b: dict, keys=("steps", "replayed")):
    for k in keys:
        check(a[k] == b[k], f"{tag}: {k} differs")
    for k, v in a["state"].items():
        check(np.array_equal(v, b["state"][k]),
              f"{tag}: state field {k} differs")


def op_count(fn) -> int:
    """The non-view PyTorch ops ``fn()`` dispatches — what decides the
    kernels it launches, counted exactly (``torch.profiler`` drops a
    few of the tens of thousands of kernel records of a long trace: one
    deterministic 80-step chaos run counted 70864–70890 kernels over 16
    profiles on an NVIDIA H100 80GB HBM3)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.n += 1
            return func(*args, **(kwargs or {}))
    with Count() as m:
        fn()
    return m.n


# the host stages of a group step, with the per-group loops of finish
GROUP_STAGES = ("step", "begin_step", "pack_rows", "_dev", "replica_step",
                "commit_window", "finish", "_readback", "_replay_committed",
                "decode_window", "_stamp_appends", "_observe",
                "leader_hint", "_maybe_rebase")


def group_times(dev, geom: dict, G: Optional[int], card: str,
                tag: str) -> dict:
    """Rates and profiles of the group engine on ``dev`` (full batches
    of 16-byte SENDs in every group; ``G=None``: the single-group
    ``SimCluster`` instead): steps/s and aggregate committed
    entries/s through ``step()`` and ``step_burst()``, CUDA kernels per
    ``step()``, the device idle share, the commit_window kernel's device
    time, and the cProfile of ``begin_step``/``finish``."""
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    from rdma_paxos_tpu_torch.shard import ShardedCluster
    cfg = LogConfig(**geom)
    B = cfg.batch_slots
    if G is not None:
        c = ShardedCluster(cfg, R, G, fanout=GROUP_FANOUT, device=dev)
        leaders = c.place_leaders()

        def feed(n):
            for g in range(G):
                c.submit_many(g, leaders[g], [(3, 1, 0, b"x" * 16)] * n)

        def committed():
            return int(sum(int(c.last["commit"][g, leaders[g]])
                           + int(c.rebased_total[g]) for g in range(G)))
    else:
        c = SimCluster(cfg, R, fanout=GROUP_FANOUT, device=dev)
        lead = c.run_until_elected(0)

        def feed(n):
            c.submit_many(lead, [(3, 1, 0, b"x" * 16)] * n)

        def committed():
            return int(c.last["commit"][lead]) + int(c.rebased_total)
    feed(2 * B)
    for _ in range(3):
        c.step()
    rates = {}
    for mode in ("step", "burst"):
        n_disp = 20 if mode == "step" else 5
        torch.cuda.synchronize()
        s0, c0 = c.step_index, committed()
        with alone():
            t0 = time.perf_counter()
            for _ in range(n_disp):
                feed(B if mode == "step" else 4 * B)
                c.step() if mode == "step" else c.step_burst()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        rates[mode] = ((c.step_index - s0) / dt, (committed() - c0) / dt)

    def ten_steps():
        for _ in range(10):
            feed(B)
            c.step()
    wall_ms, sprof, busy_ms, n_kern, n_copy = launch_profile(ten_steps)
    cw = [(n, us) for k, (n, us) in sprof.items()
          if "commit_window_kernel" in k]
    host = host_profile(ten_steps, GROUP_STAGES)
    ops = op_count(ten_steps) / 10
    out = dict(kernels=n_kern / 10, copies=n_copy / 10, ops=ops, rates=rates,
               busy_ms=busy_ms, wall_ms=wall_ms,
               idle=(1 - busy_ms / wall_ms) if sprof else None,
               cw_us=(cw[0][1] / cw[0][0]) if cw else None,
               cw_launches=cw[0][0] if cw else 0, host=host)
    if G is not None:
        loops = host["finish"] - host["_readback"]
        out["loop_share"] = loops / host["finish"] if host["finish"] else 0
        out["per_group_ms"] = loops / 10 / G
    name = "SimCluster" if G is None else f"G={G}"
    print(f"groups ({tag}) {name} at {geom} on {card}: step(): "
          f"{rates['step'][0]:.1f} steps/s {rates['step'][1]:.0f} "
          f"committed entries/s (all groups); step_burst(): "
          f"{rates['burst'][0]:.1f} steps/s {rates['burst'][1]:.0f} "
          f"committed entries/s; {out['kernels']:.1f} CUDA kernels and "
          f"{out['copies']:.1f} copies per step() (torch.profiler, 10 "
          f"steps), {ops:.1f} PyTorch ops dispatched per step(); device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms, "
          f"idle share "
          + (f"{out['idle']:.3f}" if out["idle"] is not None
             else "not measured")
          + "; commit_window "
          + (f"{out['cw_us']:.2f} us device time per launch, "
             f"{out['cw_launches']} launches in 10 steps"
             if cw else "not measured")
          + "; host ms per step (cProfile, inclusive): "
          + ", ".join(f"{k} {v / 10:.2f}" for k, v in host.items())
          + (f"; finish outside its readback: {out['loop_share']:.3f} of "
             f"finish, {out['per_group_ms']:.4f} ms per group per step"
             if G is not None else ""), flush=True)
    return out


def drive_group_kvs(dev) -> dict:
    """(10e) ``ShardedKVS`` at geometry (a), G = 4, with leases: 256 puts
    over ``keys_for_groups`` keys, then every key read from every replica
    of its group and linearizably from the group's leaseholder."""
    from rdma_paxos_tpu_torch import convert
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.obs import Observability
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.runtime import reads
    from rdma_paxos_tpu_torch.shard import ShardedCluster, ShardedKVS
    from rdma_paxos_tpu_torch.shard.chaos import keys_for_groups
    geom, _ = GEOMETRIES["a"]
    G = 4
    c = ShardedCluster(LogConfig(**geom), R, G, fanout=GROUP_FANOUT,
                       device=dev)
    c.obs = Observability()
    reads.attach(c)
    commit_window.launches = 0
    with alone():
        t0 = time.perf_counter()
        c.place_leaders()
        kv = ShardedKVS(c, cap=4096)
        keys = [k for ks in keys_for_groups(kv.router, GROUP_KV_PUTS // G)
                for k in ks]
        sess = kv.session(1)
        want = {}
        for k in keys:
            g, _ = sess.put(k, b"v-" + k)
            want[k] = (g, b"v-" + k)
        for _ in range(4):
            c.step()
        vals, lin = [], []
        for k, (g, v) in want.items():
            vals.append([kv.groups[g].get(r, k) for r in range(R)])
            lin.append(kv.get(k, linearizable=True))
        wall = time.perf_counter() - t0
    check(all(v == [want[k][1]] * R for k, v in zip(want, vals)),
          "(10e) a put did not read back from every replica of its group")
    check(lin == [v for _, v in want.values()],
          "(10e) a linearizable read disagrees")
    served = reads.read_counts(c.obs)
    check(served["lease"] > 0
          and served["lease"] + served["read_index"] == len(keys),
          f"(10e) linearizable reads served {served}")
    return dict(steps=c.step_index, launches=commit_window.launches,
                wall=wall, served=served,
                groups=sorted({g for g, _ in want.values()}),
                tables=[[convert.kv_state_to_numpy(t)
                         for t in kv.groups[g].tables] for g in range(G)])


def drive_sharded_driver(dev, pipeline: int, mesh=None, conns=None,
                         per_conn: int = GROUP_EVENTS_PER_CONN) -> dict:
    """(10f) ``ShardedClusterDriver`` at geometry (a), G = 4: the group
    timers elect round-robin, then pre-queued SENDs through all three
    replicas' shim handlers (a CONNECT held per connection, each
    connection's keys in one group) until every event is acked.
    ``conns`` lists each connection's replica (default
    ``GROUP_CONNS_PER_REPLICA`` on each), ``per_conn`` its SENDs; with
    ``mesh`` the cluster is the mesh engine on a list repeating ``dev``
    (16c)."""
    from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.proxy.proxy import PendingEvent
    from rdma_paxos_tpu_torch.runtime.sharded_driver import (
        ShardedClusterDriver)
    geom, _ = GEOMETRIES["a"]
    G = 4
    d = ShardedClusterDriver(LogConfig(**geom), R, G, fanout=GROUP_FANOUT,
                             pipeline=pipeline, mesh=mesh,
                             device=dev if mesh is None
                             else [dev] * (mesh[0] * mesh[1]),
                             timeout_cfg=TimeoutConfig(**TIMERS_OFF),
                             group_timer_lo=1, group_timer_hi=2)
    try:
        d.prewarm()
        for _ in range(20):
            if d.leader() >= 0:
                break
            d.step()
        check(d.leaders() == [g % R for g in range(G)],
              f"(10f) the group timers elected {d.leaders()}")
        handlers = [d._make_handler(r) for r in range(R)]
        evs, order = [], []
        if conns is None:
            conns = [r for r in range(R)
                     for _ in range(GROUP_CONNS_PER_REPLICA)]
        for tid, r in enumerate(conns):
            conn = (r << 24) | (300 + conns[:tid].count(r))
            check(handlers[r](2, conn, b"") == 0,
                  "(10f) a CONNECT was not held")
            g = d.router.group_of(b"k%d" % tid)
            for j in range(per_conn):
                p = (b"SET k%d-%d " % (tid, j)).ljust(FRONT_BYTES, b"v")
                ev = handlers[r](3, conn, p)
                check(isinstance(ev, PendingEvent),
                      "(10f) a SEND was refused")
                evs.append(ev)
                order.append((g, r))
        rel = np.zeros(len(evs))
        fired = np.zeros(len(evs), np.int64)

        def mark(i, _status):
            rel[i] = time.perf_counter()
            fired[i] += 1
        for i, e in enumerate(evs):
            e.attach(functools.partial(mark, i))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        commit_window.launches = 0
        steps0 = d.cluster.step_index
        with alone():
            t0 = time.perf_counter()
            d.run(period=0.001)
            for i, e in enumerate(evs):
                check(e.done.wait(300), f"(10f) event {i} was never acked")
            wall = float(rel.max()) - t0
        d.stop()
        check(d.loop_error is None, f"(10f) the loop crashed: "
                                    f"{d.loop_error!r}")
        check([e.status for e in evs] == [0] * len(evs)
              and (fired == 1).all(),
              "(10f) not every event was acked once with status 0")
        for g in range(G):
            for r in range(R):
                t = rel[[i for i, o in enumerate(order) if o == (g, r)]]
                check((np.diff(t) >= 0).all(),
                      f"(10f) group {g}'s acks on replica {r} out of order")
        c = d.cluster
        streams = [[list(s) for s in row] for row in c.replayed]
        for g in range(G):
            check(all(s == streams[g][0] for s in streams[g]),
                  f"(10f) group {g}'s replicas committed different streams")
        return dict(launches=commit_window.launches,
                    steps=c.step_index - steps0, wall=wall,
                    events=len(evs), streams=streams,
                    statuses=[e.status for e in evs],
                    max_inflight=c.max_inflight_dispatches,
                    engine=type(c).__name__)
    finally:
        d.stop()


def shard_nemesis(dev, seed: int, **kw) -> dict:
    """(10d) one ``ShardNemesisRunner`` run at G = 4 on ``dev``: its
    verdict, history, ledger, protocol steps, launches and wall time."""
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.shard.chaos import ShardNemesisRunner
    commit_window.launches = commit_scan.launches = 0
    with alone():
        t0 = time.perf_counter()
        r = ShardNemesisRunner(n_replicas=R, n_groups=4, seed=seed,
                               device=dev, **kw)
        v = r.run()
        wall = time.perf_counter() - t0
    return dict(verdict=json.dumps(v, sort_keys=True),
                history=r.history.to_jsonl(),
                ledger=json.dumps(no_anchor(r.shard.auditor.dump()),
                                  sort_keys=True),
                steps=r.shard.step_index, launches=commit_window.launches,
                scans=commit_scan.launches, wall=wall, v=v)


def phase_groups(dev, card: str, sim_kernels: float, times: dict) -> list:
    """Phase 10: G groups of R = 3 on the card with the gather fan-out;
    returns the protocol steps and commit_window launches of its
    main-path runs."""
    cpu = torch.device("cpu")
    geom_a, _ = GEOMETRIES["a"]
    runs = []

    # (10a) G = 1 against the single-group engine, results and kernels
    g1 = drive_groups(dev, geom_a, 1)
    check(g1["launches"] == g1["steps"] > 0 and g1["scans"] == 0,
          f"(10a) {g1['launches']} commit_window launches in "
          f"{g1['steps']} protocol steps")
    twin = drive_twin(dev, geom_a, 0, g1["n_place"], g1["sends"][0])
    check(twin["replayed"] == g1["replayed"][0],
          "(10a) G=1 replayed differently from the SimCluster")
    for k, v in twin["state"].items():
        check(np.array_equal(v, g1["state"][k][0]),
              f"(10a) G=1 state field {k} differs from the SimCluster")
    runs.append(g1)
    t_sim = group_times(dev, geom_a, None, card, "10a")
    t_g1 = group_times(dev, geom_a, 1, card, "10a")
    check(t_g1["ops"] == t_sim["ops"],
          f"(10a) G=1 dispatches {t_g1['ops']} ops per step(), the "
          f"SimCluster {t_sim['ops']}")
    print(f"groups (10a) on {card}: ShardedCluster(G=1) at geometry (a) "
          f"{GROUP_FANOUT}: {g1['steps']} protocol steps, {g1['launches']} "
          f"commit_window launches, {g1['entries']} SENDs, results and "
          f"state equal to the SimCluster on the card; "
          f"{t_g1['kernels']:.1f} CUDA kernels per step() against the "
          f"SimCluster's {t_sim['kernels']:.1f} (torch.profiler; phase 5, "
          f"psum: {sim_kernels:.1f}), the same {t_g1['ops']:.1f} PyTorch "
          f"ops dispatched per step() by both", flush=True)

    # (10b) G = 8 and (10c) G = 64: one launch per protocol step over
    # N = G x R, every group equal to the CPU run, one group to its twin
    per_g = {}
    cases = (("10b", geom_a, 8), ("10c", SHARD_GEOM, 64))
    twins = [TWINS.submit(drive_groups, cpu, geom, G) for _, geom, G in cases]
    for (tag, geom, G), cpu_twin in zip(cases, twins):
        gpu = drive_groups(dev, geom, G)
        check(gpu["launches"] == gpu["steps"] > 0 and gpu["scans"] == 0,
              f"({tag}) {gpu['launches']} commit_window launches in "
              f"{gpu['steps']} protocol steps")
        ref = cpu_twin.get()
        compare_runs(f"({tag}) the CPU run", gpu, ref)
        cpu_s = cpu_twin.seconds
        tg = G - 1
        twin = drive_twin(dev, geom, tg, gpu["n_place"], gpu["sends"][tg])
        check(twin["replayed"] == gpu["replayed"][tg],
              f"({tag}) group {tg} replayed differently from its twin")
        for k, v in twin["state"].items():
            check(np.array_equal(v, gpu["state"][k][tg]),
                  f"({tag}) group {tg}'s state field {k} differs from its "
                  f"twin")
        runs.append(gpu)
        per_g[G] = group_times(dev, geom, G, card, tag)
        check(per_g[G]["ops"] == t_g1["ops"],
              f"({tag}) G={G} dispatches {per_g[G]['ops']} ops per step(), "
              f"G=1 {t_g1['ops']}: the group step is not one pass")
        print(f"groups ({tag}) on {card}: G={G} at {geom} "
              f"{GROUP_FANOUT}: leaders placed round-robin, "
              f"{gpu['steps']} protocol steps, {gpu['launches']} "
              f"commit_window launches (one per step over N = "
              f"{G * R}), {gpu['entries']} SENDs in {gpu['wall']:.2f} s "
              f"on the card; every group equal to the CPU run "
              f"({cpu_s:.1f} s), group {tg} to its SimCluster twin on "
              f"the card; kernels per step() {per_g[G]['kernels']:.1f} "
              f"against G=1's {t_g1['kernels']:.1f} (torch.profiler), ops "
              f"dispatched per step() {per_g[G]['ops']:.1f} as at G=1",
              flush=True)
    syn = times.get("commit_window_192", {}).get("ms")
    own = per_g[64]["cw_us"]
    print(f"groups (10c) on {card}: commit_window at N = 192, W = "
          f"{SHARD_GEOM['window_slots']} on the main path "
          + (f"{own:.2f} us" if own is not None else "not measured")
          + " device time per launch (torch.profiler); phase 5's synthetic"
          f" N = 192, W = {geom_a['window_slots']}: "
          + (f"{syn * 1e3:.2f} us" if syn is not None else "not measured"),
          flush=True)

    # (10d) the shard nemesis, seeds 0 and 2, each with its CPU twin
    cases = ((0, dict(steps=40, crash_step=15)),
             (2, dict(steps=36, crash_step=14)))
    twins = [TWINS.submit(shard_nemesis, cpu, seed, **kw)
             for seed, kw in cases]
    for (seed, kw), cpu_twin in zip(cases, twins):
        g = shard_nemesis(dev, seed, **kw)
        c_ = cpu_twin.get()
        v = g["v"]
        for k in ("verdict", "history", "ledger", "steps"):
            check(g[k] == c_[k], f"(10d) seed {seed}: {k} differs from the "
                                 f"CPU run")
        f = v["frontiers"]
        check(v["ok"] and v["target_recovered"]
              and all(f["at_heal"][x] > f["at_crash"][x] for x in range(4)
                      if x != v["target_group"]),
              f"(10d) seed {seed}: {v}")
        check(g["launches"] == g["steps"] > 0 and g["scans"] == 0,
              f"(10d) seed {seed}: {g['launches']} launches in "
              f"{g['steps']} protocol steps")
        runs.append(g)
        print(f"groups (10d) on {card}: ShardNemesisRunner seed {seed} "
              f"G=4 {kw}: verdict ok, leader {v['crashed_leader']} of "
              f"group {v['target_group']} crashed and replaced by "
              f"{v['new_leader']}, the other groups' frontiers advanced "
              f"{f['at_crash']} -> {f['at_heal']}; verdict, history and "
              f"ledger equal to the CPU run; {g['steps']} protocol steps, "
              f"{g['launches']} commit_window launches, {g['wall']:.2f} s "
              f"on the card ({g['steps'] / g['wall']:.1f} steps/s), "
              f"{c_['wall']:.2f} s on the CPU", flush=True)

    # (10e) ShardedKVS
    twin = TWINS.submit(drive_group_kvs, cpu)
    kv = drive_group_kvs(dev)
    ref = twin.get()
    check(kv["steps"] == ref["steps"] and all(
        np.array_equal(a[k], b[k]) for ga, gb in zip(kv["tables"],
                                                      ref["tables"])
        for a, b in zip(ga, gb) for k in a),
        "(10e) the KVS tables differ from the CPU run")
    check(kv["launches"] == kv["steps"] > 0,
          f"(10e) {kv['launches']} launches in {kv['steps']} steps")
    runs.append(kv)
    print(f"groups (10e) on {card}: ShardedKVS G=4 at geometry (a): "
          f"{GROUP_KV_PUTS} session puts over groups {kv['groups']} read "
          f"back from 3/3 replicas of each group and by lease from each "
          f"leaseholder ({kv['served']}); tables equal to the CPU run; "
          f"{kv['steps']} protocol steps, {kv['launches']} commit_window "
          f"launches, {kv['wall']:.2f} s on the card", flush=True)

    # (10f) the sharded driver, pipelined on the card, serial on the CPU
    twin = TWINS.submit(drive_sharded_driver, cpu, pipeline=0)
    drv = drive_sharded_driver(dev, pipeline=2)
    ref = twin.get()
    check(drv["streams"] == ref["streams"],
          "(10f) the per-group committed streams differ from the CPU run")
    check(drv["launches"] == drv["steps"] > 0,
          f"(10f) {drv['launches']} launches in {drv['steps']} steps")
    runs.append(drv)
    print(f"groups (10f) on {card}: ShardedClusterDriver G=4 at geometry "
          f"(a), pipeline=2: {drv['events']} SEND events of {FRONT_BYTES} B"
          f" on {R * GROUP_CONNS_PER_REPLICA} connections through 3 "
          f"replicas acked once each with status 0, in order per group, "
          f"in {drv['wall'] * 1e3:.1f} ms = "
          f"{drv['events'] / drv['wall']:.0f} acked events/s; "
          f"{drv['steps']} protocol steps, {drv['launches']} "
          f"commit_window launches, max_inflight_dispatches "
          f"{drv['max_inflight']}; streams equal to the CPU serial run",
          flush=True)
    return [dict(launches=r["launches"], steps=r["steps"]) for r in runs]


# ---------------------------------------------------------------------------
# phase 11: transactions
# ---------------------------------------------------------------------------

TXN_G = 8                 # groups of (11a)/(11b), geometry (a)
TXN_PROBES = 12           # serial 2PC commits and single-key puts (11b)
# the merge A/B of benchmarks/run_bench.py:measure_txn (its defaults)
TXN_MERGE = dict(n_ops=400, n_keys=48, repeats=2, seed=17)
TXN_CID = 9
# the coordinator's host stages, for the host profile of (11b)
TXN_STAGES = ("step", "begin_step", "finish", "note_appends", "observe",
              "_observe_preparing", "_observe_decided", "_fold",
              "_fold_txn", "transact")


def txn_cluster(dev, G: int, kvs: bool = False):
    """A ``txn=True`` ``ShardedCluster`` of G groups at geometry (a)
    (gather), leaders placed round-robin; with ``kvs`` a ``ShardedKVS``
    and an attached coordinator too."""
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.obs import Observability
    from rdma_paxos_tpu_torch.shard import ShardedCluster, ShardedKVS
    from rdma_paxos_tpu_torch.txn import attach_coordinator
    geom, _ = GEOMETRIES["a"]
    c = ShardedCluster(LogConfig(**geom), R, G, txn=True,
                       fanout=GROUP_FANOUT, device=dev)
    c.obs = Observability()
    kv = coord = None
    if kvs:
        kv = ShardedKVS(c, cap=4096)
        coord = attach_coordinator(kv, timeout_steps=256)
    check(c.place_leaders() == [g % R for g in range(G)],
          f"(11) G={G}: leader placement gave {c.leaders()}")
    return c, kv, coord


def drive_vote_lane(dev) -> dict:
    """(11a) the vote lane at geometry (a), G = 8: every group's leader
    gets a prepare, watched at once (PENDING, then PREPARED once it
    commits); group 0's leader is partitioned alone first, so its
    prepare never commits and replica 1 takes over and commits over its
    index (CONFLICT), and after the heal the deposed leader converges
    (CONFLICT everywhere). Returns every step's results and the state."""
    from rdma_paxos_tpu_torch import convert
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    G = TXN_G
    c, _, _ = txn_cluster(dev, G)
    commit_window.launches = commit_scan.launches = 0
    s0 = c.step_index
    out = []

    def step(**kw):
        out.append(c.step(**kw))

    terms = [int(c.last["term"][g].max()) for g in range(G)]
    idx = [int(c.last["end"][g, g % R]) for g in range(G)]
    c.partition(0, [[0], [1, 2]])
    for g in range(G):
        c.submit(g, g % R, b"prepare-%d" % g)
        c.set_txn_watch(g, idx[g], terms[g])
    step()
    step()
    step(timeouts={0: [1]})
    c.submit(0, 1, b"over")
    for _ in range(3):
        step()
    c.heal(0)
    for _ in range(3):
        step()
    c.clear_txn_watch()
    step()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    votes = [r["txn_vote"].tolist() for r in out]
    return dict(steps=c.step_index - s0, launches=commit_window.launches,
                scans=commit_scan.launches, votes=votes,
                res=[{k: v.tolist() for k, v in r.items()} for r in out],
                state=convert.replica_state_to_numpy(c.state))


def txn_step_costs(dev, card: str) -> dict:
    """Kernels and wall ms per ``step()`` of G = 8 groups at geometry (a)
    with ``txn=False`` and ``txn=True`` (every group's watch armed on a
    committed entry), full batches of 16-byte SENDs in every group:
    dispatched PyTorch ops (exact) and CUDA kernels (torch.profiler) per
    step over 10 steps, and wall ms per step over two alternating rounds
    of 10 steps each."""
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.shard import ShardedCluster
    geom, _ = GEOMETRIES["a"]
    cfg = LogConfig(**geom)
    B, G = cfg.batch_slots, TXN_G
    cs = {}
    for txn in (False, True):
        c = ShardedCluster(cfg, R, G, txn=txn, fanout=GROUP_FANOUT,
                           device=dev)
        c.place_leaders()
        if txn:
            for g in range(G):
                c.set_txn_watch(g, int(c.last["commit"][g].max()) - 1,
                                int(c.last["term"][g].max()))
        cs[txn] = c

    def ten(c):
        for _ in range(10):
            for g in range(G):
                c.submit_many(g, g % R, [(3, 1, 0, b"x" * 16)] * B)
            c.step()
    for c in cs.values():
        ten(c)
    wall = {False: [], True: []}
    for txn in (False, True, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ten(cs[txn])
        torch.cuda.synchronize()
        wall[txn].append((time.perf_counter() - t0) * 1e3 / 10)
    out = {}
    for txn, c in cs.items():
        ops = op_count(lambda: ten(c)) / 10
        wall_ms, sprof, busy_ms, n_kern, _ = launch_profile(lambda: ten(c))
        out[txn] = dict(ops=ops, kernels=n_kern / 10, wall=wall[txn],
                        busy_ms=busy_ms / 10, prof_ms=wall_ms / 10,
                        votes=c.last.get("txn_vote"))
    check(out[True]["votes"] is not None
          and (out[True]["votes"] == 2).all(),
          "(11a) the armed watches did not vote PREPARED")
    off, on = out[False], out[True]
    print(f"txn (11a) on {card}: G={G} at geometry (a) {GROUP_FANOUT}, full "
          f"batches: PyTorch ops dispatched per step() {off['ops']:.1f} "
          f"with txn=False, {on['ops']:.1f} with txn=True (+"
          f"{on['ops'] - off['ops']:.1f}); CUDA kernels per step() "
          f"(torch.profiler, 10 steps) {off['kernels']:.1f} / "
          f"{on['kernels']:.1f}; device busy per step {off['busy_ms']:.3f} "
          f"/ {on['busy_ms']:.3f} ms; wall ms per step (two alternating "
          f"rounds of 10 steps) txn=False "
          + ", ".join(f"{w:.2f}" for w in off["wall"]) + "; txn=True "
          + ", ".join(f"{w:.2f}" for w in on["wall"]), flush=True)
    return out


def drive_txn_probes(dev, merge: bool) -> dict:
    """(11b) 2PC at geometry (a), G = 8 (``measure_txn``'s method): one
    warm-up transaction and a put per group, then :data:`TXN_PROBES`
    cross-group put-pair transactions each driven serially to completion
    and as many stamped single-key puts, counting protocol dispatches
    and wall time per commit; with ``merge``, the INCR fast path against
    plain puts, rounds alternating, each keeping its fastest round, and
    a host profile of four more 2PC commits. Returns what is compared
    with the CPU run and the numbers printed."""
    import random as _random
    from rdma_paxos_tpu_torch import convert
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.shard.chaos import keys_for_groups
    G = TXN_G
    shard, kv, coord = txn_cluster(dev, G, kvs=True)
    B = shard.cfg.batch_slots
    n_probe, n_keys = TXN_PROBES, TXN_MERGE["n_keys"]
    pools = keys_for_groups(kv.router, n_probe + 4 + n_keys // G + 2,
                            prefix=b"txb")
    commit_window.launches = commit_scan.launches = 0
    s0 = shard.step_index

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def probe_2pc(i):
        ga, gb = i % G, (i + 1) % G
        d0, t0 = shard.dispatches, time.perf_counter()
        h = kv.transact([("put", pools[ga][i], b"a%d" % i),
                         ("put", pools[gb][i], b"b%d" % i)])
        n = 0
        while not h.done and n < 64:
            shard.step()
            n += 1
        sync()
        check(h.committed, f"(11b) probe {i} aborted: {h.abort_reason}")
        return shard.dispatches - d0, time.perf_counter() - t0

    req = [0] * G

    def probe_put(i):
        g = i % G
        key = pools[g][n_probe + 5]
        req[g] += 1
        conn = kv.conn_for(TXN_CID, g)
        d0, t0 = shard.dispatches, time.perf_counter()
        kv.put(key, b"p%d" % i, client_id=TXN_CID, req_id=req[g])
        for _ in range(64):
            shard.step()
            lead = shard.leader_hint(g)
            kv.groups[g]._fold(lead)
            if kv.groups[g].last_req[lead].get(conn, 0) >= req[g]:
                break
        sync()
        return shard.dispatches - d0, time.perf_counter() - t0

    h = kv.transact([("put", pools[0][n_probe + 4], b"w"),
                     ("put", pools[1][n_probe + 4], b"w")])
    for _ in range(8):
        if h.done:
            break
        shard.step()
    check(h.committed, "(11b) the warm-up transaction did not commit")
    for g in range(G):
        req[g] = 1
        kv.put(pools[g][n_probe + 5], b"w", client_id=TXN_CID, req_id=1)
    shard.step()
    for g in range(G):
        kv.groups[g]._fold(shard.leader_hint(g))
    twopc = [probe_2pc(i) for i in range(n_probe)]
    single = [probe_put(i) for i in range(n_probe)]
    for g in range(G):
        kv.groups[g]._fold(shard.leader_hint(g))
    out = dict(twopc_dispatches=[d for d, _ in twopc],
               single_dispatches=[d for d, _ in single],
               twopc_s=float(np.mean([s for _, s in twopc])),
               single_s=float(np.mean([s for _, s in single])),
               health=coord.health(),
               tables=[convert.kv_state_to_numpy(
                   kv.groups[g].tables[shard.leader_hint(g)])
                   for g in range(G)])
    if merge:
        mkeys = [pools[i % G][n_probe + 6 + i // G] for i in range(n_keys)]
        mreq = [0] * G

        def run_round(variant, rep):
            rng = _random.Random(f"txnbench:{TXN_MERGE['seed']}:{rep}")
            order = [rng.randrange(n_keys)
                     for _ in range(TXN_MERGE["n_ops"])]
            busy = [None] * n_keys
            i = done = steps = 0
            t0 = time.perf_counter()
            while done < len(order):
                budget = B
                while i < len(order) and budget > 0:
                    k = order[i]
                    if busy[k] is not None:
                        break
                    if variant == "merge":
                        busy[k] = kv.transact([("incr", mkeys[k], 1)])
                    else:
                        g = kv.group_of(mkeys[k])
                        mreq[g] += 1
                        kv.put(mkeys[k], b"v%d" % i,
                               client_id=TXN_CID + 1, req_id=mreq[g])
                        busy[k] = (g, mreq[g])
                    i += 1
                    budget -= 1
                shard.step()
                steps += 1
                marks = {}
                for k, st in enumerate(busy):
                    if st is None:
                        continue
                    if variant == "merge":
                        if st.done:
                            check(st.committed, "(11b) a merge aborted")
                            busy[k] = None
                            done += 1
                        continue
                    g, q = st
                    if g not in marks:
                        lead = shard.leader_hint(g)
                        kv.groups[g]._fold(lead)
                        marks[g] = kv.groups[g].last_req[lead]
                    if marks[g].get(kv.conn_for(TXN_CID + 1, g), 0) >= q:
                        busy[k] = None
                        done += 1
            sync()
            dt = time.perf_counter() - t0
            return dict(seconds=dt, steps=steps, rate=done / dt)

        best = {}
        for rep in range(TXN_MERGE["repeats"]):
            for variant in ("plain", "merge"):
                r = run_round(variant, rep)
                if (variant not in best
                        or r["rate"] > best[variant]["rate"]):
                    best[variant] = r
        out["merge"] = best
        # fold the merge rounds first, so the profile's fold covers only
        # its own four commits
        for g in range(G):
            kv.groups[g]._fold(shard.leader_hint(g))
        n_host = 4
        steps_h = shard.step_index

        def host_run():
            for i in range(n_host):
                probe_2pc(n_probe + i)
            for g in range(G):
                kv.groups[g]._fold(shard.leader_hint(g))
        out["host"] = host_profile(host_run, TXN_STAGES)
        out["host_steps"] = shard.step_index - steps_h
    sync()
    out.update(steps=shard.step_index - s0, launches=commit_window.launches,
               scans=commit_scan.launches)
    return out


def txn_nemesis(dev, seed: int) -> dict:
    """(11c) one txn nemesis run at the JAX defaults on ``dev``."""
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.txn.chaos import TxnNemesisRunner
    commit_window.launches = commit_scan.launches = 0
    with alone():
        t0 = time.perf_counter()
        r = TxnNemesisRunner(seed=seed, device=dev)
        v = r.run()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return dict(v=v, verdict=json.dumps(v, sort_keys=True, default=str),
                history=r.history.to_jsonl(),
                merge=json.dumps(r._merge_summary(), sort_keys=True),
                steps=r.shard.step_index, launches=commit_window.launches,
                scans=commit_scan.launches, wall=wall)


def drive_txn_driver(dev) -> dict:
    """(11d) ``ShardedClusterDriver(txn=True, pipeline=2)`` at geometry
    (a), G = 2: the group timers elect, then its poll loop serves one
    put-pair and one INCR-pair transaction through the coordinator;
    then ``ClusterDriver(txn=True)`` is built, elects and steps."""
    from rdma_paxos_tpu_torch import convert
    from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
    from rdma_paxos_tpu_torch.models.kvs import OP_INCR
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
    from rdma_paxos_tpu_torch.runtime.sharded_driver import (
        ShardedClusterDriver)
    from rdma_paxos_tpu_torch.shard import ShardedKVS
    from rdma_paxos_tpu_torch.shard.chaos import keys_for_groups
    from rdma_paxos_tpu_torch.txn import attach_coordinator
    from rdma_paxos_tpu_torch.txn.merge import decode_merge_val
    geom, _ = GEOMETRIES["a"]
    G = 2
    d = ShardedClusterDriver(LogConfig(**geom), R, G, fanout=GROUP_FANOUT,
                             txn=True, pipeline=2, device=dev,
                             timeout_cfg=TimeoutConfig(**TIMERS_OFF),
                             group_timer_lo=1, group_timer_hi=2)
    try:
        kv = ShardedKVS(d.cluster, cap=4096)
        coord = attach_coordinator(kv, timeout_steps=512)
        d.prewarm()
        for _ in range(20):
            if d.leader() >= 0:
                break
            d.step()
        check(d.leaders() == [g % R for g in range(G)],
              f"(11d) the group timers elected {d.leaders()}")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        commit_window.launches = commit_scan.launches = 0
        s0 = d.cluster.step_index
        keys = keys_for_groups(kv.router, 4)
        with alone():
            t0 = time.perf_counter()
            d.run(period=0.002)
            hs = []
            for writes in ([("put", keys[0][0], b"live-a"),
                            ("put", keys[1][0], b"live-b")],
                           [("incr", keys[0][2], 7), ("incr", keys[1][2], 3)]):
                h = kv.transact(writes)
                t1 = time.perf_counter()
                while not h.done and time.perf_counter() - t1 < 60:
                    time.sleep(0.002)
                check(h.committed, f"(11d) {writes[0][0]} transaction: "
                                   f"{h.state} {h.abort_reason}")
                hs.append(time.perf_counter() - t1)
            wall = time.perf_counter() - t0
        st = d.health()
        d.stop()
        check(d.loop_error is None,
              f"(11d) the loop crashed: {d.loop_error!r}")
        vals = [kv.get(keys[0][0]), kv.get(keys[1][0]),
                decode_merge_val(OP_INCR, kv.get(keys[0][2])),
                decode_merge_val(OP_INCR, kv.get(keys[1][2]))]
        check(vals == [b"live-a", b"live-b", 7, 3],
              f"(11d) reads after the transactions: {vals}")
        check(st["txn"]["committed_total"] == 2 and st["txn"]["active"] == 0
              and st["txn"]["locks"] == 0 and st["txn"] == coord.health(),
              f"(11d) health()['txn'] = {st['txn']}")
        c = d.cluster
        out = dict(steps=c.step_index - s0, launches=commit_window.launches,
                   scans=commit_scan.launches, wall=wall, txn_s=hs,
                   vals=vals, health=st["txn"],
                   tables=[convert.kv_state_to_numpy(
                       kv.groups[g].tables[c.leader_hint(g)])
                       for g in range(G)])
    finally:
        d.stop()
    sd = ClusterDriver(LogConfig(**geom), R, fanout=GROUP_FANOUT, txn=True,
                       pipeline=0, device=dev,
                       timeout_cfg=TimeoutConfig(**TIMERS_OFF))
    try:
        launches0 = commit_window.launches
        s1 = sd.cluster.step_index
        sd.runtimes[0].timer._deadline = 0.0
        sd.step()
        sd.step()
        check(sd.leader() == 0
              and sd.cluster.last["txn_vote"].tolist() == [0] * R,
              f"(11d) ClusterDriver(txn=True): leader {sd.leader()}")
        out["single_steps"] = sd.cluster.step_index - s1
        out["steps"] += out["single_steps"]
        out["launches"] += commit_window.launches - launches0
    finally:
        sd.stop()
    return out


def phase_txn(dev, card: str) -> list:
    """Phase 11: transactions on the card, each run against its CPU
    twin; returns the protocol steps and commit_window launches of its
    main-path runs."""
    cpu = torch.device("cpu")
    runs = []

    def launches_ok(tag, r):
        check(r["launches"] == r["steps"] > 0 and r["scans"] == 0,
              f"({tag}) {r['launches']} commit_window and {r['scans']} "
              f"commit_scan launches in {r['steps']} protocol steps")
        runs.append(r)

    # (11a) the vote lane at full width
    t0 = time.perf_counter()
    gpu = drive_vote_lane(dev)
    launches_ok("11a", gpu)
    ref = drive_vote_lane(cpu)
    check(gpu["res"] == ref["res"], "(11a) step results (votes included) "
                                    "differ from the CPU run")
    for k, v in gpu["state"].items():
        check(np.array_equal(v, ref["state"][k]),
              f"(11a) state field {k} differs from the CPU run")
    vs = gpu["votes"]
    # the first step: each leader committed its prepare (followers one
    # step later) but group 0's, which is partitioned alone
    check(all(vs[0][g][g % R] == 2 and sorted(vs[0][g]) == [1, 1, 2]
              for g in range(1, TXN_G))
          and vs[0][0] == [1] * R
          and all(vs[1][g] == [2] * R for g in range(1, TXN_G))
          and vs[2][0][1] == 3 and vs[-2][0] == [3] * R
          and vs[-1] == [[0] * R] * TXN_G,
          f"(11a) votes {vs}")
    print(f"txn (11a) on {card}: ShardedCluster(txn=True) G={TXN_G} at "
          f"geometry (a) {GROUP_FANOUT}: votes PENDING then PREPARED in "
          f"groups 1-{TXN_G - 1}, group 0 {vs[0][0]} -> {vs[2][0]} (its "
          f"prepare overwritten by the failover leader) -> {vs[-2][0]} "
          f"after the heal; {gpu['steps']} protocol steps, "
          f"{gpu['launches']} commit_window launches; every step's [G, R] "
          f"votes and results and the state equal to the CPU run "
          f"({time.perf_counter() - t0:.1f} s both)", flush=True)
    txn_step_costs(dev, card)

    # (11b) 2PC at (a): dispatches per commit, latency, merge A/B
    gpu = drive_txn_probes(dev, merge=True)
    launches_ok("11b", gpu)
    t0 = time.perf_counter()
    ref = drive_txn_probes(cpu, merge=False)
    for k in ("twopc_dispatches", "single_dispatches", "health"):
        check(gpu[k] == ref[k], f"(11b) {k} {gpu[k]} differ from the CPU "
                                f"run's {ref[k]}")
    for a, b in zip(gpu["tables"], ref["tables"]):
        for k in a:
            check(np.array_equal(a[k], b[k]),
                  "(11b) the KVS tables differ from the CPU run")
    d2, d1 = np.mean(gpu["twopc_dispatches"]), np.mean(
        gpu["single_dispatches"])
    m = gpu["merge"]
    host = gpu["host"]
    n_h = gpu["host_steps"]
    print(f"txn (11b) on {card}: G={TXN_G} at geometry (a): "
          f"{TXN_PROBES} cross-group put-pair commits driven serially: "
          f"{d2:.2f} protocol dispatches per commit (each "
          f"{gpu['twopc_dispatches']}), {gpu['twopc_s'] * 1e3:.2f} ms per "
          f"commit; single-key put {d1:.2f} dispatches, "
          f"{gpu['single_s'] * 1e3:.2f} ms; latency ratio "
          f"{gpu['twopc_s'] / gpu['single_s']:.2f}; merge A/B "
          f"({TXN_MERGE['n_ops']} ops on {TXN_MERGE['n_keys']} keys, best "
          f"of {TXN_MERGE['repeats']} alternating rounds): merge "
          f"{m['merge']['rate']:.1f} writes/s in {m['merge']['steps']} "
          f"steps, plain {m['plain']['rate']:.1f} in {m['plain']['steps']},"
          f" ratio {m['merge']['rate'] / m['plain']['rate']:.3f}; "
          f"coordinator after the probes {gpu['health']}; dispatch counts, "
          f"coordinator and tables equal to the CPU run "
          f"({time.perf_counter() - t0:.1f} s on the CPU); "
          f"{gpu['steps']} protocol steps, {gpu['launches']} "
          f"commit_window launches", flush=True)
    print(f"txn (11b) host ms per protocol step over {n_h} steps of four "
          f"more 2PC commits (cProfile, inclusive): "
          + ", ".join(f"{k} {v / n_h:.3f}" for k, v in host.items()),
          flush=True)

    # (11c) the txn nemesis, seeds 0 and 1, each with its CPU twin; the
    # twins of (11c) and (11d) start here
    twins = [TWINS.submit(txn_nemesis, cpu, seed) for seed in (0, 1)]
    twins.append(TWINS.submit(drive_txn_driver, cpu))
    for seed in (0, 1):
        g = txn_nemesis(dev, seed)
        c_ = twins[seed].get()
        for k in ("verdict", "history", "merge", "steps"):
            check(g[k] == c_[k], f"(11c) seed {seed}: {k} differs from the "
                                 f"CPU run")
        v = g["v"]
        check(v["ok"] and v["txns"]["straddler"]["state"] == "aborted",
              f"(11c) seed {seed}: {v}")
        launches_ok("11c", g)
        print(f"txn (11c) on {card}: txn nemesis seed {seed} (G=3, leader "
              f"{v['crashed_leader']} of group {v['target_group']} crashed "
              f"mid-prepare): ok, {v['txns']['launched']} transactions, "
              f"{v['txns']['committed']} committed, straddler "
              f"{v['txns']['straddler']}, merge {v['merge']['values']}, "
              f"{v['linearizability']['ops']} checked ops; verdict, history "
              f"and merge summary equal to the CPU run; {g['steps']} "
              f"protocol steps, {g['launches']} commit_window launches, "
              f"{g['wall']:.2f} s on the card, {c_['wall']:.2f} s on the CPU",
              flush=True)

    # (11d) the live drivers
    gpu = drive_txn_driver(dev)
    launches_ok("11d", gpu)
    ref = twins[2].get()
    check(gpu["vals"] == ref["vals"] and gpu["health"] == ref["health"],
          "(11d) values or coordinator health differ from the CPU run")
    for a, b in zip(gpu["tables"], ref["tables"]):
        for k in a:
            check(np.array_equal(a[k], b[k]),
                  "(11d) the KVS tables differ from the CPU run")
    print(f"txn (11d) on {card}: ShardedClusterDriver(txn=True, "
          f"pipeline=2) G=2 at geometry (a): a put-pair and an INCR-pair "
          f"transaction through the poll loop committed in "
          + ", ".join(f"{s * 1e3:.1f}" for s in gpu["txn_s"])
          + f" ms; health()['txn'] {gpu['health']}; "
          f"{gpu['steps'] - gpu['single_steps']} protocol steps; "
          f"ClusterDriver(txn=True) elected and stepped "
          f"{gpu['single_steps']} steps; {gpu['launches']} commit_window "
          f"launches in all; values, health and tables equal to the CPU "
          f"run", flush=True)
    return [dict(launches=r["launches"], steps=r["steps"]) for r in runs]


# ---------------------------------------------------------------------------
# phase 12: the alert and health plane, repair and the governor
# ---------------------------------------------------------------------------

REPAIR_FANOUT = "gather"          # a quarantine is a peer-mask cut
REPAIR_GROUPS = 8
GOV_TICKS = 60
GOV_ROUNDS = 2


def repair_payloads(rng, n: int) -> list:
    """``n`` seeded SEND rows of 16 to 96 bytes."""
    return [(3, 1 + i % 64, 0,
             bytes(rng.integers(0, 256, int(k), dtype=np.uint8)))
            for i, k in enumerate(rng.integers(16, 97, n))]


def pump_repair(c, ctl, traffic, limit: int, until, times=None) -> list:
    """The drivers' repair contract on a bare engine: step, observe every
    finished step, run a due repair on the drained path. Returns each
    step's outputs; ``times`` collects (repair in flight, wall ms) per
    step."""
    log = []
    for _ in range(limit):
        traffic()
        busy = bool(ctl.states)
        res, ms = timed(c.device, c.step)
        ctl.observe()
        if ctl.needs_drain():
            ctl.drive()
        if times is not None:
            times.append((busy, ms))
        log.append({k: res[k].tolist() for k in
                    ("term", "role", "commit", "end", "head", "accepted")})
        if until():
            break
    return log


def drive_repair_engine(dev, case: str) -> dict:
    """(12a) on ``dev``: an audited ``SimCluster`` at geometry (a),
    gather, with a ``RepairController``. ``loop``: a follower's committed
    slot flipped and healed (quarantine, install from a majority donor,
    backfill, probation, re-admission), with the install and
    ``run_redigest`` timed and the wall ms of each audited step;
    ``retry``: the first donor corrupted too, at an index aged out of the
    live window; ``escalate``: every donor corrupted, so the controller
    escalates after ``max_attempts`` and the ``repair_failed`` page
    latches."""
    from rdma_paxos_tpu_torch.chaos.faults import corrupt_slot
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.obs import Observability
    from rdma_paxos_tpu_torch.obs.alerts import AlertEngine, default_rules
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.runtime.repair import RepairController
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    geom, _ = GEOMETRIES["a"]
    B = geom["batch_slots"]
    c = SimCluster(LogConfig(**geom), R, fanout=REPAIR_FANOUT, audit=True,
                   device=dev)
    obs = Observability()
    c.obs = obs
    opts = dict(probation_steps=4)
    if case == "escalate":
        opts.update(max_attempts=2, backoff_steps=2)
    ctl = RepairController(c, obs=obs, **opts)
    rng = np.random.default_rng(SEED + 12)
    commit_window.launches = commit_scan.launches = 0
    s0 = c.step_index
    c.run_until_elected(0)
    c.submit_many(0, repair_payloads(rng, B // 2))
    for _ in range(4):
        c.step()
        ctl.observe()
    if case != "loop":
        # age the early indices out of the [commit - W, commit) window
        # the live digests re-report: only install-time verification
        # can see a donor corrupted there
        c.submit_many(0, repair_payloads(rng, 2 * B + 64))
        while c.pending[0]:
            c.step()
            ctl.observe()
        c.step()
        ctl.observe()
    check(c.auditor.findings == [], f"(12a {case}) findings before the "
                                    f"flip: {c.auditor.findings[:1]}")
    target = int(c.last["commit"].min()) - 1
    corrupt_slot(c, 2, target)
    if case in ("retry", "escalate"):
        corrupt_slot(c, 0, 3)
    if case == "escalate":
        corrupt_slot(c, 1, 4)
    flip = c.step_index
    installs, redigests = [], []
    if case == "loop":
        inner_install, inner_redigest = ctl._install_from, c.redigest

        def install(*a):
            out, ms = timed(dev, lambda: inner_install(*a))
            installs.append(ms)
            return out

        def redigest(*a):
            out, ms = timed(dev, lambda: inner_redigest(*a))
            redigests.append(ms)
            return out
        ctl._install_from, c.redigest = install, redigest
    times = []
    until = ((lambda: ctl.escalations > 0) if case == "escalate"
             else (lambda: ctl.repairs_done and not ctl.states))
    log = pump_repair(c, ctl, lambda: c.submit_many(
        0, repair_payloads(rng, 32)), 48, until, times)
    done = c.step_index
    if case == "loop":
        # the same traffic with nothing to repair, for the step cost
        pump_repair(c, ctl, lambda: c.submit_many(
            0, repair_payloads(rng, 32)), 8, lambda: False, times)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    eng = AlertEngine(obs.metrics, rules=default_rules())
    fired = eng.evaluate()["fired"]
    st = ctl.status()
    out = dict(log=log, status=st, fired=fired,
               ledger=json.dumps(no_anchor(c.auditor.dump()),
                                 sort_keys=True, default=str),
               summary=c.auditor.summary(), target=target,
               mask=c.peer_mask.tolist(), repairs=c.auditor.repairs,
               steps=c.step_index - s0, launches=commit_window.launches,
               scans=commit_scan.launches, flip_to_done=done - flip,
               installs=installs, redigests=redigests, times=times)
    return out


def drive_repair_groups(dev) -> dict:
    """(12c) on ``dev``: ``ShardedCluster(G=8, audit=True)`` at geometry
    (a), gather: group 1's replica 1 is flipped and healed while every
    other group's commit frontier must advance strictly."""
    from rdma_paxos_tpu_torch.chaos.faults import corrupt_slot
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.runtime.repair import RepairController
    from rdma_paxos_tpu_torch.shard import ShardedCluster
    geom, _ = GEOMETRIES["a"]
    G = REPAIR_GROUPS
    sc = ShardedCluster(LogConfig(**geom), R, G, fanout=REPAIR_FANOUT,
                        audit=True, device=dev)
    ctl = RepairController(sc, probation_steps=3)
    rng = np.random.default_rng(SEED + 120)
    commit_window.launches = commit_scan.launches = 0
    s0 = sc.step_index
    sc.place_leaders()

    def traffic(n=16):
        for g in range(G):
            sc.submit_many(g, sc.leader_hint(g), repair_payloads(rng, n))
    traffic(64)
    for _ in range(4):
        sc.step()
        ctl.observe()
    target = int(sc.last["commit"][1].min()) - 1
    corrupt_slot(sc, 1, target, group=1)
    fronts = []

    def step_traffic():
        fronts.append([int(sc.last["commit"][g].max())
                       + int(sc.rebased_total[g]) for g in range(G)])
        traffic()
    log = pump_repair(sc, ctl, step_traffic, 48,
                      lambda: ctl.repairs_done and not ctl.states)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    fr = np.asarray(fronts)
    others = [g for g in range(G) if g != 1]
    return dict(log=log, status=ctl.status(), fronts=fronts,
                strict=bool((np.diff(fr[:, others], axis=0) > 0).all()),
                ledger=json.dumps(no_anchor(sc.auditor.dump()),
                                  sort_keys=True, default=str),
                summary=sc.auditor.summary(), repairs=sc.auditor.repairs,
                steps=sc.step_index - s0, launches=commit_window.launches,
                scans=commit_scan.launches)


def gov_trace(seed: int, n: int, B: int) -> list:
    """A seeded arrival trace in entries per tick: trickle, burst,
    trickle (the burst offers 1 to 5 batches a tick)."""
    rng = np.random.default_rng(seed)
    a, b = n // 3, 2 * n // 3
    return ([int(v) for v in rng.integers(0, B // 16, a)]
            + [int(v) for v in rng.integers(B, 5 * B, b - a)]
            + [int(v) for v in rng.integers(0, B // 16, n - b)])


def runs_of(xs: list) -> list:
    """Run-length pairs ``(value, count)`` of ``xs``."""
    out = []
    for x in xs:
        if out and out[-1][0] == x:
            out[-1][1] += 1
        else:
            out.append([x, 1])
    return [tuple(p) for p in out]


def governed_dispatch(c, gov):
    """The drivers' governed dispatch rule: a serial decision steps, a
    fused one bursts at its rung."""
    d = gov.decision
    if d.max_k > 1 and max(len(q) for q in c.pending):
        return c.step_burst(max_k=d.max_k)
    return c.step()


def drive_governor(dev) -> dict:
    """(12d) on ``dev``: a governed ``SimCluster`` at geometry (a),
    gather, under :func:`gov_trace`; ``ShardedCluster(G=8)`` with group
    0 loaded (per-group rungs); and the SLO shed through ``on_alert`` —
    the burn-rate pager drops the tier to serial, and it climbs again
    once the pager resolves."""
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.obs.alerts import AlertEngine, default_rules
    from rdma_paxos_tpu_torch.obs.metrics import (
        LATENCY_BUCKETS_S, MetricsRegistry)
    from rdma_paxos_tpu_torch.obs.series import TimeSeriesStore
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.runtime.governor import (
        SHED_RULE, attach_governor)
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    from rdma_paxos_tpu_torch.shard import ShardedCluster
    geom, _ = GEOMETRIES["a"]
    B = geom["batch_slots"]
    cfg = LogConfig(**geom)
    rng = np.random.default_rng(SEED + 1200)
    commit_window.launches = commit_scan.launches = 0
    c = SimCluster(cfg, R, fanout=REPAIR_FANOUT, device=dev)
    s_sim = c.step_index
    c.run_until_elected(0)
    reg = MetricsRegistry()
    store = TimeSeriesStore(capacity=256)
    eng = AlertEngine(reg, rules=default_rules(), series=store)
    gov = attach_governor(c, obs=None, alerts=eng)
    eng.add_hook(gov.on_alert)
    decisions, log = [], []
    for n in gov_trace(SEED, GOV_TICKS, B):
        if n:
            c.submit_many(0, repair_payloads(rng, n))
        res = governed_dispatch(c, gov)
        decisions.append(list(gov.decision))
        log.append({k: res[k].tolist() for k in ("commit", "end")})
    while int(c.last["commit"].min()) < int(c.last["end"].max()):
        governed_dispatch(c, gov)
    # the SLO shed: a scripted latency regression (injected walls, 5 s
    # apart) through the default burn-rate pager
    climbed = gov.decision.max_k
    w = [1000.0]
    marks = []

    def burn(n, latency, per, stop):
        for _ in range(n):
            for _ in range(per):
                reg.observe("commit_latency_seconds", latency,
                            buckets=LATENCY_BUCKETS_S, replica=0)
            store.sample(reg.snapshot(), step=store.samples, wall=w[0])
            w[0] += 5.0
            if SHED_RULE in eng.evaluate()[stop]:
                marks.append((stop, store.samples))
                return
    c.submit_many(0, repair_payloads(rng, 3 * B))
    governed_dispatch(c, gov)
    before = list(gov.decision)
    burn(10, 0.01, 20, "fired")
    burn(70, 2.0, 20, "fired")
    shed = list(gov.decision)
    c.submit_many(0, repair_payloads(rng, 3 * B))
    governed_dispatch(c, gov)
    held = list(gov.decision)
    burn(140, 0.01, 60, "resolved")
    for _ in range(3):
        c.submit_many(0, repair_payloads(rng, 3 * B))
        governed_dispatch(c, gov)
    after = list(gov.decision)
    while int(c.last["commit"].min()) < int(c.last["end"].max()):
        governed_dispatch(c, gov)
    sim_steps = c.step_index - s_sim
    # per-group rungs
    sc = ShardedCluster(cfg, R, REPAIR_GROUPS, fanout=REPAIR_FANOUT,
                        device=dev)
    s_sc = sc.step_index
    sc.place_leaders()
    sgov = attach_governor(sc, obs=None)
    rungs = []
    for _ in range(6):
        sc.submit_many(0, sc.leader_hint(0), repair_payloads(rng, 3 * B))
        d = sgov.decision
        sc.step_burst(max_k=d.max_k) if d.max_k > 1 else sc.step()
        rungs.append(list(sgov.decision))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return dict(decisions=decisions, log=log, status=gov.status(),
                climbed=climbed, before=before, shed=shed, held=held,
                after=after, marks=marks, rungs=rungs,
                sstatus=sgov.status(),
                replayed=[len(c.replayed[r]) for r in range(R)],
                steps=sim_steps + sc.step_index - s_sc,
                launches=commit_window.launches,
                scans=commit_scan.launches)


def governor_rates(dev, card: str) -> list:
    """(12d) committed entries/s on the card for one queued workload at
    geometry (a): governed against fixed serial and fixed max(K_TIERS),
    in alternating rounds; each round printed. Returns the rounds'
    protocol steps and launches."""
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.runtime.governor import attach_governor
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    geom, _ = GEOMETRIES["a"]
    B = geom["batch_slots"]
    cfg = LogConfig(**geom)
    rows = repair_payloads(np.random.default_rng(SEED + 7), 5 * B)
    loads = gov_trace(SEED + 1, 30, B)
    runs = []
    modes = ("governed", "serial", "burst16")
    for rnd in range(GOV_ROUNDS):
        rates = {}
        # each round runs the three in the other order than the last
        for mode in (modes if rnd % 2 == 0 else modes[::-1]):
            c = SimCluster(cfg, R, fanout=REPAIR_FANOUT, device=dev)
            c.run_until_elected(0)
            c.prewarm()
            gov = attach_governor(c, obs=None) if mode == "governed" \
                else None
            commit_window.launches = commit_scan.launches = 0
            s0 = c.step_index
            c0 = int(c.last["commit"].min())
            torch.cuda.synchronize()
            with alone():
                t0 = time.perf_counter()
                total = 0
                for n in loads:
                    if n:
                        c.submit_many(0, rows[:n])
                        total += n
                    if gov is not None:
                        governed_dispatch(c, gov)
                    elif mode == "burst16" and c.pending[0]:
                        c.step_burst(max_k=max(c.K_TIERS))
                    else:
                        c.step()
                while int(c.last["commit"].min()) - c0 < total:
                    if gov is not None:
                        governed_dispatch(c, gov)
                    elif mode == "burst16" and c.pending[0]:
                        c.step_burst(max_k=max(c.K_TIERS))
                    else:
                        c.step()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            runs.append(dict(steps=c.step_index - s0,
                             launches=commit_window.launches,
                             scans=commit_scan.launches))
            rates[mode] = (f"{mode} {total / dt:.0f} entries/s "
                           f"({c.step_index - s0} steps, "
                           f"{dt * 1e3:.1f} ms)")
        print(f"governor (12d) round {rnd + 1} on {card}: {len(loads)} "
              f"ticks of gov_trace, {total} entries, run "
              f"{'first to last' if rnd % 2 == 0 else 'last to first'}: "
              + "; ".join(rates[m] for m in modes), flush=True)
    return runs


def drive_repair_driver(dev, wd: str) -> dict:
    """(12e) on ``dev``: ``ClusterDriver(audit=True, repair=True)`` at
    geometry (a), gather, serial, with its LEADER corrupted: deposed,
    repaired through ``_do_recover`` and re-admitted; the
    ``digest_divergence`` page fires and writes the audit artifact, and
    ``health()`` passes ``validate_cluster``."""
    from rdma_paxos_tpu_torch.chaos.faults import corrupt_slot
    from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
    from rdma_paxos_tpu_torch.obs.health import validate_cluster
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
    geom, _ = GEOMETRIES["a"]
    rng = np.random.default_rng(SEED + 12000)
    os.makedirs(wd)
    d = ClusterDriver(LogConfig(**geom), R, fanout=REPAIR_FANOUT,
                      audit=True, repair=True, pipeline=0, device=dev,
                      workdir=wd, health_period=0.0,
                      repair_opts=dict(probation_steps=4),
                      timeout_cfg=TimeoutConfig(**TIMERS_OFF))
    try:
        d._alert_period = 1e9           # evaluated explicitly below
        commit_window.launches = commit_scan.launches = 0
        s0 = d.cluster.step_index
        d.runtimes[0].timer._deadline = 0.0
        log = [d.step()["role"].tolist()]
        check(d.leader() == 0, f"(12e) the driver elected {d.leader()}")
        for _ in range(4):
            d.cluster.submit_many(0, repair_payloads(rng, 64))
            d.step()
        target = int(d.cluster.last["commit"].min()) - 1
        corrupt_slot(d.cluster, 0, target)
        leaders, refused = [], []
        for _ in range(48):
            lead = d.leader()
            d.cluster.submit_many(lead if lead >= 0 else 1,
                                  repair_payloads(rng, 16))
            res = d.step()
            log.append({k: res[k].tolist() for k in
                        ("term", "role", "commit", "end")})
            leaders.append(d.leader())
            refused.append(not d._accepts_clients(0))
            if d.repair.repairs_done and not d.repair.states:
                break
        out = d.evaluate_alerts()
        h = d.health()
        scrape = None
        if dev.type == "cuda":
            import urllib.request
            exp = d.serve_metrics(0)
            with urllib.request.urlopen(exp.url + "/healthz",
                                        timeout=10) as r:
                hz = json.loads(r.read())
            with urllib.request.urlopen(exp.url + "/metrics",
                                        timeout=10) as r:
                metrics = r.read().decode()
            scrape = dict(healthz_ok=validate_cluster(hz) == [],
                          repairs=hz["repair"]["repairs_done"],
                          lines=len(metrics.splitlines()),
                          has_repairs="repairs_total" in metrics)
        return dict(log=log, leaders=leaders, refused=refused,
                    fired=out["fired"], status=d.repair.status(),
                    missing=validate_cluster(h),
                    audit=h["audit"], artifact=d.audit_artifact,
                    replayed=[list(d.cluster.replayed[r]) for r in range(R)],
                    scrape=scrape, steps=d.cluster.step_index - s0,
                    launches=commit_window.launches,
                    scans=commit_scan.launches)
    finally:
        d.stop()


def drive_governed_driver(dev) -> dict:
    """(12e) on ``dev``: ``ClusterDriver(governor=True, pipeline=2)`` at
    geometry (a), gather: elected, then a queued workload served by its
    live loop; the committed stream and the ``dispatch_tier``
    counters."""
    from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
    geom, _ = GEOMETRIES["a"]
    B = geom["batch_slots"]
    rows = repair_payloads(np.random.default_rng(SEED + 13000), 12 * B)
    d = ClusterDriver(LogConfig(**geom), R, fanout=REPAIR_FANOUT,
                      governor=True, pipeline=2, device=dev,
                      timeout_cfg=TimeoutConfig(**TIMERS_OFF))
    try:
        d.prewarm()
        d.runtimes[0].timer._deadline = 0.0
        d.step()
        check(d.leader() == 0, f"(12e) governed driver: leader "
                               f"{d.leader()}")
        commit_window.launches = commit_scan.launches = 0
        s0 = d.cluster.step_index
        c0 = int(d.cluster.last["commit"].min())
        t0 = time.perf_counter()
        d.run(period=0.002)
        for i in range(0, len(rows), B):
            d.cluster.submit_many(0, rows[i:i + B])
            d._wake.set()
            time.sleep(0.002)
        while int(d.cluster.last["commit"].min()) - c0 < len(rows):
            check(time.perf_counter() - t0 < 120,
                  "(12e) the governed driver never drained its workload")
            time.sleep(0.005)
        wall = time.perf_counter() - t0
        d.stop()
        check(d.loop_error is None, f"(12e) {d.loop_error!r}")
        tiers = {k: v for k, v in
                 d.obs.metrics.snapshot()["counters"].items()
                 if k.startswith("dispatch_tier")}
        return dict(tiers=tiers, wall=wall, n=len(rows),
                    inflight=d.cluster.max_inflight_dispatches,
                    committed=[list(d.cluster.replayed[r])[-len(rows):]
                               for r in range(R)],
                    governor=d.health()["governor"],
                    steps=d.cluster.step_index - s0,
                    launches=commit_window.launches,
                    scans=commit_scan.launches)
    finally:
        d.stop()


def drive_repair_sharded_driver(dev) -> dict:
    """(12e) on ``dev``: ``ShardedClusterDriver(G=2, audit=True,
    repair=True)`` at geometry (a), gather, serial: group 1's leader is
    corrupted and repaired while group 0 keeps committing."""
    from rdma_paxos_tpu_torch.chaos.faults import corrupt_slot
    from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
    from rdma_paxos_tpu_torch.obs.health import validate_cluster
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.runtime.sharded_driver import (
        ShardedClusterDriver)
    geom, _ = GEOMETRIES["a"]
    rng = np.random.default_rng(SEED + 14000)
    d = ShardedClusterDriver(LogConfig(**geom), R, 2, fanout=REPAIR_FANOUT,
                             audit=True, repair=True, pipeline=0,
                             device=dev, group_timer_lo=1,
                             group_timer_hi=2,
                             repair_opts=dict(probation_steps=3),
                             timeout_cfg=TimeoutConfig(**TIMERS_OFF))
    try:
        d._alert_period = 1e9
        commit_window.launches = commit_scan.launches = 0
        c = d.cluster
        s0 = c.step_index
        for _ in range(20):
            d.step()
            if all(v >= 0 for v in d.leaders()):
                break
        check(all(v >= 0 for v in d.leaders()),
              f"(12e) sharded driver leaders {d.leaders()}")
        for g in range(2):
            c.submit_many(g, d.leaders()[g], repair_payloads(rng, 64))
        for _ in range(4):
            d.step()
        lead1 = d.leaders()[1]
        target = int(c.last["commit"][1].min()) - 1
        corrupt_slot(c, lead1, target, group=1)
        g0, log = [], []
        for _ in range(60):
            g0.append(int(c.last["commit"][0].max())
                      + int(c.rebased_total[0]))
            lv = d.leaders()
            for g in range(2):
                if lv[g] >= 0:
                    c.submit_many(g, lv[g], repair_payloads(rng, 16))
            res = d.step()
            log.append({k: res[k].tolist() for k in
                        ("term", "role", "commit", "end")})
            if (d.repair.repairs_done and not d.repair.states
                    and all(v >= 0 for v in d.leaders())):
                break
        h = d.health()
        return dict(log=log, g0=g0, leaders=d.leaders(), lead1=lead1,
                    status=d.repair.status(), missing=validate_cluster(h),
                    summary=c.auditor.summary(),
                    steps=c.step_index - s0,
                    launches=commit_window.launches,
                    scans=commit_scan.launches)
    finally:
        d.stop()


def phase_repair_governor(dev, card: str) -> list:
    """Phase 12: repair and the governor on the card, each run against
    its CPU twin; returns the protocol steps and commit_window launches
    of its runs."""
    cpu = torch.device("cpu")
    runs = []

    def launches_ok(tag, r):
        check(r["launches"] == r["steps"] > 0 and r["scans"] == 0,
              f"({tag}) {r['launches']} commit_window and {r['scans']} "
              f"commit_scan launches in {r['steps']} protocol steps")
        runs.append(dict(launches=r["launches"], steps=r["steps"]))

    def same(tag, a, b, keys):
        for k in keys:
            check(a[k] == b[k], f"({tag}) {k} differs from the CPU run")

    # (12a) the engine's repair loop, the donor retry, the escalation
    t0 = time.perf_counter()
    res = {}
    for case in ("loop", "retry", "escalate"):
        g = drive_repair_engine(dev, case)
        ref = drive_repair_engine(cpu, case)
        same(f"12a {case}", g, ref, ("log", "status", "fired", "ledger",
                                     "summary", "mask", "repairs"))
        launches_ok(f"12a {case}", g)
        res[case] = g
    lp, rt, es = res["loop"], res["retry"], res["escalate"]
    core = [e["event"] for e in lp["status"]["timeline"]
            if e["event"] != "repair_backfill_pending"]
    check(core == ["replica_quarantined", "repair_installed",
                   "repair_backfilled", "repair_readmitted"]
          and lp["status"]["active"] == {}
          and lp["summary"]["unrepaired"] == 0
          and lp["repairs"][0]["replica"] == 2
          and np.asarray(lp["mask"]).all(),
          f"(12a loop) {lp['status']['timeline']}")
    rej = [e for e in rt["status"]["timeline"]
           if e["event"] == "repair_donor_rejected"]
    check(rt["status"]["repairs_done"] == 1 and rej and rej[0]["donor"] == 0
          and rej[0]["verify"] and rt["repairs"][0]["donor"] == 1,
          f"(12a retry) {rt['status']}")
    check(es["status"]["escalations"] == 1
          and es["status"]["active"]["0:2"]["state"] == "escalated"
          and "repair_failed" in es["fired"],
          f"(12a escalate) {es['status']} {es['fired']}")
    busy = [ms for b, ms in lp["times"] if b]
    idle = [ms for b, ms in lp["times"][-8:] if not b]
    print(f"repair (12a) on {card}: SimCluster(audit=True) at geometry (a) "
          f"{REPAIR_FANOUT}: replica 2's committed slot {lp['target']} "
          f"flipped, quarantined, installed from donor "
          f"{lp['repairs'][0]['donor']}, backfilled over "
          f"[{lp['repairs'][0]['lo']}, {lp['repairs'][0]['hi']}) and "
          f"re-admitted {lp['flip_to_done']} protocol steps after the flip;"
          f" install " + ", ".join(f"{ms:.2f}" for ms in lp["installs"])
          + " ms, run_redigest " + ", ".join(f"{ms:.2f}" for ms in
                                             lp["redigests"])
          + f" ms; wall ms per audited step with a repair in flight "
          f"{np.mean(busy):.2f} (n={len(busy)}, max {max(busy):.2f}) "
          f"against {np.mean(idle):.2f} without (n={len(idle)}); "
          f"corrupted-donor retry: donor 0 refused, repaired from donor "
          f"{rt['repairs'][0]['donor']}; escalation latched after "
          f"{es['status']['max_attempts']} attempts, repair_failed "
          f"fired; every step, status, ledger and alert equal to the CPU "
          f"run ({time.perf_counter() - t0:.1f} s both)", flush=True)

    # (12b) the repair nemesis, pipelined, two seeds
    kws = [dict(seed=seed, steps=36, fault_kinds=("drop",), repair=True,
                corrupt_step=12, pipeline=2) for seed in (3, 5)]
    twins = [TWINS.submit(chaos_run, cpu, **kw) for kw in kws]
    for seed, kw, twin in zip((3, 5), kws, twins):
        g = chaos_run(dev, **kw)
        c_ = twin.get()
        same(f"12b seed {seed}", g, c_, ("verdict", "history", "ledger",
                                         "steps"))
        v = g["verdict"]
        check(v["ok"] and v["repair"]["active"] == {}
              and v["audit"]["repairs"] == 1 and g["inflight"] >= 2,
              f"(12b) seed {seed}: {v}")
        g["scans"] = g["scan_launches"]
        launches_ok(f"12b seed {seed}", g)
        print(f"repair (12b) on {card}: repair nemesis seed {seed} "
              f"(pipeline=2, drop faults, replica {v['corrupted'][0]} "
              f"flipped at index {v['corrupted'][1]}): ok, "
              f"{len(v['repair']['timeline'])} timeline events ending "
              f"{v['repair']['timeline'][-1]['event']}, "
              f"{v['linearizability']['ops']} checked ops; verdict, "
              f"history and ledger equal to the CPU run; {g['steps']} "
              f"protocol steps, {g['wall']:.2f} s on the card, "
              f"{c_['wall']:.2f} s on the CPU", flush=True)

    # (12c) groups: one group's replica repaired, the others advancing
    t0 = time.perf_counter()
    g = drive_repair_groups(dev)
    ref = drive_repair_groups(cpu)
    same("12c", g, ref, ("log", "status", "fronts", "ledger", "summary",
                         "repairs"))
    check(g["strict"] and g["status"]["repairs_done"] == 1
          and g["status"]["active"] == {} and g["repairs"][0]["group"] == 1
          and g["summary"]["unrepaired"] == 0,
          f"(12c) {g['status']} strict={g['strict']}")
    launches_ok("12c", g)
    print(f"repair (12c) on {card}: ShardedCluster(G={REPAIR_GROUPS}, "
          f"audit=True) at geometry (a): group 1 replica 1 repaired in "
          f"{len(g['log'])} steps while the other {REPAIR_GROUPS - 1} "
          f"groups' commit frontiers advanced every step; every group "
          f"equal to the CPU run; {g['steps']} protocol steps, "
          f"{g['launches']} commit_window launches "
          f"({time.perf_counter() - t0:.1f} s both)", flush=True)

    # (12d) the governor
    t0 = time.perf_counter()
    twin = TWINS.submit(drive_governor, cpu)
    g = drive_governor(dev)
    ref = twin.get()
    same("12d", g, ref, ("decisions", "log", "status", "before", "shed",
                         "held", "after", "marks", "rungs", "sstatus",
                         "replayed"))
    tiers = [d[1] for d in g["decisions"]]
    check(max(tiers) > 1 and tiers[-1] < max(tiers), f"(12d) tiers {tiers}")
    check(g["shed"][4] and g["shed"][1] == 1 and not g["shed"][2]
          and g["held"][1] == 1 and not g["after"][4]
          and g["after"][1] > 1
          and [m for m, _ in g["marks"]] == ["fired", "resolved"],
          f"(12d) shed {g['shed']} held {g['held']} after {g['after']}")
    rg = g["rungs"][-1]
    check(rg[5][0] > 1 and rg[1] == max(rg[5])
          and all(k <= rg[5][0] for k in rg[5][1:]),
          f"(12d) per-group rungs {rg}")
    launches_ok("12d", g)
    print(f"governor (12d) on {card}: a governed SimCluster at geometry (a) "
          f"over {GOV_TICKS} ticks of trickle/burst/trickle: max_k by "
          f"tick " + ", ".join(f"{k}x{n}" for k, n in runs_of(tiers))
          + f"; the burn-rate pager "
          f"{g['marks']} shed the tier {g['before'][1]} -> {g['shed'][1]} "
          f"and it climbed to {g['after'][1]}; G={REPAIR_GROUPS} rungs "
          f"{rg[5]} (max_k {rg[1]}); decisions, outputs and status equal "
          f"to the CPU run; {g['steps']} protocol steps "
          f"({time.perf_counter() - t0:.1f} s both)", flush=True)
    if dev.type == "cuda":
        for r in governor_rates(dev, card):
            launches_ok("12d rates", r)

    # (12e) the drivers
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as wd:
        g = drive_repair_driver(dev, os.path.join(wd, "card"))
        ref = drive_repair_driver(cpu, os.path.join(wd, "cpu"))
        art_ok = g["artifact"] is not None and os.path.exists(g["artifact"])
    same("12e driver", g, ref, ("log", "leaders", "refused", "fired",
                                "status", "audit", "replayed"))
    check(g["status"]["repairs_done"] == 1 and g["status"]["active"] == {}
          and any(v not in (0, -1) for v in g["leaders"]),
          f"(12e) driver repair {g['status']} leaders {g['leaders']}")
    check(g["missing"] == [] and "digest_divergence" in g["fired"]
          and art_ok and any(g["refused"])
          and (g["scrape"] is None or (g["scrape"]["healthz_ok"]
                                       and g["scrape"]["has_repairs"])),
          f"(12e) driver: missing {g['missing']} fired {g['fired']} "
          f"artifact {art_ok} scrape {g['scrape']}")
    launches_ok("12e driver", g)
    gd = drive_governed_driver(dev)
    gref = drive_governed_driver(cpu)
    check(gd["committed"] == gref["committed"],
          "(12e) the governed driver's committed stream differs from the "
          "CPU run")
    check(any("burst" in k or "scan" in k for k in gd["tiers"])
          and gd["governor"]["ladder"] == [1, 2, 4, 8, 16],
          f"(12e) governed driver tiers {gd['tiers']}")
    launches_ok("12e governed", gd)
    sd = drive_repair_sharded_driver(dev)
    sref = drive_repair_sharded_driver(cpu)
    same("12e sharded", sd, sref, ("log", "g0", "leaders", "status",
                                   "summary"))
    check(sd["status"]["repairs_done"] == 1 and not sd["status"]["active"]
          and sd["leaders"][1] >= 0 and sd["g0"][-1] > sd["g0"][0]
          and sd["missing"] == [] and sd["summary"]["unrepaired"] == 0,
          f"(12e) sharded driver {sd['status']} leaders {sd['leaders']}")
    launches_ok("12e sharded", sd)
    print(f"repair (12e) on {card}: ClusterDriver(audit=True, repair=True) "
          f"at geometry (a): leader 0 corrupted, deposed (leaders "
          f"{sorted(set(g['leaders']))}), repaired and re-admitted "
          f"({g['status']['repairs_done']} repair), alerts fired "
          f"{g['fired']}, audit artifact written, health() valid, "
          f"/healthz and /metrics scraped ({g['scrape']}); "
          f"ClusterDriver(governor=True, pipeline=2) served {gd['n']} "
          f"queued entries in {gd['wall'] * 1e3:.1f} ms, tiers "
          f"{gd['tiers']}, max in flight {gd['inflight']}; "
          f"ShardedClusterDriver(G=2) group 1 leader {sd['lead1']} "
          f"repaired while group 0 committed {sd['g0'][-1] - sd['g0'][0]} "
          f"entries; each equal to its CPU run "
          f"({time.perf_counter() - t0:.1f} s all)", flush=True)
    print(f"phase 12 on {card}: {sum(r['launches'] for r in runs)} "
          f"commit_window launches in {sum(r['steps'] for r in runs)} "
          f"protocol steps, no commit_scan launch", flush=True)
    return runs


# ---------------------------------------------------------------------------
# phase 13: streams, elastic topology and the console
# ---------------------------------------------------------------------------

STREAM_KEYS = 2048         # distinct keys written in (13a), seeded in (13c)
STREAM_CLIENTS = 16        # session clients of (13a)
STREAM_PAGE = 64           # scan page size of (13a)
STREAM_CAP = 4096          # ReplicatedKVS capacity per replica (per group)
STREAM_FANOUT = "gather"   # a leader crash is a peer-mask cut
STREAM_ROUNDS = 3          # attached/detached rate rounds of (13a)
TOPO_G = 4                 # groups of (13c)
TOPO_PUTS = 16             # puts per protocol step while a window is open
TOPO_DRIVER_CONNS = 12     # connections of the (13d) live driver
TOPO_DRIVER_EVENTS = 1024  # SENDs per connection and load of (13d)
RES13 = ("term", "role", "commit", "end", "apply", "head", "accepted")


def spread_key(tag: bytes, i: int) -> bytes:
    """Key ``i`` (< 4096) of a family under the 4-byte ``tag``. The KVS
    table hash keeps only the low bits of each key word, so the index
    sits in the low bytes of the second and third words: keys that
    differed only in a word's high bytes would share one probe chain."""
    return tag + bytes([0x30 + (i & 63), 0x30 + ((i >> 6) & 15), 0x2D,
                        0x2D, 0x30 + (i >> 10)])


def serve_stepping(clusters, fn, max_steps: int = 400):
    """Run a blocking client call (a scan page) on a thread while the
    calling thread steps ``clusters``, so the read hub confirms and
    serves it; returns its result and the wall seconds it took."""
    box = {}

    def work():
        try:
            box["out"] = fn()
        except BaseException as exc:  # noqa: BLE001 — reraised below
            box["err"] = exc
    with alone():
        t0 = time.perf_counter()
        th = threading.Thread(target=work)
        th.start()
        for _ in range(max_steps):
            for c in clusters:
                c.step()
            if not th.is_alive():
                break
        th.join(30)
        wall = time.perf_counter() - t0
    check(not th.is_alive(), "a scan page never completed")
    if "err" in box:
        raise box["err"]
    return box["out"], wall


def outs13(res) -> dict:
    return {k: np.asarray(res[k]).tolist() for k in RES13}


def drive_streams_engine(dev, wd: str) -> dict:
    """(13a) on ``dev``: a streams hub on an audited ``SimCluster`` at
    geometry (a) with the read path and ``ReplicatedKVS(cap=4096)``, in
    lockstep with a twin without the hub: 16 session clients write 2048
    distinct keys in four rounds under a whole-range watch that resumes
    twice from its token; then a paged scan of the range whose leader is
    cut off between two pages (the new leader overwrites one key and
    deletes another, and the token holds); the CDC export verified
    against the ledger and a flipped byte named."""
    from rdma_paxos_tpu_torch import streams
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.models.replicated_kvs import ReplicatedKVS
    from rdma_paxos_tpu_torch.obs import Observability
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.runtime import reads
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    from rdma_paxos_tpu_torch.streams.cdc import CDCWriter, verify_export
    geom, _ = GEOMETRIES["a"]
    cfg = LogConfig(**geom)
    os.makedirs(wd)
    cdc_path = os.path.join(wd, "cdc.jsonl")
    c = SimCluster(cfg, R, fanout=STREAM_FANOUT, audit=True, device=dev)
    c.obs = Observability()
    reads.attach(c)
    kv = ReplicatedKVS(c, cap=STREAM_CAP)
    hub = streams.attach(c, kvs=kv, cdc_path=cdc_path, auditor=c.auditor)
    twin = SimCluster(cfg, R, fanout=STREAM_FANOUT, audit=True, device=dev)
    reads.attach(twin)
    kv_twin = ReplicatedKVS(twin, cap=STREAM_CAP)
    commit_window.launches = commit_scan.launches = 0
    log = []

    def step_both(timeouts=()):
        a, b = outs13(c.step(timeouts)), outs13(twin.step(timeouts))
        check(a == b, "(13a) a step's outputs differ with the hub attached")
        log.append(a)
    for cl in (c, twin):
        cl.run_until_elected(0)
    keys = [spread_key(b"s/k-", i) for i in range(STREAM_KEYS)]
    sub = hub.subscribe(0, prefix=b"s/", cap=4 * STREAM_KEYS)
    events, tokens = [], []
    per = STREAM_KEYS // 4
    lag_ms = None
    for rnd in range(4):
        for i in range(rnd * per, (rnd + 1) * per):
            cid, req = 1 + i % STREAM_CLIENTS, 1 + i // STREAM_CLIENTS
            for k_ in (kv, kv_twin):
                k_.put(0, keys[i], b"v0-%d" % i, client_id=cid, req_id=req)
        if rnd == 3:
            # the ops (and so the kernels) of one step that appends a
            # full batch, with the hub attached and without it
            ops = (op_count(lambda: log.append(outs13(c.step()))),
                   op_count(lambda: twin.step()))
            check(log[-1] == outs13(twin.last),
                  "(13a) a step's outputs differ with the hub attached")
        else:
            step_both()
        step_both()
        if rnd == 3:
            with alone():
                t0 = time.perf_counter()
                caught = hub.watch.wait_caught_up(
                    {0: hub.tails[0].length()})
                lag_ms = (time.perf_counter() - t0) * 1e3
            check(caught, "(13a) the watch pump never caught up")
        if rnd in (1, 2):
            # consume part of what was delivered, then reconnect from the
            # last consumed event's token: the rest replays from retention
            check(hub.watch.wait_caught_up({0: hub.tails[0].length()}),
                  "(13a) the watch pump never caught up")
            events += sub.poll(max_n=per // 3)
            tokens.append(sub.token())
            sub.close()
            sub = hub.subscribe(0, prefix=b"s/", token=tokens[-1],
                                cap=4 * STREAM_KEYS)
    events += sub.poll(max_n=1 << 16)
    ident = [(e.conn, e.req) for e in events]
    check(len(ident) == len(set(ident)) == STREAM_KEYS,
          f"(13a) the watch delivered {len(ident)} events, "
          f"{len(set(ident))} distinct, for {STREAM_KEYS} puts")
    lock_steps = c.step_index
    # the scan, its leader cut off between two pages
    pages, page_s = [], []
    page, s = serve_stepping([c], lambda: hub.scan(prefix=b"s/",
                                                   limit=STREAM_PAGE))
    pages.append(page)
    page_s.append(s)
    c.partition([[0], [1, 2]])
    c.run_until_elected(1)
    kv.put(1, keys[5], b"v1-5", client_id=STREAM_CLIENTS + 1, req_id=1)
    kv.remove(1, keys[7], client_id=STREAM_CLIENTS + 1, req_id=2)
    for _ in range(3):
        c.step()
    while page["token"] is not None:
        tok = page["token"]
        page, s = serve_stepping([c], lambda t=tok: hub.scan(token=t))
        pages.append(page)
        page_s.append(s)
    items = [kv_ for p in pages for kv_ in p["items"]]
    want = sorted((keys[i], b"v0-%d" % i) for i in range(STREAM_KEYS))
    check(items == want, f"(13a) the scan across the crash returned "
                         f"{len(items)} items, not the cut's {len(want)}")
    fresh, _ = serve_stepping([c], lambda: hub.scan_all(
        prefix=b"s/", limit=4 * STREAM_PAGE))
    fresh = dict(fresh)
    check(fresh[keys[5]] == b"v1-5" and keys[7] not in fresh
          and len(fresh) == STREAM_KEYS - 1,
          "(13a) a fresh scan does not see the new leader's writes")
    check(hub.scans.pin_count() == 0, "(13a) a scan pin was left behind")
    walks, walk_ms = [], []
    for _ in range(3):
        with alone():
            t0 = time.perf_counter()
            walks.append(kv.items_in_range(1, b"", None))
            walk_ms.append((time.perf_counter() - t0) * 1e3)
    walk = walks[0]
    check(walks[1] == walk and walks[2] == walk,
          "(13a) two table walks differ")
    check(walk == sorted(fresh.items()),
          "(13a) the table walk differs from the scan")
    # the CDC export: verified against the ledger, a flipped byte named
    check(hub.watch.wait_caught_up({0: hub.tails[0].length()}),
          "(13a) the watch pump never caught up")
    hub.fail_all("13a done")
    dump = c.auditor.dump()
    verdict = verify_export(cdc_path, [dump])
    with open(cdc_path) as f:
        text = f.read()
    lines = text.splitlines()
    rec = json.loads(lines[len(lines) // 2])
    p = rec["payload"]
    rec["payload"] = p[:-1] + ("0" if p[-1] != "0" else "1")
    bad_path = os.path.join(wd, "cdc_flipped.jsonl")
    with open(bad_path, "w") as f:
        f.write("\n".join(lines[:len(lines) // 2] + [json.dumps(rec)]
                          + lines[len(lines) // 2 + 1:]) + "\n")
    bad = verify_export(bad_path, [dump])
    recs = hub.tails[0].records(0)
    with alone():
        t0 = time.perf_counter()
        w = CDCWriter(os.path.join(wd, "cdc_timed.jsonl"),
                      auditor=c.auditor)
        w.write_records(0, recs)
        w.close()
        cdc_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return dict(log=log, ops=ops, lag_ms=lag_ms, tokens=tokens,
                events=[(e.conn, e.req, e.term, e.index) for e in events],
                items=items, fresh=sorted(fresh.items()), cdc=text,
                verdict=verdict, bad=bad, flipped=(rec["term"],
                                                   rec["index"]),
                page_ms=[s_ * 1e3 for s_ in page_s], walk_ms=walk_ms,
                cdc_rate=len(recs) / cdc_s, n_records=len(recs),
                lock_steps=lock_steps,
                steps=c.step_index + twin.step_index,
                launches=commit_window.launches,
                scans=commit_scan.launches)


def streams_rates(dev, card: str) -> dict:
    """(13a) committed entries/s at geometry (a) with a hub attached (a
    whole-range watcher and a CDC sink), with a hub and its watcher but
    no sink, and without a hub, in alternating rounds of eight full
    batches of KVS puts; each round printed."""
    from rdma_paxos_tpu_torch import streams
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.models.kvs import OP_PUT, encode_cmd
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    geom, _ = GEOMETRIES["a"]
    B = geom["batch_slots"]
    cfg = LogConfig(**geom)
    modes = ("watch+cdc", "watch", "detached")
    with tempfile.TemporaryDirectory() as wd:
        clusters, subs = {}, {}
        for mode in modes:
            c = SimCluster(cfg, R, fanout=STREAM_FANOUT, device=dev)
            c.run_until_elected(0)
            c.prewarm()
            clusters[mode] = c
            if mode != "detached":
                hub = streams.attach(c, cdc_path=(
                    os.path.join(wd, "cdc.jsonl") if "cdc" in mode
                    else None))
                subs[mode] = (hub, hub.subscribe(0, cap=1 << 22))
        commit_window.launches = commit_scan.launches = 0
        s0 = sum(c.step_index for c in clusters.values())
        rates = {m: [] for m in modes}
        delivered = {m: 0 for m in subs}
        for rnd in range(STREAM_ROUNDS):
            for mode in (modes if rnd % 2 == 0 else modes[::-1]):
                c = clusters[mode]
                rows = [(3, 1 + i % STREAM_CLIENTS,
                         1 + rnd * 8 * B // STREAM_CLIENTS
                         + i // STREAM_CLIENTS,
                         encode_cmd(OP_PUT, spread_key(b"r/k-", i % 4096),
                                    b"r%d" % rnd).tobytes())
                        for i in range(8 * B)]
                c0 = int(c.last["commit"].min())
                torch.cuda.synchronize()
                with alone():
                    t0 = time.perf_counter()
                    c.submit_many(0, rows)
                    while int(c.last["commit"].min()) - c0 < len(rows):
                        c.step()
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                rates[mode].append(len(rows) / dt)
                if mode in subs:
                    hub, sub = subs[mode]
                    check(hub.watch.wait_caught_up(
                        {0: hub.tails[0].length()}),
                        "(13a) the pump fell behind")
                    delivered[mode] += len(sub.poll(max_n=1 << 22))
        steps = sum(c.step_index for c in clusters.values()) - s0
        for hub, _ in subs.values():
            hub.fail_all("rates done")
        launches, scans = commit_window.launches, commit_scan.launches
    check(all(n == STREAM_ROUNDS * 8 * B for n in delivered.values()),
          f"(13a) the rate rounds' watchers got {delivered} events")
    for rnd in range(STREAM_ROUNDS):
        print(f"streams (13a) rate round {rnd + 1} on {card}: geometry (a) "
              f"{STREAM_FANOUT}, {8 * B} KVS puts, committed entries/s: "
              + ", ".join(f"{m} {rates[m][rnd]:.0f}" for m in modes)
              + f" (run {'in that order' if rnd % 2 == 0 else 'reversed'})",
              flush=True)
    return dict(steps=steps, launches=launches, scans=scans, rates=rates)


def drive_topology(dev) -> dict:
    """(13c) on ``dev``: ``ShardedKVS`` at G = 4, geometry (a),
    ``cap=4096`` per group, leases attached and an elastic-topology
    controller, in lockstep with a twin without one while 2048 keys are
    seeded; then the upper half of group 0's keys is split into group 1
    while puts continue (writes to the frozen range deferred), and
    merged back after the cooldown."""
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.obs import Observability
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.runtime import reads
    from rdma_paxos_tpu_torch.shard.cluster import ShardedCluster
    from rdma_paxos_tpu_torch.shard.kvs import ShardedKVS
    from rdma_paxos_tpu_torch.shard.router import RangeRule
    from rdma_paxos_tpu_torch.topology import attach_topology
    geom, _ = GEOMETRIES["a"]
    cfg = LogConfig(**geom)
    sides = []
    for attach in (True, False):
        sc = ShardedCluster(cfg, R, TOPO_G, fanout=GROUP_FANOUT, device=dev)
        sc.obs = Observability()
        kv = ShardedKVS(sc, cap=STREAM_CAP)
        reads.attach(sc)
        ctl = attach_topology(kv, obs=sc.obs, cooldown_steps=8) \
            if attach else None
        sc.place_leaders()
        sides.append((sc, kv, ctl))
    (sc, kv, ctl), (twin, kv_twin, _) = sides
    commit_window.launches = commit_scan.launches = 0
    s0 = sc.step_index + twin.step_index
    owned = [[] for _ in range(TOPO_G)]
    for i in range(4096):
        k = spread_key(b"t/k-", i)
        if len(owned[kv.group_of(k)]) < STREAM_KEYS // TOPO_G:
            owned[kv.group_of(k)].append(k)
    check(all(len(o) == STREAM_KEYS // TOPO_G for o in owned),
          f"(13c) keys per group {[len(o) for o in owned]}")
    keys = sorted(k for o in owned for k in o)
    log, ops = [], None
    for k in keys:
        for kv_ in (kv, kv_twin):
            kv_.put(k, b"v0:" + k)
    ops = (op_count(lambda: log.append(outs13(sc.step()))),
           op_count(lambda: twin.step()))
    check(log[-1] == outs13(twin.last),
          "(13c) a step's outputs differ with topology attached")
    for _ in range(3):
        a, b = outs13(sc.step()), outs13(twin.step())
        check(a == b, "(13c) a step's outputs differ with topology attached")
        log.append(a)
    hot = sorted(owned[0])
    rule = RangeRule(hot[len(hot) // 2], hot[-1] + b"\x00", 1)
    values = {k: b"v0:" + k for k in keys}
    windows, n = [], 0
    for direction in ("split", "merge"):
        while ctl.cooling():
            sc.step()
        with alone():
            t0 = time.perf_counter()
            w0 = sc.step_index
            check(ctl.propose_split(rule.lo, rule.hi, rule.group)
                  if direction == "split" else ctl.propose_merge(rule),
                  f"(13c) the {direction} was refused")
            deferred = 0
            while ctl.in_window():
                check(sc.step_index - w0 < 400, f"(13c) the {direction} "
                                                f"window never closed")
                for _ in range(TOPO_PUTS):
                    k = keys[n % len(keys)]
                    n += 1
                    if ctl.would_block(k):
                        deferred += 1
                        continue
                    values[k] = b"v%d:" % n + k
                    kv.put(k, values[k])
                sc.step()
                ctl.drive()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            windows.append(dict(direction=direction,
                                steps=sc.step_index - w0,
                                ms=(time.perf_counter() - t0) * 1e3,
                                deferred=deferred,
                                router=kv.router.to_dict(),
                                status=ctl.status()))
    for _ in range(4):
        sc.step()
    # each group's table at its leader; a key's value is its owner's
    # (a split leaves unreachable copies on the donor)
    tables = [kv.groups[g].items_in_range(sc.leader_hint(g), b"", None)
              for g in range(TOPO_G)]
    got = {k: v for g, tab in enumerate(tables) for k, v in tab
           if kv.group_of(k) == g}
    check(got == values, "(13c) a key's value was lost in the windows")
    health = sc.health()
    phases = [e.kind for e in sc.obs.trace.events()
              if e.kind.startswith("topology_")]
    fence = [(e.kind, e.fields.get("group"), e.fields.get("reason"))
             for e in sc.obs.trace.events()
             if e.kind in ("lease_revoked", "topology_cutover")]
    return dict(log=log, ops=ops, windows=windows, tables=tables,
                router=health["router"], topology=health["topology"],
                health=health, phases=phases, fence=fence,
                moved=sum(1 for k in keys if rule.lo <= k < rule.hi),
                steps=sc.step_index + twin.step_index - s0,
                launches=commit_window.launches,
                scans=commit_scan.launches)


def topology_nemesis(dev, seed: int) -> dict:
    """(13d) one ``run_topology_chaos`` run on ``dev``."""
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.topology.chaos import TopologyNemesisRunner
    l0 = commit_window.launches, commit_scan.launches
    with alone():
        t0 = time.perf_counter()
        runner = TopologyNemesisRunner(seed=seed, device=dev)
        v = runner.run()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return dict(verdict=v, wall=wall,
                history=runner.history.to_jsonl(),
                steps=runner.shard.step_index,
                launches=commit_window.launches - l0[0],
                scans=commit_scan.launches - l0[1])


def drive_topology_driver(dev) -> dict:
    """(13d) on ``dev``: ``ShardedClusterDriver`` at G = 2, geometry
    (a), ``pipeline=2``, with a controller over ``ShardedKVS(d.cluster)``
    and 64 KVS keys put in the range ``[b"k", b"l")``. Twelve
    connections (keys ``k<n>-<j>``, eight in the range, spread over both
    groups) queue SENDs through the three replicas' shim handlers; a
    split of the range into group 1 is proposed, the loop is stepped
    until the window freezes, a second load is queued, and the next
    iteration cuts over with that load in flight: the donor's waiters
    fail. The live loop then serves the rest, the failed events are
    sent again on their connections (which re-route under the new map),
    and every event ends acked once with status 0."""
    from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.proxy.proxy import PendingEvent
    from rdma_paxos_tpu_torch.runtime.sharded_driver import (
        ShardedClusterDriver)
    from rdma_paxos_tpu_torch.shard.kvs import ShardedKVS
    from rdma_paxos_tpu_torch.topology import attach_topology
    geom, _ = GEOMETRIES["a"]
    d = ShardedClusterDriver(LogConfig(**geom), R, 2, fanout=GROUP_FANOUT,
                             pipeline=2, device=dev,
                             timeout_cfg=TimeoutConfig(**TIMERS_OFF),
                             group_timer_lo=1, group_timer_hi=2)
    try:
        d.prewarm()
        kv = ShardedKVS(d.cluster, cap=STREAM_CAP)
        ctl = attach_topology(kv, obs=d.obs, cooldown_steps=8)
        for _ in range(20):
            if d.leader() >= 0:
                break
            d.step()
        check(d.leader() >= 0, f"(13d) the group timers elected "
                               f"{d.leaders()}")
        for i in range(64):
            kv.put(b"k%d-kv" % i, b"v%d" % i)
        for _ in range(3):
            d.step()
        handlers = [d._make_handler(r) for r in range(R)]
        conns = []
        for t in range(TOPO_DRIVER_CONNS):
            r = t % R
            conn = (r << 24) | (500 + t)
            check(handlers[r](2, conn, b"") == 0,
                  "(13d) a CONNECT was not held")
            conns.append((r, conn, b"k%d" % t if t < 8 else b"m%d" % t))
        owner0 = [d.router.group_of(tag) for _r, _c, tag in conns]
        logical = []                # per event: (replica, conn, payload)
        evs = []
        fired = collections.Counter()
        fired_lock = threading.Lock()

        def mark(ev, _status):
            with fired_lock:
                fired[id(ev)] += 1

        def send(i):
            r, conn, p = logical[i]
            ev = handlers[r](3, conn, p)
            check(isinstance(ev, PendingEvent), "(13d) a SEND was refused")
            ev.attach(functools.partial(mark, ev))
            evs[i].append(ev)

        def load(part):
            for r, conn, tag in conns:
                for j in range(TOPO_DRIVER_EVENTS):
                    logical.append((r, conn, (tag + b"-%d-%d " % (
                        part, j)).ljust(FRONT_BYTES, b"v")))
                    evs.append([])
                    send(len(logical) - 1)
        load(0)
        commit_window.launches = commit_scan.launches = 0
        steps0 = d.cluster.step_index
        with alone():
            t0 = time.perf_counter()
            check(ctl.propose_split(b"k", b"l", 1), "(13d) split refused")
            while not ctl.frozen():
                check(d.cluster.step_index - steps0 < 200,
                      "(13d) the window never froze")
                d.step()
            load(1)
            d.step()
            check(ctl.transitions_total == 1 and not ctl.in_window(),
                  f"(13d) no cutover: {ctl.status()}")
            failed0 = sum(1 for e in evs if e[-1].done.is_set()
                          and e[-1].status != 0)
            d.run(period=0.001)
            retried = 0
            while True:
                check(time.perf_counter() - t0 < 300, "(13d) events stalled")
                todo = [i for i, e in enumerate(evs)
                        if not e[-1].done.is_set()]
                failed = [i for i, e in enumerate(evs)
                          if e[-1].done.is_set() and e[-1].status != 0]
                if not todo and not failed:
                    break
                # resend in order: the donor's conn pins were dropped, so
                # these SENDs route under the new map
                for i in failed:
                    send(i)
                retried += len(failed)
                time.sleep(0.005)
            wall = time.perf_counter() - t0
        d.stop()
        check(d.loop_error is None, f"(13d) the loop crashed: "
                                    f"{d.loop_error!r}")
        status = ctl.status()
        return dict(router=d.cluster.router.to_dict(),
                    transitions=status["transitions_total"],
                    abandoned=status["abandoned_total"],
                    epoch=status["epoch"],
                    once=all(fired[id(ev)] == 1 for e in evs for ev in e),
                    final=[e[-1].status for e in evs], failed0=failed0,
                    retried=retried, events=len(logical), wall=wall,
                    owner0=owner0,
                    owner1=[d.router.group_of(tag) for _r, _c, tag in conns],
                    max_inflight=d.cluster.max_inflight_dispatches,
                    steps=d.cluster.step_index - steps0,
                    launches=commit_window.launches,
                    scans=commit_scan.launches)
    finally:
        d.stop()


def phase_streams_topology(dev, card: str) -> list:
    """Phase 13: streams, elastic topology and the console on the card,
    each run against its CPU twin; returns the protocol steps and
    commit_window launches of its runs."""
    from rdma_paxos_tpu_torch.obs import console
    cpu = torch.device("cpu")
    runs = []

    def launches_ok(tag, r):
        check(r["launches"] == r["steps"] > 0 and r["scans"] == 0,
              f"({tag}) {r['launches']} commit_window and {r['scans']} "
              f"commit_scan launches in {r['steps']} protocol steps")
        runs.append(dict(launches=r["launches"], steps=r["steps"]))

    def same(tag, a, b, keys):
        for k in keys:
            check(a[k] == b[k], f"({tag}) {k} differs from the CPU run")

    # (13a) streams on the engine
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as wd:
        twin = TWINS.submit(drive_streams_engine, cpu,
                            os.path.join(wd, "cpu"))
        g = drive_streams_engine(dev, os.path.join(wd, "card"))
        t_card = time.perf_counter() - t0
        ref = twin.get()
    same("13a", g, ref, ("log", "tokens", "events", "items", "fresh",
                         "cdc", "verdict", "bad", "flipped"))
    # the card's step launches one kernel where the CPU runs its plain
    # version's ops: ops compare within a device, never across
    check(g["ops"][0] == g["ops"][1] and ref["ops"][0] == ref["ops"][1],
          f"(13a) ops per step() attached / detached: card {g['ops']}, "
          f"CPU {ref['ops']}")
    check(g["verdict"]["ok"] and g["verdict"]["checked_digests"] > 0
          and not g["bad"]["ok"] and tuple(g["bad"]["bad"]) == g["flipped"],
          f"(13a) CDC verify {g['verdict']} flipped {g['bad']}")
    launches_ok("13a", g)
    step_ms = t_card * 1e3 / g["steps"]
    print(f"streams (13a) on {card}: SimCluster(audit=True) at geometry (a) "
          f"{STREAM_FANOUT} with a hub, leases and ReplicatedKVS(cap="
          f"{STREAM_CAP}): {STREAM_CLIENTS} clients wrote {STREAM_KEYS} "
          f"keys, the whole-range watch delivered {len(g['events'])} events "
          f"exactly once across 2 token resumes (tokens "
          f"{[(t['term'], t['index'], t['pos']) for t in g['tokens']]}); "
          f"the pump caught up {g['lag_ms']:.2f} ms after the last commit's "
          f"step returned (0 further protocol steps; "
          f"{g['lag_ms'] / step_ms:.3f} of a step at {step_ms:.2f} ms per "
          f"step of the run); scan of {len(g['items'])} keys in "
          f"{len(g['page_ms'])} pages of {STREAM_PAGE} with the leader cut "
          f"off after page 1: ms per page median "
          f"{np.median(g['page_ms']):.2f} (min {min(g['page_ms']):.2f}, "
          f"max {max(g['page_ms']):.2f}), every item the cut's value; "
          f"items_in_range over the {STREAM_CAP}-slot table "
          + ", ".join(f"{x:.2f}" for x in g["walk_ms"]) + " ms; CDC "
          f"{g['n_records']} records, {g['cdc_rate']:.0f} records/s written,"
          f" verified ({g['verdict']['checked_digests']} ledger digests), "
          f"the flipped byte named at {g['flipped']}; ops per step() "
          f"{g['ops'][0]} with the hub, {g['ops'][1]} without; steps, watch "
          f"events, scan pages, tables and the CDC file equal to the CPU run"
          f" ({time.perf_counter() - t0:.1f} s both)", flush=True)
    rt = streams_rates(dev, card)
    launches_ok("13a rates", rt)

    # (13b) streams through the driver and the nemesis runner
    t0 = time.perf_counter()
    geom, fanout = GEOMETRIES["a"]
    payloads = front_record(FRONT_EVENTS, FRONT_BYTES)
    twins = [TWINS.submit(drive_front_door, cpu, geom, fanout, payloads,
                          FRONT_CONNS, 0, streams=True)]
    twins += [TWINS.submit(chaos_run, cpu, seed=seed, steps=100,
                           streams=True) for seed in (0, 1)]
    fd = drive_front_door(dev, geom, fanout, payloads, FRONT_CONNS, 2,
                          streams=True)
    fref = twins[0].get()
    check(fd["statuses"] == [0] * FRONT_EVENTS and (fd["fired"] == 1).all()
          and fd["streams"][0] == fref["streams"][0],
          "(13b) the streams driver's events or committed stream")
    w, wr = fd["health"]["streams"]["watch"], fref["health"]["streams"][
        "watch"]
    check(fd["missing"] == [] and w["cursors"] == wr["cursors"]
          == {0: len(fd["streams"][0])} and w["events_total"] == 0
          and fd["sub_closed"] == (True, "stop")
          and fd["hub"]["stopped"] and fd["max_inflight"] >= 2,
          f"(13b) driver health {fd['health']['streams']} sub "
          f"{fd['sub_closed']}")
    fd["scans"] = 0
    launches_ok("13b driver", fd)
    for seed in (0, 1):
        kw = dict(seed=seed, steps=100, streams=True)
        gv = chaos_run(dev, **kw)
        cv = twins[1 + seed].get()
        same(f"13b seed {seed}", gv, cv, ("verdict", "history", "ledger",
                                          "steps"))
        s = gv["verdict"]["streams"]
        check(gv["verdict"]["ok"] and s["dups"] == 0 and s["gaps"] == 0
              and s["ordered"] and s["resumes"] == 2,
              f"(13b) seed {seed} streams {s}")
        gv["scans"] = gv["scan_launches"]
        launches_ok(f"13b seed {seed}", gv)
        print(f"streams (13b) on {card}: NemesisRunner(streams=True) seed "
              f"{seed} at DEFAULT_KV_CFG: ok, {s['events']} watch events "
              f"exactly once across {s['resumes']} resumes, "
              f"{gv['verdict']['linearizability']['ops']} checked ops; "
              f"verdict, history and ledger equal to the CPU run; "
              f"{gv['steps']} protocol steps, {gv['wall']:.2f} s on the "
              f"card, {cv['wall']:.2f} s on the CPU", flush=True)
    print(f"streams (13b) on {card}: ClusterDriver(streams=True, pipeline=2)"
          f" at geometry (a): {FRONT_EVENTS} SENDs acked once with status 0"
          f" in {fd['wall'] * 1e3:.1f} ms, health()['streams'] valid (pump "
          f"cursor {w['cursors'][0]}), the watcher closed at stop; committed"
          f" stream equal to the CPU serial run "
          f"({time.perf_counter() - t0:.1f} s all)", flush=True)

    # (13c) topology on ShardedKVS
    t0 = time.perf_counter()
    twin = TWINS.submit(drive_topology, cpu)
    g = drive_topology(dev)
    ref = twin.get()
    same("13c", g, ref, ("log", "tables", "router", "topology", "phases",
                         "fence", "moved"))
    check(ref["ops"][0] == ref["ops"][1],
          f"(13c) CPU ops per step() attached / detached {ref['ops']}")
    for a, b in zip(g["windows"], ref["windows"]):
        same("13c window", a, b, ("steps", "deferred", "router", "status"))
    check(g["ops"][0] == g["ops"][1]
          and g["topology"]["transitions_total"] == 2
          and g["topology"]["abandoned_total"] == 0
          and g["topology"]["epoch"] == 2 and not g["router"]["overrides"],
          f"(13c) ops {g['ops']} topology {g['topology']}")
    launches_ok("13c", g)
    sp, mg = g["windows"]
    print(f"topology (13c) on {card}: ShardedKVS G={TOPO_G} at geometry (a) "
          f"{GROUP_FANOUT}, cap={STREAM_CAP} per group, {STREAM_KEYS} keys "
          f"seeded: the upper half of group 0's keys (a range holding "
          f"{g['moved']} keys of all groups) split into group 1 in "
          f"{sp['steps']} protocol steps, {sp['ms']:.1f} ms from proposal to "
          f"the window's end ({sp['deferred']} puts to the frozen range "
          f"deferred), merged back in {mg['steps']} steps, {mg['ms']:.1f} ms"
          f"; {TOPO_PUTS} puts a step throughout, every value read back; "
          f"ops per step() {g['ops'][0]} with the controller, "
          f"{g['ops'][1]} without; router, epoch, health()['topology'], "
          f"every replica's table and the trace's phases equal to the CPU "
          f"run ({time.perf_counter() - t0:.1f} s both)", flush=True)

    # (13e) the console over (13c)'s health document
    docs = []
    for h in (g["health"], ref["health"]):
        view = console.fleet_view([dict(src="13c", health=dict(h, ts=0.0))])
        view["ts"] = 0.0
        for hst in view["hosts"]:
            hst.pop("age_s", None)
        docs.append((view, console.render_table(view)))
    check(docs[0] == docs[1], "(13e) the console view differs")
    view, table = docs[0]
    check("TOPO" in table and [r["topo"] for r in view["groups"]]
          == ["e2/2t"] + ["-"] * (TOPO_G - 1),
          f"(13e) console rows {[r['topo'] for r in view['groups']]}")
    print(f"console (13e): fleet_view/render_table over (13c)'s health "
          f"document show TOPO {view['groups'][0]['topo']!r} in group 0's "
          f"row, equal to the CPU run's\n" + table.split("\n\n")[0],
          flush=True)

    # (13d) the topology nemesis and the live sharded driver
    twins = [TWINS.submit(topology_nemesis, cpu, seed) for seed in (0, 1)]
    twins.append(TWINS.submit(drive_topology_driver, cpu))
    for seed in (0, 1):
        gv = topology_nemesis(dev, seed)
        cv = twins[seed].get()
        same(f"13d seed {seed}", gv, cv, ("verdict", "history", "steps"))
        v = gv["verdict"]
        check(v["ok"] and v["lease_fence"]["ok"]
              and v["topology"]["transitions"] == 2
              and v["topology"]["abandoned"] == 0,
              f"(13d) seed {seed}: {v}")
        launches_ok(f"13d seed {seed}", gv)
        print(f"topology (13d) on {card}: run_topology_chaos seed {seed} "
              f"(G=3, leader {v['crashed_leader']} of group "
              f"{v['target_group']} crashed mid-split): ok, "
              f"{v['linearizability']['ops']} checked ops, "
              f"{v['lease_fence']['cutovers']} lease-fenced cutovers; verdict"
              f" and history equal to the CPU run; {gv['steps']} protocol "
              f"steps, {gv['wall']:.2f} s on the card, {cv['wall']:.2f} s on "
              f"the CPU", flush=True)
    t0 = time.perf_counter()
    dd = drive_topology_driver(dev)
    dref = twins[2].get()
    same("13d driver", dd, dref, ("router", "transitions", "abandoned",
                                  "epoch", "final", "once", "failed0",
                                  "owner0", "owner1"))
    check(dd["final"] == [0] * dd["events"] and dd["once"]
          and dd["transitions"] == 1 and dd["abandoned"] == 0
          and dd["failed0"] > 0 and dd["retried"] >= dd["failed0"]
          and dd["max_inflight"] >= 2 and 0 in dd["owner0"][:8]
          and dd["owner1"][:8] == [1] * 8,
          f"(13d) driver: transitions {dd['transitions']} failed at the "
          f"cutover {dd['failed0']} retried {dd['retried']} once "
          f"{dd['once']} inflight {dd['max_inflight']} owners "
          f"{dd['owner0']} -> {dd['owner1']}")
    launches_ok("13d driver", dd)
    print(f"topology (13d) on {card}: ShardedClusterDriver G=2 at geometry "
          f"(a), pipeline=2: {dd['events']} SENDs on "
          f"{TOPO_DRIVER_CONNS} connections; the split of [k, l) into "
          f"group 1 cut over under the queued load: {dd['failed0']} donor "
          f"waiters failed at the cutover, {dd['retried']} SENDs sent again"
          f" (CPU twin: {dref['retried']}), every event acked once with "
          f"status 0 in "
          f"{dd['wall'] * 1e3:.1f} ms; max_inflight_dispatches "
          f"{dd['max_inflight']}; router and topology equal to the CPU run "
          f"({time.perf_counter() - t0:.1f} s both)", flush=True)
    print(f"phase 13 on {card}: {sum(r['launches'] for r in runs)} "
          f"commit_window launches in {sum(r['steps'] for r in runs)} "
          f"protocol steps, no commit_scan launch", flush=True)
    return runs


# ---------------------------------------------------------------------------
# phase 14: the profiler, interposed apps under the sharded driver, and
# one replica per process
# ---------------------------------------------------------------------------

# the 8a variants' CUDA kernels per step(), for (14a)'s program reports
VARIANT_KERNELS: dict = {}


def phase_profiler(dev, card: str, kernels_per_step: float) -> list:
    """(14a): a ``ClusterDriver.start_profile`` capture around (6a)'s
    record merged with its spans and host phases; ``program_report`` for
    the four (8a) variants; one capture started by an alert page."""
    from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
    from rdma_paxos_tpu_torch.consensus.state import clone_state
    from rdma_paxos_tpu_torch.consensus.step import make_step_input
    from rdma_paxos_tpu_torch.obs import device as obs_device
    from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    geom, fanout = GEOMETRIES["a"]
    wd = tempfile.mkdtemp(prefix="rp-prof-")
    try:
        rec = drive_front_door(dev, geom, fanout,
                               front_record(FRONT_EVENTS, FRONT_BYTES),
                               FRONT_CONNS, pipeline=2, profile="session",
                               workdir=wd)
        check(rec["launches"] == rec["steps"] > 0,
              f"(14a): {rec['launches']} commit_window launches in "
              f"{rec['steps']} protocol steps")
        check(rec["statuses"] == [0] * FRONT_EVENTS
              and (rec["fired"] == 1).all(),
              "(14a): not every event was acked once with status 0")
        doc = rec["merged"]
        other = doc["otherData"]
        kern = [e for e in doc["traceEvents"] if e.get("ph") == "X"
                and e.get("pid", 0) >= obs_device.DEVICE_PID_BASE
                and "commit_window_kernel" in e.get("name", "")]
        check(0 < len(kern) <= rec["steps"],
              f"(14a): the merged timeline holds {len(kern)} commit_window "
              f"kernel events for {rec['steps']} protocol steps")
        check(other["host_phase_events"] > 0 and other["spans"] > 0,
              f"(14a): the merged timeline lacks a layer: {other}")
        ts = [e["ts"] for e in doc["traceEvents"] if "ts" in e]
        check(min(ts) >= 0, "(14a): an event before the merged epoch")
        print(f"profiler (14a) on {card}: start_profile around (6a)'s "
              f"record ({FRONT_EVENTS} SENDs, pipelined, {rec['steps']} "
              f"protocol steps in {rec['wall'] * 1e3:.1f} ms under the "
              f"capture); trace {rec['trace_mb']:.1f} MB in "
              f"{rec['stop_s']:.2f} s to stop and export; merged timeline "
              f"{len(doc['traceEvents'])} events: {other['spans']} spans, "
              f"{other['host_phase_events']} host-phase slices, "
              f"{other['device_events']} profiler slices "
              f"({other['device_events_dropped']} dropped), of them "
              f"{len(kern)} commit_window kernels", flush=True)

        # program_report per variant, held against phases 5 and 8a
        B = geom["batch_slots"]
        rows = []
        for name, kw in VARIANTS:
            c = SimCluster(LogConfig(**geom), R, fanout=fanout, device=dev,
                           **kw)
            c.run_until_elected(0)
            c.submit_many(0, [(3, 1, 0, b"x" * 16)] * B)
            c.step()
            rep = obs_device.program_report(c, tiers=(2,))
            v = {r["variant"]: r for r in rep["variants"]}
            check(list(v) == ["step/full", "step/stable", "burst/K=2"],
                  f"(14a): variants {list(v)}")
            inp = make_step_input(c.cfg, R, device=dev)
            st = clone_state(c.state)
            ops = op_count(lambda: c._steps[False](st, inp))
            check(v["step/stable"]["ops"] == ops,
                  f"(14a) {name}: program_report counts "
                  f"{v['step/stable']['ops']} ops, op_count {ops}")
            per_step = VARIANT_KERNELS[name]
            check(v["step/stable"]["kernels"] <= per_step
                  and v["burst/K=2"]["kernels"] <= 2 * per_step
                  and (name != "neither"
                       or v["step/stable"]["kernels"] <= kernels_per_step),
                  f"(14a) {name}: report kernels "
                  f"{[r['kernels'] for r in rep['variants']]} against "
                  f"{per_step} per step() (8a), {kernels_per_step} (5)")
            rows.append((name, [(r["ops"], r["kernels"])
                                for r in rep["variants"]], per_step))
        print(f"program_report (14a) at geometry (a) on {card} (ops, CUDA "
              f"kernels of step/full, step/stable, burst/K=2; against 8a's "
              f"kernels per step()): " + "; ".join(
                  f"{n} {r} vs {k:.1f}" for n, r, k in rows), flush=True)

        # one capture per process, started by the first page
        d = ClusterDriver(LogConfig(**geom), R, fanout=fanout, device=dev,
                          timeout_cfg=TimeoutConfig(**TIMERS_OFF),
                          profile_on_page=30.0, workdir=wd)
        try:
            d.runtimes[0].timer._deadline = 0.0
            d.step()
            check(d.profile_session is None, "(14a): a capture before a page")
            d.obs.metrics.inc("audit_divergence_total")
            d.evaluate_alerts()
            s = d.profile_session
            check(s is not None and s.active,
                  "(14a): the page started no capture")
            d.step()
            d.evaluate_alerts()
            check(d.profile_session is s, "(14a): a second capture started")
            s._deadline = 0.0
            d._poll_profile()
            check(not s.active and s.trace_files,
                  "(14a): the observe pass did not end the capture")
        finally:
            d.stop()
        print(f"profile_on_page (14a): one bounded capture started by the "
              f"page ({len(s.chrome_events())} events), none after",
              flush=True)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    return [dict(launches=rec["launches"], steps=rec["steps"])]


SHARDED_APP_G = 2
SHARDED_APP_CLIENTS = 4           # request-reply clients, one connection each
SHARDED_APP_SETS = 500
SHARDED_APP_DURING = 100          # group 1's writes while group 0 fails over


def sharded_app_prefixes(router, per_group: int = 2) -> list:
    """``per_group`` key prefixes routed to each group."""
    out = {g: [] for g in range(router.n_groups)}
    i = 0
    while min(len(v) for v in out.values()) < per_group:
        p = b"p%d" % i
        g = router.group_of(p)
        if len(out[g]) < per_group:
            out[g].append(p.decode())
        i += 1
    return [p for g in sorted(out) for p in out[g]]


def pipelined_gets(port: int, keys: list, chunk: int = 256) -> list:
    """GET each key on one connection, a chunk of lines at a time."""
    c = AppClient(port)
    got = []
    try:
        for i in range(0, len(keys), chunk):
            part = keys[i:i + chunk]
            c.s.sendall(b"".join(b"GET %s\n" % k.encode() for k in part))
            got.extend(c.f.readline().strip() for _ in part)
    finally:
        c.close()
    return got


def phase_sharded_apps(dev, card: str) -> dict:
    """(14b): three toy apps under ``LD_PRELOAD`` behind a
    ``ShardedClusterDriver`` at G = 2: SETs over both groups' prefixes
    from every replica's app, one group's leader failed over while the
    other group keeps serving, then every acknowledged key read back
    from every replica's app."""
    from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.runtime.sharded_driver import (
        ShardedClusterDriver)
    build_native()
    geom, _ = GEOMETRIES["a"]
    G = SHARDED_APP_G
    wd = tempfile.mkdtemp(prefix="rp-sapps-")
    ports = free_ports(R)
    # the serial loop: every heartbeat dispatch is a step that can carry
    # the failover's election timer
    d = ShardedClusterDriver(LogConfig(**geom), R, G, workdir=wd,
                             app_ports=ports, fanout="gather", device=dev,
                             pipeline=1,
                             timeout_cfg=TimeoutConfig(elec_timeout_low=1.0,
                                                       elec_timeout_high=2.0),
                             group_timer_lo=4, group_timer_hi=8)
    apps = []
    try:
        d.prewarm()
        for r, port in enumerate(ports):
            env = dict(os.environ, LD_PRELOAD=str(NATIVE / "interpose.so"),
                       RP_PROXY_SOCK=os.path.join(wd, f"proxy{r}.sock"))
            with open(os.path.join(wd, f"app{r}.err"), "w") as err:
                apps.append(subprocess.Popen(
                    [str(NATIVE / "toyserver"), str(port)], env=env,
                    stderr=err))
        time.sleep(0.3)                      # let the apps bind
        commit_window.launches = 0
        steps0 = d.cluster.step_index
        d.run(period=0.002)
        wait_for(lambda: min(d.leaders()) >= 0, "a leader in every group")
        leaders0 = d.leaders()
        prefixes = sharded_app_prefixes(d.router)
        groups = [d.router.group_of(p.encode()) for p in prefixes]
        check(sorted(set(groups)) == list(range(G)),
              f"(14b) prefixes {prefixes} route to {groups}")
        lat, errors, acked = [], [], []

        def client(k: int) -> None:
            try:
                c = AppClient(ports[k % R])
                for i in range(SHARDED_APP_SETS // SHARDED_APP_CLIENTS):
                    key = f"{prefixes[k]}-{i}"
                    t = time.perf_counter()
                    got = c.cmd(f"SET {key} v{k}-{i}")
                    lat.append(time.perf_counter() - t)
                    if got != b"+OK":
                        errors.append((k, i, got))
                    else:
                        acked.append((key, f"v{k}-{i}".encode()))
                c.close()
            except OSError as exc:
                errors.append((k, exc))
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SHARDED_APP_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        check(not errors and len(acked) == SHARDED_APP_SETS,
              f"(14b) client SETs failed: {errors[:4]}")
        # fail over group 0's leader: isolated in group 0 only. The
        # driver's group timers tick only for a leaderless group, and an
        # isolated leader keeps its claim (ROADMAP Queue 3), so group 0's
        # election timer is fired on a surviving replica here, once, as
        # the shard nemesis fires it
        g0, g1 = 0, 1
        old = leaders0[g0]

        def closes(n):
            """Every replica's store holds ``n`` CLOSE records and no
            waiter is left: an event of the cut group still in flight
            fails at the leadership change, and a failed event marks its
            front-end's app dirty."""
            for rt in d.runtimes:
                st = rt.store
                if sum(st.read(i)[0] == 4 for i in range(len(st))) < n:
                    return False
            with d._lock:
                return d._waiter_count() == 0
        wait_for(lambda: closes(SHARDED_APP_CLIENTS),
                 "(14b) the clients' CLOSEs committed everywhere")
        d.cluster.partition(g0, [[old], [r for r in range(R) if r != old]])
        fire = {g0: [(old + 1) % R]}
        engine_step, engine_burst = d.cluster.step, d.cluster.step_burst

        def step_with_timer(timeouts=()):
            if fire:
                timeouts = {**dict(timeouts or {}), **fire}
                fire.clear()
            return engine_step(timeouts)

        def burst_or_timer(**kw):
            # the next dispatch is a serial step (a burst carries no
            # election) that fires the timer
            return (step_with_timer() if fire else engine_burst(**kw))
        d.cluster.step, d.cluster.step_burst = step_with_timer, burst_or_timer
        k1 = groups.index(g1)
        c1 = AppClient(ports[(old + 1) % R])
        served, t_over = [], None
        t_cut = time.perf_counter()
        while time.perf_counter() - t_cut < 60:
            key = f"{prefixes[k1]}-during-{len(served)}"
            got = c1.cmd(f"SET {key} x")
            check(got == b"+OK", f"(14b) group {g1} refused a write "
                                 f"during group {g0}'s failover: {got}")
            served.append(time.perf_counter() - t_cut)
            acked.append((key, b"x"))
            if t_over is None and d.leaders()[g0] not in (-1, old):
                t_over = time.perf_counter() - t_cut
            if t_over is not None and len(served) >= SHARDED_APP_DURING:
                break
        c1.close()
        new = d.leaders()[g0]
        check(new not in (-1, old), f"(14b) group {g0} never failed over "
                                    f"from replica {old}")
        k0 = groups.index(g0)
        c0 = AppClient(ports[new])
        check(c0.cmd(f"SET {prefixes[k0]}-after ok") == b"+OK",
              f"(14b) group {g0}'s new leader did not serve a write")
        c0.close()
        acked.append((f"{prefixes[k0]}-after", b"ok"))
        d.cluster.heal(g0)
        wait_for(lambda: closes(SHARDED_APP_CLIENTS + 2),
                 "(14b) the failover clients' CLOSEs committed everywhere")
        # every acknowledged key from every replica's app, the deposed
        # leader's too once it has caught up
        keys = [k for k, _ in acked]
        want = [v for _, v in acked]
        for r in range(R):
            wait_for(lambda r=r: pipelined_gets(ports[r], keys) == want,
                     f"(14b) replica {r}'s app holding every acked key",
                     timeout=60)
        d.stop()
        check(d.loop_error is None, f"(14b) the loop crashed: "
                                    f"{d.loop_error!r}")
        launches = commit_window.launches
        steps = d.cluster.step_index - steps0
        check(launches == steps > 0, f"(14b) {launches} commit_window "
                                     f"launches in {steps} protocol steps")
    except Exception:
        last = d.cluster.last or {}
        print(f"(14b) leaders {d.leaders()} loop_error {d.loop_error!r} "
              f"steps {d.cluster.step_index} " + " ".join(
                  f"{k} {np.asarray(last[k]).tolist()}"
                  for k in ("role", "term", "commit", "end") if k in last)
              + f" stepped_down {sorted(d.stepped_down)} counters "
              + str({k: v for k, v in d.obs.metrics.snapshot()[
                  "counters"].items() if "refused" in k or "failed" in k
                  or "sever" in k}), flush=True)
        for r in range(R):
            err = Path(wd, f"app{r}.err")
            if err.exists():
                print(f"app {r} stderr: {err.read_text()[-400:]!r}",
                      flush=True)
        raise
    finally:
        d.stop()
        for a in apps:
            a.kill()
            a.wait()
        shutil.rmtree(wd, ignore_errors=True)
    lat = np.sort(np.array(lat))
    print(f"sharded apps (14b) on {card}: 3 toyserver apps under "
          f"LD_PRELOAD=native/interpose.so behind ShardedClusterDriver at "
          f"G = {G}, geometry (a), gather, serial loop; group leaders "
          f"{leaders0}; "
          f"{SHARDED_APP_SETS} SETs from {SHARDED_APP_CLIENTS} clients on "
          f"replicas' apps {[k % R for k in range(SHARDED_APP_CLIENTS)]} "
          f"over prefixes {prefixes} (groups {groups}) in {wall:.2f} s = "
          f"{SHARDED_APP_SETS / wall:.1f} requests/s, latency p50 "
          f"{lat[len(lat) // 2] * 1e3:.2f} ms p99 "
          f"{lat[int(len(lat) * 0.99)] * 1e3:.2f} ms; group {g0} failed "
          f"over from replica {old} to {new} in {t_over:.3f} s; group "
          f"{g1} served {len(served)} writes from the cut on, in "
          f"{served[-1]:.2f} s; all {len(acked)} acked "
          f"keys read back from 3/3 apps; {launches} commit_window launches in "
          f"{steps} protocol steps", flush=True)
    return dict(launches=launches, steps=steps)


# (14c): geometry (a) with a rollover point the 32 batches cross
HOST_GEOM = dict(GEOMETRIES["a"][0], rebase_threshold=1 << 16)
HOST_BATCHES = 32
HOST_TIMEOUT = 600                 # seconds for one world's three ranks
HOST_SEND = 3                      # EntryType.SEND


def host_payload(i: int) -> bytes:
    return (b"h%09d" % i).ljust(FRONT_BYTES, b".")


def host_drill(hd, pid: int, fanout: str, n_batches: int, rec: dict,
               expect_rebase: bool) -> dict:
    """One rank's script: elect 0, ``n_batches`` full batches from the
    leader (timed), a burst at K = 2 and at K = 4, a K = 2 scan, the
    rollovers the step reports, then a leader change (a partition
    through ``peer_mask`` under gather; replica 1's timer under psum,
    where a partition mask is refused). Every call's outputs land in
    ``rec``; returns the protocol steps and the timed window."""
    B = hd.cfg.batch_slots
    st = dict(steps=0, seq=0, applied=0, rebases=0, calls=0)

    def put(tag, res):
        st["calls"] += 1
        for k, v in res.items():
            rec[f"{st['calls']:05d}.{tag}.{k}"] = np.asarray(v)
        st["applied"] = int(res["commit"])
        rd = int(res["rebase_delta"]) if "rebase_delta" in res else 0
        if rd > 0:
            hd.rebase(rd)
            st["applied"] -= rd
            st["rebases"] += 1
        return res

    def batch(lead):
        rows = [(HOST_SEND, 1, st["seq"] + j + 1,
                 host_payload(st["seq"] + j)) for j in range(B)]
        st["seq"] += B
        return rows if lead else []

    res = put("step", hd.step(timeout_fired=(pid == 0)))
    st["steps"] += 1
    check(int(res["term"]) == 1, f"rank {pid}: no election ({res})")
    ex0, exs0 = hd.world.exchanges, hd.world.exchange_s
    with alone():
        t0 = time.perf_counter()
        for _ in range(n_batches):
            res = put("step", hd.step(batch=batch(pid == 0),
                                      apply_done=st["applied"]))
            st["steps"] += 1
        wall = time.perf_counter() - t0
    timed = dict(wall=wall, exchanges=hd.world.exchanges - ex0,
                 exchange_s=hd.world.exchange_s - exs0,
                 steps=n_batches, entries=n_batches * B)
    res = put("step", hd.step(apply_done=st["applied"]))
    st["steps"] += 1
    commit = int(res["commit"])
    wd, wm = hd.fetch_local_window(commit - B)
    got = [wd[j].astype("<i4").tobytes()[:int(wm[j, 4])] for j in range(B)]
    check(got == [host_payload(st["seq"] - B + j) for j in range(B)],
          f"rank {pid}: fetch_local_window lacks the committed payloads")
    for K in (2, 4):
        res = put(f"burst{K}", hd.step_burst(
            K, [batch(pid == 0) for _ in range(K)],
            apply_done=st["applied"]))
        st["steps"] += K
    res, (rd, rm) = hd.step_scan(2, [batch(pid == 0) for _ in range(2)],
                                 apply_done=st["applied"])
    put("scan", dict(res, wd=rd, wm=rm))
    st["steps"] += 2
    if expect_rebase:
        check(st["rebases"] >= 1, f"rank {pid}: no rollover")
    # a heartbeat brings every commit to the leader's: a new leader's
    # commit window starts at its own commit and spans W entries, so a
    # full batch it has not seen committed would hide its NOOP
    put("step", hd.step(apply_done=st["applied"]))
    st["steps"] += 1
    cut = np.array([[1, 0, 0], [0, 1, 1], [0, 1, 1]], np.int32)[pid]
    mask = None
    if fanout == "psum":
        try:
            hd.step(peer_mask=cut)
            check(False, "the psum world took a partition mask")
        except ValueError:
            pass
    else:
        mask = cut               # one entry the heal will truncate
        put("step", hd.step(batch=batch(pid == 0)[:1], peer_mask=mask,
                            apply_done=st["applied"]))
        st["steps"] += 1
    res = put("step", hd.step(timeout_fired=(pid == 1), peer_mask=mask,
                              apply_done=st["applied"]))
    st["steps"] += 1
    # the majority's writes stay within one window, so the deposed
    # leader catches up from the log after the heal
    for _ in range(4):
        res = put("step", hd.step(batch=batch(pid == 1)[:B // 8],
                                  peer_mask=mask, apply_done=st["applied"]))
        st["steps"] += 1
    for _ in range(5):
        res = put("step", hd.step(apply_done=st["applied"]))
        st["steps"] += 1
    check(int(res["leader_id"]) == 1 and int(res["term"]) == 2
          and int(res["commit"]) == int(res["end"]),
          f"rank {pid} ({fanout}): no failover to replica 1 ({res})")
    for k, v in hd.export_local_row().items():
        rec[f"row.{k}"] = v
    return dict(steps=st["steps"], rebases=st["rebases"], timed=timed)


def host_rank(pid: int, port: int, device: str, cases_json: str,
              out: str) -> None:
    """A rank of (14c)'s world (run as its own process): the drill of
    each case ``[geometry tag, geometry, batches, fan-out]`` in turn, in
    one process group; its outputs, final rows, protocol steps and
    ``commit_window`` launches saved to ``out`` (npz) with the timings,
    keyed ``<tag>/<fan-out>``."""
    load_port()
    import torch.distributed as dist
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.runtime.host import HostReplicaDriver
    torch.set_num_threads(2)
    arrays, meta = {}, {}
    try:
        for i, (geo, geom, n_batches, fanout) in enumerate(
                json.loads(cases_json)):
            hd = HostReplicaDriver(
                LogConfig(**geom), process_id=pid, num_processes=R,
                coordinator=f"127.0.0.1:{port}", fanout=fanout,
                device=device, initialize_distributed=(i == 0),
                timeout=HOST_TIMEOUT / 2)
            rec = {}
            commit_window.launches = 0
            info = host_drill(hd, pid, fanout, n_batches, rec,
                              expect_rebase=geom.get("rebase_threshold",
                                                     1 << 30) < (1 << 30))
            info["launches"] = commit_window.launches
            arrays.update({f"{geo}/{fanout}/{k}": v for k, v in rec.items()})
            meta[f"{geo}/{fanout}"] = info
            del hd
        np.savez(out, **arrays)
        with open(out + ".json", "w") as f:
            json.dump(meta, f)
        print(f"RANK{pid} OK", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def start_rank_world(fn: str, args: tuple, wd: str, tag: str,
                     timeout: float, what: str, nice: int = 0,
                     pause=()) -> dict:
    """Start three processes, each calling ``chip_smoke.<fn>(rank, port,
    *args, out)`` on one free coordinator port, at CPU priority ``nice``
    (a CPU twin's world runs beside the card's at the lowest); rank 0,
    which reports the world's times, stops the processes ``pause`` (the
    twin world's) in its timed windows (:func:`alone`). Pass the handle
    to :func:`wait_rank_world`."""
    port = free_ports(1)[0]
    outs = [os.path.join(wd, f"{tag}{r}.npz") for r in range(R)]
    code = ("import os, sys; os.nice({nice}); sys.path.insert(0, {root!r}); "
            "import chip_smoke; chip_smoke.{fn}({r}, {port}, *{args!r}, "
            "{out!r})")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(nice=nice, root=str(ROOT), fn=fn,
                                           r=r, port=port, args=args,
                                           out=outs[r])],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=dict(os.environ, **{PAUSE_ENV: ",".join(map(str, pause))})
        if pause and r == 0 else None)
        for r in range(R)]
    return dict(procs=procs, outs=outs, tag=tag, what=what,
                t0=time.perf_counter(), deadline=time.time() + timeout,
                timeout=timeout)


def wait_rank_world(w: dict) -> tuple:
    """Wait for a :func:`start_rank_world`; fails if a rank exits
    non-zero, prints no ``RANK<r> OK`` or runs past its timeout. Returns
    per rank ``(arrays, info, output)`` from ``out`` (npz) and
    ``out + ".json"``, and the world's seconds from its start."""
    procs, tag, what = w["procs"], w["tag"], w["what"]
    texts = [""] * R
    try:
        for r, p in enumerate(procs):
            try:
                texts[r] = p.communicate(
                    timeout=max(1.0, w["deadline"] - time.time()))[0].decode()
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"check failed: {what} {tag} rank {r} "
                                   f"ran past {w['timeout']} s")
        seconds = time.perf_counter() - w["t0"]
        for r, p in enumerate(procs):
            check(p.returncode == 0 and f"RANK{r} OK" in texts[r],
                  f"{what} {tag} rank {r} exited {p.returncode}:\n"
                  f"{texts[r][-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for r in range(R):
        with open(w["outs"][r] + ".json") as f:
            info = json.load(f)
        res.append((dict(np.load(w["outs"][r])), info, texts[r]))
    return res, seconds


def start_host_world(device: str, cases: tuple, wd: str, tag: str,
                     nice: int = 0, pause=()) -> dict:
    """Three rank processes of :func:`host_rank` running ``cases`` in one
    process group, bounded by :data:`HOST_TIMEOUT` (see
    :func:`start_rank_world`)."""
    return start_rank_world("host_rank", (device, json.dumps(cases)),
                            wd, tag, HOST_TIMEOUT, "(14c)", nice, pause)


def run_host_world(device: str, cases: tuple, wd: str, tag: str) -> list:
    """:func:`start_host_world` waited for: per rank ``(arrays, meta,
    output)``."""
    return wait_rank_world(start_host_world(device, cases, wd, tag))[0]


# (14c): geometry (a) under psum and gather, (b) for a few steps
HOST_CASES = (("a", HOST_GEOM, HOST_BATCHES, "psum"),
              ("a", HOST_GEOM, HOST_BATCHES, "gather"),
              ("b", GEOMETRIES["b"][0], 4, "gather"))


def phase_host_world(card: str) -> list:
    """(14c): three ranks, each ``HostReplicaDriver(device="cuda")`` on
    the one card under gloo, at geometry (a) under psum and gather and at
    (b) for a few steps, one world for all three; every rank equal to its
    CPU twin (the same script at ``device="cpu"``), one
    ``commit_window`` launch per protocol step per rank."""
    wd = tempfile.mkdtemp(prefix="rp-host-")
    runs = []
    try:
        # the CPU twin's world beside the card's, at the lowest priority,
        # stopped while the card's rank 0 times its batches
        cpu_world = start_host_world("cpu", HOST_CASES, wd, "cpu",
                                     nice=TWIN_NICE)
        gpu, t_gpu = wait_rank_world(start_host_world(
            "cuda", HOST_CASES, wd, "gpu",
            pause=[p.pid for p in cpu_world["procs"]]))
        cpu, t_cpu = wait_rank_world(cpu_world)
        backend = [ln for ln in gpu[0][2].splitlines()
                   if ln.startswith("replica world:")]
        for r in range(R):
            (ga, gm, _), (ca, cm, _) = gpu[r], cpu[r]
            check(sorted(ga) == sorted(ca) and all(
                ga[k].dtype == ca[k].dtype and np.array_equal(ga[k], ca[k])
                for k in ga), f"(14c) rank {r} differs from its CPU twin: "
                + str([k for k in ga if k not in ca or
                       not np.array_equal(ga[k], ca[k])][:6]))
            for geo, _g, _n, f in HOST_CASES:
                key = f"{geo}/{f}"
                check(gm[key]["launches"] == gm[key]["steps"] > 0,
                      f"(14c) ({geo}, {f}) rank {r}: "
                      f"{gm[key]['launches']} commit_window launches in "
                      f"{gm[key]['steps']} protocol steps")
                check(cm[key]["launches"] == 0,
                      f"(14c) the CPU twin launched a kernel")
                runs.append(dict(launches=gm[key]["launches"],
                                 steps=gm[key]["steps"]))
        for geo, _g, _n, f in HOST_CASES:
            info = gpu[0][1][f"{geo}/{f}"]
            tm = info["timed"]
            rate = "" if geo == "b" else (
                f": {tm['steps']} full batches in {tm['wall'] * 1e3:.1f} "
                f"ms = {tm['steps'] / tm['wall']:.1f} steps/s, "
                f"{tm['entries'] / tm['wall']:.0f} committed entries/s, "
                f"{tm['exchange_s'] / tm['exchanges'] * 1e3:.3f} ms per "
                f"exchange ({tm['exchanges']} exchanges, "
                f"{tm['exchange_s'] / tm['wall']:.2f} of the wall)")
            print(f"host world (14c) geometry ({geo}) {f} on {card}: 3 "
                  f"ranks on one card ({backend[0] if backend else '?'})"
                  f"{rate}; {info['steps']} protocol steps and "
                  f"{info['rebases']} rollovers per rank, one "
                  f"commit_window launch each; outputs and rows of 3/3 "
                  f"ranks equal to the CPU twin", flush=True)
        print(f"host world (14c): card world {t_gpu:.1f} s, CPU twin "
              f"{t_cpu:.1f} s (process start included; (a) and (b) in one "
              f"world each, the two side by side)", flush=True)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    return runs


# ---------------------------------------------------------------------------
# phase 15: the per-host daemon, the launcher and the elastic plane
# ---------------------------------------------------------------------------

NODE_ITERS = 20               # iterations of (15a)'s deterministic drain
NODE_TIMEOUT = 300            # seconds for one world of three processes
NODE_TIMING = dict(elec_timeout_low=2.0, elec_timeout_high=4.0)
DEPLOY_SETS = 2000            # pipelined SETs of a (15a) deployment run
DEPLOY_CHUNK = 256            # SET lines per pipelined send
ELASTIC_SETS = 200            # pipelined SETs per write step of (15b)
ELASTIC_BARRIER = 80.0        # the controller's barrier budget (s)
ELASTIC_WAIT = 180.0          # seconds for any one generation event


def node_rank(pid: int, port: int, device: str, geom_json: str,
              n_iters: int, segments_json: str, out: str) -> None:
    """A rank of (15a)'s deterministic run (its own process): a
    ``NodeDaemon`` at ``device``, the prewarm burst, rank 0's timer
    forced, then one segment per ``[RP_BURST, events]`` of
    ``segments_json`` (bursts on, then off — the switch is read at every
    iteration, set at the same iteration on every rank and in the CPU
    twin alike): a record of that many SENDs on fresh connections
    through rank 0's shim handler and ``n_iters`` iterations. Every iteration's outputs,
    the events' statuses, the store bytes, the hard state, ``meta()`` and
    the final row are saved to ``out`` (npz) with each segment's counts
    and times."""
    load_port()
    segments = json.loads(segments_json)
    os.environ["RP_BURST"] = segments[0][0]
    import torch.distributed as dist
    from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.proxy.proxy import PendingEvent
    from rdma_paxos_tpu_torch.runtime.node import NodeDaemon
    torch.set_num_threads(2)
    arrays, info = {}, {}
    commit_window.launches = 0
    node = NodeDaemon(
        LogConfig(**json.loads(geom_json)), process_id=pid,
        num_processes=R, coordinator=f"127.0.0.1:{port}",
        workdir=out + ".wd", timeout_cfg=TimeoutConfig(**TIMERS_OFF),
        device=device, timeout=NODE_TIMEOUT / 2)
    try:
        node.prewarm_burst()

        def iterate(tag: str) -> None:
            res = node.iterate()
            for k, v in res.items():
                arrays[f"{node.iterations:04d}.{tag}.{k}"] = np.asarray(v)
        if pid == 0:
            node.timer._deadline = 0.0
        iterate("elect")
        for s, (burst, n_events) in enumerate(segments):
            os.environ["RP_BURST"] = burst
            evs = []
            if pid == 0:
                conns = [100 * (s + 1) + i for i in range(FRONT_CONNS)]
                evs = [node._on_event(2, c, b"") for c in conns]
                evs += [node._on_event(3, conns[i % FRONT_CONNS], p)
                        for i, p in enumerate(front_record(
                            n_events, FRONT_BYTES, SEED + s))]
                check(all(isinstance(e, PendingEvent) for e in evs),
                      "the leader refused an event")
            if device == "cuda":
                torch.cuda.synchronize()
            steps0, launches0 = node.steps, commit_window.launches
            with alone():
                t0 = time.perf_counter()
                done_at = None
                for i in range(n_iters):
                    iterate(f"drain{s}")
                    if evs and done_at is None and all(e.done.is_set()
                                                       for e in evs):
                        done_at = (i + 1, time.perf_counter() - t0)
                seg = dict(burst=burst, wall=time.perf_counter() - t0,
                           steps=node.steps - steps0,
                           launches=commit_window.launches - launches0)
            if pid == 0:
                check(done_at is not None, f"events still pending after "
                                           f"{n_iters} iterations")
                seg.update(events=len(evs), done_iters=done_at[0],
                           done_s=done_at[1])
            arrays[f"statuses{s}"] = np.array([e.status for e in evs],
                                              np.int32)
            info[f"seg{s}"] = seg
        arrays["store"] = np.frombuffer(node.store.dump(), np.uint8)
        arrays["hard"] = np.array(node.hard.load(), np.int64)
        for k, v in node.meta().items():
            arrays[f"meta.{k}"] = np.asarray(v)
        for k, v in node.dump_row().items():
            arrays[f"row.{k}"] = v
        info.update(steps=node.steps, launches=commit_window.launches,
                    iterations=node.iterations)
        np.savez(out, **arrays)
        with open(out + ".json", "w") as f:
            json.dump(info, f)
        print(f"RANK{pid} OK", flush=True)
    finally:
        node.close()
        if dist.is_initialized():
            dist.destroy_process_group()


def start_node_world(device: str, geom: dict, n_iters: int,
                     segments: tuple, wd: str, tag: str, nice: int = 0,
                     pause=()):
    """Three :func:`node_rank` processes (see :func:`start_rank_world`),
    bounded by :data:`NODE_TIMEOUT`."""
    return start_rank_world("node_rank", (device, json.dumps(geom), n_iters,
                                          json.dumps(segments)),
                            wd, tag, NODE_TIMEOUT, "(15a)", nice, pause)


def kill_group(p: subprocess.Popen) -> None:
    """SIGKILL a process started with ``start_new_session`` and everything
    in its process group (its app, its worker), then reap it."""
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    p.wait()


def log_leader(wd: str) -> int:
    """The replica whose log holds the highest-term ``[T<n>] LEADER``
    line, or -1."""
    best, lead = 0, -1
    for r in range(R):
        p = Path(wd, f"replica{r}.log")
        if not p.exists():
            continue
        for ln in p.read_text().splitlines():
            if "] LEADER" in ln:
                term = int(ln.split("[T", 1)[1].split("]", 1)[0])
                if term > best:
                    best, lead = term, r
    return lead


def deploy_world(geom: dict, env: dict, n_sets: int, wd: str) -> dict:
    """(15a)'s deployment: three ``python -m
    rdma_paxos_tpu_torch.runtime.launch_node --device cuda`` processes,
    each starting its toy app under ``LD_PRELOAD``; ``n_sets`` pipelined
    SETs through the leader's app, then every key read back from every
    app. The launchers run until killed (with their apps)."""
    os.makedirs(wd, exist_ok=True)
    coord, *ports = free_ports(R + 1)
    cfg = os.path.join(wd, "cfg.json")
    with open(cfg, "w") as f:
        json.dump(dict(log=geom, timing=NODE_TIMING), f)
    base = dict(os.environ, PYTHONPATH=str(ROOT), group_size=str(R), **env)
    procs = []
    try:
        t0 = time.perf_counter()
        for i in range(R):
            with open(os.path.join(wd, f"node{i}.out"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "rdma_paxos_tpu_torch.runtime.launch_node",
                     "--coordinator", f"127.0.0.1:{coord}", "--workdir", wd,
                     "--app-port", str(ports[i]), "--iterations", "1000000",
                     "--config", cfg, "--device", "cuda"],
                    cwd=str(ROOT), env=dict(base, server_idx=str(i)),
                    stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True))
        boot = wait_for(lambda: log_leader(wd) >= 0
                        or any(p.poll() is not None for p in procs),
                        "a leader line in the launchers' logs", 120)
        check(all(p.poll() is None for p in procs), "a launcher exited")
        lead = log_leader(wd)
        items = [(b"d%05d" % i, b"v%05d" % i) for i in range(n_sets)]
        wall, lat = pipelined_sets(ports[lead], items, DEPLOY_CHUNK)
        keys = [k.decode() for k, _ in items]
        want = [v for _, v in items]
        for r in range(R):
            wait_for(lambda r=r: pipelined_gets(ports[r], keys) == want,
                     f"app {r} serving every SET", 60)
        check(log_leader(wd) == lead, "the leader changed during the run")
        check(all(p.poll() is None for p in procs), "a launcher exited")
        world = [ln for ln in Path(wd, "node0.out").read_text().splitlines()
                 if ln.startswith("replica world:")]
        return dict(lead=lead, boot_s=boot, wall=wall, lat=lat,
                    world=world[0] if world else "?",
                    total_s=time.perf_counter() - t0)
    except Exception:
        for i in range(R):
            p = Path(wd, f"node{i}.out")
            if p.exists():
                print(f"launcher {i} output: {p.read_text()[-1500:]}",
                      flush=True)
        raise
    finally:
        for p in procs:
            kill_group(p)


def compare_node_worlds(tag: str, gpu: list, cpu: list) -> None:
    for r in range(R):
        ga, ca = gpu[r][0], cpu[r][0]
        bad = [k for k in sorted(set(ga) | set(ca))
               if k not in ga or k not in ca or ga[k].dtype != ca[k].dtype
               or not np.array_equal(ga[k], ca[k])]
        check(not bad, f"{tag} rank {r} differs from its CPU twin: "
                       f"{bad[:6]}")


# (15a) deployments: (geometry tag, RP_BURST, SETs). Bursts off runs at
# (b), which is also the boot check there
DEPLOYS = (("a", "1", DEPLOY_SETS), ("b", "0", DEPLOY_SETS))
# (15a) deterministic segments, in turn: (RP_BURST, SENDs of the record)
NODE_SEGMENTS = (("1", FRONT_EVENTS), ("0", 8192))


def phase_node(card: str) -> list:
    """(15a): the three-host ``NodeDaemon`` world on the one card."""
    wd = tempfile.mkdtemp(prefix="rp-node-")
    geom = GEOMETRIES["a"][0]
    runs = []
    try:
        for geo, burst, n_sets in DEPLOYS:
            d = deploy_world(GEOMETRIES[geo][0], dict(RP_BURST=burst),
                             n_sets, os.path.join(wd, f"deploy{geo}"))
            lat = d["lat"]
            print(f"node world (15a) deployment, geometry ({geo}) psum, "
                  f"RP_BURST={burst} on {card}: 3 launch_node processes "
                  f"({d['world']}) with toy apps; leader {d['lead']} after "
                  f"{d['boot_s']:.1f} s; {n_sets} pipelined SETs "
                  f"({DEPLOY_CHUNK} per send) in {d['wall']:.3f} s = "
                  f"{n_sets / d['wall']:.1f} requests/s, latency p50 "
                  f"{lat[len(lat) // 2] * 1e3:.2f} ms p99 "
                  f"{lat[int(len(lat) * 0.99)] * 1e3:.2f} ms; every key "
                  f"read back from 3/3 apps; world {d['total_s']:.1f} s",
                  flush=True)
        # the deterministic run against its CPU twin: bursts on (the
        # card's default), then off, in one world each; the twin's world
        # runs beside the card's at the lowest CPU priority, stopped while
        # the card's rank 0 times its segments
        cpu_world = start_node_world("cpu", geom, NODE_ITERS, NODE_SEGMENTS,
                                     wd, "cpu-", nice=TWIN_NICE)
        gpu_world = start_node_world(
            "cuda", geom, NODE_ITERS, NODE_SEGMENTS, wd, "gpu-",
            pause=[p.pid for p in cpu_world["procs"]])
        gpu, t_gpu = wait_rank_world(gpu_world)
        cpu, t_cpu = wait_rank_world(cpu_world)
        compare_node_worlds("(15a) deterministic", gpu, cpu)
        for s, (burst, _n) in enumerate(NODE_SEGMENTS):
            for r in range(R):
                gi, ci = gpu[r][1][f"seg{s}"], cpu[r][1][f"seg{s}"]
                check(gi["launches"] == gi["steps"] > 0,
                      f"(15a) RP_BURST={burst} rank {r}: {gi['launches']} "
                      f"commit_window launches in {gi['steps']} protocol "
                      f"steps")
                check(ci["launches"] == 0,
                      "(15a) the CPU twin launched a kernel")
                check(not gpu[r][0][f"statuses{s}"].any(),
                      f"(15a) RP_BURST={burst} rank {r}: an event failed")
                runs.append(dict(launches=gi["launches"], steps=gi["steps"]))
            g0 = gpu[0][1][f"seg{s}"]
            print(f"node world (15a) deterministic, geometry (a) psum, "
                  f"RP_BURST={burst} on {card}: a record of 100-byte SENDs "
                  f"on {FRONT_CONNS} connections ({g0['events']} events "
                  f"with the CONNECTs) through rank 0's _on_event "
                  f"acked in {g0['done_s'] * 1e3:.1f} ms = "
                  f"{g0['events'] / g0['done_s']:.0f} acked events/s over "
                  f"{g0['done_iters']} iterations = "
                  f"{g0['done_iters'] / g0['done_s']:.2f} iterations/s "
                  f"({NODE_ITERS} iterations in {g0['wall']:.3f} s); "
                  f"{g0['steps']} protocol steps and as many commit_window "
                  f"launches per rank", flush=True)
        print(f"node world (15a) deterministic: segments (RP_BURST, SENDs) "
              f"{NODE_SEGMENTS} in one world; outputs, statuses, stores, "
              f"hard state, meta and rows of 3/3 ranks equal to the CPU "
              f"twin (card world {t_gpu:.1f} s, CPU twin {t_cpu:.1f} s, "
              f"side by side)", flush=True)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    return runs


def worker_pid(sup: subprocess.Popen) -> int:
    for c in descendants([sup.pid])[1:]:
        try:
            if b"elastic_worker" in Path(f"/proc/{c}/cmdline").read_bytes():
                return c
        except OSError:
            pass
    return -1


def phase_elastic(card: str) -> list:
    """(15b): a ``GroupController`` here and three ``python -m
    rdma_paxos_tpu_torch.runtime.elastic`` supervisors whose workers run
    on the card at geometry (a), with toy apps: acked SETs; the leader's
    supervisor stopped and its worker SIGKILLed, a generation cut from
    the two survivors with the donor ``(last_log_term, end)`` elects;
    more SETs; that supervisor killed outright and restarted, its host
    rejoining in a later generation; every acked write read back from
    all three apps."""
    from rdma_paxos_tpu_torch.runtime.elastic import (
        GroupController, call, read_rowdump)
    wd = tempfile.mkdtemp(prefix="rp-elastic-")
    ctl = GroupController(expect=R, settle=1.2,
                          barrier_timeout=ELASTIC_BARRIER)
    regs = []
    handle = ctl._handle

    def recorded(req):
        if req.get("op") == "register":
            regs.append(dict(req))
        return handle(req)
    ctl._handle = recorded
    ports = free_ports(R)
    cfg = json.dumps(dict(log=GEOMETRIES["a"][0], timing=NODE_TIMING))
    sups = {}
    dirs = {h: os.path.join(wd, f"h{h}") for h in range(R)}

    def start(h):
        os.makedirs(dirs[h], exist_ok=True)
        with open(os.path.join(dirs[h], "supervisor.out"), "a") as log:
            sups[h] = subprocess.Popen(
                [sys.executable, "-m", "rdma_paxos_tpu_torch.runtime.elastic",
                 "--host-id", str(h), "--controller",
                 f"127.0.0.1:{ctl.port}", "--workdir", dirs[h],
                 "--app-port", str(ports[h]), "--round-iters", "25",
                 "--cfg-json", cfg],
                cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)),
                stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True)

    def spec_at(g):
        with ctl._lock:
            s = ctl._spec
            return dict(s) if s is not None and s["gen"] >= g else None

    def members(s):
        return [m["host"] for m in s["members"]]

    def leader_of(s):
        for h in members(s):
            d = read_rowdump(dirs[h], h)
            if d is not None and d[1].get("gen") == s["gen"] \
                    and d[1].get("leader"):
                return h
        return -1

    def wait_leader(s):
        wait_for(lambda: leader_of(s) >= 0,
                 f"a leader of generation {s['gen']}", ELASTIC_WAIT)
        return leader_of(s)

    acked = []

    def write(s, tag):
        lead = wait_leader(s)
        items = [(f"{tag}{i:04d}", f"{tag}v{i:04d}")
                 for i in range(ELASTIC_SETS)]
        pipelined_sets(ports[lead], [(k.encode(), v.encode())
                                     for k, v in items])
        acked.extend(items)
        return lead

    ends = []
    try:
        for h in range(R):
            start(h)
        wait_for(lambda: spec_at(1), "generation 1", ELASTIC_WAIT)
        s1 = spec_at(1)
        check(members(s1) == [0, 1, 2], f"generation 1 is {members(s1)}")
        lead = write(s1, "a")
        # the leader's host: supervisor stopped (it cannot re-register),
        # worker SIGKILLed
        victim, wpid = lead, worker_pid(sups[lead])
        check(wpid > 0, "no worker process under the leader's supervisor")
        os.kill(sups[victim].pid, signal.SIGSTOP)
        n_regs = len(regs)
        t_kill = time.perf_counter()
        os.kill(wpid, signal.SIGKILL)
        wait_for(lambda: spec_at(2), "generation 2", ELASTIC_WAIT)
        s2 = spec_at(2)
        survivors = members(s2)
        check(victim not in survivors and len(survivors) == R - 1,
              f"generation 2 is {survivors} after losing {victim}")
        metas = {r["host"]: r["meta"] for r in regs[n_regs:]
                 if r["host"] in survivors}
        want = max(sorted(metas), key=lambda h: (
            int(metas[h]["last_log_term"]), int(metas[h]["end"]),
            -h)) if all(metas.values()) else -1
        check(s2["donor"] == want, f"generation 2's donor {s2['donor']}, "
                                   f"the (last_log_term, end) order names "
                                   f"{want} ({metas})")
        # how each survivor learnt of the loss: its collective raised
        # (an unclean end) or the round barrier timed out (a clean one)
        cut_s = time.perf_counter() - t_kill
        learnt = {h: [("collective raised" if not e["clean"] else
                       "barrier timed out") for e in worker_ends(dirs[h], h)
                      if e["gen"] == s1["gen"]] for h in survivors}
        # time to recover: from the SIGKILL to the first acked write
        lead2 = wait_leader(s2)
        c = AppClient(ports[lead2])
        check(c.cmd("SET first-after-kill yes") == b"+OK",
              "generation 2's leader did not ack a write")
        c.close()
        recover_s = time.perf_counter() - t_kill
        acked.append(("first-after-kill", "yes"))
        write(s2, "b")
        # the stopped supervisor killed outright (with its app) and
        # restarted: its host rejoins in a later generation
        kill_group(sups[victim])
        t_rejoin = time.perf_counter()
        start(victim)
        last = acked[-1]
        wait_for(lambda: victim in members(spec_at(3) or s2),
                 f"host {victim} readmitted", ELASTIC_WAIT)
        wait_for(lambda: app_get(ports[victim], last[0], last[1].encode(),
                                 1.0) == last[1].encode(),
                 f"host {victim}'s app serving the outage's writes",
                 ELASTIC_WAIT)
        rejoin_s = time.perf_counter() - t_rejoin
        s3 = spec_at(3)
        write(s3, "c")
        keys = [k for k, _ in acked]
        want_v = [v.encode() for _, v in acked]
        for h in range(R):
            wait_for(lambda h=h: pipelined_gets(ports[h], keys) == want_v,
                     f"app {h} serving every acked write", 60)
        final = spec_at(3)
        gens = [s1["gen"], s2["gen"], final["gen"]]
        # break the generation (a member leaves) and close the
        # controller: the workers end cleanly at their round barrier and
        # print their counts; no supervisor can register again
        call(f"127.0.0.1:{ctl.port}", {"op": "leave",
                                       "host": members(final)[0]})
        ctl.close()
        for h in members(final):
            wait_for(lambda h=h: any(
                e["gen"] == final["gen"] for e in worker_ends(dirs[h], h)),
                f"host {h}'s last worker ending", 60)
        for h in range(R):
            ends += [dict(e, host=h) for e in worker_ends(dirs[h], h)]
    except Exception:
        for h in range(R):
            for name in ("supervisor.out", f"worker_h{h}.log"):
                p = Path(dirs[h], name)
                if p.exists():
                    print(f"host {h} {name}: {p.read_text()[-2000:]}",
                          flush=True)
        raise
    finally:
        ctl.close()
        for p in sups.values():
            try:
                os.kill(p.pid, signal.SIGCONT)
            except ProcessLookupError:
                pass
            kill_group(p)
        shutil.rmtree(wd, ignore_errors=True)
    runs = []
    for e in ends:
        check(e["device"] == "cuda" and e["launches"] == e["steps"],
              f"(15b) worker h{e['host']} gen {e['gen']}: {e['launches']} "
              f"commit_window launches in {e['steps']} protocol steps")
        runs.append(dict(launches=e["launches"] + e["launches_failed_call"],
                         steps=e["steps"]))
    per_it = [e["rowdump_ms"] / max(e["iterations"], 1) for e in ends]
    print(f"elastic plane (15b) on {card}: generations {gens} (gen 2 cut "
          f"from survivors {survivors} after host {victim}'s worker was "
          f"SIGKILLed, {cut_s:.2f} s later; survivors: {learnt}; donor "
          f"{s2['donor']} by (last_log_term, end)); time "
          f"to recover (SIGKILL to the first acked write of gen "
          f"{s2['gen']}) {recover_s:.2f} s; host {victim} restarted and "
          f"serving the outage's writes after {rejoin_s:.2f} s; "
          f"{len(acked)} acked writes read back from 3/3 apps; "
          f"write_rowdump {min(per_it):.3f}-{max(per_it):.3f} ms per "
          f"iteration", flush=True)
    for e in ends:
        print(f"elastic worker (15b) h{e['host']} gen {e['gen']} "
              f"{'clean' if e['clean'] else 'failed'}: {e['iterations']} "
              f"iterations, {e['steps']} protocol steps, {e['launches']} "
              f"commit_window launches (+{e['launches_failed_call']} in "
              f"the failed call), {e['rowdumps']} rowdumps in "
              f"{e['rowdump_ms']:.1f} ms", flush=True)
    return runs


def worker_ends(wd: str, h: int) -> list:
    """The ``WORKER_END`` records of host ``h``'s worker log."""
    p = Path(wd, f"worker_h{h}.log")
    if not p.exists():
        return []
    return [json.loads(ln.split(" ", 1)[1])
            for ln in p.read_text(errors="replace").splitlines()
            if ln.startswith("WORKER_END ")]


class Phase:
    """Prints ``phase N start`` (flushed) on entry and the phase's wall
    time on exit, so a failure names its phase."""

    def __init__(self, n: int, name: str):
        self.n, self.name = n, name

    def __enter__(self):
        print(f"phase {self.n} start: {self.name}", flush=True)
        self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        print(f"phase {self.n} {'failed' if exc[0] else 'done'} after "
              f"{time.perf_counter() - self.t:.1f} s", flush=True)
        return False


# ---------------------------------------------------------------------------
# phase 16: the single-controller engines over a device list
# ---------------------------------------------------------------------------

# (16a): geometry (a) with a rollover point the 16 timed batches cross
SPMD_GEOM = dict(GEOMETRIES["a"][0], rebase_threshold=1 << 15)
SPMD_BATCHES = 16
SPMD_B_BATCHES = 4
# (16b): (tag, geometry, G, mesh)
MESH_CASES = (("G=8", GEOMETRIES["a"][0], 8, (2, 3)),
              ("G=64", SHARD_GEOM, 64, (4, 3)))
MESH_RATE_STEPS = 4
MESH_BATCHES = 1              # (16b) batches per dispatch kind of drive_groups
# (16c): (6a)'s shape, 8 connections of 2560 SENDs of 100 B each, deep
# enough that the mesh driver has two dispatches in flight
MESH_DRIVER_CONNS = [c % R for c in range(8)]
MESH_DRIVER_PER_CONN = 2560


def spmd_run(dev, geom: dict, fanout: str, n_batches: int,
             spmd: bool) -> dict:
    """(16a) one engine's script on ``dev`` (``spmd``: the spmd engine on
    ``[dev] * 3``, else the stacked engine): elect replica 0,
    ``n_batches`` full batches through ``step()`` (timed), a burst and a
    scan burst, then steps until the queue drains and every replica has
    caught up. Every dispatch's results are recorded."""
    from rdma_paxos_tpu_torch import convert
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    cfg = LogConfig(**geom)
    B = cfg.batch_slots
    c = (SimCluster(cfg, R, mode="spmd", fanout=fanout, device=[dev] * R)
         if spmd else SimCluster(cfg, R, fanout=fanout, device=dev))
    try:
        results, seq = [], [0]

        def rec(res):
            results.append({k: np.array(res[k]) for k in c.RES_KEYS})

        def feed(n):
            c.submit_many(0, [(3, 1 + (seq[0] + j) % 64, 0,
                               host_payload(seq[0] + j)) for j in range(n)])
            seq[0] += n

        def committed():
            return int(c.last["commit"][0]) + int(c.rebased_total)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize()
        commit_window.launches = commit_scan.launches = 0
        rec(c.step(timeouts=[0]))
        check(c.leader() == 0, f"(16a) no election: {c.last['role']}")
        sync()
        w = c.world
        ex0 = (w.exchanges, w.exchange_s) if spmd else (0, 0.0)
        s0, c0 = c.step_index, committed()
        with alone():
            t0 = time.perf_counter()
            for _ in range(n_batches):
                feed(B)
                rec(c.step())
            sync()
            timed = dict(wall=time.perf_counter() - t0,
                         steps=c.step_index - s0,
                         entries=committed() - c0,
                         exchanges=(w.exchanges - ex0[0]) if spmd else 0,
                         exchange_s=(w.exchange_s - ex0[1]) if spmd else 0.0)
        feed(4 * B)
        rec(c.step_burst())
        c.scan = True
        feed(2 * B)
        rec(c.step_burst())
        c.scan = False
        for _ in range(12):
            rec(c.step())
            if not c.pending[0] and (c.applied == c.last["commit"][0]).all():
                break
        check(not c.pending[0] and (c.applied == c.last["commit"][0]).all(),
              "(16a) the replicas did not catch up")
        s = list(c.replayed[0])
        check(all(list(c.replayed[r]) == s for r in range(R))
              and [p for (t, _c, _q, p) in s if t == 3]
              == [host_payload(i) for i in range(seq[0])],
              "(16a) the committed streams are not the submitted SENDs")
        sync()
        return dict(results=results, replayed=[list(x) for x in c.replayed],
                    state=convert.replica_state_to_numpy(c.state),
                    steps=c.step_index, launches=commit_window.launches,
                    scans=commit_scan.launches, rebases=int(c.rebases),
                    scan_dispatches=c.scan_dispatches, timed=timed,
                    engine=type(c).__name__)
    finally:
        c.close()


def compare_steps(tag: str, a: dict, b: dict) -> None:
    """Every dispatch's results, the replay streams and the state."""
    check(len(a["results"]) == len(b["results"]),
          f"{tag}: {len(a['results'])} dispatches against "
          f"{len(b['results'])}")
    for i, (x, y) in enumerate(zip(a["results"], b["results"])):
        for k, v in x.items():
            check(np.array_equal(v, y[k]), f"{tag}: dispatch {i}: {k} "
                                           f"differs")
    compare_runs(tag, a, b)


def mesh_rate(dev, geom: dict, G: int, mesh) -> tuple:
    """(16b) steps/s and aggregate committed entries/s of
    ``MESH_RATE_STEPS`` full-batch ``step()`` calls (16-byte SENDs in
    every group), on the mesh engine or (``mesh=None``) the stacked
    one."""
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.shard import ShardedCluster
    cfg = LogConfig(**geom)
    B = cfg.batch_slots
    c = ShardedCluster(cfg, R, G, fanout=GROUP_FANOUT, mesh=mesh,
                       device=dev if mesh is None
                       else [dev] * (mesh[0] * mesh[1]))
    try:
        leaders = c.place_leaders()

        def feed():
            for g in range(G):
                c.submit_many(g, leaders[g], [(3, 1, 0, b"x" * 16)] * B)

        def committed():
            return int(sum(int(c.last["commit"][g, leaders[g]])
                           + int(c.rebased_total[g]) for g in range(G)))
        feed()
        c.step()
        torch.cuda.synchronize()
        s0, c0 = c.step_index, committed()
        with alone():
            t0 = time.perf_counter()
            for _ in range(MESH_RATE_STEPS):
                feed()
                c.step()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        return (c.step_index - s0) / dt, (committed() - c0) / dt
    finally:
        c.close()


def mesh_variant_step(dev) -> dict:
    """(16b) one audit+telemetry+txn serial step at G = 8, geometry (a),
    on the 2x3 mesh engine against the stacked engine on the card."""
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.shard import ShardedCluster
    cfg = LogConfig(**GEOMETRIES["a"][0])
    G = 8
    out = {}
    for name, mesh in (("vmap", None), ("mesh", (2, 3))):
        c = ShardedCluster(cfg, R, G, fanout=GROUP_FANOUT, mesh=mesh,
                           audit=True, telemetry=True, txn=True,
                           device=dev if mesh is None else [dev] * 6)
        try:
            leaders = c.place_leaders()
            for g in range(G):
                c.submit_many(g, leaders[g], [(3, 1, 0, host_payload(i))
                                              for i in range(64)])
            c.step()
            c.set_txn_watch(0, int(c.last["end"][0, leaders[0]]) - 1,
                            int(c.last["term"][0, leaders[0]]))
            n0 = commit_window.launches
            res = c.step()
            out[name] = dict(
                res={k: np.array(v) for k, v in res.items()},
                launches=commit_window.launches - n0,
                ledger=json.dumps(no_anchor(c.auditor.dump()),
                                  sort_keys=True, default=str),
                counters=np.array(c.device_counters))
        finally:
            c.close()
    a, b = out["vmap"], out["mesh"]
    check(set(a["res"]) == set(b["res"]) and all(
        np.array_equal(v, b["res"][k]) for k, v in a["res"].items()),
        "(16b) the audit+telemetry+txn step differs from the stacked "
        "engine's")
    check(a["ledger"] == b["ledger"]
          and np.array_equal(a["counters"], b["counters"]),
          "(16b) the ledger or the device counters differ")
    check((b["res"]["txn_vote"][0] > 0).all(),
          f"(16b) group 0's watch was not voted on: "
          f"{b['res']['txn_vote'][0]}")
    check(a["launches"] == 1 and b["launches"] == 6,
          f"(16b) the variant step launched commit_window {a['launches']} "
          f"(stacked) and {b['launches']} (mesh) times")
    return b


def phase_device_list(dev, card: str) -> list:
    """Phase 16: the spmd and mesh engines on lists repeating the one
    card; returns the protocol steps and commit_window launches of their
    runs."""
    from rdma_paxos_tpu_torch.parallel.mesh import (
        build_mesh_2d, make_replica_mesh)
    cpu = torch.device("cpu")
    runs = []
    print(f"device list (16): layouts {make_replica_mesh(R, [dev] * R).describe()}"
          f"; {build_mesh_2d(2, R, [dev] * 6).describe()}; "
          f"{build_mesh_2d(4, R, [dev] * 12).describe()}", flush=True)

    # (16a) SimCluster(mode="spmd") against the stacked engine and a CPU
    # twin, psum and gather at (a), gather at (b)
    twins = {f: TWINS.submit(spmd_run, cpu, SPMD_GEOM, f, SPMD_BATCHES,
                             True) for f in ("psum", "gather")}
    for fanout in ("psum", "gather"):
        sp = spmd_run(dev, SPMD_GEOM, fanout, SPMD_BATCHES, True)
        st = spmd_run(dev, SPMD_GEOM, fanout, SPMD_BATCHES, False)
        compare_steps(f"(16a) {fanout}: spmd against the stacked engine",
                      sp, st)
        tw = twins[fanout].get()
        cpu_s = twins[fanout].seconds
        compare_steps(f"(16a) {fanout}: the CPU twin", sp, tw)
        check(sp["launches"] == R * sp["steps"] and sp["scans"] == 0
              and st["launches"] == st["steps"],
              f"(16a) {fanout}: {sp['launches']} commit_window launches in "
              f"{sp['steps']} spmd protocol steps, {st['launches']} in "
              f"{st['steps']} stacked")
        check(sp["rebases"] >= 1 and sp["scan_dispatches"] > 0,
              f"(16a) {fanout}: {sp['rebases']} rollovers, "
              f"{sp['scan_dispatches']} scans")
        runs.append(dict(launches=sp["launches"], steps=sp["steps"]))
        ts, tt = sp["timed"], st["timed"]
        print(f"device list (16a) on {card}: SimCluster(mode='spmd') on "
              f"[{dev}] * 3 at geometry (a) {fanout}, {SPMD_BATCHES} full "
              f"batches timed: {ts['steps'] / ts['wall']:.2f} steps/s "
              f"{ts['entries'] / ts['wall']:.0f} committed entries/s "
              f"against the stacked engine's {tt['steps'] / tt['wall']:.2f}"
              f" steps/s {tt['entries'] / tt['wall']:.0f} entries/s "
              f"(ratio {tt['wall'] / ts['wall']:.3f}); "
              f"{ts['exchanges'] / ts['steps']:.2f} exchanges per step, "
              f"{ts['exchange_s'] / max(ts['exchanges'], 1) * 1e3:.3f} ms "
              f"per exchange (entry 0, waits included); "
              f"{sp['launches'] / sp['steps']:.2f} commit_window launches "
              f"per protocol step (N = 1 each); {sp['steps']} protocol "
              f"steps, {sp['rebases']} rollover(s), "
              f"{sp['scan_dispatches']} scan(s); every dispatch's results,"
              f" the streams and the rows equal to the stacked engine on "
              f"the card and to the CPU twin ({cpu_s:.1f} s)", flush=True)
    geom_b, fan_b = GEOMETRIES["b"]
    sp = spmd_run(dev, geom_b, fan_b, SPMD_B_BATCHES, True)
    st = spmd_run(dev, geom_b, fan_b, SPMD_B_BATCHES, False)
    compare_steps("(16a) geometry (b): spmd against the stacked engine",
                  sp, st)
    check(sp["launches"] == R * sp["steps"],
          f"(16a) (b): {sp['launches']} launches in {sp['steps']} steps")
    runs.append(dict(launches=sp["launches"], steps=sp["steps"]))
    print(f"device list (16a) on {card}: geometry (b) {fan_b}, "
          f"{SPMD_B_BATCHES} full batches: {sp['steps']} protocol steps, "
          f"{sp['launches']} commit_window launches, equal to the stacked "
          f"engine on the card", flush=True)

    # (16b) the mesh engine against the stacked group engine and a CPU
    # twin
    twins = [TWINS.submit(drive_groups, cpu, geom, G, mesh, MESH_BATCHES)
             for _, geom, G, mesh in MESH_CASES]
    for (tag, geom, G, mesh), twin in zip(MESH_CASES, twins):
        n_entries = mesh[0] * mesh[1]
        ms = drive_groups(dev, geom, G, mesh, MESH_BATCHES)
        vm = drive_groups(dev, geom, G, batches=MESH_BATCHES)
        compare_steps(f"(16b) {tag}: the mesh against the stacked engine",
                      ms, vm)
        tw = twin.get()
        cpu_s = twin.seconds
        compare_steps(f"(16b) {tag}: the CPU twin", ms, tw)
        check(ms["launches"] == n_entries * ms["steps"] and ms["scans"] == 0,
              f"(16b) {tag}: {ms['launches']} launches in {ms['steps']} "
              f"protocol steps")
        runs.append(dict(launches=ms["launches"], steps=ms["steps"]))
        m_rate = mesh_rate(dev, geom, G, mesh)
        v_rate = mesh_rate(dev, geom, G, None)
        print(f"device list (16b) on {card}: ShardedCluster(mesh={mesh}) "
              f"{tag} at {geom} {GROUP_FANOUT} on [{dev}] * {n_entries}: "
              f"{ms['steps']} protocol steps (step, burst, scan), "
              f"{ms['launches'] / ms['steps']:.2f} commit_window launches "
              f"per protocol step (N = {G // mesh[0]} each); every "
              f"dispatch's results, the streams and the state equal to the"
              f" stacked engine on the card and to the CPU twin "
              f"({cpu_s:.1f} s); step(): {m_rate[0]:.2f} steps/s "
              f"{m_rate[1]:.0f} committed entries/s (all groups) against "
              f"the stacked engine's {v_rate[0]:.2f} steps/s "
              f"{v_rate[1]:.0f} (ratio {m_rate[1] / v_rate[1]:.3f})",
              flush=True)
    var = mesh_variant_step(dev)
    print(f"device list (16b) on {card}: one audit+telemetry+txn step at "
          f"G = 8 on the 2x3 mesh equal to the stacked engine (results, "
          f"votes {var['res']['txn_vote'][0].tolist()} in group 0, "
          f"ledger, device counters), {var['launches']} commit_window "
          f"launches", flush=True)

    # (16c) the sharded driver on the mesh engine
    md = drive_sharded_driver(dev, pipeline=2, mesh=(2, R),
                              conns=MESH_DRIVER_CONNS,
                              per_conn=MESH_DRIVER_PER_CONN)
    vd = drive_sharded_driver(dev, pipeline=2, conns=MESH_DRIVER_CONNS,
                              per_conn=MESH_DRIVER_PER_CONN)
    check(md["statuses"] == vd["statuses"] == [0] * md["events"],
          "(16c) the acks differ from the stacked driver's")
    check(md["streams"] == vd["streams"],
          "(16c) the committed streams differ from the stacked driver's")
    check(md["launches"] == 2 * R * md["steps"],
          f"(16c) {md['launches']} launches in {md['steps']} protocol "
          f"steps")
    check(md["max_inflight"] >= 2,
          f"(16c) the mesh driver never had two dispatches in flight "
          f"(max_inflight_dispatches {md['max_inflight']})")
    runs.append(dict(launches=md["launches"], steps=md["steps"]))
    print(f"device list (16c) on {card}: ShardedClusterDriver(mesh=(2, 3))"
          f" G = 4 at geometry (a), pipeline 2: {md['events']} SEND events"
          f" of {FRONT_BYTES} B on {len(MESH_DRIVER_CONNS)} connections "
          f"acked once each with status 0, in per-group order, equal to "
          f"the stacked driver's acks and streams; {md['events'] / md['wall']:.0f}"
          f" acked events/s against the stacked driver's "
          f"{vd['events'] / vd['wall']:.0f}; {md['steps']} protocol steps,"
          f" {md['launches']} commit_window launches, max "
          f"{md['max_inflight']} dispatches in flight", flush=True)
    return runs


# ---------------------------------------------------------------------------
# phase 17: graftlint and the runtime lock sanitizer
# ---------------------------------------------------------------------------

SAN_ENV = "RP_SANITIZE"
SAN_PUTS = 512              # (17c) the streams hub's session puts
SAN_SPMD_BATCHES = 4        # (17c) (16a)'s shape, four full batches


@contextlib.contextmanager
def sanitized(on: bool = True):
    """``RP_SANITIZE=1`` (``on``) or unset for the engines built inside,
    the caller's value restored on exit."""
    old = os.environ.pop(SAN_ENV, None)
    if on:
        os.environ[SAN_ENV] = "1"
    try:
        yield
    finally:
        os.environ.pop(SAN_ENV, None)
        if old is not None:
            os.environ[SAN_ENV] = old


def lint_on_this_machine(card: str) -> None:
    """(17a) the port's graftlint CLI in a subprocess: exit 0, no live
    finding, no unused suppression."""
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "graftlint.json")
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "rdma_paxos_tpu_torch.analysis",
             "--json", out], cwd=ROOT, capture_output=True, text=True,
            timeout=300)
        dt = time.perf_counter() - t0
        check(p.returncode == 0, f"(17a) graftlint exited {p.returncode}: "
                                 f"{p.stdout[-2000:]} {p.stderr[-2000:]}")
        with open(out, encoding="utf-8") as f:
            doc = json.load(f)
    check(doc["ok"] and not doc["findings"]
          and not doc["unused_suppressions"] and doc["suppressed"],
          f"(17a) graftlint report: {len(doc['findings'])} live, "
          f"{len(doc['unused_suppressions'])} unused suppressions")
    print(f"sanitizer (17a) on the card's machine ({card}): python -m "
          f"rdma_paxos_tpu_torch.analysis exit 0, 0 live findings, "
          f"{len(doc['suppressed'])} suppressed, 0 unused suppressions, "
          f"{dt:.2f} s ({p.stdout.strip().splitlines()[-1]})", flush=True)


def offlock_write_raises(d) -> bool:
    """The deliberate race: an off-lock write of the engine's guarded
    ``pending`` must raise; the same write under the host lock must
    not. Only this one expected error is caught."""
    from rdma_paxos_tpu_torch.analysis.runtime_guard import (
        LockDisciplineError)
    c = d.cluster
    fresh = [[] for _ in range(R)]
    try:
        c.pending = fresh
        raised = False
    except LockDisciplineError:
        raised = True
    with c._host_lock:
        c.pending = fresh
    return raised


def drive_sanitized_streams(dev) -> dict:
    """(17c) a streams hub attached to a ``SimCluster`` at geometry (a)
    with the read path and ``ReplicatedKVS(cap=4096)``: ``SAN_PUTS``
    session puts under a whole-range watch, caught up, then a scan of
    the range served by stepping."""
    from rdma_paxos_tpu_torch import streams
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.models.replicated_kvs import ReplicatedKVS
    from rdma_paxos_tpu_torch.obs import Observability
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.runtime import reads
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    geom, fanout = GEOMETRIES["a"]
    c = SimCluster(LogConfig(**geom), R, fanout=fanout, device=dev)
    c.obs = Observability()
    reads.attach(c)
    hub = streams.attach(c)
    try:
        names = [type(x).__name__ for x in (c, c.reads, hub, hub.watch,
                                            hub.scans)]
        kv = ReplicatedKVS(c, cap=4096)
        commit_window.launches = 0
        s0 = c.step_index
        c.run_until_elected(0)
        sub = hub.subscribe(0)
        keys = [spread_key(b"san/", i) for i in range(SAN_PUTS)]
        for i, k in enumerate(keys):
            kv.put(0, k, b"v%d" % i, client_id=9, req_id=i + 1)
        for _ in range(32):
            c.step()
            kv._fold(0)
            if kv.last_req[0].get(9, 0) >= SAN_PUTS:
                break
        check(kv.last_req[0].get(9, 0) >= SAN_PUTS,
              "(17c) the streams hub's puts did not commit")
        check(hub.watch.wait_caught_up({0: hub.tails[0].length()}, 60),
              "(17c) the watch pump never caught up")
        events = []
        while True:
            got = sub.poll(4096)
            if not got:
                break
            events += [(e.term, e.index, e.op, e.key, e.val) for e in got]
        check([e[3] for e in events] == keys,
              "(17c) the watch did not deliver every put once, in order")
        items, _s = serve_stepping([c], lambda: hub.scan_all(
            prefix=b"san/"))
        check(sorted(k for k, _v in items) == sorted(keys),
              "(17c) the scan did not return every key")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return dict(names=names, events=events, items=items,
                    stream=list(c.replayed[0]), steps=c.step_index - s0,
                    launches=commit_window.launches,
                    status=hub.watch.status()["events_total"])
    finally:
        hub.fail_all("chip smoke (17c) done")


def phase_sanitizer(dev, card: str) -> list:
    """Phase 17: (17a) graftlint on the card's machine; (17b) the
    pipelined driver on (6a)'s record under ``RP_SANITIZE=1`` against
    unsanitized runs and a CPU twin; (17c) the sanitized sharded
    driver, streams hub and spmd engine against their CPU twins. Any
    error a thread raises fails the phase."""
    cpu = torch.device("cpu")
    raised = []
    hook = threading.excepthook

    def record(args):
        raised.append(f"{args.thread.name}: {args.exc_type.__name__}: "
                      f"{args.exc_value}")
        hook(args)
    threading.excepthook = record
    try:
        runs = sanitizer_runs(dev, cpu, card)
    finally:
        threading.excepthook = hook
    check(not raised, f"(17) a thread raised: {raised}")
    return runs


def sanitizer_runs(dev, cpu, card: str) -> list:
    lint_on_this_machine(card)
    runs = []
    on_card = dev.type == "cuda"

    # (17b) the pipelined driver on (6a)'s record, sanitized and not, in
    # alternating turns, and the sanitized serial CPU twin
    geom, fanout = GEOMETRIES["a"]
    payloads = front_record(FRONT_EVENTS, FRONT_BYTES)
    b = {}
    for name, on in (("sanitized", True), ("plain", False),
                     ("plain 2", False), ("sanitized 2", True)):
        with sanitized(on):
            b[name] = drive_front_door(dev, geom, fanout, payloads,
                                       FRONT_CONNS, 2,
                                       probe=offlock_write_raises)
    # the sanitized CPU twins of (17b) and (17c), in the workers, after
    # the alternating turns and beside the card's (17c) runs
    san = {SAN_ENV: "1"}
    twins = dict(
        front=TWINS.submit(drive_front_door, cpu, geom, fanout, payloads,
                           FRONT_CONNS, 0, probe=offlock_write_raises,
                           _env=san),
        sharded=TWINS.submit(drive_sharded_driver, cpu, pipeline=0,
                             _env=san),
        streams=TWINS.submit(drive_sanitized_streams, cpu, _env=san),
        spmd=TWINS.submit(spmd_run, cpu, SPMD_GEOM, "psum",
                          SAN_SPMD_BATCHES, True, _env=san))
    b["cpu twin"] = ref = twins["front"].get()
    for name, r in b.items():
        want = "SimCluster+sanitized" if "plain" not in name else \
            "SimCluster"
        check(r["engine"] == want, f"(17b) {name}: engine {r['engine']}")
        check(r["statuses"] == [0] * FRONT_EVENTS and (r["fired"] == 1).all(),
              f"(17b) {name}: not every event was acked once with status 0")
        check([p for (t, _c, _q, p) in r["streams"][0] if t == 3]
              == payloads, f"(17b) {name}: the committed SENDs are not "
                           f"the record in order")
        check(r["streams"] == ref["streams"],
              f"(17b) {name}: the committed streams differ from the CPU "
              f"twin's")
        check(r["probe"] is ("plain" not in name),
              f"(17b) {name}: an off-lock write of cluster.pending "
              f"{'did not raise' if 'plain' not in name else 'raised'}")
        if name != "cpu twin":
            check(r["max_inflight"] >= 2,
                  f"(17b) {name}: the pipeline never overlapped dispatches")
            check(r["launches"] == r["steps"] > 0 or not on_card,
                  f"(17b) {name}: {r['launches']} commit_window launches "
                  f"in {r['steps']} protocol steps")
    runs += [dict(launches=b[n]["launches"], steps=b[n]["steps"])
             for n in ("sanitized", "sanitized 2")]
    rate = {n: FRONT_EVENTS / b[n]["wall"] for n in b}
    print(f"sanitizer (17b) on {card}, geometry (a) fanout={fanout}: "
          f"ClusterDriver(pipeline=2) on (6a)'s record ({FRONT_EVENTS} "
          f"SENDs of {FRONT_BYTES} B on {FRONT_CONNS} connections), "
          f"RP_SANITIZE=1 engine {b['sanitized']['engine']}: every event "
          f"acked once with status 0 in order, streams equal to the "
          f"unsanitized runs and to the sanitized CPU serial twin; "
          f"max_inflight_dispatches {b['sanitized']['max_inflight']}, "
          f"{b['sanitized 2']['max_inflight']}; "
          f"{b['sanitized']['launches']} commit_window launches in "
          f"{b['sanitized']['steps']} protocol steps; an off-lock write of "
          f"cluster.pending raised LockDisciplineError (and not "
          f"unsanitized); acked events/s sanitized "
          f"{rate['sanitized']:.0f}, {rate['sanitized 2']:.0f}, "
          f"unsanitized {rate['plain']:.0f}, {rate['plain 2']:.0f} "
          f"(alternating turns, ratio "
          f"{(rate['sanitized'] + rate['sanitized 2']) / (rate['plain'] + rate['plain 2']):.3f}"
          f")", flush=True)

    # (17c) the sharded driver at G = 4, pipelined, (10f)'s shape
    with sanitized():
        sd = drive_sharded_driver(dev, pipeline=2)
    sref = twins["sharded"].get()
    for name, r in (("card", sd), ("cpu twin", sref)):
        check(r["engine"] == "ShardedCluster+sanitized",
              f"(17c) sharded driver {name}: engine {r['engine']}")
    check(sd["streams"] == sref["streams"],
          "(17c) the sanitized sharded driver's streams differ from the "
          "CPU twin's")
    check(sd["launches"] == sd["steps"] > 0 or not on_card,
          f"(17c) sharded driver: {sd['launches']} launches in "
          f"{sd['steps']} protocol steps")
    runs.append(dict(launches=sd["launches"], steps=sd["steps"]))

    # (17c) a streams hub on a SimCluster at (a)
    with sanitized():
        st = drive_sanitized_streams(dev)
    stref = twins["streams"].get()
    for name, r in (("card", st), ("cpu twin", stref)):
        check(all(n.endswith("+sanitized") for n in r["names"]),
              f"(17c) streams {name}: {r['names']}")
    for k in ("events", "items", "stream", "status"):
        check(st[k] == stref[k], f"(17c) streams: {k} differ from the "
                                 f"CPU twin's")
    check(st["launches"] == st["steps"] > 0 or not on_card,
          f"(17c) streams: {st['launches']} launches in {st['steps']} "
          f"protocol steps")
    runs.append(dict(launches=st["launches"], steps=st["steps"]))

    # (17c) SimCluster(mode="spmd") on [dev] * 3, (16a)'s shape
    with sanitized():
        sp = spmd_run(dev, SPMD_GEOM, "psum", SAN_SPMD_BATCHES, True)
    spref = twins["spmd"].get()
    check(sp["engine"] == spref["engine"] == "SimCluster+sanitized",
          f"(17c) spmd: engine {sp['engine']}")
    compare_steps("(17c) the sanitized spmd engine against its CPU twin",
                  sp, spref)
    check(sp["launches"] == R * sp["steps"] or not on_card,
          f"(17c) spmd: {sp['launches']} launches in {sp['steps']} steps")
    runs.append(dict(launches=sp["launches"], steps=sp["steps"]))
    print(f"sanitizer (17c) on {card}, RP_SANITIZE=1: "
          f"ShardedClusterDriver G = 4 at geometry (a), pipeline=2, "
          f"{sd['events']} SENDs on {R * GROUP_CONNS_PER_REPLICA} "
          f"connections acked once each with status 0, "
          f"{sd['events'] / sd['wall']:.0f} acked events/s, "
          f"max_inflight_dispatches {sd['max_inflight']}, "
          f"{sd['launches']} commit_window launches in {sd['steps']} "
          f"protocol steps; a streams hub on SimCluster at (a) "
          f"({', '.join(st['names'])}): {SAN_PUTS} session puts watched "
          f"once each in order and scanned, {st['steps']} protocol steps, "
          f"{st['launches']} launches; SimCluster(mode='spmd') on "
          f"[{dev}] * 3, {SAN_SPMD_BATCHES} full batches: {sp['steps']} "
          f"protocol steps, {sp['launches']} launches; every stream, "
          f"event, scan and dispatch equal to its sanitized CPU twin",
          flush=True)
    return runs


# ---------------------------------------------------------------------------
# phase 18: the scalar host data plane
# ---------------------------------------------------------------------------

PLANE_G = 8                 # (18b) groups of the sharded step and group_step
PLANE_STAGES = ("step", "begin_step", "pack_rows", "finish",
                "_replay_committed", "decode_window")


@contextlib.contextmanager
def host_plane(vectorized: bool):
    """The port's host data plane switched for the block, restored
    after (the switch is module-global)."""
    from rdma_paxos_tpu_torch.runtime import hostpath
    prev = hostpath.set_vectorized(vectorized)
    try:
        yield
    finally:
        hostpath.set_vectorized(prev)


def plane_host_ms(dev) -> dict:
    """(18a) per plane, the host ms per ``step()`` of
    :data:`PLANE_STAGES` (cProfile, :func:`host_profile`) over four full
    batches of 100-byte SENDs at geometry (a), the planes in turns
    (scalar, vectorized, vectorized, scalar) on one cluster; returns the
    two turns of each plane and the launches in its protocol steps."""
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    geom, fanout = GEOMETRIES["a"]
    cfg = LogConfig(**geom)
    B = cfg.batch_slots
    c = SimCluster(cfg, R, fanout=fanout, device=dev)
    lead = c.run_until_elected(0)
    payloads = front_record(B, FRONT_BYTES)

    def four_steps():
        for _ in range(4):
            c.submit_many(lead, [(3, 1 + i % FRONT_CONNS, 0, p)
                                 for i, p in enumerate(payloads)])
            c.step()
    four_steps()                                  # warm
    out = {False: [], True: []}
    commit_window.launches, s0 = 0, c.step_index
    for vec in (False, True, True, False):
        with host_plane(vec):
            ms = host_profile(four_steps, PLANE_STAGES)
        out[vec].append({k: v / 4 for k, v in ms.items()})
    torch.cuda.synchronize()
    return dict(ms=out, launches=commit_window.launches,
                steps=c.step_index - s0)


def plane_group_steps(dev) -> dict:
    """(18b) ``ShardedCluster(G=8)`` at geometry (a): leaders placed, one
    full batch per group, two steps, once with the scalar plane and once
    with the vectorized one (each on its own cluster); results, streams,
    frames and state of the two, and the launches per protocol step."""
    from rdma_paxos_tpu_torch import convert
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.shard import ShardedCluster
    cfg = LogConfig(**GEOMETRIES["a"][0])
    sends = group_sends(PLANE_G, cfg.batch_slots)
    out = {}
    for vec in (False, True):
        c = ShardedCluster(cfg, R, PLANE_G, fanout=GROUP_FANOUT, device=dev)
        c.collect_frames = True
        leaders = c.place_leaders()
        for g in range(PLANE_G):
            c.submit_many(g, leaders[g], [
                (3, 1 + i % 64, 0, p)
                for i, p in enumerate(sends[g][:cfg.batch_slots])])
        commit_window.launches, s0 = 0, c.step_index
        with host_plane(vec):
            res = [c.step(), c.step()]
        torch.cuda.synchronize()
        out[vec] = dict(
            res=[{k: np.array(v) for k, v in r.items()} for r in res],
            replayed=[[list(x) for x in row] for row in c.replayed],
            frames=[[list(x) for x in row] for row in c.frames],
            state=convert.replica_state_to_numpy(c.state),
            launches=commit_window.launches, steps=c.step_index - s0)
        c.close()
    a, b = out[False], out[True]
    for i, (x, y) in enumerate(zip(a["res"], b["res"])):
        check(set(x) == set(y) and all(np.array_equal(v, y[k])
                                       for k, v in x.items()),
              f"(18b) step {i}: the scalar plane's results differ")
    check(a["replayed"] == b["replayed"] and a["frames"] == b["frames"],
          "(18b) the scalar plane's streams or frames differ")
    check(all(np.array_equal(v, b["state"][k]) for k, v in a["state"].items()),
          "(18b) the scalar plane's state differs")
    check(sum(len(x) for x in a["replayed"][0]) >= cfg.batch_slots,
          "(18b) group 0 committed nothing")
    for r in (a, b):
        check(r["launches"] == r["steps"] == 2,
              f"(18b) {r['launches']} commit_window launches in "
              f"{r['steps']} protocol steps")
    return a


def plane_group_step_direct(dev) -> dict:
    """(18c) ``consensus.step.group_step`` called directly at G = 8,
    geometry (a): an election step (one timer per group) and a full-batch
    step, against ``parallel.mesh.build_sim_group_step`` on a copy of the
    same state; outputs and state equal, one launch per step each."""
    from rdma_paxos_tpu_torch import convert
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.consensus.log import M_LEN, M_TYPE, META_W
    from rdma_paxos_tpu_torch.consensus.state import clone_state
    from rdma_paxos_tpu_torch.consensus.step import (
        OUTPUT_FIELDS, StepInput, group_step)
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.parallel.mesh import (
        build_sim_group_step, stack_group_states)
    cfg = LogConfig(**GEOMETRIES["a"][0])
    G, B = PLANE_G, cfg.batch_slots
    rng = np.random.default_rng(SEED + 18)
    st = {"group_step": stack_group_states(cfg, G, R, R, device=dev)}
    st["build_sim_group_step"] = clone_state(st["group_step"])
    fns = {"group_step": group_step(cfg=cfg, n_replicas=R),
           "build_sim_group_step": build_sim_group_step(cfg, R)}

    def inputs(elect: bool) -> StepInput:
        z = torch.zeros((G, R), dtype=torch.int32, device=dev)
        tmo = z.clone()
        if elect:
            tmo[torch.arange(G), torch.arange(G) % R] = 1
        count = z.clone()
        meta = torch.zeros((G, R, B, META_W), dtype=torch.int32,
                           device=dev)
        if not elect:
            count[torch.arange(G), torch.arange(G) % R] = B
            meta[..., M_TYPE] = 3                             # SEND
            meta[..., M_LEN] = torch.from_numpy(rng.integers(
                1, cfg.slot_bytes + 1, (G, R, B)).astype(np.int32)).to(dev)
        data = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, (G, R, B, cfg.slot_words)).astype(
                np.int32)).to(dev)
        return StepInput(batch_data=data, batch_meta=meta,
                         batch_count=count, timeout_fired=tmo,
                         peer_mask=torch.ones((G, R, R), dtype=torch.int32,
                                              device=dev),
                         apply_done=z, queue_depth=z)
    outs = {k: [] for k in fns}
    launched = {}
    for elect in (True, False):
        inp = inputs(elect)
        for k, fn in fns.items():
            n0 = commit_window.launches
            st[k], o = fn(st[k], inp)
            launched[k] = launched.get(k, 0) + commit_window.launches - n0
            outs[k].append({f: getattr(o, f).cpu().numpy()
                            for f in OUTPUT_FIELDS})
    torch.cuda.synchronize()
    a, b = outs["group_step"], outs["build_sim_group_step"]
    check(all(np.array_equal(x[f], y[f]) for x, y in zip(a, b)
              for f in OUTPUT_FIELDS),
          "(18c) group_step's outputs differ from build_sim_group_step's")
    sa, sb = (convert.replica_state_to_numpy(st[k]) for k in fns)
    check(all(np.array_equal(v, sb[k]) for k, v in sa.items()),
          "(18c) group_step's state differs from build_sim_group_step's")
    check((a[0]["role"][np.arange(G), np.arange(G) % R] == 3).all()
          and (a[1]["commit"].max(1) >= B).all(),
          "(18c) the groups did not elect and commit a batch")
    check(launched == dict.fromkeys(fns, 2),
          f"(18c) commit_window launches {launched} in 2 steps each")
    return dict(launches=launched["group_step"], steps=2)


def phase_host_plane(dev, card: str) -> list:
    """Phase 18: the scalar host data plane on the card. (18a) (6a)'s
    record (:data:`FRONT_EVENTS` SENDs) through a pipelined
    ``ClusterDriver`` with a workdir, the planes in turns (scalar,
    vectorized, vectorized, scalar), against one serial run on the CPU;
    the planes' host ms per step. (18b) a G = 8 sharded step with the
    plane off against on. (18c) ``group_step`` called directly."""
    geom, fanout = GEOMETRIES["a"]
    payloads = front_record(FRONT_EVENTS, FRONT_BYTES)
    wd = tempfile.mkdtemp(prefix="rp-plane-")
    runs, b = [], {}
    try:
        for name, d_, pl, vec in (("scalar", dev, 2, False),
                                  ("vectorized", dev, 2, True),
                                  ("vectorized 2", dev, 2, True),
                                  ("scalar 2", dev, 2, False),
                                  ("cpu twin", torch.device("cpu"), 0, True)):
            run_wd = os.path.join(wd, name.replace(" ", ""))
            os.makedirs(run_wd)
            with host_plane(vec):
                b[name] = drive_front_door(
                    d_, geom, fanout, payloads, FRONT_CONNS, pl,
                    workdir=run_wd, stores=True)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    ref = b["cpu twin"]
    check(all(x == ref["stores"][0] for x in ref["stores"]),
          "(18a) the CPU twin's replica stores differ")
    for name, r in b.items():
        check(r["statuses"] == [0] * FRONT_EVENTS and (r["fired"] == 1).all(),
              f"(18a) {name}: not every event was acked once with status 0")
        check([p for (t, _c, _q, p) in r["streams"][0] if t == 3]
              == payloads, f"(18a) {name}: the committed SENDs are not the "
                           f"record in order")
        check(r["streams"] == ref["streams"] and r["stores"] == ref["stores"],
              f"(18a) {name}: the committed streams or store bytes differ "
              f"from the CPU twin's")
        if name != "cpu twin":
            check(r["launches"] == r["steps"] > 0,
                  f"(18a) {name}: {r['launches']} commit_window launches in "
                  f"{r['steps']} protocol steps")
            runs.append(dict(launches=r["launches"], steps=r["steps"]))
    rate = {n: FRONT_EVENTS / b[n]["wall"] for n in b}
    hp = plane_host_ms(dev)
    check(hp["launches"] == hp["steps"] == 16,
          f"(18a) host profile: {hp['launches']} commit_window launches in "
          f"{hp['steps']} protocol steps")
    runs.append(dict(launches=hp["launches"], steps=hp["steps"]))

    def ms(vec, k):
        return ", ".join(f"{t[k]:.2f}" for t in hp["ms"][vec])
    scalar = rate["scalar"] + rate["scalar 2"]
    vector = rate["vectorized"] + rate["vectorized 2"]
    print(f"host plane (18a) on {card}, geometry (a) fanout={fanout}: "
          f"ClusterDriver(pipeline=2) with a workdir on (6a)'s record, "
          f"{FRONT_EVENTS} SENDs of {FRONT_BYTES} B on {FRONT_CONNS} "
          f"connections, the host data plane in turns: every event acked "
          f"once with status 0 in order, the committed streams and "
          f"{sum(map(len, ref['stores']))} store bytes of 3/3 replicas "
          f"equal across the planes and to the CPU serial twin; acked "
          f"events/s scalar {rate['scalar']:.0f}, {rate['scalar 2']:.0f}, "
          f"vectorized {rate['vectorized']:.0f}, "
          f"{rate['vectorized 2']:.0f} (vectorized / scalar "
          f"{vector / scalar:.3f}); "
          f"{sum(b[n]['launches'] for n in b if n != 'cpu twin')} "
          f"commit_window launches in as many protocol steps", flush=True)
    print(f"host plane (18a) host profile on {card} (cProfile, inclusive ms "
          f"per step() of a full batch of {GEOMETRIES['a'][0]['batch_slots']}"
          f" 100-byte SENDs, two turns per plane; inflates Python-heavy "
          f"code, the scalar loops most): decode_window scalar "
          f"{ms(False, 'decode_window')}, vectorized "
          f"{ms(True, 'decode_window')}; pack_rows scalar "
          f"{ms(False, 'pack_rows')}, vectorized {ms(True, 'pack_rows')}; "
          f"step scalar {ms(False, 'step')}, vectorized {ms(True, 'step')}",
          flush=True)
    g = plane_group_steps(dev)
    runs.append(dict(launches=2 * g["launches"], steps=2 * g["steps"]))
    d = plane_group_step_direct(dev)
    runs.append(dict(launches=2 * d["launches"], steps=2 * d["steps"]))
    print(f"host plane (18b, 18c) on {card}: ShardedCluster(G={PLANE_G}) at"
          f" geometry (a) {GROUP_FANOUT}, two steps of a full batch per "
          f"group with the scalar plane equal to the vectorized plane "
          f"(results, streams, frames, state), one commit_window launch per "
          f"protocol step; group_step called directly at G = {PLANE_G}: an "
          f"election and a full-batch step equal to build_sim_group_step's"
          f" (outputs, state), one launch per step each", flush=True)
    return runs


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    global TWINS
    TWINS = Twins()
    try:
        return run_phases()
    finally:
        TWINS.close()


def run_phases() -> int:
    with Phase(1, "the device"):
        port = load_port()
        dev = torch.device("cuda", 0)
        name = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f"device: {name} x{count}; torch {torch.__version__} cuda "
              f"{torch.version.cuda}", flush=True)
        print(smi, flush=True)

    with Phase(2, "kernel build"):
        from rdma_paxos_tpu_torch.ops import _build
        t0 = time.perf_counter()
        libs = _build.build()
        report = " | ".join(
            f"{n}: " + " ".join(ln.strip() for ln in
                                p.with_suffix(".log").read_text().splitlines()
                                if "Used" in ln or "spill" in ln)
            for n, p in libs.items())
        print(f"build: {len(libs)} kernel(s) in "
              f"{time.perf_counter() - t0:.1f} s ({report})", flush=True)

    with Phase(3, "kernels against their plain versions"):
        checks = dict(commit_scan=phase_kernel_checks(dev),
                      commit_window=phase_window_checks(dev))
    with Phase(4, "the main path at geometries (a) and (b)"):
        twins = {g: TWINS.submit(drive, None, g, CPU, MAIN_KVS_OPS)
                 for g in GEOMETRIES}
        main_runs = [phase_main_path(port, g, dev, MAIN_KVS_OPS, twins[g])
                     for g in GEOMETRIES]
    with Phase(5, "times"):
        times = phase_kernel_times(dev, smi)
        kernels_per_step, step_prof = phase_times(dev, smi)
    with Phase(6, "the front door (6a driver, 6b apps)"):
        main_runs.append(phase_front_driver(dev, smi))
        main_runs.append(phase_front_apps(dev, smi))
    with Phase(7, "recovery (7a engine, 7b driver and apps)"):
        main_runs.append(phase_recovery_engine(dev, smi))
        main_runs.append(phase_recovery_apps(dev, smi))
    with Phase(8, "audit and telemetry (8a engine, 8b corruption, "
                  "8c driver)"):
        main_runs += phase_audit(dev, smi, kernels_per_step, step_prof)
    with Phase(9, "the chaos judge (9a defaults, 9b geometry (a), "
                  "9c the dedup bug)"):
        main_runs += phase_chaos(dev, smi)
    with Phase(10, "groups (10a G=1, 10b G=8, 10c G=64, 10d shard "
                   "nemesis, 10e ShardedKVS, 10f sharded driver)"):
        main_runs += phase_groups(dev, smi, kernels_per_step, times)
    with Phase(11, "transactions (11a vote lane, 11b 2PC, 11c txn "
                   "nemesis, 11d live drivers)"):
        main_runs += phase_txn(dev, smi)
    with Phase(12, "repair and the governor (12a engine repair, 12b "
                   "repair nemesis, 12c groups, 12d governor, 12e "
                   "drivers)"):
        main_runs += phase_repair_governor(dev, smi)
    with Phase(13, "streams and elastic topology (13a engine, 13b "
                   "driver and nemesis, 13c split and merge, 13d "
                   "topology nemesis and live driver, 13e console)"):
        main_runs += phase_streams_topology(dev, smi)
    with Phase("14a", "the profiler (a driver capture of (6a)'s record, "
                      "program_report, a page's capture)"):
        main_runs += phase_profiler(dev, smi, kernels_per_step)
    with Phase("14b", "interposed apps under the sharded driver, G = 2"):
        main_runs.append(phase_sharded_apps(dev, smi))
    with Phase("14c", "one replica per process: three HostReplicaDriver "
                      "ranks on the card under gloo"):
        main_runs += phase_host_world(smi)
    with Phase("15a", "the per-host NodeDaemon: launcher deployments and "
                      "a deterministic run against its CPU twin"):
        build_native()
        main_runs += phase_node(smi)
    with Phase("15b", "the elastic plane: controller, supervisors and "
                      "workers on the card"):
        main_runs += phase_elastic(smi)
    with Phase(16, "the single-controller engines over a device list "
                   "(16a spmd, 16b mesh, 16c the sharded driver)"):
        main_runs += phase_device_list(dev, smi)
    with Phase(17, "graftlint and the runtime lock sanitizer (17a the "
                   "CLI, 17b the pipelined driver, 17c the sharded "
                   "driver, a streams hub and the spmd engine)"):
        main_runs += phase_sanitizer(dev, smi)
    with Phase(18, "the scalar host data plane (18a the pipelined driver "
                   "and the host profile, 18b a sharded step, 18c "
                   "group_step)"):
        main_runs += phase_host_plane(dev, smi)

    launches = dict(commit_window=sum(m["launches"] for m in main_runs),
                    commit_scan=0)
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda",
        "source": "rdma_paxos_tpu_torch/csrc/commit_scan.cu",
        "replaces": "rdma_paxos_tpu/ops/quorum.py:144",
        "launches": launches[k], "max_abs_err": checks[k]["max_abs_err"],
        **{f: times[k][f] for f in ("ms", "plain_ms", "bound_ms",
                                    "bound_by")},
        "library_ms": None} for k in ("commit_scan", "commit_window")]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
