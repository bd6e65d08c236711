#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # one card; no arguments

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
   ``step_burst()``, then a ``ClientSession`` workload on
   ``ReplicatedKVS(cap=65536)``. Every acknowledged write must read back
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
   served by the driver on the card: election by the timers, 2000 SETs
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
   wrapper and, for one run, by ``torch.profiler``). (9a) the runner's
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
10. the ``kernels`` JSON line, then ``{"ok": true, "device": ...}`` last.

Each phase prints ``phase N start`` before it runs and its wall time
after, so a failure names its phase.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
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
    n_inst, found = 0, 0
    for shape, extra in cases:
        args, kw = window_case(rng, dev, **shape, **extra)
        got = commit_window_cuda(*args, w=shape["W"], **kw)
        want = commit_window_ref(*args, w=shape["W"], **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("commit2", "xpos"), got, want):
            bad = int((a != b).sum())
            check(bad == 0, f"commit_window kernel != plain in {name} on "
                            f"{bad} of {len(a)} instances ({shape}, {extra}):"
                            f" {a[a != b][:8].tolist()} vs "
                            f"{b[a != b][:8].tolist()}")
        n_inst += len(got[0])
        found += int((want[1] >= 0).sum())
    check(0 < found < n_inst, "the crossing search was never exercised")
    print(f"kernel check: commit_window == commit_window_ref on {n_inst} "
          f"instances in {len(cases)} batches (N in 3/13/192, W in "
          f"16/128/2048; edge cases: {', '.join(WINDOW_EDGES)}; "
          f"{found} with a crossing CONFIG row), max_abs_err 0", flush=True)
    return dict(max_abs_err=0, instances=n_inst)


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

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


def phase_main_path(port, geo: str, dev, kvs_ops: int) -> dict:
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    commit_window.launches = commit_scan.launches = 0
    gpu = drive(port, geo, dev, kvs_ops)
    launches = commit_window.launches
    check(gpu["launches"] == (launches, commit_scan.launches)
          and launches == gpu["steps"] > 0 and commit_scan.launches == 0,
          f"commit_window launched {launches} times and commit_scan "
          f"{commit_scan.launches} times in {gpu['steps']} protocol steps")
    t0 = time.perf_counter()
    cpu = drive(port, geo, torch.device("cpu"), kvs_ops)
    for k in ("steps", "acked", "replayed"):
        check(cpu[k] == gpu[k], f"CPU run differs in {k}")
    for k, v in gpu["state"].items():
        check(np.array_equal(v, cpu["state"][k]),
              f"CPU run differs in state field {k}")
    for a, b in zip(gpu["tables"], cpu["tables"]):
        for k in a:
            check(np.array_equal(a[k], b[k]),
                  f"CPU run differs in KVS table {k}")
    same = f"bit-equal ({time.perf_counter() - t0:.1f} s on the CPU)"
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
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_profile(fn):
    """Run ``fn`` under ``torch.profiler`` (CUDA activity only): the wall
    time in ms and ``{name: (count, device us)}`` of what ran on the
    card (kernels and copies)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out[e.key] = (e.count, us)
    return wall_ms, out


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
    return dict(commit_scan=scan, commit_window=window[R])


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
                     workdir=None, **variants) -> dict:
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
    artifact, a run with telemetry its device counters."""
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
        prof = None
        if profile == "device":
            from torch.profiler import ProfilerActivity, profile as tprof
            prof = tprof(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
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
        time.sleep(0.2)          # let the follower frontiers settle
        d.stop()
        check(d.loop_error is None, f"the loop crashed: {d.loop_error!r}")
        out.update(
            launches=commit_window.launches,
            steps=d.cluster.step_index - steps0, bursts=len(bursts),
            wall=wall, fired=fired, statuses=[e.status for e in evs],
            latency=rel - np.array([e.t0 for e in evs]),
            hist=d.obs.metrics.get("commit_latency_seconds", replica=0),
            max_inflight=d.cluster.max_inflight_dispatches,
            post_step_ms=post_s[0] * 1e3, phases=d._phase_prof.sums(),
            streams=[list(s) for s in d.cluster.replayed])
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
            kern = [(e.count, getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0))
                    for e in prof.key_averages()]
            names = [e.key for e in prof.key_averages()]
            out["kernels"] = sum(n for (n, us), k in zip(kern, names)
                                 if us > 0 and not k.startswith(
                                     ("Memcpy", "Memset")))
            out["busy_ms"] = sum(us for n, us in kern if us > 0) / 1e3
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


def free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


APP_CLIENTS = 4
APP_SETS = 2000


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
    t = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


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
    for geo, n_entries, learner in (("a", 3 * 8192 + 1000, True),
                                    ("b", 4 * 2048, False)):
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
        t = time.perf_counter()
        cpu = drive_recovery(torch.device("cpu"), geom, "gather", n_entries,
                             learner)
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
              + f"; {time.perf_counter() - t:.1f} s on the CPU)", flush=True)
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


def pipelined_sets(port: int, items, chunk: int = 256) -> float:
    """SET each ``(key, value)`` on one connection, a chunk of lines at a
    time, then the chunk's replies; returns the wall seconds."""
    c = AppClient(port)
    t = time.perf_counter()
    for i in range(0, len(items), chunk):
        part = items[i:i + chunk]
        c.s.sendall(b"".join(b"SET %s %s\n" % kv for kv in part))
        for k, _v in part:
            got = c.f.readline().strip()
            check(got == b"+OK", f"SET {k!r} answered {got!r}")
    wall = time.perf_counter() - t
    c.close()
    return wall


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
        out["sets_s"] = pipelined_sets(ports[lead], items)
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
        out["big_s"] = pipelined_sets(ports[lead], big)
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
    if profile:
        box = {}
        wall_ms, kprof = device_profile(lambda: box.update(
            gpu=chaos_run(dev, **kw)))
        gpu = box["gpu"]
        busy_ms = sum(us for _, us in kprof.values()) / 1e3
        cuda_kernels = sum(n for k, (n, _) in kprof.items()
                           if "commit_window_kernel" in k)
        if kprof:                    # else the profiler saw no kernel
            check(cuda_kernels == gpu["steps"],
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
    t = time.perf_counter()
    cpu = chaos_run(torch.device("cpu"), **kw)
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
          f"({time.perf_counter() - t:.1f} s on the CPU)", flush=True)
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
          f"commit_window launches in {time.perf_counter() - t0:.2f} s",
          flush=True)
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


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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
        main_runs = [phase_main_path(port, g, dev, kvs_ops=3000)
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
