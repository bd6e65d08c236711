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
6. the ``kernels`` JSON line, then ``{"ok": true, "device": ...}`` last.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

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


def drive(port, geo: str, dev, kvs_ops: int) -> dict:
    """The seeded main-path run on ``dev``; returns what the caller
    compares across devices."""
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.models.kvs import CMD_W, OP_INCR, decode_val
    from rdma_paxos_tpu_torch.models.replicated_kvs import (
        TXN_CMD_W, ReplicatedKVS)
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    geom, fanout = GEOMETRIES[geo]
    cfg = LogConfig(**geom)
    B = cfg.batch_slots
    rng = np.random.default_rng(SEED)
    c = SimCluster(cfg, R, fanout=fanout, device=dev)
    kv = ReplicatedKVS(c, cap=65536)
    launches0, steps0 = (commit_window.launches,
                         commit_scan.launches), c.step_index
    t0 = time.perf_counter()

    lead = c.run_until_elected(0)
    # SEND stream: two full batches through step(), eight through bursts
    # (lengths of a KVS command or a txn record are skipped: the KVS
    # fold would read such SEND payloads as commands)
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


# the host-side stages of one engine step, for the host profile
HOST_STAGES = ("step", "submit_many", "begin_step", "pack_rows", "_dev",
               "replica_step", "commit_window", "finish", "_readback",
               "_replay_committed", "decode_window")


def host_profile(fn) -> dict:
    """Inclusive wall ms of each :data:`HOST_STAGES` function over
    ``fn()`` under cProfile."""
    import cProfile
    import pstats
    pr = cProfile.Profile()
    pr.enable()
    fn()
    torch.cuda.synchronize()
    pr.disable()
    out = dict.fromkeys(HOST_STAGES, 0.0)
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


def phase_times(dev, card: str) -> None:
    """End to end at geometry (a): full batches through the stable step
    and through bursts, then the device and host profiles of ``step()``."""
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
    wall_ms, sprof = device_profile(ten_steps)
    busy_ms = sum(us for _, us in sprof.values()) / 1e3
    n_kern = sum(n for k, (n, _) in sprof.items()
                 if not k.startswith(("Memcpy", "Memset")))
    n_copy = sum(n for _, (n, _) in sprof.items()) - n_kern
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


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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

    from rdma_paxos_tpu_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.build()
    report = " | ".join(
        f"{n}: " + " ".join(ln.strip() for ln in
                            p.with_suffix(".log").read_text().splitlines()
                            if "Used" in ln or "spill" in ln)
        for n, p in libs.items())
    print(f"build: {len(libs)} kernel(s) in {time.perf_counter() - t0:.1f} s"
          f" ({report})", flush=True)

    checks = dict(commit_scan=phase_kernel_checks(dev),
                  commit_window=phase_window_checks(dev))
    main_runs = [phase_main_path(port, g, dev, kvs_ops=3000)
                 for g in GEOMETRIES]
    times = phase_kernel_times(dev, smi)
    phase_times(dev, smi)

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
