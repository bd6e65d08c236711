"""Port parity: one replica per process. Three OS processes, each a
``HostReplicaDriver(device="cpu")`` under gloo on 127.0.0.1, replay the
scripts of the JAX package's ``tests/test_multihost.py`` (election ->
write -> lazy commit -> ``fetch_local_window``, the scan tier, the
rebase) plus fused bursts and a leader failover, under both fan-outs.
Each rank dumps every call's outputs and its final ``export_local_row``
to an npz file; the same scripts then drive the JAX
``SimCluster(CFG, 3, mode="spmd")`` in this process (its compiled spmd
step, burst and scan over the conftest's virtual CPU mesh, three
threads meeting at each collective) and every array must be equal.

Also here: the stacked step's pinned op counts (the exchange seams add
no op to it), the lone-instance commit window, and ``ClusterConfig`` /
``load_config`` against the JAX package's.

Every subprocess has a timeout of its own and gloo an init and
collective ``timeout``, so a hung rank fails its test."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import traceback

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = 3
GEO = dict(n_slots=64, slot_bytes=32, window_slots=16, batch_slots=8)
GEO_REBASE = dict(GEO, rebase_threshold=100)
FANOUTS = ("psum", "gather")
RANK_TIMEOUT = 120          # seconds per world of three rank processes
GLOO_TIMEOUT = 60           # init and collective timeout of each rank

SEND = 3                    # EntryType.SEND in both packages
LEADER, FOLLOWER = 3, 1     # Role


def sends(conn: int, first: int, payloads) -> list:
    return [(SEND, conn, first + i, p) for i, p in enumerate(payloads)]


# ---------------------------------------------------------------------------
# the drills: one function per script, run by every rank (``hd`` is a
# HostReplicaDriver, or a rank of the JAX world below); ``rec`` records
# every result in call order
# ---------------------------------------------------------------------------

class Recorder:
    def __init__(self):
        self.items = []

    def put(self, tag: str, res: dict) -> dict:
        self.items.append((tag, {k: np.asarray(v) for k, v in res.items()}))
        return res

    def arrays(self) -> dict:
        return {f"{i:04d}.{tag}.{k}": v
                for i, (tag, res) in enumerate(self.items)
                for k, v in res.items()}


def drill_elect_write(hd, pid: int, fanout: str, rec: Recorder) -> None:
    """``test_multihost.py:65``: host 0's timer fires, it writes one
    entry, the lazy commit reaches every host, each reads the entry
    from its own log."""
    res = rec.put("step", hd.step(timeout_fired=(pid == 0)))
    assert res["term"] == 1, res
    if pid == 0:
        assert res["role"] == LEADER and res["became_leader"] == 1, res
    batch = sends(1, 1, [b"mh-write"]) if pid == 0 else []
    res = rec.put("step", hd.step(batch=batch,
                                  apply_done=int(res["commit"])))
    if pid == 0:
        assert res["commit"] == 2, res
    res = rec.put("step", hd.step(apply_done=int(res["commit"])))
    assert res["commit"] == 2, res
    wd, wm = hd.fetch_local_window(1)
    rec.put("fetch", dict(wd=wd, wm=wm))
    assert wd[0].astype("<i4").tobytes()[:int(wm[0, 4])] == b"mh-write"


def drill_bursts_scan(hd, pid: int, fanout: str, rec: Recorder) -> None:
    """Fused bursts at K = 2 and 4, then ``test_multihost.py:126``: a
    K = 2 scan whose replay rows carry the committed entries."""
    res = rec.put("step", hd.step(timeout_fired=(pid == 0)))
    lead = pid == 0
    seq = 0
    for K in (2, 4):
        batches = ([sends(1, seq + 8 * k + 1,
                          [b"k%d-%d-%d" % (K, k, j) for j in range(8)])
                    for k in range(K)] if lead else [])
        seq += 8 * K
        res = rec.put(f"burst{K}", hd.step_burst(
            K, batches, apply_done=int(res["commit"]),
            queue_depth=3 if lead else 0))
    applied = int(res["commit"])
    batches = ([sends(1, seq + 1, [b"sc-one"]), sends(1, seq + 2,
                                                      [b"sc-two"])]
               if lead else [])
    res, rows = hd.step_scan(2, batches, apply_done=applied)
    rec.put("scan", dict(res, wd=rows[0], wm=rows[1]))
    res, (wd, wm) = hd.step_scan(2, [], apply_done=applied)
    rec.put("scan", dict(res, wd=wd, wm=wm))
    commit = int(res["commit"])
    assert commit == 1 + 8 * 6 + 2, res
    got = [wd[i].astype("<i4").tobytes()[:int(wm[i, 4])]
           for i in range(commit - applied - 2, commit - applied)]
    assert got == [b"sc-one", b"sc-two"], got
    assert int(res["accepted"]) == 0, res


def drill_rebase(hd, pid: int, fanout: str, rec: Recorder) -> None:
    """``test_multihost.py:204`` at ``rebase_threshold=100``: 160
    entries in batches of 8; every rank applies the gathered
    ``rebase_delta`` in the same iteration."""
    res = rec.put("step", hd.step(timeout_fired=(pid == 0)))
    applied = seq = rebases = 0
    for _ in range(60):
        batch = []
        if pid == 0 and seq < 160:
            batch = sends(1, seq + 1, [b"rb%05d" % (seq + j + 1)
                                       for j in range(8)])
            seq += 8
        res = rec.put("step", hd.step(batch=batch, apply_done=applied))
        applied = int(res["commit"])
        rd = int(res["rebase_delta"])
        if rd > 0:
            hd.rebase(rd)
            applied -= rd
            rebases += 1
    assert rebases >= 1, "no rollover happened"
    wd, wm = hd.fetch_local_window(int(res["commit"]) - 1)
    rec.put("fetch", dict(wd=wd, wm=wm))
    assert wd[0].astype("<i4").tobytes()[:int(wm[0, 4])] == b"rb00160"


def drill_failover(hd, pid: int, fanout: str, rec: Recorder) -> None:
    """A leader change. Under ``gather`` a partition through
    ``peer_mask`` cuts leader 0 off, the majority elects 1, the old
    leader's write in its minority is truncated after the heal. Under
    ``psum`` a partition mask is refused (every rank, before any
    collective) and replica 1's timer takes the leadership from a live
    leader."""
    res = rec.put("step", hd.step(timeout_fired=(pid == 0)))
    batch = sends(1, 1, [b"before-%d" % i for i in range(4)]) \
        if pid == 0 else []
    res = rec.put("step", hd.step(batch=batch,
                                  apply_done=int(res["commit"])))
    res = rec.put("step", hd.step(apply_done=int(res["commit"])))
    cut = np.array([[1, 0, 0], [0, 1, 1], [0, 1, 1]], np.int32)[pid]
    if fanout == "psum":
        with pytest.raises(ValueError, match="all-ones peer_mask"):
            hd.step(peer_mask=cut)
        mask = None
        res = rec.put("step", hd.step(timeout_fired=(pid == 1),
                                      apply_done=int(res["commit"])))
    else:
        mask = cut
        batch = sends(1, 5, [b"lost"]) if pid == 0 else []
        res = rec.put("step", hd.step(batch=batch, peer_mask=mask,
                                      apply_done=int(res["commit"])))
        res = rec.put("step", hd.step(timeout_fired=(pid == 1),
                                      peer_mask=mask,
                                      apply_done=int(res["commit"])))
    if pid == 1:
        assert res["role"] == LEADER and res["term"] == 2, res
    for i in range(4):
        batch = sends(2, 1 + i, [b"after-%d" % i]) if pid == 1 else []
        res = rec.put("step", hd.step(batch=batch, peer_mask=mask,
                                      apply_done=int(res["commit"])))
    for _ in range(3):                               # heal, catch up
        res = rec.put("step", hd.step(apply_done=int(res["commit"])))
    assert res["leader_id"] == 1 and res["term"] == 2, res
    assert res["role"] == (LEADER if pid == 1 else FOLLOWER), res
    assert res["commit"] == res["end"] == 1 + 4 + 1 + 4, res
    wd, wm = hd.fetch_local_window(5)
    rec.put("fetch", dict(wd=wd, wm=wm))
    assert wd[1].astype("<i4").tobytes()[:int(wm[1, 4])] == b"after-0"


def drill_genesis(hd, pid: int, fanout: str, rec: Recorder) -> None:
    """The elastic-rebuild boot path: once the logs agree, every rank
    installs the same genesis row (its own converged row, sanitised:
    ``snapshot.genesis_row``), restores a persisted HardState above it,
    and the rebuilt world elects replica 2 and commits a write."""
    from rdma_paxos_tpu_torch.consensus.snapshot import genesis_row
    res = rec.put("step", hd.step(timeout_fired=(pid == 0)))
    batch = sends(1, 1, [b"g0", b"g1"]) if pid == 0 else []
    for _ in range(3):
        res = rec.put("step", hd.step(batch=batch,
                                      apply_done=int(res["commit"])))
        batch = []
    row = genesis_row(hd.export_local_row(), group_mask=0b111, epoch=4,
                      n_replicas=R, term=int(res["term"]))
    rec.put("genesis", row)
    hd.install_genesis(row)
    hd.restore_hardstate(int(row["term"]) + pid, 1, 0)
    rec.put("restored", hd.export_local_row())
    res = rec.put("step", hd.step(timeout_fired=(pid == 2),
                                  apply_done=int(res["commit"])))
    batch = sends(3, 1, [b"after-genesis"]) if pid == 2 else []
    for _ in range(2):
        res = rec.put("step", hd.step(batch=batch,
                                      apply_done=int(res["commit"])))
        batch = []
    assert res["leader_id"] == 2 and res["commit"] == res["end"], res


DRILLS = dict(elect_write=(drill_elect_write, GEO),
              bursts_scan=(drill_bursts_scan, GEO),
              rebase=(drill_rebase, GEO_REBASE),
              failover=(drill_failover, GEO),
              genesis=(drill_genesis, GEO))


def run_drills(make_driver, pid: int, fanout: str) -> dict:
    """Every drill on a fresh driver; ``{drill: Recorder arrays}`` with
    the final ``export_local_row`` of each."""
    out = {}
    for name, (drill, geo) in DRILLS.items():
        hd = make_driver(geo)
        rec = Recorder()
        drill(hd, pid, fanout, rec)
        rec.put("row", hd.export_local_row())
        out[name] = rec.arrays()
    return out


# ---------------------------------------------------------------------------
# the port's side: three rank processes
# ---------------------------------------------------------------------------

def rank_main(argv=None) -> None:
    """One rank: ``rank port fanout out.npz``."""
    pid, port, fanout, out = (argv or sys.argv[1:])[:4]
    pid = int(pid)
    torch.set_num_threads(1)
    import torch.distributed as dist
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.runtime.host import HostReplicaDriver
    first = [True]

    def make(geo):
        hd = HostReplicaDriver(
            LogConfig(**geo), process_id=pid, num_processes=R,
            coordinator=f"127.0.0.1:{port}", fanout=fanout, device="cpu",
            initialize_distributed=first[0], timeout=GLOO_TIMEOUT)
        first[0] = False
        return hd
    try:
        res = run_drills(make, pid, fanout)
        np.savez(out, **{f"{d}/{k}": v for d, a in res.items()
                         for k, v in a.items()})
        print(f"RANK{pid} OK", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def port_worlds(tmp_path_factory):
    """Both fan-outs' worlds at once: six rank processes; ``{fanout:
    [per-rank npz dict]}``."""
    wd = tmp_path_factory.mktemp("host_world")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = {}
    for fanout in FANOUTS:
        port = free_port()
        procs[fanout] = [subprocess.Popen(
            [sys.executable, "-c",
             "from tests.test_torch_host import rank_main; rank_main()",
             str(i), str(port), fanout, str(wd / f"{fanout}{i}.npz")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for i in range(R)]
    worlds = {}
    try:
        for fanout, ps in procs.items():
            outs = [p.communicate(timeout=RANK_TIMEOUT)[0].decode()
                    for p in ps]
            for i, (p, out) in enumerate(zip(ps, outs)):
                assert p.returncode == 0 and f"RANK{i} OK" in out, (
                    f"{fanout} rank {i} failed:\n{out}")
            worlds[fanout] = [dict(np.load(wd / f"{fanout}{i}.npz"))
                              for i in range(R)]
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return worlds


# ---------------------------------------------------------------------------
# the JAX side: SimCluster(mode="spmd"), three threads meeting at each
# collective
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def jax_step_cache_restored():
    """Leave the JAX step cache as this module found it (the JAX tests
    count the keys a cluster adds; see tests/test_torch_sim.py)."""
    from rdma_paxos_tpu.runtime.sim import STEP_CACHE
    before = set(STEP_CACHE)
    yield
    for k in set(STEP_CACHE) - before:
        del STEP_CACHE[k]


class JaxWorld:
    """The JAX ``SimCluster(mode="spmd")``'s state and compiled spmd
    programs, driven by R rank handles: each collective call waits for
    every rank's inputs, then one dispatch serves all R."""

    def __init__(self, geo: dict, fanout: str):
        from rdma_paxos_tpu.config import LogConfig as JCfg
        from rdma_paxos_tpu.runtime.sim import SimCluster
        self.cfg = JCfg(**geo)
        self.fanout = fanout
        self.c = SimCluster(self.cfg, R, mode="spmd", fanout=fanout)
        self.scans = {}
        self.pending = [None] * R
        self.results = [None] * R
        self.error = None
        self.barrier = threading.Barrier(R, action=self._collective,
                                         timeout=GLOO_TIMEOUT)

    def _collective(self):
        try:
            kinds = {p[0] for p in self.pending}
            assert len(kinds) == 1, kinds
            kind = kinds.pop()
            self.results = getattr(self, "_" + kind)(
                [p[1] for p in self.pending])
        except Exception:                          # noqa: BLE001
            self.error = traceback.format_exc()
            self.results = [None] * R

    def call(self, rank: int, kind: str, kw: dict):
        self.pending[rank] = (kind, kw)
        self.barrier.wait()
        if self.error:
            raise RuntimeError(self.error)
        return self.results[rank]

    def _pack(self, batch, gen=0):
        from rdma_paxos_tpu.consensus.log import META_W
        from rdma_paxos_tpu.runtime.hostpath import pack_window
        B = self.cfg.batch_slots
        data = np.zeros((B, self.cfg.slot_words), np.int32)
        meta = np.zeros((B, META_W), np.int32)
        pack_window(data.view(np.uint8).reshape(B, -1), meta,
                    list(batch)[:B], self.cfg.slot_bytes, gen=gen)
        return data, meta, min(len(batch), B)

    def _step(self, kws):
        import jax.numpy as jnp
        from rdma_paxos_tpu.consensus.step import StepInput
        from rdma_paxos_tpu.runtime.host import OUT_KEYS
        packed = [self._pack(kw.get("batch", ())) for kw in kws]
        pm = np.stack([np.ones(R, np.int32) if kw.get("peer_mask") is None
                       else np.asarray(kw["peer_mask"], np.int32)
                       for kw in kws])

        def col(key, default=0):
            return jnp.asarray(np.array([int(kw.get(key, default))
                                         for kw in kws], np.int32))
        inp = StepInput(
            batch_data=jnp.asarray(np.stack([p[0] for p in packed])),
            batch_meta=jnp.asarray(np.stack([p[1] for p in packed])),
            batch_count=jnp.asarray(np.array([p[2] for p in packed],
                                             np.int32)),
            timeout_fired=col("timeout_fired"), peer_mask=jnp.asarray(pm),
            apply_done=col("apply_done"), queue_depth=col("queue_depth"))
        fn = self.c._build_step(elections=True)
        self.c.state, out = fn(self.c.state, inp)
        return [{k: np.asarray(getattr(out, k))[r] for k in OUT_KEYS}
                for r in range(R)]

    def _kinputs(self, kws):
        import jax.numpy as jnp
        from rdma_paxos_tpu.consensus.log import META_W
        K = kws[0]["K"]
        assert all(kw["K"] == K for kw in kws)
        B, sw, mw = self.cfg.batch_slots, self.cfg.slot_words, META_W
        data = np.zeros((K, R, B, sw), np.int32)
        meta = np.zeros((K, R, B, mw), np.int32)
        count = np.zeros((K, R), np.int32)
        for r, kw in enumerate(kws):
            for k, batch in enumerate(list(kw.get("batches", ()))[:K]):
                data[k, r], meta[k, r], count[k, r] = self._pack(batch)

        def col(key):
            return jnp.asarray(np.array([int(kw.get(key, 0)) for kw in kws],
                                        np.int32))
        return (K, jnp.asarray(data), jnp.asarray(meta), jnp.asarray(count),
                jnp.ones((R, R), jnp.int32), col("apply_done"),
                col("queue_depth"))

    def _burst(self, kws):
        from rdma_paxos_tpu.runtime.host import OUT_KEYS
        K, *args = self._kinputs(kws)
        self.c.state, outs = self.c._burst_fn(K)(self.c.state, *args)
        res = []
        for r in range(R):
            d = {k: np.asarray(getattr(outs, k))[-1, r] for k in OUT_KEYS}
            d["accepted"] = np.asarray(outs.accepted)[:, r].sum()
            res.append(d)
        return res

    def _scan(self, kws):
        from rdma_paxos_tpu.consensus.step import SCAN_KEYS
        from rdma_paxos_tpu.parallel.mesh import build_spmd_scan
        K, *args = self._kinputs(kws)
        if K not in self.scans:
            self.scans[K] = build_spmd_scan(
                self.cfg, R, self.c.mesh,
                replay_slots=self.cfg.window_slots, fanout=self.fanout)
        self.c.state, outs = self.scans[K](self.c.state, *args)
        scal = np.asarray(outs["scal"])[-1]
        rd, rm = (np.asarray(outs["replay_data"]),
                  np.asarray(outs["replay_meta"]))
        return [({k: scal[r, i] for i, k in enumerate(SCAN_KEYS)},
                 (rd[r], rm[r])) for r in range(R)]

    def _genesis(self, kws):
        import dataclasses
        import jax
        from rdma_paxos_tpu.consensus.log import Log
        st = self.c.state
        rows = [kw["row"] for kw in kws]
        fields = {f.name: np.stack([np.asarray(r[f.name]).astype(
            getattr(st, f.name).dtype) for r in rows])
            for f in dataclasses.fields(st) if f.name != "log"}
        fields["log"] = Log(buf=np.stack([np.asarray(r["log_buf"], np.int32)
                                          for r in rows]))
        self.c.state = jax.device_put(
            type(st)(**fields), jax.sharding.NamedSharding(
                self.c.mesh, jax.sharding.PartitionSpec("replica")))
        return [None] * R

    def _hardstate(self, kws):
        import dataclasses
        import jax.numpy as jnp
        g = jnp.asarray(np.array([[kw["term"], kw["voted_term"],
                                   kw["voted_for"]] for kw in kws],
                                 np.int32))
        st = self.c.state
        self.c.state = dataclasses.replace(
            st, term=jnp.maximum(st.term, g[:, 0]),
            voted_for=jnp.where(g[:, 1] > st.voted_term, g[:, 2],
                                st.voted_for),
            voted_term=jnp.maximum(st.voted_term, g[:, 1]))
        return [None] * R

    def _rebase(self, kws):
        import jax.numpy as jnp
        from rdma_paxos_tpu.consensus.snapshot import rebase_offsets
        deltas = {kw["delta"] for kw in kws}
        assert len(deltas) == 1, deltas
        self.c.state = rebase_offsets(self.c.state,
                                      jnp.asarray(deltas.pop(), jnp.int32))
        return [None] * R


class JaxRank:
    """Rank ``r`` of a :class:`JaxWorld`, with the HostReplicaDriver
    calls the drills make."""

    def __init__(self, world: JaxWorld, r: int):
        self.w, self.r = world, r

    def step(self, **kw):
        pm = kw.get("peer_mask")
        if (pm is not None and self.w.fanout == "psum"
                and not np.all(np.asarray(pm) != 0)):
            raise ValueError("psum fan-out requires an all-ones peer_mask")
        return self.w.call(self.r, "step", kw)

    def step_burst(self, K, batches=(), **kw):
        return self.w.call(self.r, "burst", dict(kw, K=K, batches=batches))

    def step_scan(self, K, batches=(), **kw):
        return self.w.call(self.r, "scan", dict(kw, K=K, batches=batches))

    def rebase(self, delta):
        self.w.call(self.r, "rebase", dict(delta=int(delta)))

    def install_genesis(self, row):
        self.w.call(self.r, "genesis", dict(row=row))

    def restore_hardstate(self, term, voted_term, voted_for):
        self.w.call(self.r, "hardstate", dict(
            term=term, voted_term=voted_term, voted_for=voted_for))

    def fetch_local_window(self, start):
        import jax.numpy as jnp
        from rdma_paxos_tpu.consensus.log import Log
        from rdma_paxos_tpu.consensus.step import fetch_window
        wd, wm = fetch_window(Log(buf=self.w.c.state.log.buf[self.r]),
                              jnp.asarray(start, jnp.int32),
                              window_slots=self.w.cfg.window_slots)
        return np.asarray(wd), np.asarray(wm)

    def export_local_row(self):
        from rdma_paxos_tpu.consensus.snapshot import export_row
        return export_row(self.w.c.state, self.r)


def jax_drill(name: str, fanout: str) -> list:
    """The drill ``name`` on the JAX spmd engine: each rank's arrays."""
    drill, geo = DRILLS[name]
    world = JaxWorld(geo, fanout)
    out, errors = [None] * R, []

    def run(r):
        try:
            rec = Recorder()
            drill(JaxRank(world, r), r, fanout, rec)
            rec.put("row", JaxRank(world, r).export_local_row())
            out[r] = rec.arrays()
        except Exception:                          # noqa: BLE001
            errors.append(traceback.format_exc())
            world.barrier.abort()
    threads = [threading.Thread(target=run, args=(r,)) for r in range(R)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(GLOO_TIMEOUT * 2)
    assert not errors, errors[0]
    return out


@pytest.mark.parametrize("fanout", FANOUTS)
@pytest.mark.parametrize("drill", list(DRILLS))
def test_host_world_matches_jax_spmd(port_worlds, drill, fanout):
    """Every rank's per-call outputs, fetched windows and final state row
    bit-equal to the JAX spmd engine given the same inputs."""
    want = jax_drill(drill, fanout)
    for r in range(R):
        got = {k.split("/", 1)[1]: v for k, v in port_worlds[fanout][r].items()
               if k.startswith(drill + "/")}
        assert sorted(got) == sorted(want[r]), (drill, fanout, r)
        for k, v in want[r].items():
            assert got[k].dtype == v.dtype, (k, got[k].dtype, v.dtype)
            np.testing.assert_array_equal(got[k], v,
                                          err_msg=f"{drill}/{fanout}/{r}/{k}")


# ---------------------------------------------------------------------------
# the stacked path and the lone-instance commit window
# ---------------------------------------------------------------------------

# non-view ops per step() on the CPU, measured once on the parent of the
# exchange seams (the same op sequence, op for op); the plain commit
# window's ops are included (the card launches one kernel there)
STACKED_OPS = {("gather", False, "stable"): 601,
               ("gather", False, "full"): 703,
               ("gather", True, "stable"): 674,
               ("gather", True, "full"): 786,
               ("psum", False, "stable"): 603,
               ("psum", False, "full"): 705,
               ("psum", True, "stable"): 676,
               ("psum", True, "full"): 788}


@pytest.mark.parametrize("key", list(STACKED_OPS))
def test_stacked_step_dispatches_the_parents_ops(key):
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.obs.device import count_ops
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    fanout, variants, kind = key
    kw = dict(audit=True, telemetry=True, txn=True) if variants else {}
    c = SimCluster(LogConfig(**GEO), R, fanout=fanout, device="cpu", **kw)
    c.step(timeouts=[0])
    c.submit(0, b"x")
    if kind == "stable":
        n = count_ops(c.step)
    else:
        n = count_ops(lambda: c.step(timeouts=[1]))
    assert n == STACKED_OPS[key]


def test_group_step_dispatches_the_parents_ops():
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.obs.device import count_ops
    from rdma_paxos_tpu_torch.shard.cluster import ShardedCluster
    sc = ShardedCluster(LogConfig(**GEO), R, 2, device="cpu")
    sc.place_leaders()
    assert count_ops(sc.step) == 601


def test_lone_instance_commit_window_reads_its_groups_acks():
    """The process-group step calls ``commit_window`` with N = 1 and the
    R gathered acks: each instance of a stacked call, alone, gives the
    same commit and crossing row."""
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    rng = np.random.default_rng(5)
    W, n_slots, cols = 16, 64, 16
    buf = torch.from_numpy(rng.integers(0, 4, (R, n_slots, cols))
                           .astype(np.int32))
    buf[..., -8 + 5] = torch.arange(n_slots, dtype=torch.int32)  # M_GIDX
    buf[..., -8 + 1] = 1                                         # M_TERM
    peer = torch.from_numpy(rng.random((R, R)) < 0.8)
    my_ack = torch.from_numpy(rng.integers(0, 30, R).astype(np.int32))

    def i32(v):
        return torch.tensor(v, dtype=torch.int32)
    v = dict(commit=i32([3, 5, 2]), my_term=i32([1, 1, 1]),
             my_end=i32([40, 40, 40]), transit=i32([0, 0, 0]),
             maj_old=i32([2, 2, 2]), maj_new=i32([2, 2, 2]),
             commit1=i32([3, 5, 2]), i_lead=torch.tensor([True, False,
                                                          True]),
             bm_old=torch.full((R,), 7, dtype=torch.int64),
             bm_new=torch.full((R,), 7, dtype=torch.int64))
    c_all, x_all = commit_window(buf, peer, my_ack, w=W, **v)
    for n in range(R):
        c1, x1 = commit_window(buf[n:n + 1].contiguous(), peer[n:n + 1],
                               my_ack, w=W,
                               **{k: t[n:n + 1] for k, t in v.items()})
        assert (int(c1), int(x1)) == (int(c_all[n]), int(x_all[n])), n
    with pytest.raises(ValueError, match="does not split"):
        commit_window(buf[:2].contiguous(), peer[:2], my_ack[:2], w=W,
                      **{k: t[:2] for k, t in v.items()})


def test_make_replica_world_needs_an_initialised_group():
    from rdma_paxos_tpu_torch.parallel.mesh import make_replica_world
    with pytest.raises(RuntimeError, match="not initialised"):
        make_replica_world(3, device="cpu")


def test_host_driver_runs_on_the_card_unless_told():
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.runtime.host import HostReplicaDriver
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HostReplicaDriver(LogConfig(**GEO), process_id=0, num_processes=3,
                          coordinator="127.0.0.1:1",
                          initialize_distributed=False)


# ---------------------------------------------------------------------------
# ClusterConfig and load_config against the JAX package's
# ---------------------------------------------------------------------------

ENVS = [{}, dict(server_idx="2", group_size="5", server_type="join",
                 config_path="/x.cfg", dare_log_file="/l.log",
                 peers="h0:1,h1:2,,h2:3")]


def cc_fields(c) -> dict:
    return {k: getattr(c, k) for k in ("server_idx", "group_size",
                                       "server_type", "config_path",
                                       "log_file", "peers", "majority")}


@pytest.mark.parametrize("env", ENVS)
def test_cluster_config_from_env_matches_jax(env):
    from rdma_paxos_tpu.config import ClusterConfig as J
    from rdma_paxos_tpu_torch.config import ClusterConfig as T
    assert cc_fields(T.from_env(env)) == cc_fields(J.from_env(env))


@pytest.mark.parametrize("kw", [dict(group_size=0), dict(group_size=14),
                                dict(server_type="spare"),
                                dict(group_size=13), dict(group_size=1)])
def test_cluster_config_validation_matches_jax(kw):
    from rdma_paxos_tpu.config import ClusterConfig as J
    from rdma_paxos_tpu_torch.config import ClusterConfig as T

    def outcome(cls):
        try:
            return cc_fields(cls(**kw))
        except ValueError as exc:
            return ("ValueError", str(exc))
    assert outcome(T) == outcome(J)


@pytest.mark.parametrize("env", ENVS[:1] + [dict(server_idx="1",
                                                 group_size="5")])
def test_load_config_matches_jax(tmp_path, env):
    import dataclasses
    from rdma_paxos_tpu.config import load_config as j_load
    from rdma_paxos_tpu_torch.config import load_config as t_load
    p = tmp_path / "nodes.json"
    p.write_text(json.dumps(dict(
        log=dict(n_slots=256, slot_bytes=64, window_slots=32,
                 batch_slots=16),
        timing=dict(hb_period=0.002, elec_timeout_low=0.02),
        cluster=dict(group_size=3, peers=["h0:9000", "h1:9000"]))))
    j, t = j_load(str(p), env), t_load(str(p), env)
    for a, b in zip(j, t):
        assert type(a).__name__ == type(b).__name__
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert t[2].majority == j[2].majority
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(dict(cluster=dict(group_size=20))))
    for load in (j_load, t_load):
        with pytest.raises(ValueError, match="group_size must be"):
            load(str(bad), {})
