"""The stable step replayed from a CUDA graph (``parallel/graph.py``).

On the CPU no engine records a graph: every protocol step runs eagerly
and is counted under its reason (``elections`` where a timer fired,
``no_capture`` elsewhere), on a stacked engine, a device-list engine
and through the driver's metrics registry. The graphed path itself runs
here with :class:`EagerGraph`, a ``StepGraph`` whose record and replay
run the recorded body eagerly: a graphed engine is held against the
same engine without one, step for step, every result and every state
field equal, through serial steps, no-take steps, bursts of every tier,
two tickets in flight, elections, a rebase and a rebound state.
:func:`drive_graphed` is the scenario; ``tests/test_torch_gpu.py`` runs
it with the real graphs on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.consensus.log import Log
from rdma_paxos_tpu_torch.consensus.state import STATE_FIELDS, clone_state
from rdma_paxos_tpu_torch.consensus.step import make_step_input
from rdma_paxos_tpu_torch.parallel.graph import StepGraph
from rdma_paxos_tpu_torch.runtime import sim
from rdma_paxos_tpu_torch.runtime.sim import SimCluster
from rdma_paxos_tpu_torch.shard.cluster import ShardedCluster

torch.set_num_threads(1)

# bursts of every tier fit the ring; ~1300 appends cross the rebase
GEO = dict(n_slots=1024, slot_bytes=64, window_slots=32, batch_slots=16,
           rebase_threshold=1100)
R = 3
VARIANTS = {"plain": {}, "audit_telemetry": dict(audit=True,
                                                 telemetry=True)}


class EagerGraph(StepGraph):
    """A ``StepGraph`` whose record and replays run its body eagerly:
    the CPU stand-in for the CUDA graph, so the engines' graphed path
    runs here. Recording leaves the state as it found it, as a capture
    does."""

    def _record(self, step, body):
        saved = [t.clone() for t in self._static]
        self._body = body
        packed = body()
        for t, v in zip(self._static, saved):
            t.copy_(v)
        return packed

    def _launch(self):
        self.packed.copy_(self._body())


class One:
    """A single-group engine for the scenario."""

    def __init__(self, device, **variants):
        self.c = SimCluster(LogConfig(**GEO), R, device=device, **variants)

    def input(self, device):
        return make_step_input(self.c.cfg, R, device=device)

    def elect(self, r):
        return self.c.step(timeouts=[r])

    def load(self, n, tag):
        lead = self.c.leader()
        self.c.submit_many(lead, [(3, 7, i, b"%s-%05d" % (tag, i))
                                  for i in range(n)])


class Groups(One):
    """Two groups of a sharded engine; group g's replica ``(r + g) % R``
    is elected, so the groups' leaders differ."""

    G = 2

    def __init__(self, device, **variants):
        self.c = ShardedCluster(LogConfig(**GEO), R, self.G, device=device,
                                **variants)

    def input(self, device):
        return make_step_input(self.c.cfg, R, n_groups=self.G,
                               device=device)

    def elect(self, r):
        return self.c.step(timeouts={g: [(r + g) % R]
                                     for g in range(self.G)})

    def load(self, n, tag):
        for g in range(self.G):
            self.c.submit_many(g, self.c.leader(g), [
                (3, 7 + g, i, b"%s-%d-%05d" % (tag, g, i))
                for i in range(n)])


ENGINES = {"sim": One, "shard": Groups}


def assert_same(a, b, res_a, res_b, tag):
    """Equal results, state (every field, the rings included), apply
    cursors and replay streams."""
    assert set(res_a) == set(res_b), tag
    for k in res_a:
        np.testing.assert_array_equal(res_a[k], res_b[k],
                                      err_msg=f"{tag}: {k}")
    for k in STATE_FIELDS:
        ta, tb = getattr(a.state, k), getattr(b.state, k)
        if k == "log":
            ta, tb = ta.buf, tb.buf
        assert torch.equal(ta.cpu(), tb.cpu()), (tag, k)
    np.testing.assert_array_equal(a.applied, b.applied, err_msg=tag)
    streams = ((lambda c: [list(s) for s in c.replayed])
               if not isinstance(a, ShardedCluster) else
               (lambda c: [[list(s) for s in g] for g in c.replayed]))
    assert streams(a) == streams(b), tag
    assert np.array_equal(a.rebases, b.rebases), tag


def drive_graphed(make, graphed_device, plain_device="cpu", **variants):
    """Hold an engine with graphs (``make(graphed_device)``, which
    records them) against the same engine without
    (``make(plain_device)``), step for step. Returns the graphed engine
    and its expected step counts: ``{"step", "burst", "elections"}``."""
    ea, eb = make(graphed_device, **variants), make(plain_device, **variants)
    a, b = ea.c, eb.c
    want = dict(step=0, burst=0, elections=0)

    def both(fn, tag, path):
        ra, rb = fn(ea), fn(eb)
        if isinstance(ra, tuple):             # pipelined: finish in order
            ra, rb = [ea.c.finish(t) for t in ra][-1], [
                eb.c.finish(t) for t in rb][-1]
        assert_same(a, b, ra, rb, tag)
        for p, n in path:
            want[p] += n

    both(lambda e: e.elect(0), "elect", [("elections", 1)])
    both(lambda e: e.c.step(), "settle", [("step", 1)])
    for i in range(3):
        both(lambda e: (e.load(20, b"s%d" % i), e.c.step())[1],
             f"serial {i}", [("step", 1)])
    both(lambda e: e.c.finish(e.c.begin_step(take_batch=False)),
         "no-take", [("step", 1)])
    B = GEO["batch_slots"]
    for K in a.K_TIERS:
        def burst(e, K=K):
            e.load((K - 1) * B + 1, b"b%d" % K)
            t = e.c.begin_burst()
            assert t.K == K, (t.K, K)
            return e.c.finish(t)
        both(burst, f"burst {K}", [("burst", K)])
    both(lambda e: (e.load(40, b"p"), (e.c.begin_burst(),
                                       e.c.begin_step(take_batch=False)))[1],
         "two in flight", [("burst", 4), ("step", 1)])
    both(lambda e: (e.c.begin_step(take_batch=False),
                    e.c.begin_step(take_batch=False)),
         "two steps in flight", [("step", 2)])
    both(lambda e: e.elect(1), "election between replays",
         [("elections", 1)])
    for i in range(3):
        both(lambda e: e.c.step(), f"after election {i}", [("step", 1)])
    rebased = 0
    for i in range(12):
        both(lambda e: (e.load(8 * B, b"r%d" % i), e.c.step_burst())[1],
             f"toward the rebase {i}", [("burst", 8)])
        rebased = int(np.sum(a.rebases))
        if rebased:
            break
    assert rebased, "no rebase within the scenario"
    for i in range(2):
        both(lambda e: (e.load(B, b"x%d" % i), e.c.step())[1],
             f"after the rebase {i}", [("step", 1)])
    for e in (ea, eb):
        with e.c._host_lock:
            e.c.state = dataclasses.replace(
                clone_state(e.c.state),
                log=Log(e.c.state.log.buf.clone()))
    both(lambda e: (e.load(B, b"y"), e.c.step())[1], "after a rebinding",
         [("step", 1)])
    both(lambda e: (e.load(2 * B, b"z"), e.c.step_burst())[1],
         "burst after a rebinding", [("burst", 2)])
    assert b.graph_replays == {"step": 0, "burst": 0}
    assert b.eager_steps == {"elections": want["elections"],
                             "no_capture": want["step"] + want["burst"]}
    return ea, want


def capture(e):
    """Record the engine's graphs the way ``prewarm`` does."""
    c = e.c
    c._capture_graphs(lambda: e.input(c.device), None)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_graphed_path_equals_eager(monkeypatch, kind, variant):
    """The graphed path (record and replay run eagerly here) gives every
    result and every state field of the eager engine, and counts each
    protocol step once: replayed by path, eager by reason."""
    monkeypatch.setattr(sim, "StepGraph", EagerGraph)
    make = ENGINES[kind]

    def build(device, **kw):
        e = make("cpu", **kw)
        if device == "graphed":
            e.c.prewarm()
            capture(e)
            assert set(e.c._graphs) == {"step", "burst"}
        return e
    ea, want = drive_graphed(build, "graphed", "plain", **VARIANTS[variant])
    a = ea.c
    assert a.graph_replays == {"step": want["step"],
                               "burst": want["burst"]}
    assert a.eager_steps == {"elections": want["elections"],
                             "no_capture": 0}
    assert a.step_index == sum(want.values())


def test_txn_engine_records_a_burst_graph_without_the_lane(monkeypatch):
    """With the transaction lane the serial step and a burst's step are
    two programs: two graphs, and each dispatch replays its own."""
    monkeypatch.setattr(sim, "StepGraph", EagerGraph)
    cfg = LogConfig(**dict(GEO, slot_bytes=128))
    a = SimCluster(cfg, R, device="cpu", txn=True)
    b = SimCluster(cfg, R, device="cpu", txn=True)
    a._capture_graphs(lambda: make_step_input(cfg, R, device="cpu"),
                      sim.build_sim_step(cfg, R, elections=False))
    assert a._graphs["step"] is not a._graphs["burst"]
    assert a._graphs["step"].inp.txn_watch is not None
    assert a._graphs["burst"].inp.txn_watch is None
    for c in (a, b):
        c.step(timeouts=[0])
        c.submit_many(0, [(3, 1, i, b"t%03d" % i) for i in range(40)])
        c.set_txn_watch(2, 1)
    ra, rb = a.step(), b.step()
    assert_same(a, b, ra, rb, "txn step")
    assert "txn_vote" in ra
    ra, rb = a.step_burst(), b.step_burst()
    assert_same(a, b, ra, rb, "txn burst")
    assert a.graph_replays == {"step": 1, "burst": 2}


def _eager_counts(c):
    return dict(c.eager_steps), dict(c.graph_replays)


@pytest.mark.parametrize("engine", ["stacked", "device_list",
                                    "sharded", "mesh"])
def test_no_graph_off_the_card(engine):
    """A CPU engine and a device-list engine record no graph, even
    after ``prewarm``: every step runs eagerly, ``elections`` where a
    timer fired, ``no_capture`` elsewhere, bursts counted by their
    steps."""
    cfg = LogConfig(**GEO)
    if engine == "stacked":
        c = SimCluster(cfg, R, device="cpu")
    elif engine == "device_list":
        c = SimCluster(cfg, R, mode="spmd", device=["cpu"] * R)
    elif engine == "sharded":
        c = ShardedCluster(cfg, R, 2, device="cpu")
    else:
        c = ShardedCluster(cfg, R, 2, mesh=(2, R), device=["cpu"] * 2 * R)
    try:
        c.prewarm(tiers=(2,))
        assert c._graphs == {}
        if isinstance(c, ShardedCluster):
            c.step(timeouts={0: [0], 1: [1]})
            c.submit(0, 0, b"v")
        else:
            c.step(timeouts=[0])
            c.submit(0, b"v")
        c.step()
        c.step_burst()
        assert _eager_counts(c) == (
            {"elections": 1, "no_capture": 1 + 2},
            {"step": 0, "burst": 0})
    finally:
        c.close()


def test_driver_registry_counts_eager_steps_by_reason():
    """The driver's registry (``/metrics``) carries the counts: on the
    CPU, ``step_eager_total`` by reason and no replays."""
    from rdma_paxos_tpu_torch.config import TimeoutConfig
    from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
    d = ClusterDriver(LogConfig(**GEO), R, pipeline=0, device="cpu",
                      timeout_cfg=TimeoutConfig(elec_timeout_low=1e9,
                                                elec_timeout_high=2e9))
    try:
        d.runtimes[0].timer._deadline = 0.0
        d.step()
        d.step()
        m = d.obs.metrics
        assert m.get("step_eager_total", reason="elections") == 1
        assert m.get("step_eager_total", reason="no_capture") == \
            d.cluster.eager_steps["no_capture"] >= 1
        assert m.get("step_graph_replays_total", path="step") == 0
        from rdma_paxos_tpu_torch.obs.export import render_prometheus
        text = render_prometheus(m.snapshot())
        assert 'step_eager_total{reason="elections"} 1' in text
    finally:
        d.stop()
