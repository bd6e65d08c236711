"""The commit waiter (``proxy.proxy.PendingEvent``) of the port, on the CPU.

* exactly one callback, with the released status, under many threads
  racing ``attach``, ``release(0)``, ``release(-1)`` and a first ``done``;
* ``done.wait()`` returns for a thread that blocked before the release
  and for one that came after it;
* a waiter seen only through ``attach`` never makes a ``threading.Event``,
  and creating one adds one gc-tracked object;
* the ``ClusterDriver`` holds waiters in ``inflight`` stamped with their
  submit sequence, and ``commit_waiters_released_total`` splits the
  released ones by ``path``: ``callback`` or ``event``."""

from __future__ import annotations

import gc
import sys
import threading
import time

import pytest
import torch

from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
from rdma_paxos_tpu_torch.consensus.log import EntryType
from rdma_paxos_tpu_torch.proxy import proxy
from rdma_paxos_tpu_torch.proxy.proxy import PendingEvent
from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver

torch.set_num_threads(1)

GEO = dict(n_slots=128, slot_bytes=64, window_slots=32, batch_slots=8)
TIMERS = dict(elec_timeout_low=1e9, elec_timeout_high=2e9)   # manual
CONNECT, SEND = 2, 3
TRIALS = 300


def waiter(seq: int = 0) -> PendingEvent:
    return PendingEvent(EntryType.SEND, 7, b"SET k v\n", seq)


def _yield_in_waiter(frame, event, _arg):
    """A thread trace that gives the interpreter up at every line of the
    waiter's module, so racing threads interleave inside its methods."""
    if frame.f_code.co_filename != proxy.__file__:
        return None

    def on_line(_frame, ev, _a):
        if ev == "line":
            time.sleep(0)
        return on_line
    return on_line


@pytest.fixture
def fast_switches():
    """Threads started under it switch every microsecond and at every
    line of the waiter's code."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threading.settrace(_yield_in_waiter)
    try:
        yield
    finally:
        threading.settrace(None)
        sys.setswitchinterval(old)


@pytest.mark.parametrize("first", ["attach", "release0", "release1",
                                   "done"])
def test_one_callback_under_racing_threads(first, fast_switches):
    """Four threads per waiter, released by a barrier, the named one
    started first: the callback runs once with the status that
    ``status`` reads and the waiting thread saw, and ``done`` is set."""
    for _ in range(TRIALS):
        w = waiter()
        calls, seen = [], []
        gate = threading.Barrier(4)

        def attach():
            gate.wait()
            w.attach(calls.append)

        def release(status):
            gate.wait()
            w.release(status)

        def ask_done():
            gate.wait()
            assert w.done.wait(10)
            seen.append(w.status)

        racers = dict(attach=attach, release0=lambda: release(0),
                      release1=lambda: release(-1), done=ask_done)
        order = [first] + [k for k in racers if k != first]
        threads = [threading.Thread(target=racers[k]) for k in order]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        assert calls == [w.status] and w.status in (0, -1)
        assert seen == [w.status]
        assert w.done.is_set()


def test_many_waiters_many_releasers(fast_switches):
    """One thread attaches to every waiter while two release them all
    with different statuses: every callback fires once, with its
    waiter's status."""
    ws = [waiter(i) for i in range(2000)]
    calls = [[] for _ in ws]
    gate = threading.Barrier(3)

    def attach_all():
        gate.wait()
        for i, w in enumerate(ws):
            w.attach(calls[i].append)

    def release_all(status):
        gate.wait()
        for w in ws:
            w.release(status)

    threads = [threading.Thread(target=attach_all),
               threading.Thread(target=release_all, args=(0,)),
               threading.Thread(target=release_all, args=(-1,))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert [c for c in calls] == [[w.status] for w in ws]


def test_done_wait_before_and_after_the_release():
    w = waiter()
    early, late = [], []
    blocked = threading.Event()

    def before():
        ev = w.done
        blocked.set()
        early.append((ev.wait(10), w.status))

    t = threading.Thread(target=before)
    t.start()
    assert blocked.wait(10)
    assert w.release(-1) is True        # a thread had asked for done
    t.join(10)
    assert early == [(True, -1)]
    t2 = threading.Thread(target=lambda: late.append(
        (w.done.wait(10), w.status)))
    t2.start()
    t2.join(10)
    assert late == [(True, -1)]


def test_done_asked_first_after_the_release_is_set():
    w = waiter()
    assert w.release(0) is False        # nobody asked: no Event to set
    assert w.done.is_set() and w.done.wait(0) and w.status == 0


def test_first_release_wins():
    w = waiter()
    calls = []
    w.attach(calls.append)
    w.release(-1)
    w.release(0)
    assert w.status == -1 and calls == [-1]
    late = []
    w.attach(late.append)               # attached after: fires at once
    assert late == [-1]


def test_attach_only_waiter_makes_no_event():
    w = waiter()
    calls = []
    w.attach(calls.append)
    assert w.release(0) is False
    assert calls == [0]
    assert w._event is None
    w2 = waiter()
    w2.release(0)
    w2.attach(calls.append)
    assert calls == [0, 0] and w2._event is None


def test_a_link_died_callback_is_swallowed():
    def dead(_status):
        raise OSError("link closed")
    w = waiter()
    w.attach(dead)
    w.release(0)                        # no raise
    w2 = waiter()
    w2.release(0)
    w2.attach(dead)                     # no raise


def test_a_waiter_is_one_tracked_object():
    """Creating 1000 waiters, and releasing them through their
    callbacks, adds at most 2 gc-tracked objects each."""
    calls = []
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        n0 = len(gc.get_objects())
        ws = [waiter(i) for i in range(1000)]
        n1 = len(gc.get_objects())
        for w in ws:
            w.attach(calls.append)
            w.release(0)
        n2 = len(gc.get_objects())
    finally:
        if was:
            gc.enable()
    assert n1 - n0 <= 2 * 1000 + 1, n1 - n0     # + the list itself
    assert n2 - n1 <= 1, n2 - n1
    assert calls == [0] * 1000


def test_driver_counts_released_waiters_by_path():
    """A step-locked ``ClusterDriver``: waiters seen through ``attach``
    count under ``callback``, those a thread asked ``done`` of under
    ``event``, in the commit release and in ``_fail_inflight_locked``."""
    d = ClusterDriver(LogConfig(**GEO), 3, timeout_cfg=TimeoutConfig(
        **TIMERS), pipeline=0, device="cpu")
    try:
        d.runtimes[0].timer._deadline = 0.0
        d.step()
        d.step()
        assert d.leader() == 0
        handler = d._make_handler(0)
        conn = (0 << 24) | 21
        calls = []
        handler(CONNECT, conn, b"").attach(calls.append)
        evs = [handler(SEND, conn, b"s%03d" % i) for i in range(10)]
        rt = d.runtimes[0]
        assert list(rt.inflight)[1:] == evs
        seqs = [ev.seq for ev in rt.inflight]
        assert seqs == sorted(seqs) and seqs[-1] == rt.submit_seq
        for i, ev in enumerate(evs):
            if i % 3 == 0:
                ev.done                          # a thread asks for done
            else:
                ev.attach(calls.append)
        for _ in range(20):
            if all(ev.done.is_set() for ev in evs[::3]) and len(calls) == 7:
                break
            d.step()
        assert calls == [0] * 7
        assert all(ev.done.is_set() and ev.status == 0 for ev in evs)
        get = d.obs.metrics.get
        assert get("commit_waiters_released_total", replica=0,
                   path="callback") == 7
        assert get("commit_waiters_released_total", replica=0,
                   path="event") == 4
        # the failure path counts its waiters alike
        doomed = [handler(SEND, conn, b"f%03d" % i) for i in range(3)]
        doomed[0].done
        for ev in doomed[1:]:
            ev.attach(calls.append)
        with d._lock:
            d._fail_inflight_locked(rt, "test")
        assert calls[7:] == [-1, -1] and doomed[0].status == -1
        assert get("commit_waiters_released_total", replica=0,
                   path="callback") == 9
        assert get("commit_waiters_released_total", replica=0,
                   path="event") == 5
        assert get("inflight_failed_total", replica=0) == 3
    finally:
        d.stop()
