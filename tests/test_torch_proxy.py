"""Port parity of the front door's host modules: the stable store and
hard state over the shared ``native/libstablestore.so`` write the same
files as the JAX package's, and ``fragment``, ``config_payload`` and the
election timer equal their originals; the proxy's shim wire protocol and
the loopback replay engine work end to end on their own."""

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import rdma_paxos_tpu.consensus.membership as jmem
import rdma_paxos_tpu.proxy.stablestore as jss
import rdma_paxos_tpu.runtime.hostpath as jhp
import rdma_paxos_tpu.runtime.timers as jtimers
import rdma_paxos_tpu.utils.codec as jcodec
from rdma_paxos_tpu.config import LogConfig as JCfg, TimeoutConfig as JTO
from rdma_paxos_tpu.runtime.sim import SimCluster as JSim
import rdma_paxos_tpu_torch.consensus.membership as tmem
import rdma_paxos_tpu_torch.proxy.stablestore as tss
import rdma_paxos_tpu_torch.runtime.timers as ttimers
import rdma_paxos_tpu_torch.utils.codec as tcodec
from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
from rdma_paxos_tpu_torch.consensus.log import EntryType
from rdma_paxos_tpu_torch.proxy.proxy import (
    OP_CONNECT, OP_HELLO, OP_SEND, PendingEvent, ProxyServer, ReplayEngine,
    replay_store_into)
from rdma_paxos_tpu_torch.runtime.sim import SimCluster

torch.set_num_threads(1)


def framed(seed: int, n: int) -> bytes:
    """A store-ready framed blob of ``n`` seeded client entries."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 30, n).astype(np.int64)
    blob = bytes(rng.integers(0, 256, int(lens.sum()), dtype=np.uint8))
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return jhp.frames_from_cols(rng.integers(2, 5, n), rng.integers(
        0, 1 << 26, n), lens, blob, offs)


def test_stable_store_files_match_jax(tmp_path):
    stores = {}
    for name, mod in (("j", jss), ("t", tss)):
        s = mod.StableStore(str(tmp_path / f"{name}.db"))
        s.append(b"\x02" + (7).to_bytes(4, "little"))
        assert s.append_framed(framed(1, 50)) == 50
        s.append(b"\x03" + (7).to_bytes(4, "little") + b"SET k v\n")
        s.compact(10)
        s.append_framed(framed(2, 20))
        s.sync()
        stores[name] = s
    j, t = stores["j"], stores["t"]
    assert (len(t), t.base) == (len(j), j.base) == (72, 10)
    assert [t.read(i) for i in range(10, 72)] == [
        j.read(i) for i in range(10, 72)]
    assert t.dump() == j.dump()
    assert (tmp_path / "t.db").read_bytes() == (tmp_path / "j.db").read_bytes()
    # a dump loads into a fresh store of the other package, and trimmed
    # dumps of a recovery point agree
    fresh = tss.StableStore(str(tmp_path / "fresh.db"))
    fresh.load(j.dump())
    assert fresh.dump() == t.dump() and fresh.base == 10
    fresh.reset()
    assert len(fresh) == 0
    for s in (j, t, fresh):
        s.close()
    assert tss.trimmed_dump(str(tmp_path / "t.db"), 40) == \
        jss.trimmed_dump(str(tmp_path / "j.db"), 40)


def test_hard_state_files_match_jax(tmp_path):
    j = jss.HardState(str(tmp_path / "j.hs"))
    t = tss.HardState(str(tmp_path / "t.hs"))
    assert t.load() is None
    for tup in ((1, 0, -1), (1, 1, 2), (1, 1, 2), (7, 7, 0)):
        j.save(*tup)
        t.save(*tup)
        assert t.load() == j.load() == tup
        assert (tmp_path / "t.hs").read_bytes() == \
            (tmp_path / "j.hs").read_bytes()


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 200])
@pytest.mark.parametrize("slot_bytes", [64, 128])
def test_fragment_matches_jax(n, slot_bytes):
    payload = bytes(range(256))[:n] * (1 + n // 256)
    payload = payload[:n]
    assert tcodec.fragment(payload, slot_bytes) == jcodec.fragment(
        payload, slot_bytes)


@pytest.mark.parametrize("words", [(7, 7, 0, 1), (7, 0b1111, 1, 2),
                                   (0, (1 << 31) - 1, 2, 9)])
def test_config_payload_matches_jax(words):
    assert tmem.config_payload(*words) == jmem.config_payload(*words)


@pytest.mark.parametrize("words", [(7, 7, -1 << 32, 1), (7, 7, 0, 1 << 31),
                                   (7, 1 << 32, 0, 1)])
def test_config_payload_refuses_out_of_range_words(words):
    """Only the masks travel as u32 bit patterns: a too wide mask, or a
    cid_state/epoch outside i32, raises as in the JAX original instead
    of wrapping into a wrong CONFIG entry."""
    with pytest.raises(OverflowError):
        jmem.config_payload(*words)
    with pytest.raises(OverflowError):
        tmem.config_payload(*words)


def test_bit31_mask_round_trips_through_both_engines():
    """A member mask with bit 31 set, packed as its u32 bit pattern,
    comes back as the same unsigned mask from both engines' state."""
    geo = dict(n_slots=64, slot_bytes=32, window_slots=16, batch_slots=8)
    mask = 0b111 | (1 << 31)
    payload = tmem.config_payload(0b111, mask, 0, 1)
    j, t = JSim(JCfg(**geo), 3), SimCluster(LogConfig(**geo), 3,
                                            device="cpu")
    for c in (j, t):
        c.run_until_elected(0)
        c.submit(0, payload, EntryType.CONFIG)
        c.step()
        c.step()
    for r in range(3):
        want = jmem.MembershipManager(j).current(r)
        assert tmem.MembershipManager(t).current(r) == want
        assert want["bitmask_new"] == mask and want["epoch"] == 1


def test_election_timer_matches_jax():
    now = [100.0]
    cfg = dict(elec_timeout_low=0.1, elec_timeout_high=0.3)
    j = jtimers.ElectionTimer(JTO(**cfg), seed=5, clock=lambda: now[0])
    t = ttimers.ElectionTimer(TimeoutConfig(**cfg), seed=5,
                              clock=lambda: now[0])
    for i in range(50):
        assert t._deadline == j._deadline
        assert (t.expired(), t.remaining()) == (j.expired(), j.remaining())
        now[0] += 0.07
        if i % 7 == 0:
            t.false_positive()
            j.false_positive()
        elif i % 3 == 0:
            t.beat()
            j.beat()
    assert (t.low, t.high) == (j.low, j.high)


def _wire(sock, op, seq, fd, payload=b""):
    sock.sendall(struct.pack("<BIiI", op, seq, fd, len(payload)) + payload)


def _status(f):
    return struct.unpack("<Ii", f.read(8))


def test_proxy_server_speaks_the_shim_wire_protocol(tmp_path):
    """HELLO, CONNECT and SEND over the UDS link: a pass-through answers
    at once, a parked event answers when released, in any order."""
    seen, parked = [], []

    def on_event(etype, conn, payload):
        seen.append((etype, conn, payload))
        if etype == int(EntryType.SEND):
            ev = PendingEvent(EntryType(etype), conn, payload)
            parked.append(ev)
            return ev
        return None
    srv = ProxyServer(str(tmp_path / "p.sock"), 2, on_event)
    try:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(str(tmp_path / "p.sock"))
        f = s.makefile("rb")
        _wire(s, OP_HELLO, 1, 0, b"\x01")
        assert _status(f) == (1, 0)
        assert srv.spec_mode
        _wire(s, OP_CONNECT, 2, 9)
        assert _status(f) == (2, 0)
        _wire(s, OP_SEND, 3, 9, b"SET k v\n")
        _wire(s, OP_SEND, 4, 9, b"GET k\n")
        while len(parked) < 2:
            threading.Event().wait(0.01)
        parked[1].release(-1)
        assert _status(f) == (4, -1)
        parked[0].release(0)
        assert _status(f) == (3, 0)
        conn = (2 << 24) | 1
        assert seen == [(2, conn, b""), (3, conn, b"SET k v\n"),
                        (3, conn, b"GET k\n")]
        s.close()
    finally:
        srv.close()


def test_replay_engine_writes_the_committed_stream(tmp_path):
    """CONNECT/SEND/CLOSE replay over loopback, from a store's records."""
    lsn = socket.socket()
    lsn.bind(("127.0.0.1", 0))
    lsn.listen(4)
    port = lsn.getsockname()[1]
    store = tss.StableStore(str(tmp_path / "r.db"))
    conn = (1 << 24) | 5
    for etype, payload in ((2, b""), (3, b"SET a 1\n"), (3, b"SET b 2\n"),
                           (4, b"")):
        store.append(bytes([etype]) + conn.to_bytes(4, "little") + payload)
    eng = ReplayEngine("127.0.0.1", port)
    replay_store_into(store, eng)
    peer, addr = lsn.accept()
    # the CLOSE half-closes: the replay port stays ours until the app
    # has read every replayed byte and closed its end
    assert addr[1] in eng.local_ports and len(eng.closing) == 1
    peer.sendall(b"+OK\n+OK\n")               # responses left unread
    got = b""
    while True:
        chunk = peer.recv(64)
        if not chunk:
            break
        got += chunk
    assert got == b"SET a 1\nSET b 2\n"
    peer.close()
    deadline = time.time() + 10
    while eng.closing and time.time() < deadline:
        eng.drain_responses()
    assert not eng.closing and addr[1] not in eng.local_ports
    lsn.close()
    eng.close()
    store.close()
