"""Proxy: the RSM client + replay engine (reference ``src/proxy/proxy.c``).

Leader side: every socket event the interposition shim reports (CONNECT /
SEND / CLOSE) is tagged with a cluster-wide connection id
(``node_id << 8 | counter`` — proxy.c:101-106), queued for the driver to
batch into the consensus step, and the shim's blocking ack is released only
once the entry is committed + applied (the spin at proxy.c:160, here a
``PendingEvent``'s callback or its ``threading.Event``).

Follower side: committed events whose connection id originates at another
node are replayed into the local unmodified app over loopback TCP
(``do_action_connect/send/close``, proxy.c:373-439) — producing the
identical byte stream the leader's app consumed.

The shim ↔ driver wire protocol is defined in ``native/interpose.cpp``.
This is the port's copy of the JAX package's ``proxy/proxy.py``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import socket
import struct
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from rdma_paxos_tpu_torch.consensus.log import EntryType
from rdma_paxos_tpu_torch.obs import trace as obs_trace
from rdma_paxos_tpu_torch.obs.metrics import default_registry
from rdma_paxos_tpu_torch.obs.trace import default_ring

OP_HELLO, OP_CONNECT, OP_SEND, OP_CLOSE = 1, 2, 3, 4

# one-shot stderr warning latch for unverifiable quiesce barriers (the
# structured signal — quiesce_unknown trace event + counter — fires on
# every occurrence; the human-readable line only once per process)
_QUIESCE_UNKNOWN_WARNED = False


def spec_send_refused_dirty(etype: int, conn_id: int, replicated_conns,
                            proxy, app_dirty: bool) -> bool:
    """Shared intake-refusal quarantine policy (single source for BOTH
    runtimes — ClusterDriver and NodeDaemon — so they cannot drift).

    True iff refusing this event with -1 leaves a SPECULATIVE app
    diverged: the shim already delivered a SEND's bytes to the app
    (read() returns before the verdict), so a refused SEND on a
    replicated session means the app executed input that will never
    commit — the caller must set ``app_dirty`` before severing, exactly
    as failing in-flight events does."""
    return (etype == int(EntryType.SEND)
            and conn_id in replicated_conns
            and proxy is not None
            and proxy.spec_mode and not app_dirty)

_OP_TO_ETYPE = {
    OP_CONNECT: EntryType.CONNECT,
    OP_SEND: EntryType.SEND,
    OP_CLOSE: EntryType.CLOSE,
}


# One lock for every commit waiter: it orders a waiter's release against
# its callback's attach and the first ask for ``done``, whichever threads
# they come from, without a lock object per request.
_WAITER_LOCK = threading.Lock()


class PendingEvent:
    """One shim event awaiting commit (the blocked app thread's handle).

    Two completion surfaces: an optional ``on_done`` callback the
    ProxyServer attaches to send the seq-tagged wire response — the
    pipelined-shim contract, where the link thread never blocks on a
    commit — and ``done``, a threading.Event for in-process waiters.

    A waiter is one slotted object. ``done`` is made only when a thread
    first asks for it (already set if the release came first), so a
    waiter seen only through ``attach`` allocates nothing more. The first
    ``release`` wins; the callback runs exactly once, outside the lock,
    with the released status, however ``attach``, ``release`` and the
    first ``done`` interleave across threads."""

    __slots__ = ("etype", "conn_id", "payload", "status", "on_done", "t0",
                 "seq", "_released", "_event")
    etype: EntryType
    conn_id: int
    payload: bytes
    status: int
    on_done: Optional[Callable[[int], None]]
    # creation timestamp (perf_counter): release-site instrumentation
    # measures intake→commit-release as the client-visible commit
    # latency (obs commit_latency_seconds histogram)
    t0: float
    # the driver's submit sequence of the event's last fragment: the
    # ack release matches commits on it
    seq: int

    def __init__(self, etype: EntryType, conn_id: int, payload: bytes,
                 seq: int = 0):
        self.etype = etype
        self.conn_id = conn_id
        self.payload = payload
        self.status = 0
        self.on_done = None
        self.t0 = time.perf_counter()
        self.seq = seq
        self._released = False
        self._event: Optional[threading.Event] = None

    def __repr__(self) -> str:
        return "PendingEvent(%s, conn=%d, seq=%d, %s)" % (
            self.etype, self.conn_id, self.seq,
            "status=%d" % self.status if self._released else "pending")

    @property
    def done(self) -> threading.Event:
        ev = self._event
        if ev is None:
            with _WAITER_LOCK:
                ev = self._event
                if ev is None:
                    ev = self._event = threading.Event()
                    if self._released:
                        ev.set()
        return ev

    def release(self, status: int = 0) -> bool:
        """Complete the event with ``status`` (a later release is
        ignored). Returns True when a thread had asked for ``done``, so
        the release set an Event; False when only the callback sees it."""
        with _WAITER_LOCK:
            if self._released:
                return False
            self.status = status
            self._released = True
            cb, self.on_done = self.on_done, None
            ev = self._event
        if ev is not None:
            ev.set()
        if cb is not None:
            _call(cb, status)
        return ev is not None

    def attach(self, cb: Callable[[int], None]) -> None:
        """Attach the wire-response callback (fires immediately if the
        event already completed — release/attach may race)."""
        with _WAITER_LOCK:
            if not self._released:
                self.on_done = cb
                return
        _call(cb, self.status)


def _call(cb: Callable[[int], None], status: int) -> None:
    try:
        cb(status)
    except OSError:
        pass                         # link died: the shim fell back


class ProxyServer:
    """Unix-socket server the interposed app connects to.

    One thread per app link. The link thread only READS: each event is
    handed to the driver-provided ``on_event`` callback, and the
    seq-tagged response is written either immediately (pass-through /
    sever verdicts) or from whatever thread releases the PendingEvent
    once the entry commits — so many app threads can have events in
    flight concurrently (the reference's tailq-insert-then-spin split,
    ``proxy.c:114-160``). Per-fd event order is preserved end-to-end:
    the shim serializes writes under its send mutex and this server
    reads them in order into the driver's submit queue.
    """

    def __init__(self, sock_path: str, node_id: int,
                 on_event: Callable[[int, int, bytes],
                                    Optional[PendingEvent]],
                 conn_ctr_start: int = 0, obs=None):
        self.sock_path = sock_path
        # Observability facade (rdma_paxos_tpu_torch.obs) — link threads
        # count wire events per op so replication throughput and shim
        # pressure export with every snapshot
        self.obs = obs
        # conn ids pack the origin into bits 24+ of an int32 log column
        # (M_CONN): an id >= 128 would flip the sign bit and break the
        # origin test ((conn >> 24) == host_id) everywhere downstream —
        # fail loudly here rather than hang that host's clients. Elastic
        # host ids grow monotonically, so long-lived deployments must
        # recycle ids below 128 (the reference packs node_id<<8 into an
        # int with the same kind of bound, proxy.c:101-106).
        if not 0 <= node_id < 128:
            raise ValueError(
                f"node_id {node_id} does not fit the conn-id origin "
                "field (int32 M_CONN allows 0..127)")
        self.node_id = node_id
        self.on_event = on_event
        # declared by the shim's HELLO (bit0 of its payload byte): the
        # app executes SPECULATIVELY on not-yet-committed input, holding
        # replies until commit (output commit). The driver needs this to
        # know that failing an inflight event (deposition) leaves the
        # app DIRTY — it consumed input that may never commit — and must
        # be quarantined until rebuilt from the committed store.
        self.spec_mode = False
        # namespaced start (elastic generations) so a restarted host's
        # fresh connection ids avoid ids its previous incarnation stamped
        # into carried-over log entries. The namespace is bounded (16
        # generations x 2^20 connections before wrap), so collisions are
        # rare, not impossible — the ReplayEngine treats a repeated
        # CONNECT for a known id as a stream RESET, which keeps a wrap
        # benign (M_GEN protects the ack path independently).
        self._conn_ctr = conn_ctr_start & 0xFFFFFF
        self.conn_of_fd: Dict[Tuple[int, int], int] = {}  # (link, fd) -> id
        if os.path.exists(sock_path):
            os.unlink(sock_path)
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(sock_path)
        self._srv.listen(8)
        self._links: List[socket.socket] = []
        self._link_ctr = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    def next_conn_id(self) -> int:
        self._conn_ctr = (self._conn_ctr + 1) & 0xFFFFFF
        return (self.node_id << 24) | self._conn_ctr

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                link, _ = self._srv.accept()
            except OSError:
                return
            self._links.append(link)
            lid = self._link_ctr
            self._link_ctr += 1
            threading.Thread(target=self._serve_link, args=(link, lid),
                             daemon=True).start()

    def _recv_exact(self, sock: socket.socket, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _serve_link(self, link: socket.socket, lid: int) -> None:
        wlock = threading.Lock()     # responses come from many threads

        def respond(seq: int, status: int) -> None:
            with wlock:
                link.sendall(struct.pack("<Ii", seq, status))

        try:
            while not self._stop.is_set():
                hdr = self._recv_exact(link, 13)
                if hdr is None:
                    return
                op, seq, fd, ln = struct.unpack("<BIiI", hdr)
                payload = self._recv_exact(link, ln) if ln else b""
                if payload is None:
                    return
                if self.obs is not None:
                    self.obs.metrics.inc("proxy_wire_events_total",
                                         replica=self.node_id, op=op)
                if op not in _OP_TO_ETYPE:       # HELLO / unknown
                    if op == OP_HELLO and payload:
                        self.spec_mode = bool(payload[0] & 1)
                    respond(seq, 0)
                    continue
                if op == OP_CONNECT:
                    self.conn_of_fd[(lid, fd)] = self.next_conn_id()
                conn_id = self.conn_of_fd.get((lid, fd), 0)
                if op == OP_CLOSE:
                    self.conn_of_fd.pop((lid, fd), None)
                # handler returns: None => pass through (0);
                # int => immediate status (<0 severs the connection);
                # PendingEvent => respond when committed (the link
                # thread moves on to the next event immediately)
                ev = self.on_event(int(_OP_TO_ETYPE[op]), conn_id,
                                   payload)
                if isinstance(ev, PendingEvent):
                    ev.attach(functools.partial(respond, seq))
                elif isinstance(ev, int):
                    respond(seq, ev)
                else:
                    respond(seq, 0)
        except OSError:
            pass
        finally:
            try:
                link.close()
            except OSError:
                pass

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        for l in self._links:
            try:
                l.close()
            except OSError:
                pass
        if os.path.exists(self.sock_path):
            os.unlink(self.sock_path)


def replay_store_into(store, replay: "ReplayEngine",
                      start: int = 0) -> None:
    """Replay the stable store's event history from record ``start``
    into the local app (``proxy_apply_db_snapshot`` analog,
    ``proxy.c:306-339``) — the single decoder of the store record layout
    (1-byte etype + 4-byte little-endian conn id + payload). ``start=0``
    rebuilds a FRESH app; a nonzero ``start`` delivers only the delta to
    a LIVE app that already executed the prefix (store streams are
    prefix-consistent: every store is a prefix of the committed event
    order)."""
    if replay is None:
        return
    base = getattr(store, "base", 0)
    if start < base:
        # records below base were compacted away; their effects must
        # already be covered by a restored app-state checkpoint
        start = base
    for i in range(start, len(store)):
        rec = store.read(i)
        replay.apply(rec[0], int.from_bytes(rec[1:5], "little"), rec[5:])
    replay.drain_responses()


class ReplayEngine:
    """Replays committed remote-origin events into the local app over
    loopback TCP (the follower half of the reference proxy)."""

    def __init__(self, app_host: str, app_port: int):
        self.addr = (app_host, app_port)
        self.conns: Dict[int, socket.socket] = {}
        # replayed CLOSEs: half-closed sockets kept open until the app
        # has read every replayed byte and closed its end. Closing at
        # once would reset the connection whenever an app response is
        # still unread here, and the reset discards the replayed input
        # the app has not read yet (a store replay delivers a whole
        # session's CONNECT, SENDs and CLOSE back to back). The wait is
        # bounded: past HALF_CLOSE_GRACE seconds a socket is released
        # once the kernel queues show the app read every replayed byte
        # (an app that ignores EOF never closes its end).
        self.closing: List[socket.socket] = []
        self._closed_at: Dict[socket.socket, float] = {}
        # local (ephemeral) ports of our replay sockets: the driver uses
        # these to recognize its own replayed connections arriving back
        # through the app's interposition shim
        self.local_ports: set = set()

    def _connect(self, conn_id: int) -> socket.socket:
        # a CONNECT for an id we already track means the id wrapped
        # around (bounded namespaces); the new stream replaces the old
        # one — reset rather than interleave bytes into a stale socket
        old = self.conns.pop(conn_id, None)
        if old is not None:
            try:
                self.local_ports.discard(old.getsockname()[1])
                old.close()
            except OSError:
                pass
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        # bind first so the local port is REGISTERED before the app can
        # possibly observe the connection: a hot-polling app accepts and
        # reports CONNECT to the driver concurrently with (even before)
        # our connect() returning, and the driver must never misclassify
        # our own replay connection as a client session
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        self.local_ports.add(port)
        try:
            s.connect(self.addr)
        except OSError:
            self.local_ports.discard(port)
            s.close()
            raise
        self.conns[conn_id] = s
        return s

    def apply(self, etype: int, conn_id: int, payload: bytes) -> None:
        if etype == int(EntryType.CONNECT):
            self._connect(conn_id)
        elif etype == int(EntryType.SEND):
            s = self.conns.get(conn_id)
            if s is None:       # joined mid-stream: open lazily
                s = self._connect(conn_id)
            s.sendall(payload)
        elif etype == int(EntryType.CLOSE):
            s = self.conns.pop(conn_id, None)
            if s is not None:
                try:
                    s.shutdown(socket.SHUT_WR)
                    self.closing.append(s)
                    self._closed_at[s] = time.monotonic()
                except OSError:
                    self._release(s)

    @contextlib.contextmanager
    def raw_conn(self):
        """Context manager: a passthrough-registered connection to the
        local app for OUT-OF-BAND operations (app checkpoint dump /
        restore). Bound before connecting so the driver always
        classifies it as our own (never replicates its traffic); the
        port registration is dropped on exit so a later real client
        reusing the ephemeral port cannot be misclassified."""
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        self.local_ports.add(port)
        try:
            s.connect(self.addr)
            yield s
        finally:
            self.local_ports.discard(port)
            try:
                s.close()
            except OSError:
                pass

    def barrier(self, probe_fn, timeout: float = 10.0) -> None:
        """PROCESSED-INPUT barrier: replay input is delivered over
        per-connection sockets asynchronously, so a single-threaded
        event-loop app may service a later out-of-band connection (e.g.
        a checkpoint dump) before draining replay bytes still buffered
        on other connections. ``probe_fn(sock)`` must issue a
        request/response roundtrip on ``sock`` and return only once it
        has observed the response to ITS OWN request (discarding any
        buffered responses to earlier replayed commands). A reply on a
        connection proves the app consumed every byte written to that
        connection before the probe (TCP ordering + in-order reads), so
        probing every replay connection proves all delivered records
        were consumed."""
        for s in list(self.conns.values()):
            s.settimeout(timeout)
            try:
                probe_fn(s)
            finally:
                s.settimeout(None)
        # a half-closed replayed session cannot be probed: the app's
        # own close of it, or (past the grace) kernel queues that show
        # every replayed byte read, proves it consumed them
        deadline = time.monotonic() + timeout
        self.drain_responses()
        while self.closing:
            if time.monotonic() >= deadline:
                raise TimeoutError("the app did not finish %d replayed "
                                   "sessions" % len(self.closing))
            time.sleep(0.002)
            self.drain_responses()

    # both address families: a dual-stack or v6-bound app's loopback
    # sockets appear in tcp6 (with v4-mapped peers), invisible to the
    # IPv4 table — scanning only /proc/net/tcp silently weakened the
    # barrier there (ADVICE.md #2)
    _PROC_TCP_PATHS = ("/proc/net/tcp", "/proc/net/tcp6")

    # seconds a half-closed replayed session waits for the app's own
    # close before the kernel-queue check may release it
    HALF_CLOSE_GRACE = 0.25

    @staticmethod
    def _send_queue(s: socket.socket) -> Optional[int]:
        """Our unsent bytes on ``s`` (TIOCOUTQ); None when unknowable."""
        import fcntl
        import termios
        try:
            return struct.unpack("i", fcntl.ioctl(
                s.fileno(), termios.TIOCOUTQ, b"\x00" * 4))[0]
        except OSError:
            return None

    def _peer_rx_queues(self, ports) -> Optional[Dict[int, int]]:
        """The app-side receive queue of the peer of each of our replay
        ``ports`` that has a row in /proc/net/tcp{,6} (local port == the
        app's, remote == ours; rx_queue is hex field 4 after the colon,
        the same layout in both tables); None when no table is
        readable."""
        app_port = self.addr[1]
        readable = 0
        rx: Dict[int, int] = {}
        for proc in self._PROC_TCP_PATHS:
            try:
                with open(proc) as f:
                    lines = f.readlines()[1:]
            except OSError:
                continue         # this table unreadable
            readable += 1
            for ln in lines:
                try:
                    parts = ln.split()
                    lport = int(parts[1].split(":")[1], 16)
                    rport = int(parts[2].split(":")[1], 16)
                    if lport == app_port and rport in ports:
                        rx[rport] = max(rx.get(rport, 0),
                                        int(parts[4].split(":")[1], 16))
                except (IndexError, ValueError):
                    continue     # garbled row: not a verification
        return rx if readable else None

    def _consumed(self, socks) -> set:
        """The half-closed ``socks`` whose replayed bytes the app has
        read: our send queue and the app's receive queue both verified
        empty (an unknowable queue is not empty)."""
        ports = {}
        for s in socks:
            try:
                if self._send_queue(s) == 0:
                    ports[s.getsockname()[1]] = s
            except OSError:
                pass
        rx = self._peer_rx_queues(ports) if ports else None
        return {ports[p] for p, q in (rx or {}).items() if q == 0}

    def _quiesce_unknown(self, reason: str) -> None:
        """The kernel-queue barrier could not be VERIFIED (unreadable
        /proc tables, failed ioctl with no compensating peer check):
        record it as unknown — never as quiescent. Logged once per
        process (stderr); traced/counted on every occurrence."""
        default_ring().record(obs_trace.QUIESCE_UNKNOWN, reason=reason)
        default_registry().inc("quiesce_unknown_total")
        global _QUIESCE_UNKNOWN_WARNED
        if not _QUIESCE_UNKNOWN_WARNED:
            _QUIESCE_UNKNOWN_WARNED = True
            print("ReplayEngine.quiesce: cannot verify kernel queues "
                  f"({reason}); treating as NOT quiescent — supply an "
                  "app_snapshot probe_fn for an exact barrier",
                  file=sys.stderr, flush=True)

    def quiesce(self, timeout: float = 5.0,
                settle_rounds: int = 3) -> bool:
        """Best-effort app-agnostic barrier (used when no probe hook is
        configured): wait until every replay connection's bytes have
        left BOTH kernel queues — our unsent send queue (TIOCOUTQ) and
        the app-side receive queue (via /proc/net/tcp{,6} rx_queue for
        the loopback peer socket) — over ``settle_rounds`` consecutive
        samples. NARROWS but does NOT close the race: bytes the app has
        read() into userspace buffers (or lines applied one at a time
        between lock releases) are invisible to kernel queues, so a
        checkpoint can still observe partially-applied input. Apps that
        can express a request/response no-op should supply the
        app_snapshot probe_fn, which is exact.

        Unverifiable is UNKNOWN, never 'empty' (the old behavior
        silently counted both a failed TIOCOUTQ ioctl and an unreadable
        /proc/net/tcp as empty, degrading the barrier to nothing on
        IPv6 loopback / non-Linux / sandboxed kernels — ADVICE.md #2):

        * no readable /proc/net/tcp{,6} table → return False (the
          app-side rx queue is unknowable);
        * TIOCOUTQ unsupported (e.g. sandboxed kernels) → degrade to
          requiring the peer-rx check to VERIFY every replay port (a
          matching row with rx_queue 0 in a readable table); if any
          port cannot be matched, return False.

        Both degradations log once per process and emit a
        ``quiesce_unknown`` trace event + counter so the weakened
        barrier is visible, and a returned False makes the caller
        abort the checkpoint instead of compacting records the
        checkpoint may not cover."""
        import time as _time
        deadline = _time.monotonic() + timeout
        quiet = 0
        while True:
            # half-closed replayed sessions are consumed once the app
            # closes its end or, past the grace, reads every byte
            # (drain_responses releases them then)
            self.drain_responses()
            busy = bool(self.closing)
            sendq_verified = True
            ports = {}
            n_conns = 0
            for s in ([] if busy else list(self.conns.values())):
                n_conns += 1
                out = self._send_queue(s)
                if out is None:
                    # unknown, NOT empty: fall through to the peer-rx
                    # check, which must then verify this socket
                    sendq_verified = False
                    out = 0
                if out:
                    busy = True
                    break
                try:
                    ports[s.getsockname()[1]] = True
                except OSError:
                    pass
            if not busy and n_conns:
                rx = self._peer_rx_queues(ports)
                if rx is None:
                    self._quiesce_unknown(
                        "no readable /proc/net/tcp{,6}")
                    return False
                busy = any(rx.values())
                if (not busy and not sendq_verified
                        and (len(rx) < n_conns or len(ports) < n_conns)):
                    # the send queue was unverifiable AND at least one
                    # replay socket has no visible peer row: nothing
                    # proves its bytes were consumed
                    self._quiesce_unknown(
                        "TIOCOUTQ unsupported and peer rows missing "
                        f"({len(rx)}/{n_conns} verified)")
                    return False
            if not busy:
                quiet += 1
                if quiet >= settle_rounds:
                    return True
            else:
                quiet = 0
            if _time.monotonic() >= deadline:
                return False
            _time.sleep(0.002)

    def _release(self, s: socket.socket) -> None:
        self._closed_at.pop(s, None)
        try:
            self.local_ports.discard(s.getsockname()[1])
        except OSError:
            pass
        try:
            s.close()
        except OSError:
            pass

    def drain_responses(self) -> None:
        """The local app writes responses to replayed connections; nobody
        reads them (the reference's follower likewise discards app output
        — only the leader's app talks to real clients). Drain so the app
        never blocks on a full socket buffer, and release each
        half-closed connection once the app has closed its end, or once
        it has been half-closed for ``HALF_CLOSE_GRACE`` seconds and the
        kernel queues show the app read every replayed byte (our receive
        side is drained first, so the close resets nothing unread)."""
        for s in self.conns.values():
            s.setblocking(False)
            try:
                while s.recv(65536):
                    pass
            except (BlockingIOError, OSError):
                pass
            finally:
                s.setblocking(True)
        still = []
        for s in self.closing:
            s.setblocking(False)
            try:
                while s.recv(65536):
                    pass
                self._release(s)              # EOF: the app closed
            except BlockingIOError:
                s.setblocking(True)
                still.append(s)
            except OSError:
                self._release(s)
        now = time.monotonic()
        due = [s for s in still
               if now - self._closed_at.get(s, now) >= self.HALF_CLOSE_GRACE]
        if due:
            done = self._consumed(due)
            for s in done:
                self._release(s)
            still = [s for s in still if s not in done]
        self.closing = still

    def close(self) -> None:
        for s in list(self.conns.values()) + self.closing:
            try:
                s.close()
            except OSError:
                pass
        self.conns.clear()
        self.closing = []
        self._closed_at.clear()
