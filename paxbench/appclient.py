"""The app runner's clients, in a process of their own: ``clients`` TCP
connections to the leader's app, each a closed loop with
``outstanding`` requests in flight, served by one ``selectors`` loop.

The process imports the standard library and NumPy only (no torch, no
JAX, nothing of the program), so the driver's process keeps its
interpreter lock to itself, as it does beside redis-benchmark. It
shares one file with the harness (``Shared``): the harness writes the
command and the replica that leads into its header; the clients write,
per request, the pool index, the connection, the send and answer
stamps and the answer, and per connection its client.
Both stamps are ``time.perf_counter()``, ``CLOCK_MONOTONIC`` on Linux,
the harness's clock too.

The clients connect once the header names a leader. A request counts
as acked when its ``+OK`` line arrives; the answers on
a connection are matched to its requests in order. A connection the
app severs fails its requests in flight, and its client reconnects to
the replica that leads now (a follower's app would serve it locally,
unreplicated), as the header names it.

Run by the harness: ``python3 -m paxbench.appclient --shared FILE --cap
N --pool FILE --ports P0,P1,P2 --clients C --outstanding K``."""

from __future__ import annotations

import argparse
import collections
import heapq
import selectors
import socket
import sys
import time
from typing import Deque, List, Optional, Sequence

import numpy as np

# header words (int64) of the shared file
CMD, LEADER, STATE, N_ROWS, N_ANSWERED, RECONNECTS, EXTRA_REPLIES, \
    OVERFLOW, N_CONNS = range(9)
HEADER_WORDS = 16
# commands (the harness's) and states (the clients')
WAIT, GO, STOP, EXIT = 0, 1, 2, 3
CONNECTED, FAILED = 1, -1
# a request's answer (0: none yet)
OK, BAD, SEVERED = 1, 2, 3
MAX_CONNS = 4096
RETRY_S = 0.005          # a client waits this long before trying again
AVOID_S = 1.0            # and this long before it goes back to a replica
                         # that severed it (an election takes 0.1-0.3 s)
CONNECT_TIMEOUT_S = 5.0


class Shared:
    """The file both processes map: the header, then per request row
    ``t_send``, ``t_ack`` (f8), ``pidx``, ``conn`` (i4) and ``answer``
    (i1), and per connection its client, ``conn_client`` (i4). Rows
    are written in send order."""

    def __init__(self, path: str, cap: int, create: bool = False):
        self.path, self.cap = path, int(cap)
        layout = (("hdr", np.int64, HEADER_WORDS),
                  ("t_send", np.float64, self.cap),
                  ("t_ack", np.float64, self.cap),
                  ("pidx", np.int32, self.cap),
                  ("conn", np.int32, self.cap),
                  ("conn_client", np.int32, MAX_CONNS),
                  ("answer", np.int8, self.cap))
        size = sum(np.dtype(t).itemsize * n for _, t, n in layout)
        self._mm = np.memmap(path, np.uint8, "w+" if create else "r+",
                             shape=(size,))
        off = 0
        for name, t, n in layout:
            nb = np.dtype(t).itemsize * n
            setattr(self, name, self._mm[off:off + nb].view(t))
            off += nb

    def flush(self) -> None:
        self._mm.flush()


def write_pool(path: str, payloads: Sequence[bytes]) -> None:
    """The pool the clients send from: the payloads back to back, then
    their offsets in ``<path>.offs`` (i8)."""
    lens = np.fromiter((len(p) for p in payloads), np.int64, len(payloads))
    offs = np.zeros(len(payloads) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    with open(path, "wb") as f:
        f.write(b"".join(payloads))
    offs.tofile(path + ".offs")


def read_pool(path: str) -> List[bytes]:
    with open(path, "rb") as f:
        blob = f.read()
    o = np.fromfile(path + ".offs", np.int64).tolist()
    return [blob[o[i]:o[i + 1]] for i in range(len(o) - 1)]


class Clients:
    def __init__(self, sh: Shared, payloads: Sequence[bytes],
                 ports: Sequence[int], n_clients: int, outstanding: int):
        self.sh, self.payloads, self.ports = sh, payloads, list(ports)
        self.P = len(payloads)
        self.n, self.outstanding = int(n_clients), int(outstanding)
        self.sel = selectors.DefaultSelector()
        self.sock: List[Optional[socket.socket]] = [None] * self.n
        self.conn_of = [-1] * self.n
        self.replica_of = [-1] * self.n    # the replica c is connected to
        self.severed_at = [-AVOID_S] * self.n
        self.inflight: List[Deque[int]] = [collections.deque()
                                           for _ in range(self.n)]
        self.buf = [b""] * self.n
        self.retry: List = []
        self.n_rows = self.n_req = self.n_conns = self.answered = 0
        self.go = False

    def connect(self, c: int) -> bool:
        """A new connection for client ``c`` at the replica that leads;
        for ``AVOID_S`` not at the one that severed its last connection,
        which no longer leads whatever the header still says."""
        sh = self.sh
        lead = int(sh.hdr[LEADER])
        if (lead < 0 or self.n_conns >= MAX_CONNS
                or (lead == self.replica_of[c] and time.perf_counter()
                    - self.severed_at[c] < AVOID_S)):
            sh.hdr[OVERFLOW] |= int(self.n_conns >= MAX_CONNS)
            return False
        try:
            s = socket.create_connection(("127.0.0.1", self.ports[lead]),
                                         timeout=CONNECT_TIMEOUT_S)
        except OSError:
            return False
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        k = self.n_conns
        sh.conn_client[k] = c
        self.n_conns = k + 1
        sh.hdr[N_CONNS] = self.n_conns
        if self.conn_of[c] >= 0:
            sh.hdr[RECONNECTS] += 1
        self.sock[c], self.conn_of[c], self.buf[c] = s, k, b""
        self.replica_of[c] = lead
        self.sel.register(s, selectors.EVENT_READ, c)
        return True

    def send(self, c: int) -> None:
        sh, k = self.sh, self.n_rows
        if k >= sh.cap:
            sh.hdr[OVERFLOW] = 1
            return
        p = self.n_req % self.P
        self.n_req += 1
        sh.pidx[k], sh.conn[k] = p, self.conn_of[c]
        sh.t_send[k] = time.perf_counter()
        self.n_rows = k + 1
        sh.hdr[N_ROWS] = self.n_rows
        self.inflight[c].append(k)
        try:
            self.sock[c].sendall(self.payloads[p])
        except OSError:
            self.sever(c)

    def sever(self, c: int) -> None:
        """The app closed or reset client ``c``'s connection: its
        requests in flight fail; it reconnects while the loop runs."""
        s = self.sock[c]
        if s is None:
            return
        self.sel.unregister(s)
        s.close()
        self.sock[c] = None
        self.severed_at[c] = time.perf_counter()
        for k in self.inflight[c]:
            self.sh.answer[k] = SEVERED
        self.answered += len(self.inflight[c])
        self.sh.hdr[N_ANSWERED] = self.answered
        self.inflight[c].clear()
        if self.go:
            heapq.heappush(self.retry, (time.perf_counter(), c))

    def on_read(self, c: int) -> None:
        try:
            data = self.sock[c].recv(65536)
        except OSError:
            data = b""
        if not data:
            self.sever(c)
            return
        now = time.perf_counter()
        sh, q = self.sh, self.inflight[c]
        *lines, self.buf[c] = (self.buf[c] + data).split(b"\n")
        for line in lines:
            if not q:
                sh.hdr[EXTRA_REPLIES] += 1
                continue
            k = q.popleft()
            sh.t_ack[k] = now
            sh.answer[k] = OK if line == b"+OK" else BAD
            self.answered += 1
            if self.go:
                self.send(c)
        sh.hdr[N_ANSWERED] = self.answered

    def start(self) -> None:
        self.go = True
        for c in range(self.n):
            for _ in range(self.outstanding):
                self.send(c)

    def retry_due(self) -> None:
        now = time.perf_counter()
        while self.retry and self.retry[0][0] <= now:
            _, c = heapq.heappop(self.retry)
            if not self.go:
                continue
            if self.connect(c):
                for _ in range(self.outstanding):
                    self.send(c)
            else:
                heapq.heappush(self.retry, (now + RETRY_S, c))

    def serve(self) -> None:
        """Until the harness says ``EXIT``: answers, next requests,
        reconnects; after ``STOP`` nothing new is sent."""
        sh = self.sh
        while True:
            cmd = int(sh.hdr[CMD])
            if cmd == EXIT:
                return
            self.go = cmd == GO
            wait = 0.01
            if self.retry:
                wait = max(0.0, min(wait, self.retry[0][0]
                                    - time.perf_counter()))
            for key, _ in self.sel.select(wait):
                self.on_read(key.data)
            self.retry_due()

    def close(self) -> None:
        for s in self.sock:
            if s is not None:
                s.close()
        self.sel.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="paxbench.appclient")
    p.add_argument("--shared", required=True)
    p.add_argument("--cap", type=int, required=True)
    p.add_argument("--pool", required=True)
    p.add_argument("--ports", required=True)
    p.add_argument("--clients", type=int, required=True)
    p.add_argument("--outstanding", type=int, required=True)
    a = p.parse_args(argv)
    sh = Shared(a.shared, a.cap)
    cl = Clients(sh, read_pool(a.pool), [int(x) for x in a.ports.split(",")],
                 a.clients, a.outstanding)
    try:
        while int(sh.hdr[LEADER]) < 0:      # until the harness names one
            if int(sh.hdr[CMD]) == EXIT:
                return 0
            time.sleep(0.005)
        if not all(cl.connect(c) for c in range(cl.n)):
            sh.hdr[STATE] = FAILED
            print("appclient: a client could not connect to the leader's "
                  "app", file=sys.stderr)
            return 2
        sh.hdr[STATE] = CONNECTED
        while int(sh.hdr[CMD]) == WAIT:
            time.sleep(0.001)
        if int(sh.hdr[CMD]) == GO:
            cl.start()
        cl.serve()
    finally:
        cl.close()
        sh.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
