"""The closed-loop clients and their intake thread.

Each client keeps ``outstanding`` requests in flight on one connection
to the leader. One intake thread hands queued requests to the front
end's shim handler, as a proxy link thread does. A completion is seen
through the pipelined-shim callback (``PendingEvent.attach``), which
stamps the release and queues that client's next request. All bytes
are made before the window opens; inside it this module only hands over
bytes and stamps times.

A client whose request is refused or failed (the leader lost its
leadership) does what a client of a replicated server does: it opens a
new connection (a CONNECT) at the replica that now leads and goes on
sending there. Every CONNECT is a row of its own (pool index -1), so
the reference holds the log to it like to any request."""

from __future__ import annotations

import functools
import heapq
import itertools
import queue
import threading
import time
from typing import Callable, List, Sequence

import numpy as np

REFUSED = -9          # the handler answered at once without an event
CONNECT, SEND = 2, 3
RETRY_S = 0.005       # a client waits this long before trying again


class ClosedLoop:
    def __init__(self, payloads: Sequence[bytes], n_clients: int,
                 outstanding: int, handlers: Sequence[Callable],
                 leader: Callable[[], int], cap: int):
        self.payloads = payloads
        self.P = len(payloads)
        self.n_clients = int(n_clients)
        self.outstanding = int(outstanding)
        self.handlers = list(handlers)
        self.leader = leader
        self.cap = int(cap)
        # per row (a request or a CONNECT), in send order (np.empty:
        # pages are touched only as rows arrive)
        self.t_send = np.empty(self.cap)
        self.t_ack = np.empty(self.cap)
        self.conn = np.empty(self.cap, np.int64)
        self.pidx = np.empty(self.cap, np.int32)
        self.status = np.zeros(self.cap, np.int16)
        self.fired = np.zeros(self.cap, np.int8)
        self.order = np.zeros(self.cap, np.int64)
        self.n_sent = 0
        self.n_requests = 0
        self.reconnects = 0
        self.overflow = False
        self.closing = False
        self._conn_of = [0] * self.n_clients
        self._front_of = [-1] * self.n_clients
        self._stale = [True] * self.n_clients
        self._next_conn = 1
        self._acks = itertools.count()
        self._retry: List = []
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._intake, daemon=True,
                                        name="paxbench-intake")

    def connect_all(self) -> List[int]:
        """Every client's first CONNECT, at the current leader (set-up).
        Returns their rows."""
        rows = []
        for c in range(self.n_clients):
            k = self.n_sent
            if not self._connect(c):
                raise RuntimeError("the leader refused a CONNECT")
            rows.append(k)
        return rows

    def start(self) -> None:
        for c in range(self.n_clients):
            for _ in range(self.outstanding):
                self._q.put(c)
        self._thread.start()

    def close(self) -> None:
        """Hand over no new request; those in flight still complete."""
        self.closing = True
        self._q.put(None)

    def join(self, timeout: float) -> bool:
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def answered(self) -> int:
        return int(np.count_nonzero(self.fired[:self.n_sent]))

    def _row(self, conn: int, p: int) -> int:
        k = self.n_sent
        if k >= self.cap:
            self.overflow = True
            return -1
        self.conn[k] = conn
        self.pidx[k] = p
        self.t_send[k] = time.perf_counter()
        return k

    def _stamp(self, k: int, status: int) -> None:
        self.t_ack[k] = time.perf_counter()
        self.status[k] = status
        self.fired[k] += 1
        self.order[k] = next(self._acks)

    def _done(self, k: int, client: int, token: bool, status: int) -> None:
        self._stamp(k, status)
        if status != 0 and self._conn_of[client] == self.conn[k]:
            self._stale[client] = True
        if token and not self.closing:
            self._q.put(client)

    def _refused(self, k: int, client: int, ev) -> None:
        self._stamp(k, ev if isinstance(ev, int) else REFUSED)
        if self._conn_of[client] == self.conn[k]:
            self._stale[client] = True

    def _connect(self, c: int) -> bool:
        """A new connection for client ``c`` at the current leader."""
        lead = self.leader()
        if lead < 0:
            return False
        conn = (lead << 24) | self._next_conn
        self._next_conn += 1
        k = self._row(conn, -1)
        if k < 0:
            return False
        ev = self.handlers[lead](CONNECT, conn, b"")
        self.n_sent = k + 1
        if self._front_of[c] >= 0:
            self.reconnects += 1
        if not hasattr(ev, "attach"):
            self._stamp(k, ev if isinstance(ev, int) and ev else REFUSED)
            return False
        self._conn_of[c], self._front_of[c] = conn, lead
        self._stale[c] = False
        ev.attach(functools.partial(self._done, k, c, False))
        return True

    def _next(self):
        """The next client with a request to send (None: stop)."""
        while True:
            if not self._retry:
                return self._q.get()
            wait = self._retry[0][0] - time.perf_counter()
            if wait <= 0:
                return heapq.heappop(self._retry)[1]
            try:
                return self._q.get(timeout=wait)
            except queue.Empty:
                continue

    def _intake(self) -> None:
        payloads, P, handlers = self.payloads, self.P, self.handlers
        done = self._done
        while True:
            c = self._next()
            if c is None:
                return
            if self.closing:
                continue
            if self._stale[c] and not self._connect(c):
                heapq.heappush(self._retry,
                               (time.perf_counter() + RETRY_S, c))
                continue
            conn = self._conn_of[c]
            p = self.n_requests % P
            k = self._row(conn, p)
            if k < 0:
                continue
            self.n_requests += 1
            ev = handlers[self._front_of[c]](SEND, conn, payloads[p])
            self.n_sent = k + 1
            if hasattr(ev, "attach"):
                ev.attach(functools.partial(done, k, c, True))
            else:
                self._refused(k, c, ev)
                heapq.heappush(self._retry,
                               (time.perf_counter() + RETRY_S, c))
