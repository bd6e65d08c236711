"""A sharded deployment (a configuration with ``groups`` G > 1): the
port's ``ShardedClusterDriver``, a client map taken once from its
router, clients that keep one connection per group, and the program's
outputs read group by group.

The driver holds a CONNECT until that connection's first SEND, pins the
connection to the group of that SEND's key, and acks its waiters per
(replica, group); every replica fronts every group."""

from __future__ import annotations

import functools
import heapq
import time
from typing import Callable, List, Sequence

import numpy as np

from paxbench.loop import CONNECT, REFUSED, RETRY_S, SEND, ClosedLoop

FNV32_OFFSET, FNV32_PRIME, MASK32 = 0x811C9DC5, 0x01000193, 0xFFFFFFFF


def build_driver(conf: dict, device, workdir: str):
    from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
    from rdma_paxos_tpu_torch.runtime.sharded_driver import (
        ShardedClusterDriver)
    return ShardedClusterDriver(
        LogConfig(**conf["log"]), int(conf["replicas"]),
        int(conf["groups"]), workdir=workdir, fanout=conf["fanout"],
        pipeline=int(conf["pipeline"]),
        timeout_cfg=TimeoutConfig(**conf["timeouts"]), device=device)


def stable_leaders(d, hold: float, timeout: float) -> List[int]:
    """Each group's leader, once every group's has held for ``hold``
    seconds."""
    end = time.monotonic() + timeout
    lead = d.leaders()
    since = [time.monotonic()] * len(lead)
    while time.monotonic() < end:
        now, cur = time.monotonic(), d.leaders()
        for g, (a, b) in enumerate(zip(lead, cur)):
            if a != b:
                since[g] = now
        lead = cur
        if all(v >= 0 for v in lead) and now - max(since) >= hold:
            return lead
        time.sleep(0.005)
    raise TimeoutError("not every group held a leader for %.1f s" % hold)


# ---- the client's map: the router's published table, computed here ----

def ring_hash(keys: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """FNV-1a (32 bits) of each row's first ``lens`` bytes, through
    Murmur3's 32-bit finalizer: the hash the table names
    (``fnv1a32+fmix32``)."""
    h = np.full(len(keys), FNV32_OFFSET, np.uint64)
    for j in range(keys.shape[1]):
        nh = ((h ^ keys[:, j]) * np.uint64(FNV32_PRIME)) & np.uint64(MASK32)
        h = np.where(j < lens, nh, h)
    for shift, mul in ((16, 0x85EBCA6B), (13, 0xC2B2AE35)):
        h ^= h >> np.uint64(shift)
        h = (h * np.uint64(mul)) & np.uint64(MASK32)
    return h ^ (h >> np.uint64(16))


def _rows(labels: Sequence[bytes]):
    w = max(len(b) for b in labels)
    mat = np.zeros((len(labels), w), np.uint8)
    for i, b in enumerate(labels):
        mat[i, :len(b)] = np.frombuffer(b, np.uint8)
    return mat, np.array([len(b) for b in labels])


class ClientMap:
    """Key to group, as a client computes it from the table the cluster
    publishes (``router.to_dict()``, as a Redis Cluster client takes
    ``CLUSTER SLOTS``): each group's ``vnodes`` points on a 32-bit ring,
    placed by the hash of ``group:<g>:vnode:<v>``; a key goes to the
    first point at or after its own hash, wrapping. The table's ring
    checksum must match the ring built here."""

    def __init__(self, table: dict):
        if (table.get("kind") != "hash_ring"
                or table.get("hash") != "fnv1a32+fmix32"
                or table.get("overrides")):
            raise ValueError(f"a client cannot route by {table!r}")
        G, V = int(table["n_groups"]), int(table["vnodes"])
        labels = [b"group:%d:vnode:%d" % (g, v)
                  for g in range(G) for v in range(V)]
        pts = ring_hash(*_rows(labels))
        grp = np.repeat(np.arange(G), V)
        o = np.lexsort((grp, pts))
        self.points, self.groups = pts[o], grp[o]
        ck = FNV32_OFFSET
        for p, g in zip(self.points.tolist(), self.groups.tolist()):
            for b in p.to_bytes(4, "big") + bytes([g & 0xFF]):
                ck = ((ck ^ b) * FNV32_PRIME) & MASK32
        if ck != table["ring_checksum"]:
            raise ValueError("the ring built from the table does not match "
                             "the cluster's checksum")

    def groups_of(self, keys: np.ndarray, lens: np.ndarray) -> np.ndarray:
        i = np.searchsorted(self.points, ring_hash(keys, lens), "left")
        return self.groups[np.where(i == len(self.points), 0, i)]


def route(pool, router) -> np.ndarray:
    """Each pool request's group, by the client's map of ``router``'s
    table; checked against the router itself on a sample of keys."""
    groups = ClientMap(router.to_dict()).groups_of(pool.keys, pool.key_lens)
    for i in range(0, len(groups), max(1, len(groups) // 64)):
        key = pool.keys[i, :pool.key_lens[i]].tobytes()
        if router.group_of(key) != groups[i]:
            raise ValueError(f"the client's map routes {key!r} elsewhere")
    return groups.astype(np.int8)


# ---- the clients ----

class ShardedLoop(ClosedLoop):
    """Clients of a sharded cluster, as Redis Cluster's clients are:
    client c fronts at replica ``c mod R`` (every replica fronts the
    cluster), holds one connection there per group, and sends each
    request on the connection of its key's group (``groups[p]``, from
    the map taken at set-up). A CONNECT answered 0 (held by the driver
    until the connection's first SEND) is accepted. A refused or failed
    request reconnects that one (client, group) connection. Each row's
    group is recorded in ``group``."""

    def __init__(self, payloads: Sequence[bytes], groups: np.ndarray,
                 n_groups: int, n_clients: int, outstanding: int,
                 handlers: Sequence[Callable], cap: int):
        super().__init__(payloads, n_clients, outstanding, handlers,
                         lambda: -1, cap)
        self.G = int(n_groups)
        self.pgroup = groups.tolist()
        self.group = np.empty(self.cap, np.int8)
        # per (client, group) slot s = client * G + group
        slots = self.n_clients * self.G
        self._conn_of = [0] * slots
        self._stale = [True] * slots
        self._front_of = [s // self.G % len(self.handlers)
                          for s in range(slots)]

    def connect_all(self) -> List[int]:
        rows = []
        for s in range(self.n_clients * self.G):
            k = self.n_sent
            if not self._connect(s):
                raise RuntimeError("a front end refused a CONNECT")
            rows.append(k)
        return rows

    def _done(self, k: int, s: int, token: bool, status: int) -> None:
        self._stamp(k, status)
        if status != 0 and self._conn_of[s] == self.conn[k]:
            self._stale[s] = True
        if token and not self.closing:
            self._q.put(s // self.G)

    def _connect(self, s: int) -> bool:
        front = self._front_of[s]
        conn = (front << 24) | self._next_conn
        self._next_conn += 1
        k = self._row(conn, -1)
        if k < 0:
            return False
        self.group[k] = s % self.G
        ev = self.handlers[front](CONNECT, conn, b"")
        self.n_sent = k + 1
        if self._conn_of[s]:
            self.reconnects += 1
        if hasattr(ev, "attach"):
            ev.attach(functools.partial(self._done, k, s, False))
        elif isinstance(ev, int) and ev == 0:
            self._stamp(k, 0)             # held until the first SEND
        else:
            self._stamp(k, ev if isinstance(ev, int) and ev else REFUSED)
            return False
        self._conn_of[s] = conn
        self._stale[s] = False
        return True

    def _intake(self) -> None:
        payloads, P, handlers = self.payloads, self.P, self.handlers
        pgroup, G, done = self.pgroup, self.G, self._done
        while True:
            c = self._next()
            if c is None:
                return
            if self.closing:
                continue
            p = self.n_requests % P
            s = c * G + pgroup[p]
            if self._stale[s] and not self._connect(s):
                heapq.heappush(self._retry,
                               (time.perf_counter() + RETRY_S, c))
                continue
            conn = self._conn_of[s]
            k = self._row(conn, p)
            if k < 0:
                continue
            self.group[k] = pgroup[p]
            self.n_requests += 1
            ev = handlers[self._front_of[s]](SEND, conn, payloads[p])
            self.n_sent = k + 1
            if hasattr(ev, "attach"):
                ev.attach(functools.partial(done, k, s, True))
            else:
                self._refused(k, s, ev)
                heapq.heappush(self._retry,
                               (time.perf_counter() + RETRY_S, c))


# ---- the program's outputs, group by group ----

def settled(replayed) -> bool:
    """Every group's replicas hold streams of one length."""
    return all(len({len(s) for s in row}) == 1 for row in replayed)


def outputs(cluster):
    """``[G][R]`` committed streams, device rings and end indices."""
    G, R = cluster.G, cluster.R
    ends = np.asarray(cluster.state.end.cpu()).reshape(G, R)
    return ([list(row) for row in cluster.replayed],
            [[cluster.ring(g, r) for r in range(R)] for g in range(G)],
            ends)
