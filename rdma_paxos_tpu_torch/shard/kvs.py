"""Sharded replicated KVS — router-directed puts/gets over G groups
(the port of the JAX package's ``shard/kvs.py``).

Each consensus group runs the standard single-group service
(:class:`~rdma_paxos_tpu_torch.models.replicated_kvs.ReplicatedKVS` folding
its group's committed stream into per-replica device tables), reused
UNCHANGED through a ``SimCluster``-shaped per-group facade — sharding
adds routing on top, it does not fork the state-machine code. The
:class:`~rdma_paxos_tpu_torch.shard.router.KeyRouter` decides which group
serves a key; sessions keep **per-group dedup sequence numbers** (one
``(client_id, req_id)`` stream per group, since groups commit
independently and a shared counter would leave holes every group's
dedup registry would misread); leader failover in one group re-routes
only that group's traffic — sessions against other groups never
notice.

Client-id namespacing: every stamped submission through this layer —
sessions AND direct ``ShardedKVS.put(client_id=...)`` calls — maps an
external client id ``c`` to conn ``c * G + g`` in group ``g``
(:meth:`ShardedKVS.conn_for`): injective over (client, group), so
dedup registries, span keys, and history records can never collide
across groups OR between the two submission paths within a group,
even though every group numbers its requests from 1.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from rdma_paxos_tpu_torch.consensus.log import EntryType
from rdma_paxos_tpu_torch.models.replicated_kvs import ReplicatedKVS
from rdma_paxos_tpu_torch.shard.cluster import ShardedCluster
from rdma_paxos_tpu_torch.shard.router import KeyLike, KeyRouter


class _GroupFacade:
    """A ``SimCluster``-shaped view of ONE group of a
    :class:`ShardedCluster` — exactly the surface ``ReplicatedKVS``
    consumes (``R``, ``submit``, ``replayed``, ``last``, ``obs``), so
    the single-group KVS folds a group's committed stream unchanged.
    This is the step/sim-boundary contract that keeps single-group the
    G=1 special case instead of a parallel code path."""

    def __init__(self, shard: ShardedCluster, group: int):
        self._shard = shard
        self.group = group
        self.R = shard.R
        self.device = shard.device

    @property
    def obs(self):
        return self._shard.obs

    @property
    def leases(self):
        """The sharded cluster's per-group LeaseManager (or None) —
        the single-group KVS consults it with this facade's group, so
        lease-path reads work identically through the facade."""
        return getattr(self._shard, "leases", None)

    @property
    def need_recovery(self):
        """This group's slice of the sharded ``{(g, r)}`` recovery
        set, in the single-group ``{r}`` shape the KVS serving gate
        consults."""
        return {r for (g, r) in self._shard.need_recovery
                if g == self.group}

    @property
    def read_blocked(self):
        """This group's slice of the repair pipeline's read-serving
        bar (same shape translation as ``need_recovery``)."""
        return {r for (g, r) in getattr(self._shard, "read_blocked",
                                        ())
                if g == self.group}

    def span_replica(self, r: int) -> int:
        """Namespaced span-track id for this group's replica ``r`` —
        the SAME ``g*R + r`` namespace the sharded cluster's
        append/commit/apply span stamps use, so session submit/ack
        events land on the right track."""
        return self._shard._span_rep(self.group, r)

    @property
    def replayed(self):
        return self._shard.replayed[self.group]

    @property
    def applied(self):
        """This group's ``[R]`` host apply cursors (the serving
        frontier gate in ``ReplicatedKVS.get`` compares them against
        the group's commit indices)."""
        return self._shard.applied[self.group]

    @property
    def last(self):
        last = self._shard.last
        if last is None:
            return None
        return {k: v[self.group] for k, v in last.items()}

    def submit(self, replica: int, payload: bytes,
               etype: EntryType = EntryType.SEND, conn: int = 1,
               req_id: int = 0) -> None:
        self._shard.submit(self.group, replica, payload, etype=etype,
                           conn=conn, req_id=req_id)


class ShardedKVS:
    """KVS service over a :class:`ShardedCluster`: every operation is
    routed to its key's group; reads/writes inside a group keep the
    single-group semantics (read-index linearizable GETs at the
    group's leader, weak GETs anywhere)."""

    def __init__(self, shard: ShardedCluster,
                 router: Optional[KeyRouter] = None, cap: int = 4096):
        self.shard = shard
        self.router = router if router is not None else shard.router
        if self.router.n_groups != shard.G:
            raise ValueError(
                f"router n_groups {self.router.n_groups} != cluster "
                f"groups {shard.G}")
        self.groups: List[ReplicatedKVS] = []
        for g in range(shard.G):
            kv = ReplicatedKVS(_GroupFacade(shard, g), cap=cap)
            kv.group = g
            self.groups.append(kv)

    # ---------------- routing ----------------

    def group_of(self, key: KeyLike) -> int:
        return self.router.group_of(key)

    def conn_for(self, client_id: int, group: int) -> int:
        """Group-namespaced conn id (``client_id * G + g``) — the ONE
        mapping every stamped submission through this layer uses
        (direct puts and sessions alike), so a direct put can never
        alias a session's dedup high-water mark within a group.
        ``client_id`` 0 (unstamped, dedup-exempt) stays 0."""
        if client_id <= 0:
            return client_id
        return client_id * self.shard.G + group

    def _leader(self, g: int, leader: Optional[int]) -> int:
        if leader is not None:
            return leader
        lead = self.shard.leader_hint(g)
        if lead < 0:
            raise RuntimeError(f"group {g} has no known leader")
        return lead

    def _gate(self, key: bytes) -> None:
        """Topology freeze gate: while an elastic cutover has ``key``'s
        range frozen, WRITES to it queue here (block) until the router
        swap lands or the window abandons — the only moment a key's
        group assignment may change out from under a submission. Reads
        never gate (the live router serves the old owner up to the
        atomic swap)."""
        topo = getattr(self.shard, "topology", None)
        if topo is not None:
            topo.gate_key(key)

    # ---------------- client API ----------------

    def put(self, key: bytes, val: bytes, *, client_id: int = 0,
            req_id: int = 0, leader: Optional[int] = None) -> int:
        """Route a PUT to its key's group (submitted at that group's
        leader, or ``leader`` when given). A stamped ``client_id`` is
        namespaced via :meth:`conn_for` — consistent with sessions.
        Returns the group id."""
        self._gate(key)
        g = self.group_of(key)
        self.groups[g].put(self._leader(g, leader), key, val,
                           client_id=self.conn_for(client_id, g),
                           req_id=req_id)
        return g

    def remove(self, key: bytes, *, client_id: int = 0,
               req_id: int = 0, leader: Optional[int] = None) -> int:
        self._gate(key)
        g = self.group_of(key)
        self.groups[g].remove(self._leader(g, leader), key,
                              client_id=self.conn_for(client_id, g),
                              req_id=req_id)
        return g

    def get(self, key: bytes, *, linearizable: bool = False,
            replica: Optional[int] = None) -> Optional[bytes]:
        """Read ``key`` from its group. Linearizable reads default to
        the group's lease-serving replica (the holder — how
        ``place_leaders`` spreads read serving across the R replicas)
        falling back to the leader for the read-index path; weak
        reads go to ``replica`` (or the leader by default)."""
        g = self.group_of(key)
        if replica is None:
            lm = getattr(self.shard, "leases", None)
            if linearizable and lm is not None:
                replica = lm.serving_holder(g)
            else:
                replica = -1
            if replica < 0:
                replica = self.shard.leader_hint(g)
            if replica < 0:
                replica = 0
        return self.groups[g].get(replica, key,
                                  linearizable=linearizable)

    def session(self, client_id: int) -> "ShardedSession":
        return ShardedSession(self, client_id)

    def transact(self, writes, reads=()):
        """Admit one cross-group atomic transaction (``txn/api.py``):
        ``writes`` are ``(op_name, key, value)`` triples, op_name in
        {put, rm, incr, sadd, max}. Requires ``txn.attach_coordinator``
        on a ``txn=True`` cluster. Returns a ``TxnHandle``."""
        from rdma_paxos_tpu_torch.txn.api import transact
        return transact(self, writes, reads)


class ShardedSession:
    """A retransmitting client over the sharded keyspace.

    One underlying single-group ``ClientSession`` per group, created
    lazily, each with its own req_id stream (per-group dedup sequence
    numbers) and a group-namespaced conn id (``client_id * G + g``).
    The single-group protocol contract holds PER GROUP: at most one
    request outstanding per group's session; requests to different
    groups may be in flight concurrently (they commit independently).

    Failover: :meth:`retransmit_put` re-sends a known ``(key,
    req_id)`` verbatim to the key's group's CURRENT leader — after a
    leader crash in one group, only that group's traffic re-routes.
    """

    def __init__(self, kvs: ShardedKVS, client_id: int):
        if client_id <= 0:
            raise ValueError("client_id must be positive")
        self.kvs = kvs
        self.client_id = client_id
        self._sess: Dict[int, object] = {}

    def conn_for(self, group: int) -> int:
        """The group-namespaced conn id riding M_CONN for this
        session's entries in ``group``'s log (the shared
        ``ShardedKVS.conn_for`` mapping, so direct stamped puts with
        the same external client_id hit the SAME dedup stream)."""
        return self.kvs.conn_for(self.client_id, group)

    def _group_session(self, g: int):
        sess = self._sess.get(g)
        if sess is None:
            sess = self.kvs.groups[g].session(self.conn_for(g))
            self._sess[g] = sess
        return sess

    def put(self, key: bytes, val: bytes, *,
            leader: Optional[int] = None) -> tuple:
        """Submit a PUT; returns ``(group, req_id)`` — keep the pair to
        retransmit after a timeout or that group's leader failover."""
        self.kvs._gate(key)
        g = self.kvs.group_of(key)
        rid = self._group_session(g).put(
            self.kvs._leader(g, leader), key, val)
        return g, rid

    def remove(self, key: bytes, *,
               leader: Optional[int] = None) -> tuple:
        self.kvs._gate(key)
        g = self.kvs.group_of(key)
        rid = self._group_session(g).remove(
            self.kvs._leader(g, leader), key)
        return g, rid

    def retransmit_put(self, key: bytes, val: bytes, req_id: int, *,
                       leader: Optional[int] = None) -> int:
        """Resend an earlier PUT verbatim to the key's group's current
        leader. Safe any number of times — the group's dedup registry
        applies it exactly once, surviving failover and restarts."""
        self.kvs._gate(key)
        g = self.kvs.group_of(key)
        self._group_session(g).retransmit_put(
            self.kvs._leader(g, leader), key, val, req_id)
        return g

    def req_id(self, group: int) -> int:
        """The session's current (last issued) req_id in ``group``."""
        sess = self._sess.get(group)
        return sess.req_id if sess is not None else 0
