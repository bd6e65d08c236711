"""Elastic multi-host deployment — generation-based world rebuild.

The reference's elasticity is a side-channel story: a joiner multicasts
JOIN into the running group over UD/IB-multicast, the leader allocates a
slot or up-sizes, and the joiner snapshot-recovers over RDMA
(``handle_server_join_request`` ``dare_ibv_ud.c:972-1068``;
``rc_recover_sm``/``rc_recover_log`` ``dare_ibv_rc.c:603-856``). RDMA QPs
can be built to a new peer while the group keeps running.

A ``torch.distributed`` world cannot: its process set and ranks are
fixed at ``init_process_group``. The design therefore moves membership
change OUT of the data plane and into a TCP control plane, as a sequence
of **generations**:

* A generation is a fixed member set running the ordinary lock-step
  :class:`~rdma_paxos_tpu_torch.runtime.node.NodeDaemon` loop in a
  dedicated worker process (its own gloo world, its own coordinator
  port).
* A :class:`GroupController` (the IB-multicast-group analog) tracks
  registrations and cuts a new generation whenever the member set needs
  to change — a host died (its worker stops posting round barriers /
  survivors report the collective failure), left, or (re)joined.
* On a cut, every member of the new generation installs an identical
  GENESIS state derived from the **donor** — the most up-to-date
  survivor by Raft's election ordering ``(last_log_term, end)``. With the
  controller refusing to cut unless the survivors include a majority of
  the previous generation, the donor's log contains every committed
  entry (Leader Completeness), so acked client writes survive any
  tolerated failure. The donor's uncommitted suffix carries over and is
  committed or truncated by the new generation's first leader, exactly
  like a Raft restart.
* The joiner (and, uniformly, every member) adopts the donor's stable
  store and rebuilds its app instance by replaying it — the
  ``proxy_apply_db_snapshot`` analog — so a restarted host serves the
  full replicated history the moment its generation starts.

Workers cannot rely on crash handlers: a worker may be SIGKILLed, and a
survivor's collective ends in an exception (or its gloo timeout) when a
peer dies, after which it exits at once. So recovery points are written
BEFORE failures, not at them: after every iteration that made progress a
small (state row, meta + live-store length) pair is renamed into place
(atomic against process death), and :func:`best_recovery` pairs it with
the live store trimmed to the recorded length — the freshest recovery
point, containing every write the member acked, is never more than one
iteration old regardless of how the process dies. A durable fsynced
full triple is additionally written at every round barrier (the
power-loss tier). A member hard-killed outright counts as a FAILED
member: acked-write survival needs only a majority of SURVIVING
members, whose recovery points carry every committed entry. The
supervisor (this module's :class:`ElasticSupervisor`) never touches the
device itself and survives any worker death; it freezes the recovery
point it offers (and serves to fetches) at registration time, so every
member of a cut installs exactly the state the donor election ranked.

Wire protocol: newline-delimited JSON over short-lived TCP connections;
binary blobs ride length-prefixed after the JSON header.

The port of the JAX package's ``runtime/elastic.py``, which is free of
JAX itself: the framing, dumps, controller and supervisor are copies.
The supervisor spawns the port's worker
(``rdma_paxos_tpu_torch.runtime.elastic_worker``), ``--worker-cpu``
hands it ``--device cpu`` (without it the worker runs on the card), and
the shim and toy app come from ``native/`` beside the package. The
reference arms no runtime lock sanitizer here, and neither does the
port.
"""

from __future__ import annotations

import io
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from rdma_paxos_tpu_torch.obs import trace as obs_trace
from rdma_paxos_tpu_torch.obs.metrics import default_registry
from rdma_paxos_tpu_torch.obs.trace import default_ring
from rdma_paxos_tpu_torch.proxy.stablestore import NATIVE_DIR


# ---------------------------------------------------------------------------
# framing helpers
# ---------------------------------------------------------------------------

def _send_msg(sock: socket.socket, obj: dict,
              blobs: Tuple[bytes, ...] = ()) -> None:
    head = json.dumps(obj).encode() + b"\n"
    sock.sendall(struct.pack("<I", len(head)) + head)
    sock.sendall(struct.pack("<I", len(blobs)))
    for b in blobs:
        sock.sendall(struct.pack("<Q", len(b)))
        sock.sendall(b)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)                # linear even for large snapshots
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], min(n - got, 1 << 20))
        if r == 0:
            raise ConnectionError("peer closed")
        got += r
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> Tuple[dict, List[bytes]]:
    (hlen,) = struct.unpack("<I", _recv_exact(sock, 4))
    obj = json.loads(_recv_exact(sock, hlen))
    (nblobs,) = struct.unpack("<I", _recv_exact(sock, 4))
    blobs = []
    for _ in range(nblobs):
        (blen,) = struct.unpack("<Q", _recv_exact(sock, 8))
        blobs.append(_recv_exact(sock, blen))
    return obj, blobs


def call(addr: str, obj: dict, blobs: Tuple[bytes, ...] = (),
         timeout: float = 60.0) -> Tuple[dict, List[bytes]]:
    """One request/response round trip to ``host:port``."""
    host, port = addr.rsplit(":", 1)
    with socket.create_connection((host, int(port)),
                                  timeout=timeout) as s:
        s.settimeout(timeout)
        _send_msg(s, obj, blobs)
        return _recv_msg(s)


def _row_to_npz(row: dict) -> bytes:
    bio = io.BytesIO()
    np.savez(bio, **row)
    return bio.getvalue()


def _npz_to_row(blob: bytes) -> dict:
    with np.load(io.BytesIO(blob)) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# dump files (the worker's recovery points)
# ---------------------------------------------------------------------------

def dump_path(workdir: str, host_id: int) -> str:
    return os.path.join(workdir, f"dump_h{host_id}.bin")


def write_dump(workdir: str, host_id: int, row: dict, store_blob: bytes,
               meta: dict) -> None:
    """Atomically persist a consistent (state row, store, meta) triple as
    ONE file — a crash can only ever leave the previous complete triple,
    never a mixed pair."""
    from rdma_paxos_tpu_torch.proxy.stablestore import atomic_write
    row_npz = _row_to_npz(row)
    head = json.dumps(meta).encode()
    atomic_write(
        dump_path(workdir, host_id),
        struct.pack("<I", len(head)) + head
        + struct.pack("<Q", len(row_npz)) + row_npz
        + struct.pack("<Q", len(store_blob)) + store_blob)


def read_dump(workdir: str, host_id: int
              ) -> Optional[Tuple[dict, bytes, dict]]:
    try:
        with open(dump_path(workdir, host_id), "rb") as f:
            (hlen,) = struct.unpack("<I", f.read(4))
            meta = json.loads(f.read(hlen))
            (rlen,) = struct.unpack("<Q", f.read(8))
            row = _npz_to_row(f.read(rlen))
            (slen,) = struct.unpack("<Q", f.read(8))
            store = f.read(slen)
            if len(store) != slen:
                return None
    except (OSError, json.JSONDecodeError, ValueError, struct.error):
        return None
    return row, store, meta


# --- per-iteration recovery points (row + meta only) -----------------------
#
# Workers can be killed INSTANTLY and un-catchably (SIGKILL, or a
# survivor's own hard exit once a peer's death breaks its collective).
# No crash handler can be relied on, so after every iteration that made
# progress the worker persists a small (state row, meta) pair by atomic
# rename
# (durable=False: safe against process death, which is the threat here).
# The meta records the live store's record count at that moment; recovery
# reconstructs the matching store blob by trimming the live store file —
# so the freshest recovery point is never more than one iteration old,
# abort or no abort.

def rowdump_path(workdir: str, host_id: int) -> str:
    return os.path.join(workdir, f"rowdump_h{host_id}.bin")


def write_rowdump(workdir: str, host_id: int, row: dict,
                  meta: dict) -> None:
    from rdma_paxos_tpu_torch.proxy.stablestore import atomic_write
    row_npz = _row_to_npz(row)
    head = json.dumps(meta).encode()
    atomic_write(rowdump_path(workdir, host_id),
                 struct.pack("<I", len(head)) + head
                 + struct.pack("<Q", len(row_npz)) + row_npz,
                 durable=False)


def read_rowdump(workdir: str, host_id: int
                 ) -> Optional[Tuple[dict, dict]]:
    try:
        with open(rowdump_path(workdir, host_id), "rb") as f:
            (hlen,) = struct.unpack("<I", f.read(4))
            meta = json.loads(f.read(hlen))
            (rlen,) = struct.unpack("<Q", f.read(8))
            blob = f.read(rlen)
            if len(blob) != rlen:
                return None
            row = _npz_to_row(blob)
    except (OSError, json.JSONDecodeError, ValueError, struct.error):
        return None
    return row, meta


def best_recovery(workdir: str, host_id: int
                  ) -> Optional[Tuple[dict, bytes, dict]]:
    """The freshest consistent (row, store blob, meta) recovery point:
    the per-iteration rowdump (paired with the live store trimmed to its
    recorded length) when it is newer than the last barrier dump, else
    the barrier dump."""
    from rdma_paxos_tpu_torch.proxy.stablestore import trimmed_dump

    def freshness(m: dict):
        # generations strictly order recovery points: a later world's
        # genesis can legitimately START with a lower applied offset
        # than an earlier world reached, and regressing across worlds
        # would lose the later world's acked writes
        return (int(m.get("gen", 0)), int(m.get("applied", -1)))

    barrier = read_dump(workdir, host_id)
    rd = read_rowdump(workdir, host_id)
    if rd is not None:
        row, meta = rd
        if barrier is None or freshness(meta) >= freshness(barrier[2]):
            store_path = os.path.join(workdir, f"host{host_id}.db")
            n = int(meta.get("store_len", 0))
            try:
                blob = (trimmed_dump(store_path, n)
                        if os.path.exists(store_path) else b"")
            except OSError:
                blob = None
            if blob is not None:
                return row, blob, meta
    return barrier


# ---------------------------------------------------------------------------
# GroupController — the TCP rendezvous / membership service
# ---------------------------------------------------------------------------

class GroupController:
    """Membership + generation service (the IB multicast group +
    ``handle_server_join_request`` control role, re-homed to TCP).

    Ops (JSON over :func:`call`):

    * ``register`` — a supervisor offers its host for the next
      generation (with its latest dump meta for donor election).
    * ``poll`` — fetch the current generation spec.
    * ``round`` — worker round barrier; doubles as the generation-change
      signal (``ok=0`` tells workers to exit for a rebuild).
    * ``fail`` — a supervisor reports its worker died on a collective
      error; the generation is broken and will be re-cut.
    * ``leave`` — graceful departure.
    """

    def __init__(self, port: int = 0, *, expect: int,
                 settle: float = 0.7, barrier_timeout: float = 120.0):
        # barrier_timeout bounds how long one member may lag the others
        # at a round barrier before the generation is declared broken; it
        # must comfortably exceed a generation's FIRST round, which
        # includes each worker's start (process, torch, the card).
        self.expect = expect
        self.settle = settle
        self.barrier_timeout = barrier_timeout
        self._lock = threading.Condition()
        # host -> {"addr", "meta"}: supervisors waiting for the next cut
        self._reg: Dict[int, dict] = {}
        self._reg_changed = time.monotonic()
        self._gen = 0
        self._spec: Optional[dict] = None      # active generation spec
        self._prev_members: List[int] = []
        self._regen_wanted = False
        self._barriers: Dict[Tuple[int, int], set] = {}
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", port))
        self._srv.listen(32)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        # the CUTTER owns the settle deadline: cuts fire the moment the
        # expected membership is complete (event-driven) or when the
        # settle window elapses after the last registration — never
        # dependent on the timing of the NEXT incoming RPC (the old
        # behavior re-evaluated only inside request handlers, making
        # cut latency a function of worker poll cadence: the elastic
        # suite's flake locus)
        self._cutter = threading.Thread(target=self._cut_loop, daemon=True)
        self._cutter.start()

    # ------------------------------------------------------------------

    def _break(self, reason: str) -> None:
        """Break the RUNNING generation (workers exit at their next
        round barrier) and log why. No-op logging-wise when no
        generation is active — there is nothing to break, only pending
        registrations to re-evaluate. Caller holds the lock."""
        if self._spec is not None:
            print(f"controller: gen {self._gen} break — {reason}",
                  flush=True)
            # structured twin of the print: the elastic control plane's
            # churn signal (breaks per wall-clock = regen storm alarm)
            default_registry().inc("elastic_generation_breaks_total")
            default_ring().record(obs_trace.GENERATION_BREAK,
                                  gen=self._gen, reason=reason)
        self._regen_wanted = True
        self._lock.notify_all()

    def _maybe_cut(self) -> None:
        """Cut a new generation if the pending set is stable + quorate.
        Caller holds the lock."""
        if self._spec is not None and not self._regen_wanted:
            return
        hosts = sorted(self._reg)
        if not hosts:
            return

        def _donor_eligible(h: int) -> bool:
            m = self._reg[h].get("meta")
            return bool(m) and bool(int(m.get("usable", 1)))

        group_has_history = any(self._reg[h].get("meta") for h in hosts)
        if self._prev_members:
            # survivors must include a majority of the previous world,
            # else the donor cannot be proven complete (Raft overlap)
            maj = len(self._prev_members) // 2 + 1
            prev = set(self._prev_members)
            if len(prev.intersection(hosts)) < maj:
                return
            # When the group HAS history, only DONOR-ELIGIBLE survivors
            # count toward that majority: the donor election below skips
            # force-pruned laggards (usable=0) and meta-less
            # registrations, so letting them justify the cut could
            # elect a donor missing a committed entry whose only
            # surviving holder is the unusable host (commit acked by
            # leader+wedged follower, leader dies, third follower
            # lags) — the cut must wait for a provably complete donor
            # set. When NO survivor has any meta (every disk was lost),
            # there is nothing recoverable anywhere: fall through to
            # the fresh-world cut below rather than deadlock.
            if group_has_history:
                eligible = [h for h in hosts
                            if h in prev and _donor_eligible(h)]
                if len(eligible) < maj:
                    return
        elif len(hosts) < self.expect:
            return
        # event-driven cut: a REBUILD with every previous member back
        # has nobody to settle for — cut immediately. Fresh worlds and
        # partial-survivor rebuilds wait out the settle window (batching
        # near-simultaneous registrations — a fresh boot of MORE than
        # `expect` hosts must not cut at the expect-th registration and
        # immediately churn on the next newcomer); the cutter thread
        # owns that deadline.
        full = bool(self._prev_members) and (
            set(self._prev_members) <= set(hosts))
        if (not full
                and time.monotonic() - self._reg_changed < self.settle):
            return
        # the generation's workers still running must have been told to
        # exit before their hosts re-registered; hosts in _reg are idle
        self._gen += 1
        donor, donor_key = -1, (-1, -1)
        term_base = 0
        has_meta = False
        for h in hosts:
            m = self._reg[h].get("meta")
            if not m:
                continue
            has_meta = True
            term_base = max(term_base, int(m.get("term", 0)))
            if not m.get("usable", 1):
                # a force-pruned laggard's log no longer holds its own
                # apply cursor: installing it would wedge the generation
                continue
            key = (int(m.get("last_log_term", 0)), int(m.get("end", 0)))
            if key > donor_key:
                donor, donor_key = h, key
        if has_meta and donor < 0:
            # the group HAS history but no member can donate it (every
            # dump is unusable): cutting a fresh world here would
            # silently discard committed state — refuse and wait for
            # operator intervention or a usable registration, exactly
            # like the majority-overlap guard above
            return
        members = [{"host": h, "addr": self._reg[h]["addr"]}
                   for h in hosts]
        coord_host = self._reg[hosts[0]]["addr"].rsplit(":", 1)[0]
        self._spec = {
            "gen": self._gen,
            "members": members,
            "coordinator": f"{coord_host}:{self.port + 100 + self._gen}",
            "donor": donor,
            "donor_addr": (self._reg[donor]["addr"] if donor >= 0
                           else ""),
            "term_base": term_base,
            "epoch": self._gen,
            # workers derive their round-RPC client timeout from this,
            # so raising the controller's barrier budget (slow cold
            # compiles) can never make healthy workers time out first
            "barrier_timeout": self.barrier_timeout,
        }
        self._prev_members = hosts
        self._reg.clear()
        self._regen_wanted = False
        self._barriers.clear()
        default_registry().inc("elastic_generation_cuts_total")
        default_registry().set("elastic_generation", self._gen)
        default_ring().record(obs_trace.GENERATION_CUT, gen=self._gen,
                              members=hosts, donor=donor,
                              term_base=term_base)
        self._lock.notify_all()

    def _cut_loop(self) -> None:
        """Re-evaluate pending cuts when the settle deadline passes —
        independent of RPC arrival timing."""
        with self._lock:
            while not self._stop.is_set():
                before = self._gen
                self._maybe_cut()
                if self._gen != before:
                    continue
                if self._reg and (self._spec is None
                                  or self._regen_wanted):
                    left = (self._reg_changed + self.settle
                            - time.monotonic())
                    # settle deadline already passed but the cut is
                    # blocked on something else (majority overlap /
                    # donor eligibility): no point busy-waking — only a
                    # registration (which notifies) can unblock it
                    self._lock.wait(timeout=left if left > 0 else 1.0)
                else:
                    self._lock.wait(timeout=1.0)

    def _handle(self, req: dict) -> dict:
        op = req.get("op")
        if op == "round":
            return self._round(req)
        with self._lock:
            if op == "register":
                h = int(req["host"])
                if not 0 <= h < 128:
                    # never admit an id the proxy layer cannot encode:
                    # a generation containing it would crash on spawn
                    return {"error": f"host id {h} out of range 0..127"}
                self._reg[h] = {"addr": req["addr"],
                                "meta": req.get("meta")}
                self._reg_changed = time.monotonic()
                if (self._spec is not None
                        and h not in [m["host"]
                                      for m in self._spec["members"]]):
                    # a newcomer wants in
                    self._break(f"newcomer h{h} registered")
                self._maybe_cut()
                return {"gen": self._gen}
            if op == "poll":
                self._maybe_cut()
                h = int(req["host"])
                if (self._spec is not None
                        and h in [m["host"]
                                  for m in self._spec["members"]]):
                    return dict(self._spec, ok=1)
                return {"ok": 0, "gen": self._gen, "pending": True}
            if op in ("fail", "leave"):
                h = int(req["host"])
                self._break(f"{op} from h{h}")
                if op == "leave":
                    self._reg.pop(h, None)
                return {"ok": 1, "gen": self._gen}
            return {"error": f"unknown op {op!r}"}

    def _round(self, req: dict) -> dict:
        g, r, h = int(req["gen"]), int(req["round"]), int(req["host"])
        deadline = time.monotonic() + self.barrier_timeout
        with self._lock:
            if self._spec is None or g != self._spec["gen"]:
                return {"ok": 0, "gen": self._gen}
            members = {m["host"] for m in self._spec["members"]}
            key = (g, r)
            self._barriers.setdefault(key, set()).add(h)
            # completed earlier rounds can never be waited on again
            for k in [k for k in self._barriers
                      if k[0] == g and k[1] < r - 2]:
                del self._barriers[k]
            while True:
                if self._regen_wanted:
                    return {"ok": 0, "gen": self._gen}
                if self._spec is None or self._spec["gen"] != g:
                    return {"ok": 0, "gen": self._gen}
                if self._barriers.get(key, set()) >= members:
                    return {"ok": 1, "gen": g}
                left = deadline - time.monotonic()
                if left <= 0:
                    # a member never arrived: the generation is broken
                    missing = members - self._barriers.get(key, set())
                    self._break(f"barrier round {r} timed out waiting "
                                f"for {sorted(missing)}")
                    return {"ok": 0, "gen": self._gen}
                self._lock.wait(timeout=min(left, 0.25))

    # ------------------------------------------------------------------

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_one, args=(conn,),
                             daemon=True).start()

    def _serve_one(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(self.barrier_timeout + 30)
            req, _ = _recv_msg(conn)
            resp = self._handle(req)
            with self._lock:
                self._lock.notify_all()
            _send_msg(conn, resp)
        except (OSError, ConnectionError, json.JSONDecodeError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            self._lock.notify_all()    # release the cutter promptly
        try:
            self._srv.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# ElasticSupervisor — the per-host daemon (never touches the device)
# ---------------------------------------------------------------------------

class ElasticSupervisor:
    """Owns one host's participation across generations: registers with
    the controller, prepares genesis/store from the generation's donor,
    spawns the worker process (and the unmodified app under the shim),
    serves its own dumps to other hosts, and reports failures."""

    def __init__(self, *, host_id: int, controller: str, workdir: str,
                 port: int = 0, app_port: int = 0, app_cmd: str = "",
                 round_iters: int = 25, cfg_json: str = "",
                 worker_env: Optional[dict] = None,
                 worker_device: str = ""):
        # conn ids pack the host id into bits 24+ of an int32 log column;
        # enforce the bound HERE (where elastic host ids are chosen) so
        # an oversized id fails one supervisor at startup instead of
        # crashing every generation that includes it (the worker's
        # ProxyServer would raise the same bound mid-generation,
        # breaking the whole world in a regen loop)
        if not 0 <= host_id < 128:
            raise ValueError(
                f"host_id {host_id} out of range: conn-id origin field "
                "allows 0..127 — recycle retired host ids")
        self.host_id = host_id
        self.controller = controller
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.app_port = app_port
        self.app_cmd = app_cmd
        self.round_iters = round_iters
        self.cfg_json = cfg_json
        self.worker_env = worker_env or {}
        # the workers' --device ("" = the worker's default, the card)
        self.worker_device = worker_device
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", port))
        self._srv.listen(16)
        self.addr = "127.0.0.1:%d" % self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._last_gen = 0
        self._child: Optional[subprocess.Popen] = None
        self._app: Optional[subprocess.Popen] = None
        # the recovery point offered for the NEXT generation, frozen at
        # registration time (no worker is running then, so the store
        # file is quiescent); donor fetches serve exactly this
        self._offered: Optional[Tuple[dict, bytes, dict]] = None
        threading.Thread(target=self._serve, daemon=True).start()

    # ---------------- dump serving (the donor side) ----------------

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_one, args=(conn,),
                             daemon=True).start()

    def _serve_one(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(60)
            req, _ = _recv_msg(conn)
            if req.get("op") == "fetch":
                # serve the FROZEN offer captured at registration: the
                # live store may be getting replaced by our own _prepare
                # concurrently, and every member of the cut must see the
                # same donor state the controller elected on
                d = self._offered
                if d is None:
                    _send_msg(conn, {"ok": 0})
                else:
                    row, store, meta = d
                    _send_msg(conn, {"ok": 1, "meta": meta},
                              (_row_to_npz(row), store))
            else:
                _send_msg(conn, {"error": "unknown op"})
        except (OSError, ConnectionError, json.JSONDecodeError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # ---------------- generation lifecycle ----------------

    def _prepare(self, spec: dict) -> None:
        """Install the donor's state + store for the coming generation
        (uniformly for every member — see module docstring)."""
        from rdma_paxos_tpu_torch.proxy.stablestore import StableStore
        donor = int(spec["donor"])
        if donor < 0:
            return
        if donor == self.host_id:
            d = self._offered
            assert d is not None, "donor lost its own recovery point"
            row_npz, store_blob, donor_meta = (_row_to_npz(d[0]), d[1],
                                               d[2])
        else:
            resp, blobs = call(spec["donor_addr"], {"op": "fetch"})
            if not resp.get("ok"):
                raise RuntimeError("donor has no dump to serve")
            row_npz, store_blob, donor_meta = (blobs[0], blobs[1],
                                               resp["meta"])
        base = os.path.join(self.workdir,
                            f"gen{spec['gen']}_donor")
        with open(f"{base}_row_h{self.host_id}.npz", "wb") as f:
            f.write(row_npz)
        with open(f"{base}_meta_h{self.host_id}.json", "w") as f:
            json.dump(donor_meta, f)
        # the old per-iteration rowdump pairs with the OLD store
        # contents: remove it BEFORE the store is replaced (a supervisor
        # killed in between then merely falls back to its consistent
        # barrier dump, instead of mis-pairing the old row with the new
        # store); our _offered copy keeps the old point safe in memory
        try:
            os.unlink(rowdump_path(self.workdir, self.host_id))
        except OSError:
            pass
        store = StableStore(os.path.join(self.workdir,
                                         f"host{self.host_id}.db"))
        try:
            store.reset()
            if store_blob:
                store.load(store_blob)
            store.sync()
        finally:
            store.close()

    def _spawn(self, spec: dict) -> None:
        members = [m["host"] for m in spec["members"]]
        slot = members.index(self.host_id)
        sock_path = os.path.join(self.workdir, f"proxy{slot}.sock")
        # a worker hard-killed mid-generation leaves its socket file
        # behind; matching it below would start the app against a dead
        # socket — the shim's connect fails and it silently serves
        # unreplicated. Remove it BEFORE the worker spawns (racing the
        # new worker's own bind would delete the live socket instead).
        try:
            os.unlink(sock_path)
        except OSError:
            pass
        spec_path = os.path.join(
            self.workdir, f"gen{spec['gen']}_spec_h{self.host_id}.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ)
        env.update(self.worker_env)
        env["PYTHONUNBUFFERED"] = "1"
        argv = [sys.executable, "-m",
                "rdma_paxos_tpu_torch.runtime.elastic_worker",
                "--spec", spec_path, "--workdir", self.workdir,
                "--host-id", str(self.host_id),
                "--controller", self.controller,
                "--app-port", str(self.app_port),
                "--round-iters", str(self.round_iters)]
        if self.cfg_json:
            argv += ["--cfg-json", self.cfg_json]
        if self.worker_device:
            argv += ["--device", self.worker_device]
        log = open(os.path.join(self.workdir,
                                f"worker_h{self.host_id}.log"), "ab")
        # keep a LOCAL handle: stop()/_reap() null self._child from
        # another thread, and dereferencing the attribute mid-wait was
        # a use-after-null crash (AttributeError spew on teardown)
        child = subprocess.Popen(argv, env=env, stdout=log,
                                 stderr=subprocess.STDOUT)
        self._child = child
        log.close()
        if self._stop.is_set():
            # stop() raced the Popen: its kill() saw _child as None, so
            # nothing would ever reap this worker — kill it here
            child.kill()
        if self.app_port:
            deadline = time.monotonic() + 120
            while (not os.path.exists(sock_path)
                   and child.poll() is None
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            if os.path.exists(sock_path):
                native = NATIVE_DIR
                cmd = (self.app_cmd.split() if self.app_cmd
                       else [os.path.join(native, "toyserver"),
                             str(self.app_port)])
                aenv = dict(os.environ)
                aenv["LD_PRELOAD"] = os.path.join(native, "interpose.so")
                aenv["RP_PROXY_SOCK"] = sock_path
                self._app = subprocess.Popen(
                    cmd, env=aenv, stderr=subprocess.DEVNULL)
                print(f"supervisor h{self.host_id}: app started on "
                      f"port {self.app_port} (gen {spec['gen']}, pid "
                      f"{self._app.pid})", flush=True)
            else:
                print(f"supervisor h{self.host_id}: worker sock never "
                      f"appeared (gen {spec['gen']}) — app NOT started",
                      flush=True)

    def _reap(self) -> None:
        # swap-then-use: stop() and the run thread both reap; a local
        # handle makes the pair idempotent and race-free
        app, self._app = self._app, None
        if app is not None:
            app.kill()
            app.wait()
        self._child = None

    def run(self) -> None:
        """Supervisor main loop: register → wait for a generation that
        includes this host → prepare → run the worker → repeat."""
        while not self._stop.is_set():
            # freeze the recovery point we offer this cycle (no worker
            # is running, so the store file is quiescent right now)
            self._offered = best_recovery(self.workdir, self.host_id)
            try:
                call(self.controller,
                     {"op": "register", "host": self.host_id,
                      "addr": self.addr,
                      "meta": (self._offered[2]
                               if self._offered else None)})
            except (OSError, ConnectionError):
                time.sleep(0.5)
                continue
            spec = None
            while not self._stop.is_set():
                try:
                    resp, _ = call(self.controller,
                                   {"op": "poll",
                                    "host": self.host_id})
                except (OSError, ConnectionError):
                    time.sleep(0.5)
                    continue
                if resp.get("ok") and resp["gen"] > self._last_gen:
                    spec = resp
                    break
                time.sleep(0.15)
            if spec is None:
                break
            self._last_gen = spec["gen"]
            try:
                self._prepare(spec)
                self._spawn(spec)
                child = self._child
                rc = child.wait() if child is not None else -1
            except Exception:
                rc = -1
                if not self._stop.is_set():
                    # a stop() racing the spawn is an expected shutdown
                    # path, not a fault — only real failures may print
                    import traceback
                    traceback.print_exc()
            finally:
                self._reap()
            if rc != 0 and not self._stop.is_set():
                try:
                    call(self.controller, {"op": "fail",
                                           "host": self.host_id,
                                           "gen": spec["gen"]})
                except (OSError, ConnectionError):
                    pass

    def stop(self) -> None:
        self._stop.set()
        # local handle: the run thread's _reap() may null the attribute
        # between a check and the kill (the same use-after-null class
        # fixed in _spawn) — read once, then act on the copy
        child = self._child
        if child is not None:
            child.kill()
        self._reap()
        try:
            self._srv.close()
        except OSError:
            pass


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host-id", type=int, required=True)
    ap.add_argument("--controller", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--app-port", type=int, default=0)
    ap.add_argument("--app-cmd", default="")
    ap.add_argument("--round-iters", type=int, default=25)
    ap.add_argument("--cfg-json", default="")
    ap.add_argument("--worker-cpu", action="store_true",
                    help="run the workers' consensus cores on the CPU "
                         "(hands them --device cpu; without this the "
                         "workers run on the card)")
    args = ap.parse_args()
    sup = ElasticSupervisor(
        host_id=args.host_id, controller=args.controller,
        workdir=args.workdir, port=args.port, app_port=args.app_port,
        app_cmd=args.app_cmd, round_iters=args.round_iters,
        cfg_json=args.cfg_json,
        worker_device="cpu" if args.worker_cpu else "")
    print(f"supervisor h{args.host_id} serving on {sup.addr}",
          flush=True)
    try:
        sup.run()
    finally:
        sup.stop()


if __name__ == "__main__":
    main()
