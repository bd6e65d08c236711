"""Log-as-product: the ``streams/`` subsystem.

The port's copy of the JAX package's ``streams`` (host-only; the
runtime lock sanitizer's ``maybe_guard`` call is left out, as in every
copied module, ROADMAP Queue 1, item 15). ``tests/test_torch_streams.py``
holds its scan pages, watch sequences and CDC records equal to the
reference's.

APUS followers replay the committed input stream into their local app
copies — the log IS an ordered, audited, digest-verified event
stream. This package opens it as a product with three serving
surfaces over one tail-follower core (:mod:`.tail`):

* **ordered range scans** (:mod:`.scan`) — one batched read-index
  confirm per page through the ReadHub, pages served from local
  applied state at the linearization point, with a consistent-cut
  token so pagination never tears across a leader failover;
* **watch/subscribe** (:mod:`.watch`) — committed deltas per key
  range, fanned out from a dedicated pump thread with exactly-once
  resume tokens in audit coordinates ``(group, term, index)``;
* **CDC export** (:mod:`.cdc`) — a JSONL sink carrying the audit
  chain's digests, verifiable end-to-end with
  ``python -m rdma_paxos_tpu_torch.streams verify``.

Entirely host-side: no change to the step, no new device work (the
step outputs and the ops per ``step()`` are equal attached and
detached), and no tensor is touched.

Wiring: :func:`attach` hangs a :class:`StreamHub` off either engine
(``cluster.streams``); the engines' finish() tail calls
:meth:`StreamHub.observe` after the read drain and before the
governor (a deep watch backlog is demand the governor must see —
``runtime/governor.py`` consults :meth:`StreamHub.backlogs`).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from rdma_paxos_tpu_torch.consensus.state import Role
from rdma_paxos_tpu_torch.streams.cdc import CDCWriter
from rdma_paxos_tpu_torch.streams.scan import (
    ScanManager, TokenExpired, groups_for_range, key_range)
from rdma_paxos_tpu_torch.streams.tail import GroupTail
from rdma_paxos_tpu_torch.streams.watch import (
    ResumeExpired, Subscription, WatchHub)

__all__ = [
    "attach", "StreamHub", "ScanFailed", "TokenExpired",
    "ResumeExpired", "Subscription",
]


class ScanFailed(RuntimeError):
    """A scan page's read definitively failed (patience lapsed or the
    engine stopped) — the token stays valid; retry the page."""


def _n_groups(cluster) -> int:
    return cluster.G if hasattr(cluster, "G") else 1


def _leader_of(cluster, group: int) -> int:
    """Highest-term self-claimed leader (the drivers' failover view
    rule), -1 when unknown — engine-shape aware."""
    last = cluster.last
    if last is None:
        return -1
    if hasattr(cluster, "G"):
        return cluster.leader_hint(group)
    claims = [(int(last["term"][r]), r) for r in range(cluster.R)
              if int(last["role"][r]) == int(Role.LEADER)]
    return max(claims)[1] if claims else -1


class StreamHub:
    """The attached subsystem: per-group tails + the three surfaces.
    Client calls (scan/subscribe) are thread-safe; :meth:`observe`
    belongs to the engine finish() tail (readback thread) and is
    O(G) cheap — it never decodes and never blocks on a consumer."""

    def __init__(self, cluster, *, kvs=None, obs=None,
                 cdc_path: Optional[str] = None, auditor=None,
                 queue_cap: int = 1024, retain: int = 1 << 16,
                 pin_steps: int = 512, page_size: int = 64,
                 patience_steps: Optional[int] = None):
        self.cluster = cluster
        self.kvs = kvs
        self.obs = obs if obs is not None else getattr(cluster, "obs",
                                                       None)
        self.page_size = int(page_size)
        self.patience_steps = patience_steps
        self.G = _n_groups(cluster)
        self.tails = [GroupTail(cluster, g) for g in range(self.G)]
        self.cdc = None if cdc_path is None else CDCWriter(
            cdc_path, auditor=auditor, obs=self.obs)
        self.scans = ScanManager(self.tails, pin_steps=pin_steps,
                                 obs=self.obs)
        self.watch = WatchHub(self.tails, obs=self.obs,
                              queue_cap=queue_cap, retain=retain,
                              cdc=self.cdc)
        self._lock = threading.Lock()
        self._hsteps = 0          # guarded-by: _lock
        self._hstopped = False    # guarded-by: _lock

    # ---------------- engine-side (finish() tail) ----------------

    def observe(self, cluster, res) -> None:
        """Per finished step: note the new committed frontiers, kick
        the pump, tick scan-pin expiry, publish backpressure gauges."""
        lens = {t.group: t.length() for t in self.tails}
        self.watch.kick(lens)
        self.scans.on_step()
        with self._lock:
            self._hsteps += 1
        if self.obs is not None:
            if self.cdc is not None:
                cursors = self.watch.cursors()
                for g, n in lens.items():
                    self.obs.metrics.set("cdc_lag_entries",
                                         max(0, n - cursors.get(g, 0)),
                                         group=g)
            for g, depth in self.watch.backlogs().items():
                self.obs.metrics.set("watch_backlog_entries", depth,
                                     group=g)

    def backlogs(self) -> List[int]:
        """Per-group watch demand for the governor ([G] ints). Never
        takes the engine host lock (the governor calls this right
        after its own host-locked backlog read)."""
        depth = self.watch.backlogs()
        return [depth.get(g, 0) for g in range(self.G)]

    # ---------------- watch ----------------

    def subscribe(self, group: int = 0, *, prefix: bytes = None,
                  lo: bytes = None, hi: bytes = None,
                  token: Optional[dict] = None,
                  cap: Optional[int] = None) -> Subscription:
        rlo, rhi = key_range(prefix, lo, hi)
        return self.watch.subscribe(group, lo=rlo, hi=rhi,
                                    token=token, cap=cap)

    # ---------------- scan ----------------

    def _pick_replica(self, group: int) -> int:
        lm = getattr(self.cluster, "leases", None)
        if lm is not None:
            rep = lm.serving_holder(group)
            if rep is not None and rep >= 0:
                return rep
        rep = _leader_of(self.cluster, group)
        return rep if rep >= 0 else 0

    def scan(self, *, prefix: bytes = None, lo: bytes = None,
             hi: bytes = None, limit: Optional[int] = None,
             token: Optional[dict] = None, group: Optional[int] = None,
             timeout: float = 30.0, retries: int = 3) -> dict:
        """One page of an ordered range scan. Returns ``{items,
        token, done}``: ``items`` is ``[(key, value), ...]`` in key
        order, at most ``limit`` long; pass ``token`` back for the
        next page. The first page pins a consistent cut — every later
        page reads AS OF it, across leader failover (the token holds;
        only pin EXPIRY invalidates it, explicitly).

        Sharded engines fan out per group (router-aware narrowing
        when a range override covers the whole range) and merge-sort
        by key; the token carries per-group cuts."""
        limit = self.page_size if limit is None else int(limit)
        if token is not None:
            rlo = bytes.fromhex(token["lo"])
            rhi = (None if token["hi"] is None
                   else bytes.fromhex(token["hi"]))
            after = (None if token["after"] is None
                     else bytes.fromhex(token["after"]))
            gstate = {int(g): dict(s)
                      for g, s in token["groups"].items()}
        else:
            rlo, rhi = key_range(prefix, lo, hi)
            after = None
            if group is not None:
                groups = [int(group)]
            else:
                router = getattr(self.cluster, "router", None)
                groups = groups_for_range(router, rlo, rhi)
                if groups is None:
                    groups = list(range(self.G))
            gstate = {g: dict(cut=None, done=False) for g in groups}
        reads = getattr(self.cluster, "reads", None)
        if reads is None:
            raise RuntimeError(
                "streams.scan requires the ReadHub (attach reads)")
        pages = {}
        for g, st in gstate.items():
            if st["done"]:
                continue
            pages[g] = self._page_with_retries(
                reads, g, rlo, rhi, after, limit, st["cut"],
                timeout, retries)
        merged = []
        for g, page in pages.items():
            gstate[g]["cut"] = page["cut"]
            gstate[g]["term"] = page["term"]
            gstate[g]["index"] = page["index"]
            if page["done"]:
                gstate[g]["done"] = True
            merged.extend((k, v, g) for k, v in page["items"])
        merged.sort(key=lambda t: t[0])
        emit = merged[:limit]
        items = [(k, v) for k, v, _ in emit]
        leftovers = {g for _, _, g in merged[limit:]}
        for g in leftovers:
            gstate[g]["done"] = False   # re-query past the new after
        done = all(st["done"] for st in gstate.values())
        if done or not items:
            for g, st in gstate.items():
                if st.get("cut") is not None:
                    self.scans.release(g, st["cut"])
            return dict(items=items, token=None, done=True)
        new_after = items[-1][0] if items else after
        out_token = dict(
            v=1, lo=rlo.hex(),
            hi=None if rhi is None else rhi.hex(),
            after=None if new_after is None else new_after.hex(),
            groups={str(g): st for g, st in gstate.items()})
        return dict(items=items, token=out_token, done=False)

    def scan_all(self, **kw) -> List[tuple]:
        """Drain a whole scan (test/tooling convenience)."""
        items: List[tuple] = []
        page = self.scan(**kw)
        while True:
            items.extend(page["items"])
            if page["done"]:
                return items
            page = self.scan(token=page["token"])

    def _page_with_retries(self, reads, group, rlo, rhi, after,
                           limit, cut, timeout, retries) -> dict:
        last_err = "read failed"
        for _ in range(max(1, retries)):
            def serve(t, g=group, c=cut):
                return self.scans.serve_page(
                    g, rlo, rhi, after, limit, c, self.kvs)
            ticket = reads.submit(
                serve, replica=self._pick_replica(group),
                group=group, pass_ticket=True,
                patience=self.patience_steps)
            if not ticket.wait(timeout):
                raise ScanFailed(
                    f"scan page timed out after {timeout}s "
                    f"(group {group})")
            if ticket.status == "ok" and ticket.value is not None:
                page = ticket.value
                if "error" in page:
                    raise TokenExpired(page["error"])
                return page
        raise ScanFailed(
            f"scan page failed (group {group}): {last_err}")

    # ---------------- lifecycle / status ----------------

    def fail_all(self, reason: str) -> None:
        """Driver stop path: stop the pump, close every subscription,
        flush + close the CDC sink. Idempotent."""
        with self._lock:
            if self._hstopped:
                return
            self._hstopped = True
        self.watch.fail_all(reason)
        if self.cdc is not None:
            self.cdc.close()

    def status(self) -> dict:
        with self._lock:
            steps = self._hsteps
            stopped = self._hstopped
        return dict(
            groups=self.G, steps=steps, stopped=stopped,
            watch=self.watch.status(), scan=self.scans.status(),
            cdc=None if self.cdc is None else {
                str(g): self.cdc.exported(g) for g in range(self.G)})


def attach(cluster, **kw) -> StreamHub:
    """Create and wire a :class:`StreamHub` onto ``cluster`` (the
    engines consult ``cluster.streams`` at the finish() tail — same
    attach pattern as ``reads.attach``)."""
    hub = StreamHub(cluster, **kw)
    cluster.streams = hub
    return hub
