"""Nemesis runner: workload × fault schedule × invariants × checker.

The port's copy of the JAX package's ``chaos/runner.py``, over the
port's engine (``device=None`` means the card; tests pass
``device="cpu"``). With the same seed and options it gives the JAX
runner's verdict, history and audit ledger, bit for bit
(``tests/test_torch_chaos.py``). The self-healing (``repair=``),
governor and streams (``streams=``, ``cdc_path=``) modes run as in the
JAX runner (``tests/test_torch_repair.py``,
``tests/test_torch_governor.py``, ``tests/test_torch_streams.py``). All
three default to off, as in the JAX runner.

Composes the whole chaos subsystem against a live ``SimCluster`` +
``ReplicatedKVS``: a seeded client workload (sessioned PUT/RM with
retransmit-on-failover and seeded in-flight message duplication,
linearizable read-index GETs at the leader, weak GETs anywhere) runs
under a seeded :class:`~rdma_paxos_tpu_torch.chaos.faults.FaultSchedule`
while every step is checked against the I1–I5 protocol invariants and
the full client history is recorded; after the run settles, the
per-key Wing–Gong checker verdicts the client-visible contract.

Determinism: ALL randomness derives from the run seed (schedule,
workload, link model, timers); time is the logical step counter. The
same seed therefore yields a byte-identical schedule, history, and
verdict — the reproducibility contract ``tests/test_torch_chaos.py``
holds against the JAX runner.

On any violation the runner dumps a self-contained reproducer artifact
(seed, schedule JSON, history JSONL, obs trace ring, metrics snapshot)
and puts its path in the verdict; :meth:`NemesisRunner.replay` re-runs
an artifact end to end.

Fanout guard (never die mid-run): ``fanout='psum'`` cannot model
partitions — ``SimCluster.partition()``/non-full masks raise mid-step
by design. The runner refuses mask-affecting schedules on psum
clusters AT CONSTRUCTION, or — with ``skip_incompatible_faults=True``
— strips them with a single warning line and runs the rest.
"""

from __future__ import annotations

import logging
import random
from typing import Dict, List, Optional

from rdma_paxos_tpu_torch.chaos import artifact as chaos_artifact
from rdma_paxos_tpu_torch.chaos.faults import (
    FaultSchedule, HardStateTracker, LinkModel, StepTimerModel,
    generate_schedule)
from rdma_paxos_tpu_torch.chaos.history import HistoryRecorder
from rdma_paxos_tpu_torch.chaos.invariants import (
    InvariantChecker, InvariantViolation)
from rdma_paxos_tpu_torch.chaos.linearize import check_history
from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.consensus.state import Role
from rdma_paxos_tpu_torch.models.replicated_kvs import ReplicatedKVS
from rdma_paxos_tpu_torch.obs import Observability, trace as obs_trace
from rdma_paxos_tpu_torch.runtime.sim import SimCluster

log = logging.getLogger("rdma_paxos_tpu_torch.chaos")

# the JAX runner's default geometry (KVS commands are CMD_W*4 = 68
# bytes — they must fit one slot)
DEFAULT_KV_CFG = LogConfig(n_slots=128, slot_bytes=128,
                           window_slots=32, batch_slots=16)


def _leader_of(res) -> int:
    """Highest-term self-claimed leader (the driver's view rule): an
    isolated deposed leader can still claim, but terms are unique per
    leader by quorum election, so max-term picks the real one."""
    if res is None:
        return -1
    claims = [(int(res["term"][r]), r) for r in range(len(res["role"]))
              if int(res["role"][r]) == int(Role.LEADER)]
    return max(claims)[1] if claims else -1


class _Workload:
    """Seeded closed-loop clients over a ReplicatedKVS.

    Each client keeps AT MOST ONE write outstanding (the
    ``ClientSession`` protocol contract) and retransmits it — to the
    new leader after a failover — until its commit is observed or the
    client gives up (→ ambiguous). With probability ``dup_msg_p`` the
    network duplicates a client message in flight: the copy is
    re-submitted a few steps later with the SAME ``(client, req_id)``
    stamp — exactly the hazard the dedup registry exists for, and the
    signal the linearizability checker uses to catch a broken one."""

    def __init__(self, kv: ReplicatedKVS, history: HistoryRecorder,
                 seed: int, n_clients: int, n_keys: int, *,
                 p_write: float = 0.45, p_rm: float = 0.12,
                 p_read: float = 0.5, p_weak: float = 0.3,
                 dup_msg_p: float = 0.15, dup_delay: int = 4,
                 patience: int = 14, p_holder_read: float = 0.35,
                 p_follower_read: float = 0.35,
                 read_patience: int = 12):
        self.kv = kv
        self.h = history
        self.rng = random.Random(f"workload:{seed}")
        # the read-path mix (leases + read-index follower reads,
        # runtime/reads.py) draws from its OWN seeded rng so enabling
        # it never perturbs the write/weak-read sequences existing
        # seeds pin
        self.rng_reads = random.Random(f"reads:{seed}")
        self.p_holder_read = p_holder_read
        self.p_follower_read = p_follower_read
        self.read_patience = read_patience
        self.sessions = [kv.session(i + 1) for i in range(n_clients)]
        self.keys = [b"key%d" % i for i in range(n_keys)]
        self.outstanding: List[Optional[dict]] = [None] * n_clients
        self.dup_queue: List[dict] = []   # in-flight duplicated msgs
        self.p_write, self.p_rm = p_write, p_rm
        self.p_read, self.p_weak = p_read, p_weak
        self.dup_msg_p, self.dup_delay = dup_msg_p, dup_delay
        self.patience = patience
        self._vn = 0

    # ---- completion observation (after the step) ----

    def observe(self, t: int, leader: int) -> None:
        if leader < 0:
            return
        self.kv._fold(leader)
        marks = self.kv.last_req[leader]
        spans = self.kv._spans()
        for ci, out in enumerate(self.outstanding):
            if out is None:
                continue
            if marks.get(out["client"], 0) >= out["req_id"]:
                self.h.ok(out["op_id"])
                if spans is not None:
                    # the client observed its commit: the span's ack
                    spans.ack_key(out["client"], out["req_id"])
                self.outstanding[ci] = None

    # ---- issue phase (before the step) ----

    def _submit(self, sess, leader: int, out: dict) -> None:
        if out["kind"] == "put":
            self.kv.put(leader, out["key"], out["val"],
                        client_id=out["client"], req_id=out["req_id"])
        else:
            self.kv.remove(leader, out["key"],
                           client_id=out["client"],
                           req_id=out["req_id"])

    def _maybe_dup(self, t: int, out: dict) -> None:
        if self.rng.random() < self.dup_msg_p:
            self.dup_queue.append(dict(
                at=t + self.rng.randint(1, self.dup_delay), **out))

    def issue(self, t: int, leader: int, down) -> None:
        # network-duplicated copies land at whatever leader now rules
        due = [d for d in self.dup_queue if d["at"] <= t]
        self.dup_queue = [d for d in self.dup_queue if d["at"] > t]
        for d in due:
            if leader >= 0:
                self._submit(None, leader, d)
                self.h.retransmit(d["op_id"], replica=leader,
                                  network_dup=True)
        for ci, sess in enumerate(self.sessions):
            out = self.outstanding[ci]
            if out is not None:
                if t - out["issued"] > self.patience:
                    # fate unknown — ambiguous for the checker
                    self.h.timeout(out["op_id"])
                    spans = self.kv._spans()
                    if spans is not None:
                        spans.fail_key(out["client"], out["req_id"],
                                       status="timeout")
                    self.outstanding[ci] = None
                elif leader >= 0 and leader != out["to"]:
                    # failover: retransmit the SAME req_id elsewhere
                    out["to"] = leader
                    self._submit(sess, leader, out)
                    self.h.retransmit(out["op_id"], replica=leader)
                    self._maybe_dup(t, out)
                out = self.outstanding[ci]
            if out is None and leader >= 0 \
                    and self.rng.random() < self.p_write:
                key = self.rng.choice(self.keys)
                if self.rng.random() < self.p_rm:
                    rid = sess.remove(leader, key)
                    kind, val = "rm", None
                else:
                    self._vn += 1
                    val = b"c%dv%d" % (sess.client_id, self._vn)
                    rid = sess.put(leader, key, val)
                    kind = "put"
                op_id = self.h.op_id_for(sess.client_id, rid)
                rec = dict(op_id=op_id, kind=kind, key=key, val=val,
                           client=sess.client_id, req_id=rid,
                           to=leader, issued=t)
                self.outstanding[ci] = rec
                self._maybe_dup(t, rec)
        # reads: the linearizable path self-records ok/fail via the
        # history hook in ReplicatedKVS.get
        if leader >= 0 and self.rng.random() < self.p_read:
            self.kv.get(leader, self.rng.choice(self.keys),
                        linearizable=True)
        if self.rng.random() < self.p_weak:
            live = [r for r in range(self.kv.c.R) if r not in down]
            if live:
                self.kv.get(self.rng.choice(live),
                            self.rng.choice(self.keys))
        self._issue_reads(t, leader, down)

    def _issue_reads(self, t: int, leader: int, down) -> None:
        """The read-scaling mix (when the runner attached the read
        path): a linearizable read AT THE LEASE HOLDER — even a
        freshly deposed one, so chaos proves an expired/revoked lease
        refuses rather than serves stale — and a READ-INDEX read
        queued at a random live replica, drained by the hub at the
        linearization point. All linearizable: the Wing–Gong checker
        verdicts every one of them."""
        hub = getattr(self.kv.c, "reads", None)
        if hub is None:
            return
        rr = self.rng_reads
        lm = self.kv.c.leases
        if rr.random() < self.p_holder_read:
            holder = (lm.serving_holder(0) if lm is not None else -1)
            target = holder if holder >= 0 else leader
            if target >= 0 and target not in down:
                # a crashed process serves nothing; a PARTITIONED
                # holder is the interesting case and stays eligible
                self.kv.get(target, rr.choice(self.keys),
                            linearizable=True)
        if rr.random() < self.p_follower_read:
            live = [r for r in range(self.kv.c.R) if r not in down]
            if live:
                f = rr.choice(live)
                key = rr.choice(self.keys)
                op_id = self.h.invoke("get", key, replica=f)

                def done(status, value, _op=op_id):
                    if status == "ok":
                        self.h.ok(_op, value)
                    else:
                        # never served: definitively did not happen
                        self.h.fail(_op, reason="read_unserved")

                hub.submit(
                    lambda f=f, k=key: self.kv.serve_local(f, k),
                    replica=f, patience=self.read_patience,
                    step0=t, on_done=done)

    def finish(self) -> None:
        """Run end: every still-unresolved op is ambiguous."""
        for out in self.outstanding:
            if out is not None:
                self.h.timeout(out["op_id"])
        for op_id in self.h.pending():
            self.h.timeout(op_id)


class NemesisRunner:
    """One seeded chaos run over a fresh in-process cluster."""

    def __init__(self, cfg: Optional[LogConfig] = None,
                 n_replicas: int = 3, *, seed: int = 0,
                 steps: int = 120, schedule: Optional[FaultSchedule]
                 = None, fault_kinds=("partition", "crash", "drop",
                                      "delay", "dup", "skew"),
                 n_clients: int = 2, n_keys: int = 3,
                 workload_opts: Optional[dict] = None,
                 fanout: str = "gather", kvs_cap: int = 256,
                 settle_steps: int = 30,
                 artifact_path: Optional[str] = None,
                 skip_incompatible_faults: bool = False,
                 obs: Optional[Observability] = None,
                 audit: bool = True, pipeline: int = 0,
                 scan: bool = False,
                 governor: bool = False,
                 leases: bool = True,
                 repair: bool = False,
                 corrupt_step: Optional[int] = None,
                 corrupt_offset: int = 1,
                 repair_opts: Optional[dict] = None,
                 streams: bool = False,
                 cdc_path: Optional[str] = None,
                 device=None):
        self.cfg = cfg or DEFAULT_KV_CFG
        self.R = int(n_replicas)
        self.seed = int(seed)
        self.steps = int(steps)
        self.settle_steps = int(settle_steps)
        self.artifact_path = artifact_path
        self.workload_opts = dict(workload_opts or {})
        self.obs = obs if obs is not None else Observability()
        # chaos runs are short and their whole point is post-mortem
        # evidence: trace EVERY command so a violation artifact ships
        # the complete causal timeline — but only on a runner-OWNED
        # facade; a caller-supplied (possibly shared, possibly live-
        # production) facade keeps its configured sampling rate
        if obs is None:
            self.obs.spans.set_sample_every(1)
        if schedule is None:
            schedule = generate_schedule(seed, self.R, steps,
                                         kinds=fault_kinds)
        schedule.validate(self.R)
        # fanout guard — up front, never mid-run (see module docstring)
        if fanout == "psum" and schedule.mask_affecting():
            if not skip_incompatible_faults:
                raise ValueError(
                    "fanout='psum' cannot model partitions/crashes/"
                    "link faults (single-contributor broadcast needs "
                    "full connectivity); build with fanout='gather' "
                    "or pass skip_incompatible_faults=True")
            n_dropped = len(schedule.mask_affecting())
            schedule = schedule.without_mask_faults()
            log.warning(
                "chaos: fanout='psum' — skipping %d mask-affecting "
                "fault(s) (partition/crash/drop/delay need 'gather')",
                n_dropped)
        self.schedule = schedule
        # chaos runs audit at 100% by default: every committed entry is
        # digest-checked across replicas every step, so a run that
        # passes also PROVES bit-identical replicated state under the
        # schedule (and a divergence ships audit + flight evidence in
        # the reproducer artifact)
        self.cluster = SimCluster(self.cfg, self.R, fanout=fanout,
                                  audit=audit, device=device)
        self.cluster.obs = self.obs
        # self-healing mode (runtime/repair.py): a scripted bit
        # corruption at ``corrupt_step`` (victim = leader +
        # ``corrupt_offset``, target = the min committed index — both
        # derived from protocol state, so same-seed runs corrupt the
        # same slot) is detected by the audit, quarantined, repaired
        # from a ledger-majority donor, backfilled, and re-admitted —
        # and the verdict requires the loop to have CLOSED (zero
        # unrepaired findings, no replica still held). Without the
        # repair pipeline the verdict reports the divergence. The
        # repair timeline (step-domain, deterministic) rides the verdict
        # and any reproducer artifact.
        self.repairer = None
        if repair:
            if not audit:
                raise ValueError("repair=True requires audit=True")
            from rdma_paxos_tpu_torch.runtime.repair import RepairController
            self.repairer = RepairController(self.cluster,
                                             obs=self.obs,
                                             **(repair_opts or {}))
        self.corrupt_step = corrupt_step
        self.corrupt_offset = int(corrupt_offset)
        self.corrupted: Optional[tuple] = None   # (victim, index)
        # read path (runtime/reads.py): chaos runs exercise leader
        # leases + read-index follower reads BY DEFAULT — every
        # linearizable read lands in the checked history, so a lease
        # serving stale state under the schedule is a caught
        # violation, and the lease timeline (grant/renew/expire/
        # revoke) rides the trace ring into any reproducer artifact
        if leases:
            from rdma_paxos_tpu_torch.runtime import reads as reads_mod
            reads_mod.attach(self.cluster)
        self.link = LinkModel(self.R, seed=seed)
        self.link.obs = self.obs
        self.cluster.link_model = self.link
        self.kv = ReplicatedKVS(self.cluster, cap=kvs_cap)
        # streams=True: an all-keys watch subscription rides the whole
        # run and the verdict proves EXACTLY-ONCE delivery against an
        # independent fold of the committed stream — including across
        # two scripted close-and-resume-with-token reconnects at
        # seeded mid-run steps (leader crashes land in between under
        # any crash-bearing schedule). Its rng is separate, so pinned
        # seeds' workload/schedule sequences are unchanged. cdc_path
        # additionally exports every pumped record for
        # ``streams verify`` against the run's audit ledger.
        self.streams_hub = None
        self._watch_sub = None
        self._watch_events: List = []
        self._watch_resumes = 0
        if streams:
            from rdma_paxos_tpu_torch import streams as streams_mod
            rng_s = random.Random(f"streams:{seed}")
            self.streams_hub = streams_mod.attach(
                self.cluster, kvs=self.kv, obs=self.obs,
                cdc_path=cdc_path, auditor=self.cluster.auditor)
            self._watch_sub = self.streams_hub.subscribe(0)
            lo, hi = max(2, steps // 4), max(3, steps // 2)
            self._watch_resume_at = {
                rng_s.randrange(lo, hi),
                rng_s.randrange(hi, max(hi + 1, (3 * steps) // 4))}
        self.history = HistoryRecorder()
        self.kv.history = self.history
        self.hard = HardStateTracker(self.R)
        self.timers = StepTimerModel(self.R, seed=seed)
        self.invariants = InvariantChecker(self.R)
        self.workload = _Workload(self.kv, self.history, seed,
                                  n_clients, n_keys,
                                  **self.workload_opts)
        self.n_clients, self.n_keys = n_clients, n_keys
        self.fanout = fanout
        # pipeline >= 2: drive the cluster the way the pipelined
        # driver does — up to that many dispatches in flight on the
        # stable-leader path (begin_step, ring-room checked), draining
        # to the serial step whenever a fault event is due, a timer
        # fires, or the leader is unknown. The chaos verdict must stay
        # green: pipelining is a pure latency transform.
        self.pipeline = int(pipeline)
        self._pl: List[tuple] = []  # (logical step id, ticket) in flight
        # scan=True: stable-leader traffic iterations ride the
        # device-resident K-window scan tier (cluster.step_burst with
        # the scan program — fused steps, consolidated readback,
        # in-dispatch replay rows), DRAINING TO THE SERIAL single-step
        # path the moment a fault event is due, a timer fires, or the
        # leader is unknown — so a leader crash mid-run is handled by
        # exactly the election machinery the serial drive uses. The
        # verdict must stay green: the scan tier is bit-identical to
        # serial steps (tests/test_torch_scan.py pins it engine-level).
        self.scan = bool(scan)
        if scan:
            if pipeline >= 2:
                raise ValueError(
                    "runner scan mode and pipelined mode are "
                    "mutually exclusive (bursts are serial-path)")
            self.cluster.scan = True
        # governor=True: the adaptive dispatch governor rides the run —
        # observed on every finish (the engine's hook), consulted by the
        # fused/pipelined drives, and DRAINED TO SERIAL exactly like
        # elections and repair: any iteration with a fault event due, a
        # timer firing, or an unknown leader runs the serial single step
        # regardless of the governor's tier, and a serial governor
        # decision itself forces the serial path. Decisions are pure
        # step-domain functions of the observed backlog and arrival
        # stream, so same-seed verdicts stay bit-reproducible.
        self.governor = None
        if governor:
            from rdma_paxos_tpu_torch.runtime.governor import attach_governor
            self.governor = attach_governor(self.cluster, obs=self.obs)

    # ------------------------------------------------------------------

    def _config_doc(self) -> dict:
        return dict(
            log=dict(n_slots=self.cfg.n_slots,
                     slot_bytes=self.cfg.slot_bytes,
                     window_slots=self.cfg.window_slots,
                     batch_slots=self.cfg.batch_slots,
                     rebase_threshold=self.cfg.rebase_threshold),
            n_replicas=self.R, steps=self.steps,
            settle_steps=self.settle_steps, fanout=self.fanout,
            n_clients=self.n_clients, n_keys=self.n_keys,
            workload_opts=self.workload_opts)

    def _observe_res(self, t: int, res,
                     violations: List[dict]) -> int:
        """Post-step observation rules for one finished step's outputs
        (shared by the serial and pipelined drives)."""
        self.hard.observe(res)
        self.timers.observe(res)
        try:
            self.invariants.check_step(
                res, step=t, rebased_total=self.cluster.rebased_total)
        except InvariantViolation as v:
            violations.append(v.as_dict())
            self.obs.trace.record(obs_trace.NEMESIS_VIOLATION,
                                  **v.as_dict())
        leader = _leader_of(res)
        self.workload.observe(t, leader)
        if self._watch_sub is not None:
            self._watch_events.extend(self._watch_sub.poll(
                max_n=1 << 16))
            if t in self._watch_resume_at:
                # scripted reconnect: resume from the last CONSUMED
                # event's token — the exactly-once contract says the
                # concatenated event sequence must stay gapless and
                # duplicate-free across it
                tok = (self._watch_events[-1].token()
                       if self._watch_events else None)
                self._watch_sub.close()
                self._watch_sub = self.streams_hub.subscribe(
                    0, token=tok)
                self._watch_resumes += 1
        if self.repairer is not None:
            self.repairer.observe()
        return leader

    def _finish_one(self, violations: List[dict]) -> int:
        t, ticket = self._pl.pop(0)
        res = self.cluster.finish(ticket)
        return self._observe_res(t, res, violations)

    def _drain(self, leader: int, violations: List[dict]) -> int:
        while self._pl:
            leader = self._finish_one(violations)
        return leader

    def _pipeline_eligible(self, t: int, leader: int) -> bool:
        """The stable-leader dispatch-without-finishing window: no
        fault event due this step, a known leader, an initialized
        cluster. Ring room is checked separately (``_room_ok``) AFTER
        the workload issues this step's entries — a pre-issue check
        would not cover them."""
        if self.pipeline < 2:
            return False
        # a governor that has disengaged pipelining (or shed to serial)
        # drains the in-flight window — the same serial-path discipline
        # elections and repair use
        if (self.governor is not None
                and not self.governor.decision.pipeline):
            return False
        return self._stable_window(t, leader)

    def _corrupt_due(self, t: int) -> bool:
        return (self.corrupt_step is not None
                and self.corrupted is None
                and t >= self.corrupt_step)

    def _timer_excluded(self):
        """Replicas whose election timers must not fire: crashed ones
        and — under repair — quarantined/probation ones (an isolated
        quarantined replica's futile candidacies would only inflate its
        local term; a probation replica must not lead)."""
        if self.repairer is None:
            return self.link.down
        return self.link.down | self.repairer.blocked_replicas(0)

    def _room_ok(self) -> bool:
        """Ring room for the WHOLE pending backlog (including entries
        the workload just issued), so a shortfall requeue — which
        would reorder against in-flight dispatches — is impossible;
        elections cannot start in flight because in-flight dispatches
        carried no timeouts."""
        c = self.cluster
        reserved = c.reserved_appends()
        last = c.last
        return all(
            len(c.pending[r]) + int(reserved[r])
            <= (self.cfg.n_slots - 1) - (int(last["end"][r])
                                         - int(last["head"][r]))
            for r in range(self.R))

    def _stable_window(self, t: int, leader: int) -> bool:
        """The shared fused-dispatch eligibility predicate (pipelined
        AND scan drives): a known leader, an initialized cluster, no
        fault event due this step, no corruption pending, no repair
        needing a drained serial iteration."""
        if leader < 0:
            return False
        if self._corrupt_due(t):
            return False
        if self.repairer is not None and self.repairer.needs_drain():
            return False
        return (self.cluster.last is not None
                and not self.schedule.due(t))

    def _scan_eligible(self, t: int, leader: int) -> bool:
        """The scan tier's window: the shared stable-window rule PLUS
        no per-step-random link fault active. A K-fused dispatch
        samples the link model's effective mask ONCE for all K steps,
        so active drop/delay/dup state (whose randomness keys on the
        per-step clock) would be under-injected inside a scan — drain
        to the serial path until it clears. Static masks (crashes,
        blocks, partitions) apply identically on every fused step and
        fuse soundly."""
        if not self.scan:
            return False
        if self.link.drop or self.link.delay or self.link.dup:
            return False
        # a serial governor decision drains the scan tier too
        if (self.governor is not None
                and self.governor.decision.max_k <= 1):
            return False
        return self._stable_window(t, leader)

    def _one_step(self, t: int, leader: int,
                  violations: List[dict]) -> int:
        self.history.set_clock(t)
        if self._scan_eligible(t, leader):
            self.workload.issue(t, leader, self.link.down)
            timeouts = self.timers.fire(self._timer_excluded())
            if (not timeouts and self._room_ok()
                    and any(len(q) for q in self.cluster.pending)):
                # K-window scan dispatch (K sized to the backlog,
                # capped at the governor's rung when one is attached)
                res = self.cluster.step_burst(
                    max_k=(self.governor.decision.max_k
                           if self.governor is not None else None))
            else:
                res = self.cluster.step(timeouts=timeouts)
            return self._observe_res(t, res, violations)
        if self._pipeline_eligible(t, leader):
            self.workload.issue(t, leader, self.link.down)
            timeouts = self.timers.fire(self._timer_excluded())
            if not timeouts and self._room_ok():
                self._pl.append((t, self.cluster.begin_step()))
                if len(self._pl) >= self.pipeline:
                    leader = self._finish_one(violations)
                return leader
            # a timer fired (or the ring can no longer cover the
            # issued backlog): drain and run the serial step
            leader = self._drain(leader, violations)
            res = self.cluster.step(timeouts=timeouts)
            return self._observe_res(t, res, violations)
        # serial path: fault events mutate cluster/link state and must
        # never run under in-flight dispatches
        leader = self._drain(leader, violations)
        if self._corrupt_due(t) and leader >= 0 \
                and self.cluster.last is not None \
                and int(self.cluster.last["commit"].min()) >= 1:
            from rdma_paxos_tpu_torch.chaos.faults import corrupt_slot
            victim = (leader + self.corrupt_offset) % self.R
            target = int(self.cluster.last["commit"].min()) - 1
            corrupt_slot(self.cluster, victim, target)
            self.corrupted = (victim, target)
        if self.repairer is not None:
            for (_g, rr) in self.repairer.drive():
                # a snapshot re-install legitimately rewrites the
                # repaired replica's offsets — same invariant-baseline
                # reset as a crash restart
                self.invariants.reset_replica(rr)
        fired = self.schedule.apply(t, self.cluster, self.link,
                                    timers=self.timers, hard=self.hard,
                                    kvs=self.kv)
        for ev in fired:
            if ev["op"] == "restart":
                self.invariants.reset_replica(ev["replica"])
        self.workload.issue(t, leader, self.link.down)
        timeouts = self.timers.fire(self._timer_excluded())
        res = self.cluster.step(timeouts=timeouts)
        return self._observe_res(t, res, violations)

    def run(self) -> Dict:
        """Execute the schedule, settle, check. Returns the verdict
        dict (deterministic for a given seed: no wall-clock fields);
        writes a reproducer artifact when anything failed."""
        violations: List[dict] = []
        leader = -1
        for t in range(self.steps):
            leader = self._one_step(t, leader, violations)
            if violations:
                break
        # drain any in-flight pipelined dispatches before host-side
        # state surgery (restarts) or the convergence sweep
        leader = self._drain(leader, violations)
        # settle: clear faults, revive the dead, let the cluster
        # converge so the convergence invariant and pending ops resolve
        self.history.set_clock(self.steps)
        self.link.heal()
        if not violations:
            from rdma_paxos_tpu_torch.chaos.faults import restart_replica
            for r in sorted(self.link.down):
                restart_replica(self.cluster, r, self.link,
                                hard=self.hard, kvs=self.kv)
                self.invariants.reset_replica(r)
            for t in range(self.steps, self.steps + self.settle_steps):
                leader = self._one_step(t, leader, violations)
                if violations:
                    break
            leader = self._drain(leader, violations)
        if self.cluster.reads is not None:
            # still-queued reads will never be confirmed: fail them
            # (their history records close as FAIL — constraint-free)
            self.cluster.reads.fail_all("run end")
        self.workload.finish()
        if not violations:
            try:
                self.invariants.check_convergence(self.cluster.replayed)
            except InvariantViolation as v:
                violations.append(v.as_dict())
        linz = check_history(self.history.ops())
        audit_summary = (self.cluster.auditor.summary()
                         if self.cluster.auditor is not None else None)
        repair_summary = (self.repairer.status()
                          if self.repairer is not None else None)
        if self.repairer is not None:
            # self-healing acceptance: the loop must have CLOSED — every
            # divergence repaired and backfilled, no replica still
            # quarantined, on probation or escalated
            audit_ok = (audit_summary is not None
                        and audit_summary["unrepaired"] == 0
                        and not repair_summary["active"])
        else:
            audit_ok = (audit_summary is None
                        or audit_summary["findings"] == 0)
        streams_summary = (self._streams_summary()
                           if self.streams_hub is not None else None)
        streams_ok = (streams_summary is None
                      or (streams_summary["dups"] == 0
                          and streams_summary["gaps"] == 0))
        ok = (not violations and linz["ok"] is True and audit_ok
              and streams_ok)
        verdict: Dict = dict(
            ok=ok, seed=self.seed, steps=self.steps,
            schedule_events=len(self.schedule),
            invariant_violations=violations,
            linearizability=dict(ok=linz["ok"],
                                 violations=linz["violations"],
                                 undecided=linz["undecided"],
                                 ops=linz["ops"],
                                 states=linz["states"]),
            audit=audit_summary,
            repair=repair_summary,
            corrupted=self.corrupted,
            history_events=len(self.history),
            client_ops=len(self.history.ops(include_weak=True)),
        )
        if self.cluster.reads is not None:
            # deterministic read-path summary: per-path served totals
            # (registry accounting), hub state, lease timeline counts
            from rdma_paxos_tpu_torch.runtime.reads import read_counts
            verdict["reads"] = dict(
                read_counts(self.obs),
                hub=self.cluster.reads.status(),
                leases=self.cluster.leases.status())
        if self.governor is not None:
            # pure step-domain controller state: same seed -> same tier
            # sequence -> identical summary
            verdict["governor"] = self.governor.status()
        if streams_summary is not None:
            verdict["streams"] = streams_summary
        if not ok:
            # ok=None (state budget exceeded) is NOT a found violation —
            # label it honestly so nobody chases a bug that was never
            # detected; the artifact still ships for a deeper re-check
            reason = ("invariant violation" if violations
                      else "linearizability violation"
                      if linz["violations"]
                      else "audit divergence" if not audit_ok
                      else "watch delivery violated exactly-once"
                      if not streams_ok
                      else "linearizability undecided "
                           "(checker state budget exceeded)")
            verdict["artifact"] = chaos_artifact.write_reproducer(
                self.artifact_path, seed=self.seed,
                schedule=self.schedule, reason=reason,
                config=self._config_doc(),
                history=self.history.to_jsonl(),
                violation=dict(invariants=violations,
                               linearizability={
                                   "violations": linz["violations"],
                                   "undecided": linz["undecided"]},
                               audit=audit_summary),
                obs=self.obs, extra={
                    "verdict": {k: v for k, v in verdict.items()
                                if k != "artifact"},
                    # the audit ledger dump + flight-recorder ring ride
                    # every reproducer so a divergence is localizable
                    # (and the seeded run replayable) from the artifact
                    "audit": (self.cluster.auditor.dump()
                              if self.cluster.auditor is not None
                              else None),
                    "repair": repair_summary,
                    "flight": (self.cluster.flight.dump()
                               if self.cluster.flight is not None
                               else None)})
        elif (self.artifact_path and repair_summary is not None
                and repair_summary["timeline"]):
            # a HEALED run still ships its evidence when asked: the
            # deterministic repair timeline and ledger (with the repair
            # records closing the findings) — the self-healing loop's
            # post-incident document
            verdict["artifact"] = chaos_artifact.write_reproducer(
                self.artifact_path, seed=self.seed,
                schedule=self.schedule,
                reason="divergence repaired (self-healed)",
                config=self._config_doc(),
                history=self.history.to_jsonl(),
                violation=dict(invariants=[], linearizability={},
                               audit=audit_summary),
                obs=self.obs, extra={
                    "verdict": {k: v for k, v in verdict.items()
                                if k != "artifact"},
                    "audit": self.cluster.auditor.dump(),
                    "repair": repair_summary,
                    "flight": (self.cluster.flight.dump()
                               if self.cluster.flight is not None
                               else None)})
        return verdict

    def _streams_summary(self) -> Dict:
        """Flush the watch pump to the final committed frontier, drain
        the subscription, and verdict exactly-once delivery against an
        INDEPENDENT fold of the committed stream. Identity is the
        ``(conn, req)`` pair — the dedup registry's own key, stable
        whether or not log coordinates survived restarts — so the
        check is: zero duplicates, zero gaps, and in committed order,
        across every scripted token resume. Deterministic for a seed:
        the committed stream and the event set are; only the
        resume split points move within it."""
        from rdma_paxos_tpu_torch.streams.tail import (
            DedupFold, OP_PUT, OP_RM, decode_kvs)
        hub = self.streams_hub
        tail = hub.tails[0]
        hub.watch.wait_caught_up({0: tail.length()})
        self._watch_events.extend(self._watch_sub.poll(max_n=1 << 20))
        fold = DedupFold()
        expect = []
        for rec in tail.records(0):
            if not fold.accept(rec):
                continue
            cmd = decode_kvs(rec.payload)
            if cmd is not None and cmd[0] in (OP_PUT, OP_RM):
                expect.append((rec.conn, rec.req))
        got = [(e.conn, e.req) for e in self._watch_events]
        seen = set()
        dups = 0
        for ident in got:
            if ident in seen:
                dups += 1
            seen.add(ident)
        gaps = sum(1 for ident in expect if ident not in seen)
        hub.fail_all("run end")
        return dict(events=len(got), expected=len(expect), dups=dups,
                    gaps=gaps, ordered=(got == expect),
                    resumes=self._watch_resumes,
                    cdc=(hub.cdc.exported(0) if hub.cdc is not None
                         else None))

    # ------------------------------------------------------------------

    @classmethod
    def replay(cls, path: str, **overrides) -> Dict:
        """Re-run a reproducer artifact: same seed, same schedule, same
        config — the deterministic harness reproduces the same history
        and verdict (the whole point of the artifact)."""
        doc = chaos_artifact.load_reproducer(path)
        cfg_doc = doc["config"]
        kw = dict(
            cfg=LogConfig(**cfg_doc["log"]),
            n_replicas=cfg_doc["n_replicas"],
            seed=doc["seed"], steps=cfg_doc["steps"],
            settle_steps=cfg_doc.get("settle_steps", 30),
            schedule=FaultSchedule(doc["schedule"]),
            fanout=cfg_doc.get("fanout", "gather"),
            n_clients=cfg_doc.get("n_clients", 2),
            n_keys=cfg_doc.get("n_keys", 3),
            workload_opts=cfg_doc.get("workload_opts") or {},
        )
        kw.update(overrides)
        return cls(**kw).run()
