"""Builders of the protocol step: R replicas stacked on one device
(the JAX package's ``vmap``-simulated replica axis), or one replica per
process of a ``torch.distributed`` world (its ``shard_map`` over a
replica mesh whose devices live in different processes).

Each builder returns a plain function over tensors; there is nothing to
compile, so a "build" only binds the static configuration. The fused
K-step burst and scan are Python loops of the stable step (the JAX
``lax.scan``). The state is updated in place and returned.

The group builders (``build_sim_group_*``) step G independent groups of
R replicas stacked ``[G, R, ...]`` in one pass: the step is written over
leading batch axes, so they bind the same functions with the JAX
builders' ``[K, G, R, ...]`` input contract, and one step of every
group is one set of launches.

The spmd builders (``build_spmd_step``, ``build_spmd_burst``,
``build_spmd_scan``) run the same step over a :class:`ReplicaWorld`, the
counterpart of ``make_replica_mesh``: each process holds its one
replica's row ``[1, ...]`` and the step's five collectives go through
the world's gloo process group (see ``consensus/step.py``). The world
fixes its backend and its staging when it is built: CPU tensors travel
as they are; CUDA tensors are copied to the host explicitly before
each collective and back after it (gloo's collectives are for CPU
tensors; NCCL refuses two ranks on one card), and :meth:`ReplicaWorld.
describe` says so. The 2-D mesh (``build_mesh_2d``, ``group_sharding``,
``build_spmd_group_*``) comes with the single-controller engines
(ROADMAP Queue 1, item 14).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Sequence

import torch

from rdma_paxos_tpu_torch.consensus.log import extract_window
from rdma_paxos_tpu_torch.consensus.state import (
    ReplicaState, make_replica_state, map_state)
from rdma_paxos_tpu_torch.consensus.step import (
    OUTPUT_FIELDS, VARIANT_FIELDS, StepInput, StepOutput, replica_step,
    scan_readback)


def stack_states(cfg, n_replicas: int, group_size: int, *, device
                 ) -> ReplicaState:
    """Batched initial state: every field gains a leading replica axis."""
    one = make_replica_state(cfg, group_size, n_replicas, device=device)
    return map_state(
        lambda x: x.expand((n_replicas,) + tuple(x.shape)).clone(), one)


def stack_group_states(cfg, n_groups: int, n_replicas: int,
                       group_size: int, *, device) -> ReplicaState:
    """Batched initial state for G groups: every field gains leading
    ``[group, replica]`` axes, every group starting from the same
    per-replica state. Each group gets its own CLONE: the step updates
    the state in place, so an expanded view (the JAX ``broadcast_to``)
    would alias one ring across every group."""
    one = make_replica_state(cfg, group_size, n_replicas, device=device)
    return map_state(
        lambda x: x.expand((n_groups, n_replicas) + tuple(x.shape)).clone(),
        one)


def _stack_outputs(outs) -> StepOutput:
    """Stack K steps' outputs ``[K, ...]``; a variant's field that is
    off (None) stays None."""
    return StepOutput(**{k: torch.stack([getattr(o, k) for o in outs])
                         for k in OUTPUT_FIELDS + VARIANT_FIELDS
                         if getattr(outs[0], k) is not None})


def build_sim_step(cfg, n_replicas: int, *, fanout: str = "gather",
                   elections: bool = True, audit: bool = False,
                   telemetry: bool = False, txn: bool = False):
    """``fn(state, inp) -> (state, out)``: one step of all replicas."""
    return functools.partial(
        replica_step, cfg=cfg, n_replicas=n_replicas, fanout=fanout,
        elections=elections, audit=audit, telemetry=telemetry, txn=txn)


def _burst_steps(cfg, n_replicas, fanout, audit, telemetry, exchange,
                 state, datas, metas, counts, peer_mask, applied, qdepth):
    """The K stable steps of a burst: no timeouts fire, the host apply
    cursors ``applied`` stay frozen (the host cannot replay mid-burst),
    ``qdepth`` is the backlog remaining beyond the burst."""
    zeros_r = torch.zeros_like(applied)
    for k in range(datas.shape[0]):
        inp = StepInput(batch_data=datas[k], batch_meta=metas[k],
                        batch_count=counts[k], timeout_fired=zeros_r,
                        peer_mask=peer_mask, apply_done=applied,
                        queue_depth=qdepth)
        state, out = replica_step(state, inp, cfg=cfg,
                                  n_replicas=n_replicas, fanout=fanout,
                                  elections=False, audit=audit,
                                  telemetry=telemetry, exchange=exchange)
        yield state, out


def _build_burst(cfg, n_replicas, fanout, audit, telemetry, exchange):
    def burst(state, datas, metas, counts, peer_mask, applied, qdepth):
        outs = []
        for state, out in _burst_steps(cfg, n_replicas, fanout, audit,
                                       telemetry, exchange, state, datas,
                                       metas, counts, peer_mask, applied,
                                       qdepth):
            outs.append(out)
        return state, _stack_outputs(outs)
    return burst


def _build_scan(cfg, n_replicas, replay_slots, fanout, audit, telemetry,
                exchange):
    def scan(state, datas, metas, counts, peer_mask, applied, qdepth):
        acc = torch.zeros_like(applied)
        ys = []
        for state, out in _burst_steps(cfg, n_replicas, fanout, audit,
                                       telemetry, exchange, state, datas,
                                       metas, counts, peer_mask, applied,
                                       qdepth):
            acc = acc + out.accepted
            ys.append(scan_readback(out, acc, audit=audit,
                                    telemetry=telemetry))
        res = {k: torch.stack([y[k] for y in ys]) for k in ys[0]}
        res["replay_data"], res["replay_meta"] = extract_window(
            state.log, applied, replay_slots)
        return state, res
    return scan


def build_sim_burst(cfg, n_replicas: int, *, fanout: str = "gather",
                    audit: bool = False, telemetry: bool = False):
    """K protocol steps in one call: ``burst(state, datas [K,R,B,sw],
    metas [K,R,B,MW], counts [K,R], peer_mask [R,R], applied [R],
    qdepth [R]) -> (state, outs)`` with every output field stacked
    ``[K, ...]`` (the ``audit=``/``telemetry=`` fields of every step
    too, when on)."""
    return _build_burst(cfg, n_replicas, fanout, audit, telemetry, None)


def build_sim_scan(cfg, n_replicas: int, *, replay_slots: int,
                   fanout: str = "gather", audit: bool = False,
                   telemetry: bool = False):
    """The K-window scan tier: the burst's K steps with ONE consolidated
    readback — ``scal [K, R, len(SCAN_KEYS)]`` (``accepted``
    cumulative), ``peer_acked [K, R, R]`` and ``replay_slots`` rows per
    replica from the PRE-scan apply cursors of the post-scan log
    (``replay_data``/``replay_meta``), plus every step's audit windows
    and telemetry vectors ``[K, ...]`` when those variants are on."""
    return _build_scan(cfg, n_replicas, replay_slots, fanout, audit,
                       telemetry, None)


def build_sim_group_step(cfg, n_replicas: int, *, fanout: str = "gather",
                         elections: bool = True, audit: bool = False,
                         telemetry: bool = False, txn: bool = False):
    """``fn(state, inp) -> (state, out)``: one protocol step of every
    group of a ``[G, R, ...]`` state, in one pass (the G count is not
    bound: any stack of groups sharing ``cfg`` runs through it). With
    ``txn=True`` the input carries ``txn_watch``/``txn_term`` ``[G, R]``
    (each group's watch repeated over its replicas) and the output the
    ``[G, R]`` vote matrix; bursts and scans never carry the lane."""
    return build_sim_step(cfg, n_replicas, fanout=fanout,
                          elections=elections, audit=audit,
                          telemetry=telemetry, txn=txn)


def build_sim_group_burst(cfg, n_replicas: int, *, fanout: str = "gather",
                          audit: bool = False, telemetry: bool = False):
    """:func:`build_sim_burst` over every group: ``burst(state, datas
    [K,G,R,B,sw], metas [K,G,R,B,MW], counts [K,G,R], peer_mask
    [G,R,R], applied [G,R], qdepth [G,R])`` — the single-group burst's
    contract applied per group, one pass per protocol step."""
    return build_sim_burst(cfg, n_replicas, fanout=fanout, audit=audit,
                           telemetry=telemetry)


def build_sim_group_scan(cfg, n_replicas: int, *, replay_slots: int,
                         fanout: str = "gather", audit: bool = False,
                         telemetry: bool = False):
    """:func:`build_sim_scan` over every group (inputs as
    :func:`build_sim_group_burst`; the readback's axes gain ``G`` after
    ``K``, the replay rows are ``[G, R, replay_slots, ...]``)."""
    return build_sim_scan(cfg, n_replicas, replay_slots=replay_slots,
                          fanout=fanout, audit=audit, telemetry=telemetry)


# ---------------------------------------------------------------------------
# one replica per process: the replica world and the spmd builders
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReplicaWorld:
    """This process's place in a world of R processes, one consensus
    replica each — the counterpart of the JAX ``make_replica_mesh`` over
    devices of different hosts. It carries the rank (which is the
    replica index ``me``), the world size, the process group, the device
    the replica's state lives on, the backend and the staging of the
    collectives, and it is the ``exchange`` the replica step takes:
    :meth:`all_gather` and :meth:`all_sum` are its seams' collectives.

    Every exchange packs its messages into ONE int64 buffer (exact for
    i32 words and for u32 values held in int64), so a seam is one
    collective. ``exchanges`` and ``exchange_s`` count the collectives
    and their host wall time, the staging copies included."""

    rank: int
    size: int
    group: object
    device: torch.device
    backend: str
    staging: str                  # "none" (CPU tensors) or "host"
    me: torch.Tensor = None       # [1] i32: the rank
    peer: torch.Tensor = None     # [1, R] i32: every sender's index
    exchanges: int = 0
    exchange_s: float = 0.0

    def __post_init__(self):
        self.me = torch.tensor([self.rank], dtype=torch.int32,
                               device=self.device)
        self.peer = torch.arange(self.size, dtype=torch.int32,
                                 device=self.device)[None, :]

    def describe(self) -> str:
        return (f"replica world: rank {self.rank} of {self.size}, backend "
                f"{self.backend}, device {self.device}, staging "
                f"{self.staging}")

    def _pack(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        buf = torch.cat([t.reshape(-1).to(torch.int64) for t in tensors])
        return buf.cpu() if self.staging == "host" else buf

    def _unpack(self, buf: torch.Tensor, tensors, lead: int) -> tuple:
        if self.staging == "host":
            buf = buf.to(self.device)
        out, at = [], 0
        for t in tensors:
            n = t[0].numel()
            out.append(buf[:, at:at + n].reshape(lead, *t.shape[1:])
                       .to(t.dtype))
            at += n
        return tuple(out)

    def all_gather(self, tensors: Sequence[torch.Tensor]) -> tuple:
        """Each local ``[1, ...]`` message -> the ``[R, ...]`` messages of
        every rank, in rank order (the JAX ``lax.all_gather``)."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        buf = self._pack(tensors)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        out = self._unpack(torch.stack(parts), tensors, self.size)
        self.exchanges += 1
        self.exchange_s += time.perf_counter() - t0
        return out

    def all_sum(self, tensors: Sequence[torch.Tensor]) -> tuple:
        """Each local ``[1, ...]`` message -> its sum over every rank,
        ``[1, ...]`` (the JAX ``lax.psum``), summed in int64: exact for
        the single-contributor window fan-out."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        buf = self._pack(tensors)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        out = self._unpack(buf[None], tensors, 1)
        self.exchanges += 1
        self.exchange_s += time.perf_counter() - t0
        return out


def make_replica_world(n_replicas: int, *, device,
                       group=None) -> ReplicaWorld:
    """The replica world of this process in an initialised
    ``torch.distributed`` process group of ``n_replicas`` ranks (the
    default group unless ``group`` is given): rank r is replica r.
    Only gloo is taken (NCCL refuses two ranks on one card; a world of
    one rank per card is ROADMAP work), and the staging follows the
    device: explicit host copies around every collective for a CUDA
    device, none for the CPU."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_replica_world: torch.distributed is not "
                           "initialised (init_process_group first)")
    size = dist.get_world_size(group)
    if size != n_replicas:
        raise ValueError(f"need a world of {n_replicas} ranks, have {size}")
    backend = str(dist.get_backend(group))
    if backend != "gloo":
        raise ValueError(f"the replica world runs on gloo, not {backend}")
    device = torch.device(device)
    return ReplicaWorld(rank=dist.get_rank(group), size=size, group=group,
                        device=device, backend=backend,
                        staging="host" if device.type == "cuda" else "none")


def local_state(cfg, n_replicas: int, group_size: int, *, device
                ) -> ReplicaState:
    """This process's replica row ``[1, ...]`` of :func:`stack_states`."""
    one = make_replica_state(cfg, group_size, n_replicas, device=device)
    return map_state(lambda x: x[None].clone(), one)


def build_spmd_step(cfg, n_replicas: int, world: ReplicaWorld, *,
                    fanout: str = "gather", elections: bool = True,
                    audit: bool = False, telemetry: bool = False,
                    txn: bool = False):
    """``fn(state, inp) -> (state, out)``: one protocol step of this
    process's replica (``state``, ``inp`` and ``out`` are its ``[1,
    ...]`` row, ``inp.peer_mask`` ``[1, R]``), collective over the
    world: every rank calls it in the same iteration."""
    return functools.partial(
        replica_step, cfg=cfg, n_replicas=n_replicas, fanout=fanout,
        elections=elections, audit=audit, telemetry=telemetry, txn=txn,
        exchange=world)


def build_spmd_burst(cfg, n_replicas: int, world: ReplicaWorld, *,
                     fanout: str = "gather", audit: bool = False,
                     telemetry: bool = False):
    """:func:`build_sim_burst` over the world: ``burst(state, datas
    [K,1,B,sw], metas [K,1,B,MW], counts [K,1], peer_mask [1,R], applied
    [1], qdepth [1])`` for this process's row; every rank calls it in
    the same iteration with the same K."""
    return _build_burst(cfg, n_replicas, fanout, audit, telemetry, world)


def build_spmd_scan(cfg, n_replicas: int, world: ReplicaWorld, *,
                    replay_slots: int, fanout: str = "psum",
                    audit: bool = False, telemetry: bool = False):
    """:func:`build_sim_scan` over the world: the K fused steps, the
    consolidated readback of this process's row and ITS replay window
    (``replay_slots`` rows from its pre-scan apply cursor, read from its
    own post-scan log with no collective)."""
    return _build_scan(cfg, n_replicas, replay_slots, fanout, audit,
                       telemetry, world)
