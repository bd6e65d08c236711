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
describe` says so.

The single-controller engines hold a list of devices in one process
(the JAX ``make_replica_mesh``/``build_mesh_2d`` meshes under
``shard_map``): :func:`make_replica_mesh` (``(R,)``, one replica row per
entry) and :func:`build_mesh_2d` (``(group_shards, R)``, each entry
holding ``G / group_shards`` whole groups of one replica column) return
a :class:`DeviceLayout`; :func:`group_sharding` places ``[G, R, ...]``
tensors on a 2-D layout (:class:`LayoutSharding`). A
:class:`DeviceWorld` runs a layout: one persistent worker thread per
entry steps that entry's block ``[1, ...]`` (``[Gl, 1, ...]`` on the 2-D
layout) with the unchanged step, and each of the step's five seams is an
explicit exchange between the R entries of one group shard (every
receiver copies each sender's message onto its own device) — never
across the group axis. The device-list builders (``build_spmd_*`` given
a layout, and ``build_spmd_group_*``) take and return the per-entry
blocks with stacked inputs and stacked outputs, so an engine's host
bookkeeping is the stacked engine's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import queue
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from rdma_paxos_tpu_torch.consensus.log import Log, extract_window
from rdma_paxos_tpu_torch.consensus.state import (
    STATE_FIELDS, ReplicaState, make_replica_state, map_state)
from rdma_paxos_tpu_torch.consensus.step import (
    OUTPUT_FIELDS, VARIANT_FIELDS, StepInput, StepOutput, group_step,
    replica_step, scan_readback)


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


def _stable_step(cfg, n_replicas, fanout, audit, telemetry, exchange):
    """The replica step a burst or scan repeats: ``elections=False``."""
    return functools.partial(
        replica_step, cfg=cfg, n_replicas=n_replicas, fanout=fanout,
        elections=False, audit=audit, telemetry=telemetry,
        exchange=exchange)


def _burst_steps(step, state, datas, metas, counts, peer_mask, applied,
                 qdepth):
    """The K stable steps of a burst, each ``step(state, inp)``: no
    timeouts fire, the host apply cursors ``applied`` stay frozen (the
    host cannot replay mid-burst), ``qdepth`` is the backlog remaining
    beyond the burst."""
    zeros_r = torch.zeros_like(applied)
    for k in range(datas.shape[0]):
        inp = StepInput(batch_data=datas[k], batch_meta=metas[k],
                        batch_count=counts[k], timeout_fired=zeros_r,
                        peer_mask=peer_mask, apply_done=applied,
                        queue_depth=qdepth)
        state, out = step(state, inp)
        yield state, out


def _build_burst(step):
    def burst(state, datas, metas, counts, peer_mask, applied, qdepth):
        outs = []
        for state, out in _burst_steps(step, state, datas, metas, counts,
                                       peer_mask, applied, qdepth):
            outs.append(out)
        return state, _stack_outputs(outs)
    return burst


def _build_scan(step, replay_slots, audit, telemetry):
    def scan(state, datas, metas, counts, peer_mask, applied, qdepth):
        acc = torch.zeros_like(applied)
        ys = []
        for state, out in _burst_steps(step, state, datas, metas, counts,
                                       peer_mask, applied, qdepth):
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
    return _build_burst(_stable_step(cfg, n_replicas, fanout, audit,
                                     telemetry, None))


def build_sim_scan(cfg, n_replicas: int, *, replay_slots: int,
                   fanout: str = "gather", audit: bool = False,
                   telemetry: bool = False):
    """The K-window scan tier: the burst's K steps with ONE consolidated
    readback — ``scal [K, R, len(SCAN_KEYS)]`` (``accepted``
    cumulative), ``peer_acked [K, R, R]`` and ``replay_slots`` rows per
    replica from the PRE-scan apply cursors of the post-scan log
    (``replay_data``/``replay_meta``), plus every step's audit windows
    and telemetry vectors ``[K, ...]`` when those variants are on."""
    return _build_scan(_stable_step(cfg, n_replicas, fanout, audit,
                                    telemetry, None),
                       replay_slots, audit, telemetry)


def build_sim_group_step(cfg, n_replicas: int, *, fanout: str = "gather",
                         elections: bool = True, audit: bool = False,
                         telemetry: bool = False, txn: bool = False):
    """``fn(state, inp) -> (state, out)``: one protocol step of every
    group of a ``[G, R, ...]`` state, in one pass
    (:func:`~rdma_paxos_tpu_torch.consensus.step.group_step`; the G count
    is not bound: any stack of groups sharing ``cfg`` runs through it).
    With ``txn=True`` the input carries ``txn_watch``/``txn_term``
    ``[G, R]`` (each group's watch repeated over its replicas) and the
    output the ``[G, R]`` vote matrix; bursts and scans never carry the
    lane."""
    return group_step(cfg=cfg, n_replicas=n_replicas, fanout=fanout,
                      elections=elections, audit=audit,
                      telemetry=telemetry, txn=txn)


def build_sim_group_burst(cfg, n_replicas: int, *, fanout: str = "gather",
                          audit: bool = False, telemetry: bool = False):
    """:func:`build_sim_burst` over every group: ``burst(state, datas
    [K,G,R,B,sw], metas [K,G,R,B,MW], counts [K,G,R], peer_mask
    [G,R,R], applied [G,R], qdepth [G,R])`` — the single-group burst's
    contract applied per group, one ``group_step`` per protocol step."""
    return _build_burst(group_step(
        cfg=cfg, n_replicas=n_replicas, fanout=fanout, elections=False,
        audit=audit, telemetry=telemetry))


def build_sim_group_scan(cfg, n_replicas: int, *, replay_slots: int,
                         fanout: str = "gather", audit: bool = False,
                         telemetry: bool = False):
    """:func:`build_sim_scan` over every group (inputs as
    :func:`build_sim_group_burst`; the readback's axes gain ``G`` after
    ``K``, the replay rows are ``[G, R, replay_slots, ...]``)."""
    return _build_scan(group_step(
        cfg=cfg, n_replicas=n_replicas, fanout=fanout, elections=False,
        audit=audit, telemetry=telemetry), replay_slots, audit, telemetry)


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


def build_spmd_step(cfg, n_replicas: int, world, *,
                    fanout: str = "gather", elections: bool = True,
                    audit: bool = False, telemetry: bool = False,
                    txn: bool = False):
    """Over a :class:`ReplicaWorld`: ``fn(state, inp) -> (state, out)``,
    one protocol step of this process's replica (``state``, ``inp`` and
    ``out`` are its ``[1, ...]`` row, ``inp.peer_mask`` ``[1, R]``),
    collective over the world: every rank calls it in the same
    iteration. Over a 1-D :class:`DeviceLayout` (:func:`make_replica_
    mesh`): the :class:`DeviceListProgram` ``prog(device_world, blocks,
    inp) -> (blocks, out)``, ``inp``/``out`` stacked ``[R, ...]``."""
    if isinstance(world, DeviceLayout):
        _check_layout(world, n_replicas, (REPLICA_AXIS,))
        return _step_program("spmd", cfg, n_replicas, world, fanout,
                             elections, audit, telemetry, txn)
    return functools.partial(
        replica_step, cfg=cfg, n_replicas=n_replicas, fanout=fanout,
        elections=elections, audit=audit, telemetry=telemetry, txn=txn,
        exchange=world)


def build_spmd_burst(cfg, n_replicas: int, world, *,
                     fanout: str = "gather", audit: bool = False,
                     telemetry: bool = False):
    """:func:`build_sim_burst` over the world: ``burst(state, datas
    [K,1,B,sw], metas [K,1,B,MW], counts [K,1], peer_mask [1,R], applied
    [1], qdepth [1])`` for this process's row; every rank calls it in
    the same iteration with the same K. Over a 1-D layout: the program
    taking the stacked burst inputs (see :func:`build_spmd_step`)."""
    if isinstance(world, DeviceLayout):
        _check_layout(world, n_replicas, (REPLICA_AXIS,))
        return _burst_program("spmd-burst", cfg, n_replicas, world,
                              fanout, audit, telemetry)
    return _build_burst(_stable_step(cfg, n_replicas, fanout, audit,
                                     telemetry, world))


def build_spmd_scan(cfg, n_replicas: int, world, *,
                    replay_slots: int, fanout: str = "psum",
                    audit: bool = False, telemetry: bool = False):
    """:func:`build_sim_scan` over the world: the K fused steps, the
    consolidated readback of this process's row and ITS replay window
    (``replay_slots`` rows from its pre-scan apply cursor, read from its
    own post-scan log with no collective). Over a 1-D layout: the
    program taking the stacked scan inputs, each entry reading its own
    replay rows."""
    if isinstance(world, DeviceLayout):
        _check_layout(world, n_replicas, (REPLICA_AXIS,))
        return _scan_program("spmd-scan", cfg, n_replicas, world,
                             replay_slots, fanout, audit, telemetry)
    return _build_scan(_stable_step(cfg, n_replicas, fanout, audit,
                                    telemetry, world),
                       replay_slots, audit, telemetry)


# ---------------------------------------------------------------------------
# one process, a list of devices: the layouts, the in-process world and
# the device-list builders
# ---------------------------------------------------------------------------

REPLICA_AXIS = "replica"
GROUP_AXIS = "group"


def _machine_devices() -> list:
    """The machine's distinct cards, ``cuda:0..n-1`` (none without
    CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _entry_device(d) -> torch.device:
    """One explicit entry of a device list: named exactly, a card that
    is not there raises (no fallback)."""
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass a CPU device list (['cpu'] * n) to "
                "run on the CPU")
        dev = torch.device("cuda", torch.cuda.current_device()
                           if dev.index is None else dev.index)
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} named, but the machine has "
                               f"{torch.cuda.device_count()} card(s)")
    return dev


@dataclasses.dataclass(frozen=True)
class DeviceLayout:
    """A device list shaped ``(R,)`` (axis ``replica``) or
    ``(group_shards, R)`` (axes ``group``, ``replica``): the counterpart
    of a JAX ``Mesh``. ``devices`` is a numpy object array of
    ``torch.device``; an entry may repeat a device (torch has one CPU
    device, and a one-card machine repeats ``cuda:0``), and
    :meth:`describe` prints the list with its repeats."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> tuple:
        return tuple(self.devices.shape)

    @property
    def entries(self) -> list:
        return list(self.devices.flat)

    @property
    def key(self) -> tuple:
        """The static layout as a hashable value (shape and device
        names): what a device-list builder's cache key carries."""
        return (self.axis_names, self.shape,
                tuple(str(d) for d in self.entries))

    def describe(self) -> str:
        names = [str(d) for d in self.entries]
        return (f"{'x'.join(map(str, self.shape))} layout "
                f"({', '.join(self.axis_names)}) over [{', '.join(names)}]"
                f" ({len(set(names))} distinct device(s))")


def make_replica_mesh(n_replicas: int, devices=None) -> DeviceLayout:
    """1-D layout with one consensus replica per entry; ``devices=None``
    takes the machine's cards."""
    devs = list(_machine_devices() if devices is None else devices)
    devs = devs[:n_replicas]
    if len(devs) < n_replicas:
        raise ValueError(f"need {n_replicas} devices, have {len(devs)}")
    arr = np.empty(n_replicas, dtype=object)
    arr[:] = [_entry_device(d) for d in devs]
    return DeviceLayout(arr, (REPLICA_AXIS,))


def build_mesh_2d(group_shards: int, replicas: int,
                  devices=None) -> DeviceLayout:
    """2-D layout ``(group, replica)``: each entry owns ``G /
    group_shards`` whole groups of one replica column, and every seam of
    the step runs between the ``replicas`` entries of one group shard,
    never across the group axis. Uses ``group_shards * replicas``
    entries (the machine's cards when ``devices`` is None)."""
    need = int(group_shards) * int(replicas)
    devs = list(_machine_devices() if devices is None else devices)
    if len(devs) < need:
        raise ValueError(
            f"need {need} devices for a {group_shards}x{replicas} "
            f"mesh, have {len(devs)}")
    arr = np.empty(need, dtype=object)
    arr[:] = [_entry_device(d) for d in devs[:need]]
    return DeviceLayout(arr.reshape(int(group_shards), int(replicas)),
                        (GROUP_AXIS, REPLICA_AXIS))


@dataclasses.dataclass(frozen=True)
class LayoutSharding:
    """Where each entry's block of a stacked tensor lives. A 1-D layout
    takes row ``r`` of an ``[..., R, ...]`` tensor (the replica axis at
    ``lead``); a 2-D layout takes group rows ``[s*Gl, (s+1)*Gl)`` of
    replica column ``r`` of an ``[..., G, R, ...]`` tensor (axes ``lead``
    and ``lead + 1``), ``Gl`` read from the tensor: no group count is
    bound. Entry ``i`` is ``(s, r) = divmod(i, R)``."""

    layout: DeviceLayout

    @property
    def n_entries(self) -> int:
        return self.layout.devices.size

    @property
    def replicas(self) -> int:
        return self.layout.shape[-1]

    @property
    def two_d(self) -> bool:
        return len(self.layout.shape) == 2

    def index(self, t: torch.Tensor, i: int, lead: int = 0) -> tuple:
        s, r = divmod(i, self.replicas)
        pre = (slice(None),) * lead
        if not self.two_d:
            return pre + (slice(r, r + 1),)
        gl = t.shape[lead] // self.layout.shape[0]
        return pre + (slice(s * gl, (s + 1) * gl), slice(r, r + 1))

    def block(self, t: torch.Tensor, i: int, lead: int = 0, *,
              own: bool = False) -> torch.Tensor:
        """Entry ``i``'s block on its device: a view where it already
        lies there, else a copy; ``own=True`` always gives a fresh
        contiguous copy (state blocks, which the step updates in
        place)."""
        b = t[self.index(t, i, lead)]
        dev = self.layout.entries[i]
        if own:
            return b.to(dev, copy=True, memory_format=torch.contiguous_format)
        return b.to(dev)

    def split(self, t: torch.Tensor, lead: int = 0, *,
              own: bool = False) -> list:
        return [self.block(t, i, lead, own=own)
                for i in range(self.n_entries)]

    def join(self, parts: Sequence[torch.Tensor], lead: int = 0, *,
             device) -> torch.Tensor:
        """The stacked tensor of every entry's block, on ``device``."""
        parts = [p.to(device) for p in parts]
        R = self.replicas
        if not self.two_d:
            return torch.cat(parts, dim=lead)
        rows = [torch.cat(parts[s * R:(s + 1) * R], dim=lead + 1)
                for s in range(self.layout.shape[0])]
        return rows[0] if len(rows) == 1 else torch.cat(rows, dim=lead)


def group_sharding(mesh: DeviceLayout) -> LayoutSharding:
    """The placement of ``[group, replica, ...]`` states on a
    :func:`build_mesh_2d` layout (the JAX ``NamedSharding(mesh,
    P("group", "replica"))``)."""
    if tuple(mesh.axis_names) != (GROUP_AXIS, REPLICA_AXIS):
        raise ValueError(f"mesh axes must be ({GROUP_AXIS!r}, "
                         f"{REPLICA_AXIS!r}), got {tuple(mesh.axis_names)}")
    return LayoutSharding(mesh)


def split_state(sharding: LayoutSharding, state: ReplicaState) -> list:
    """Every entry's own copy of its block of a stacked state."""
    blocks = [map_state(lambda x, i=i: sharding.block(x, i, own=True),
                        state) for i in range(sharding.n_entries)]
    return blocks


def join_state(sharding: LayoutSharding, blocks: Sequence[ReplicaState],
               *, device) -> ReplicaState:
    """The stacked state assembled from the entries' blocks (a copy on
    ``device``)."""
    def field(k):
        if k == "log":
            return Log(sharding.join([b.log.buf for b in blocks],
                                     device=device))
        return sharding.join([getattr(b, k) for b in blocks], device=device)
    return ReplicaState(**{k: field(k) for k in STATE_FIELDS})


class SeamEndpoint:
    """One entry's side of a :class:`DeviceWorld`: the ``exchange`` the
    replica step takes (``rank``, ``me``, ``peer``, :meth:`all_gather`,
    :meth:`all_sum`), as :class:`ReplicaWorld` is for a process.

    A seam deposits the entry's messages in its slot of the group
    shard's current slot set, passes the shard's barrier, and copies
    every sender's message onto its own device. The slot sets alternate
    between consecutive seams, so one barrier per seam suffices: a slot
    set is written again only two seams later, after every entry has
    passed the barrier between, and so finished reading it. The step
    never writes a tensor it has sent."""

    def __init__(self, world, row: int, rank: int, device: torch.device):
        self.world = world
        self.row = row
        self.rank = rank
        self.device = device
        self.me = torch.tensor([rank], dtype=torch.int32, device=device)
        self.peer = torch.arange(world.replicas, dtype=torch.int32,
                                 device=device)[None, :]
        self._parity = 0
        self.exchanges = 0
        self.exchange_s = 0.0

    def _swap(self, msgs: tuple) -> list:
        w = self.world
        slots = w._slots[self.row][self._parity]
        self._parity ^= 1
        slots[self.rank] = msgs
        w._barriers[self.row].wait()
        return slots

    def all_gather(self, tensors: Sequence[torch.Tensor]) -> tuple:
        """Each local block message -> every sender's along the replica
        axis, in rank order (the JAX ``lax.all_gather``)."""
        t0 = time.perf_counter()
        slots = self._swap(tuple(tensors))
        ax, dev = self.world.raxis, self.device
        out = tuple(torch.cat([s[k].to(dev) for s in slots], dim=ax)
                    for k in range(len(tensors)))
        self.exchanges += 1
        self.exchange_s += time.perf_counter() - t0
        return out

    def all_sum(self, tensors: Sequence[torch.Tensor]) -> tuple:
        """Each local block message -> its sum over the senders (the JAX
        ``lax.psum``), summed in int64 on the receiver's device."""
        t0 = time.perf_counter()
        slots = self._swap(tuple(tensors))
        dev = self.device
        out = tuple(torch.stack([s[k].to(dev) for s in slots])
                    .sum(0, dtype=torch.int64).to(t.dtype)
                    for k, t in enumerate(tensors))
        self.exchanges += 1
        self.exchange_s += time.perf_counter() - t0
        return out


class DeviceWorld:
    """A device layout run by one process: one persistent worker thread
    per entry (started here, joined by :meth:`close`, never spawned per
    step), the seam barriers (one per group shard, with ``timeout``
    seconds) and the endpoints. :meth:`run` hands a job to every worker
    and returns when all of them are done, so every thread has passed
    its last seam when it returns.

    A job that raises aborts every barrier, so the other entries leave
    their seams at once with ``BrokenBarrierError``; :meth:`run` raises
    the first real error and the world stays broken (its blocks were
    stepped part way). A seam that some entry never reaches breaks when
    its barrier times out."""

    def __init__(self, layout: DeviceLayout, *, timeout: float = 60.0):
        self.layout = layout
        self.sharding = LayoutSharding(layout)
        self.replicas = layout.shape[-1]
        self.raxis = len(layout.shape) - 1   # replica axis of a block
        rows = layout.devices.size // self.replicas
        self.timeout = float(timeout)
        self.device = layout.entries[0]
        self._barriers = [threading.Barrier(self.replicas, timeout=timeout)
                          for _ in range(rows)]
        self._slots = [[[None] * self.replicas, [None] * self.replicas]
                       for _ in range(rows)]
        self.endpoints = [SeamEndpoint(self, *divmod(i, self.replicas), d)
                          for i, d in enumerate(layout.entries)]
        self.broken: Optional[BaseException] = None
        # a context each job runs in, made per job (a per-thread op
        # counter: obs/device.py:count_ops); None = none
        self.job_context = None
        self._run_lock = threading.Lock()
        self._jobs = [queue.SimpleQueue() for _ in self.endpoints]
        self._done: queue.SimpleQueue = queue.SimpleQueue()
        self._results: list = [None] * len(self.endpoints)
        self._threads = [threading.Thread(target=self._serve, args=(i,),
                                          name=f"device-world-{i}",
                                          daemon=True)
                         for i in range(len(self.endpoints))]
        for t in self._threads:
            t.start()

    @property
    def exchanges(self) -> int:
        """Seams passed (every entry passes the same ones)."""
        return self.endpoints[0].exchanges

    @property
    def exchange_s(self) -> float:
        """Entry 0's wall seconds in its seams, waits included."""
        return self.endpoints[0].exchange_s

    def describe(self) -> str:
        return (f"device world: {self.layout.describe()}, "
                f"{len(self._threads)} worker thread(s), seam timeout "
                f"{self.timeout:g} s")

    def _serve(self, i: int) -> None:
        dev = self.endpoints[i].device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        while True:
            job = self._jobs[i].get()
            if job is None:
                return
            try:
                make = self.job_context
                with (make() if make is not None
                      else contextlib.nullcontext()):
                    self._results[i] = (True, job(self.endpoints[i], i))
            except BaseException as e:          # noqa: BLE001
                self._results[i] = (False, e)
                for b in self._barriers:
                    b.abort()
            self._done.put(i)

    def run(self, job) -> list:
        """``job(endpoint, i)`` on every entry's thread; returns the
        results in entry order, or raises the first error."""
        with self._run_lock:
            if self.broken is not None:
                raise RuntimeError("device world is broken by an earlier "
                                   "error") from self.broken
            if not self._threads[0].is_alive():
                raise RuntimeError("device world is closed")
            for q in self._jobs:
                q.put(job)
            for _ in self._jobs:
                self._done.get()
            results, self._results = self._results, [None] * len(
                self._jobs)
        errors = [r[1] for r in results if not r[0]]
        if not errors:
            return [r[1] for r in results]
        real = [e for e in errors
                if not isinstance(e, threading.BrokenBarrierError)]
        self.broken = real[0] if real else errors[0]
        if real:
            raise real[0]
        raise RuntimeError(
            f"device world: a seam's barrier broke (no entry arrived "
            f"within {self.timeout:g} s)") from errors[0]

    def close(self) -> None:
        """Stop and join the worker threads, each within the seam
        timeout (idempotent; a thread stuck in a device call is left to
        the process's exit: the threads are daemons)."""
        for q, t in zip(self._jobs, self._threads):
            if t.is_alive():
                q.put(None)
        for t in self._threads:
            t.join(self.timeout)


def _input_block(sh: LayoutSharding, inp: StepInput, i: int) -> StepInput:
    return StepInput(**{f.name: (None if getattr(inp, f.name) is None
                                 else sh.block(getattr(inp, f.name), i))
                        for f in dataclasses.fields(StepInput)})


def _join_output(sh: LayoutSharding, outs: list, lead: int,
                 device) -> StepOutput:
    return StepOutput(**{k: sh.join([getattr(o, k) for o in outs], lead,
                                    device=device)
                         for k in OUTPUT_FIELDS + VARIANT_FIELDS
                         if getattr(outs[0], k) is not None})


# the device-list programs, keyed by the static layout and never by G:
# one program per variant serves every group count on one layout
PROGRAMS: dict = {}


class DeviceListProgram:
    """One step variant over a device layout: ``prog(world, blocks,
    *inputs) -> (blocks, out)`` takes the entries' state blocks and the
    stacked inputs (on any device), runs ``body(block, *block_inputs,
    exchange=endpoint)`` on every entry's thread, and returns the new
    blocks and the stacked outputs on the world's first device.
    ``in_leads``/``out_lead`` name where each input's and the outputs'
    layout axes start (``K`` leads a burst's per-step inputs)."""

    def __init__(self, key: tuple, body, in_leads: tuple, join):
        self.key = key
        self.body = body
        self.in_leads = in_leads
        self.join = join

    def __call__(self, world: DeviceWorld, blocks: Sequence, *inputs):
        if world.layout.key != self.key[1]:
            raise ValueError(f"program for layout {self.key[1]} run on "
                             f"{world.layout.key}")
        sh = world.sharding

        def job(ep, i):
            args = [(_input_block(sh, x, i) if isinstance(x, StepInput)
                     else sh.block(x, i, lead))
                    for x, lead in zip(inputs, self.in_leads)]
            return self.body(blocks[i], *args, exchange=ep)
        res = world.run(job)
        return [r[0] for r in res], self.join(sh, [r[1] for r in res],
                                              world.device)


def _program(kind: str, cfg, n_replicas: int, layout: DeviceLayout,
             flags: tuple, body, in_leads: tuple, join
             ) -> DeviceListProgram:
    key = (kind, layout.key, cfg, n_replicas) + flags
    prog = PROGRAMS.get(key)
    if prog is None:
        prog = PROGRAMS[key] = DeviceListProgram(key, body, in_leads, join)
    return prog


def _step_program(kind, cfg, n_replicas, layout, fanout, elections, audit,
                  telemetry, txn) -> DeviceListProgram:
    body = functools.partial(
        replica_step, cfg=cfg, n_replicas=n_replicas, fanout=fanout,
        elections=elections, audit=audit, telemetry=telemetry, txn=txn)
    return _program(kind, cfg, n_replicas, layout,
                    (fanout, elections, audit, telemetry, txn), body, (0,),
                    lambda sh, outs, dev: _join_output(sh, outs, 0, dev))


_BURST_LEADS = (1, 1, 1, 0, 0, 0)


def _burst_program(kind, cfg, n_replicas, layout, fanout, audit,
                   telemetry) -> DeviceListProgram:
    def body(block, *args, exchange):
        return _build_burst(_stable_step(cfg, n_replicas, fanout, audit,
                                         telemetry, exchange))(block, *args)
    return _program(kind, cfg, n_replicas, layout,
                    (fanout, audit, telemetry), body, _BURST_LEADS,
                    lambda sh, outs, dev: _join_output(sh, outs, 1, dev))


def _scan_program(kind, cfg, n_replicas, layout, replay_slots, fanout,
                  audit, telemetry) -> DeviceListProgram:
    def body(block, *args, exchange):
        return _build_scan(_stable_step(cfg, n_replicas, fanout, audit,
                                        telemetry, exchange),
                           replay_slots, audit, telemetry)(block, *args)

    def join(sh, outs, dev):
        return {k: sh.join([o[k] for o in outs],
                           0 if k.startswith("replay_") else 1, device=dev)
                for k in outs[0]}
    return _program(kind, cfg, n_replicas, layout,
                    (replay_slots, fanout, audit, telemetry), body,
                    _BURST_LEADS, join)


def _check_layout(layout: DeviceLayout, n_replicas: int, axes: tuple
                  ) -> None:
    if tuple(layout.axis_names) != axes:
        raise ValueError(f"mesh axes must be {axes}, got "
                         f"{tuple(layout.axis_names)}")
    if layout.shape[-1] != n_replicas:
        raise ValueError(
            f"mesh replica axis is {layout.shape[-1]} devices but the "
            f"cluster has {n_replicas} replicas (one replica per "
            f"device along the replica axis)")


def build_spmd_group_step(cfg, n_replicas: int, mesh: DeviceLayout, *,
                          fanout: str = "gather", elections: bool = True,
                          audit: bool = False, telemetry: bool = False,
                          txn: bool = False) -> DeviceListProgram:
    """:func:`build_sim_group_step` over a :func:`build_mesh_2d` layout:
    ``prog(world, blocks, inp) -> (blocks, out)`` with ``inp``/``out``
    the stacked ``[G, R, ...]`` tensors; each entry steps its ``[Gl, 1,
    ...]`` block of whole group rows in one pass, its seams within its
    group shard's R entries."""
    _check_layout(mesh, n_replicas, (GROUP_AXIS, REPLICA_AXIS))
    return _step_program("spmd-group", cfg, n_replicas, mesh, fanout,
                         elections, audit, telemetry, txn)


def build_spmd_group_burst(cfg, n_replicas: int, mesh: DeviceLayout, *,
                           fanout: str = "gather", audit: bool = False,
                           telemetry: bool = False) -> DeviceListProgram:
    """:func:`build_sim_group_burst` over a 2-D layout (inputs and
    outputs as the stacked group burst's)."""
    _check_layout(mesh, n_replicas, (GROUP_AXIS, REPLICA_AXIS))
    return _burst_program("spmd-group-burst", cfg, n_replicas, mesh,
                          fanout, audit, telemetry)


def build_spmd_group_scan(cfg, n_replicas: int, mesh: DeviceLayout, *,
                          replay_slots: int, fanout: str = "gather",
                          audit: bool = False, telemetry: bool = False
                          ) -> DeviceListProgram:
    """:func:`build_sim_group_scan` over a 2-D layout: each entry reads
    its own replay rows from its own post-scan ring."""
    _check_layout(mesh, n_replicas, (GROUP_AXIS, REPLICA_AXIS))
    return _scan_program("spmd-group-scan", cfg, n_replicas, mesh,
                         replay_slots, fanout, audit, telemetry)


def run_fetch(world: DeviceWorld, blocks: Sequence[ReplicaState],
              starts: torch.Tensor, window_slots: int) -> tuple:
    """The replay fetch on a device list: each entry extracts
    ``window_slots`` rows of its own ring from its block of ``starts``;
    returns the stacked ``(data, meta)`` on the world's first device."""
    sh = world.sharding
    res = world.run(lambda ep, i: extract_window(
        blocks[i].log, sh.block(starts, i), window_slots))
    return tuple(sh.join([r[k] for r in res], device=world.device)
                 for k in (0, 1))
