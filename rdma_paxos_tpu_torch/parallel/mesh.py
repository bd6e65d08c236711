"""Single-device builders of the protocol step: R replicas stacked on
one device (the JAX package's ``vmap``-simulated replica axis).

Each builder returns a plain function over tensors; there is nothing to
compile, so a "build" only binds the static configuration. The fused
K-step burst and scan are Python loops of the stable step (the JAX
``lax.scan``). The state is updated in place and returned.

The group builders (``build_sim_group_*``) step G independent groups of
R replicas stacked ``[G, R, ...]`` in one pass: the step is written over
leading batch axes, so they bind the same functions with the JAX
builders' ``[K, G, R, ...]`` input contract, and one step of every
group is one set of launches. The multi-device (spmd, 2-D mesh)
builders, ``build_mesh_2d`` and ``group_sharding`` belong to the
multi-device slice (ROADMAP Queue 1, item 14).
"""

from __future__ import annotations

import functools

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


def _burst_steps(cfg, n_replicas, fanout, audit, telemetry, state, datas,
                 metas, counts, peer_mask, applied, qdepth):
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
                                  telemetry=telemetry)
        yield state, out


def build_sim_burst(cfg, n_replicas: int, *, fanout: str = "gather",
                    audit: bool = False, telemetry: bool = False):
    """K protocol steps in one call: ``burst(state, datas [K,R,B,sw],
    metas [K,R,B,MW], counts [K,R], peer_mask [R,R], applied [R],
    qdepth [R]) -> (state, outs)`` with every output field stacked
    ``[K, ...]`` (the ``audit=``/``telemetry=`` fields of every step
    too, when on)."""

    def burst(state, datas, metas, counts, peer_mask, applied, qdepth):
        outs = []
        for state, out in _burst_steps(cfg, n_replicas, fanout, audit,
                                       telemetry, state, datas, metas,
                                       counts, peer_mask, applied, qdepth):
            outs.append(out)
        return state, _stack_outputs(outs)
    return burst


def build_sim_scan(cfg, n_replicas: int, *, replay_slots: int,
                   fanout: str = "gather", audit: bool = False,
                   telemetry: bool = False):
    """The K-window scan tier: the burst's K steps with ONE consolidated
    readback — ``scal [K, R, len(SCAN_KEYS)]`` (``accepted``
    cumulative), ``peer_acked [K, R, R]`` and ``replay_slots`` rows per
    replica from the PRE-scan apply cursors of the post-scan log
    (``replay_data``/``replay_meta``), plus every step's audit windows
    and telemetry vectors ``[K, ...]`` when those variants are on."""

    def scan(state, datas, metas, counts, peer_mask, applied, qdepth):
        acc = torch.zeros_like(applied)
        ys = []
        for state, out in _burst_steps(cfg, n_replicas, fanout, audit,
                                       telemetry, state, datas, metas,
                                       counts, peer_mask, applied, qdepth):
            acc = acc + out.accepted
            ys.append(scan_readback(out, acc, audit=audit,
                                    telemetry=telemetry))
        res = {k: torch.stack([y[k] for y in ys]) for k in ys[0]}
        res["replay_data"], res["replay_meta"] = extract_window(
            state.log, applied, replay_slots)
        return state, res
    return scan


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
