"""The stable protocol step replayed from a CUDA graph.

A stacked engine on the card (``SimCluster`` in ``mode="sim"``,
``ShardedCluster`` without a mesh) enqueues ~530 small kernels from
Python on every protocol step. :class:`StepGraph` records its stable
step (``elections=False``) once, in the engine's ``prewarm()``, and each
stable dispatch then replays the record: one launch for the same
kernels, in the same order, on the same int32 values.

Everything the graph reads and writes stays where it was recorded:

- the state: the engine's own state tensors, its rings included. The
  step updates the ring in place and returns fresh tensors for the
  other fields; the graph copies those back into the state's own (one
  ``_foreach_copy_`` launch per dtype), so every replay steps the same
  tensors in place. A state the engine rebinds between replays (a
  rebase, a snapshot install, ``cluster.state = ...``) is found by
  identity at the next :meth:`StepGraph.bind` and copied in;
- the inputs: one :class:`~rdma_paxos_tpu_torch.consensus.step.
  StepInput` of device tensors that :meth:`StepGraph.stage` fills from
  the host arrays. A burst's per-step arrays go to the card in one copy
  each (:meth:`StepGraph.stage_steps`) and into the inputs before each
  of its K replays (:meth:`StepGraph.replay_steps`);
- the outputs: the fields the engine reads back, packed by the graph
  into one int32 row. Each replay's row is copied out before another
  replay can write it, so a ticket's outputs hold until its finish,
  whatever is dispatched after it.

A replay runs none of the kernel wrappers, so it adds their launch
counts (``ops/quorum.py``: ``commit_window.launches``) itself; the
recording, which launches nothing, takes its own counts back.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from rdma_paxos_tpu_torch.consensus.log import Log
from rdma_paxos_tpu_torch.consensus.state import (
    STATE_FIELDS, ReplicaState, clone_state)
from rdma_paxos_tpu_torch.consensus.step import StepInput
from rdma_paxos_tpu_torch.ops import quorum

# the state's fields other than the ring, in ReplicaState order
_FIELDS = tuple(k for k in STATE_FIELDS if k != "log")
# the inputs a burst gives each of its steps; the others it shares
STEP_INPUTS = ("batch_data", "batch_meta", "batch_count")


def _tensors(state: ReplicaState) -> Tuple[torch.Tensor, ...]:
    """The ring, then every other field of ``state``."""
    return (state.log.buf,) + tuple(getattr(state, k) for k in _FIELDS)


def _counts() -> Tuple[int, int]:
    return quorum.commit_window.launches, quorum.commit_scan.launches


def _add_counts(d: Tuple[int, int], times: int) -> None:
    with quorum._COUNT_LOCK:
        quorum.commit_window.launches += d[0] * times
        quorum.commit_scan.launches += d[1] * times


class StepGraph:
    """``step(state, inp) -> (state, out)`` recorded as a CUDA graph over
    ``state``'s own tensors and the device tensors of ``inp``, with the
    non-None ``fields`` of ``out`` packed into one int32 row.

    Recorded on a side stream after one warm-up run on a copy of the
    state (which fills every first-use cache: the audit fold's weights,
    the kernels' ctypes entries); any failure raises here. ``steps`` is
    the deepest burst :meth:`stage_steps` is sized for up front."""

    def __init__(self, step, state: ReplicaState, inp: StepInput,
                 fields: Sequence[str], steps: int):
        dev = state.term.device
        self.inp = inp
        self.state = state
        self._static = _tensors(state)

        def body() -> torch.Tensor:
            c0 = _counts()
            new, out = step(state, inp)
            if new.log.buf is not state.log.buf:
                raise RuntimeError("the step must update the ring in place")
            by_dtype: Dict[torch.dtype, tuple] = {}
            for k in _FIELDS:
                src, dst = getattr(new, k), getattr(state, k)
                if src is not dst:
                    d, s = by_dtype.setdefault(dst.dtype, ([], []))
                    d.append(dst)
                    s.append(src)
            for d, s in by_dtype.values():
                torch._foreach_copy_(d, s)
            keep = [(k, getattr(out, k)) for k in fields
                    if getattr(out, k) is not None]
            self.layout, at = [], 0
            for k, t in keep:
                self.layout.append((k, tuple(t.shape), at, at + t.numel()))
                at += t.numel()
            c1 = _counts()
            self._launches = (c1[0] - c0[0], c1[1] - c0[1])
            return torch.cat([t.reshape(-1) for _k, t in keep])

        self.packed = self._record(step, body)
        _add_counts(self._launches, -1)
        self._staged = {k: torch.empty((steps,) + tuple(getattr(
            inp, k).shape), dtype=torch.int32, device=dev)
            for k in STEP_INPUTS}

    def _record(self, step, body) -> torch.Tensor:
        dev = self.state.term.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step(clone_state(self.state), self.inp)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side,
                              capture_error_mode="thread_local"):
            return body()

    def _launch(self) -> None:
        self.graph.replay()

    def bind(self, live: ReplicaState) -> ReplicaState:
        """The state to store after a replay: ``live`` when its tensors
        are the graph's; else (the engine rebound its state) the graph's
        own state, with ``live``'s values copied in. Call before the
        replay, with the engine's host lock held."""
        moved = False
        for t, src in zip(self._static, _tensors(live)):
            if src is not t:
                t.copy_(src)
                moved = True
        if not moved:
            return live
        self.state = ReplicaState(log=Log(self._static[0]),
                                  **dict(zip(_FIELDS, self._static[1:])))
        return self.state

    def stage(self, **host: np.ndarray) -> None:
        """Copy host arrays into the named inputs of the next replay."""
        for k, a in host.items():
            getattr(self.inp, k).copy_(
                torch.from_numpy(np.ascontiguousarray(a)))

    def stage_steps(self, **host: np.ndarray) -> None:
        """Copy a burst's per-step host arrays ``[K, ...]`` (the
        ``STEP_INPUTS``) to the card, one copy each."""
        for k, a in host.items():
            self._staged[k][:a.shape[0]].copy_(torch.from_numpy(a))

    def replay(self) -> torch.Tensor:
        """One replay; its packed outputs ``[1, L]``, a copy of its own."""
        self._launch()
        _add_counts(self._launches, 1)
        return self.packed.clone()[None]

    def replay_steps(self, K: int) -> torch.Tensor:
        """K replays over the staged steps, each with its own inputs;
        their packed outputs ``[K, L]``."""
        rows = torch.empty((K,) + tuple(self.packed.shape),
                           dtype=self.packed.dtype,
                           device=self.packed.device)
        for k in range(K):
            for name, buf in self._staged.items():
                getattr(self.inp, name).copy_(buf[k])
            self._launch()
            rows[k].copy_(self.packed)
        _add_counts(self._launches, K)
        return rows

    def unpack(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        """Packed rows ``[K, L]`` read back to the host, as each field
        ``[K, ...]``."""
        K = rows.shape[0]
        return {k: rows[:, a:b].reshape((K,) + shape)
                for k, shape, a, b in self.layout}
