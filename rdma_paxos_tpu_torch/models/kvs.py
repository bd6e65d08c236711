"""Device-resident KVS — the built-in replicated state machine.

The port of ``rdma_paxos_tpu/models/kvs.py`` (reference
``dare_kvs_sm.c``, ``apply_kvs_cmd`` ``:158-202``): a fixed-capacity
open-addressing table in tensors — ``keys [cap, KEY_W]``, ``vals
[cap, VAL_W]``, ``used [cap]`` (all int32) — probed with PROBES
quadratic candidates at once. Commands are int32 word rows
``[op, key[KEY_W], val[VAL_W]]``, op in {1=PUT, 2=GET, 3=RM, 4=INCR,
5=SADD, 6=MAX}; ops 4-6 fold the operand into the current value
(absent key = zeros). Unknown ops are no-ops.

:func:`apply_cmd` updates the table IN PLACE and never synchronises
with the host (the probe position is a tensor, never a Python int). The
u32 FNV hash runs in int64 masked to 32 bits.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

OP_PUT, OP_GET, OP_RM = 1, 2, 3
OP_INCR, OP_SADD, OP_MAX = 4, 5, 6
KEY_W, VAL_W = 8, 8
CMD_W = 1 + KEY_W + VAL_W
PROBES = 32

_FNV_BASIS = 2166136261
_FNV_PRIME = 16777619
_U32 = 0xFFFFFFFF


@dataclasses.dataclass
class KVState:
    keys: torch.Tensor   # [cap, KEY_W] i32
    vals: torch.Tensor   # [cap, VAL_W] i32
    used: torch.Tensor   # [cap] i32

    @property
    def cap(self) -> int:
        return self.keys.shape[0]


def make_kvs(cap: int = 4096, *, device) -> KVState:
    if cap & (cap - 1):
        raise ValueError("cap must be a power of two")
    return KVState(
        keys=torch.zeros((cap, KEY_W), dtype=torch.int32, device=device),
        vals=torch.zeros((cap, VAL_W), dtype=torch.int32, device=device),
        used=torch.zeros((cap,), dtype=torch.int32, device=device))


def _hash(keys: torch.Tensor) -> torch.Tensor:
    """FNV-ish u32 mix of ``keys [N, KEY_W]`` -> 31-bit seeds ``[N]``."""
    h = torch.full(keys.shape[:1], _FNV_BASIS, dtype=torch.int64,
                   device=keys.device)
    for i in range(KEY_W):
        h = ((h ^ (keys[:, i].to(torch.int64) & _U32)) * _FNV_PRIME) & _U32
    return (h & 0x7FFFFFFF).to(torch.int32)


def _probe_slots(keys: torch.Tensor, cap: int) -> torch.Tensor:
    """Quadratic probe sequences ``[N, PROBES]`` (summed in int64: the
    low bits equal the JAX package's wrapping i32 sum)."""
    i = torch.arange(PROBES, dtype=torch.int64, device=keys.device)
    return (_hash(keys).to(torch.int64)[:, None] + i * (i + 1) // 2) & (
        cap - 1)


def _find(kv: KVState, keys: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(match slot or -1, first free slot or -1)``, each ``[N]``."""
    slots = _probe_slots(keys, kv.cap)                     # [N, P]
    occupied = kv.used[slots] > 0
    match = occupied & (kv.keys[slots] == keys[:, None, :]).all(-1)
    p = torch.arange(PROBES, device=keys.device)
    midx = torch.where(match, p, PROBES).min(-1).values
    fidx = torch.where(~occupied, p, PROBES).min(-1).values
    pick = torch.gather(slots, 1, torch.stack(
        [midx.clamp(max=PROBES - 1), fidx.clamp(max=PROBES - 1)], 1))
    mslot = torch.where(midx < PROBES, pick[:, 0], -1)
    fslot = torch.where(fidx < PROBES, pick[:, 1], -1)
    return mslot, fslot


def lookup(kv: KVState, keys: torch.Tensor) -> torch.Tensor:
    """GET of ``keys [N, KEY_W]`` -> values ``[N, VAL_W]`` (zeros when
    absent); the table is not modified."""
    mslot, _ = _find(kv, keys)
    got = kv.vals[mslot.clamp(min=0)]
    return torch.where((mslot >= 0)[:, None], got, torch.zeros_like(got))


def apply_cmd(kv: KVState, cmd: torch.Tensor
              ) -> Tuple[KVState, torch.Tensor]:
    """Apply one command row ``cmd [CMD_W]`` in place; returns ``(kv,
    value)`` — the value words for a GET hit, else zeros."""
    op = cmd[0]
    key = cmd[1:1 + KEY_W][None]
    val = cmd[1 + KEY_W:1 + KEY_W + VAL_W]
    mslot, fslot = _find(kv, key)
    target = torch.where(mslot >= 0, mslot, fslot)
    m = mslot.clamp(min=0)                                 # [1]
    zeros = torch.zeros_like(val)
    base = torch.where(mslot >= 0, kv.vals[m][0], zeros)
    is_merge = (op == OP_INCR) | (op == OP_SADD) | (op == OP_MAX)
    merged = torch.where(
        op == OP_INCR, base + val,
        torch.where(op == OP_SADD, base | val, torch.maximum(base, val)))
    do_put = ((op == OP_PUT) | is_merge) & (target[0] >= 0)
    wval = torch.where(is_merge, merged, val)
    t = target.clamp(min=0)
    kv.keys[t] = torch.where(do_put, key, kv.keys[t])
    kv.vals[t] = torch.where(do_put, wval[None], kv.vals[t])
    kv.used[t] = torch.where(do_put, 1, kv.used[t])
    do_rm = (op == OP_RM) & (mslot[0] >= 0)
    kv.used[m] = torch.where(do_rm, 0, kv.used[m])
    hit = (op == OP_GET) & (mslot[0] >= 0)
    out = torch.where(hit, kv.vals[m][0], zeros)
    return kv, out


def apply_batch(kv: KVState, cmds: torch.Tensor, count
                ) -> Tuple[KVState, torch.Tensor]:
    """Apply the first ``count`` of ``cmds [B, CMD_W]`` in log order;
    returns ``(kv, outs [B, VAL_W])`` (zeros past ``count``)."""
    outs = torch.zeros((cmds.shape[0], VAL_W), dtype=torch.int32,
                       device=cmds.device)
    for i in range(min(int(count), cmds.shape[0])):
        kv, outs[i] = apply_cmd(kv, cmds[i])
    return kv, outs


def encode_cmd(op: int, key: bytes, val: bytes = b"") -> np.ndarray:
    if len(key) > KEY_W * 4 or len(val) > VAL_W * 4:
        raise ValueError("key/value too large")
    k = np.zeros(KEY_W * 4, np.uint8)
    v = np.zeros(VAL_W * 4, np.uint8)
    k[:len(key)] = np.frombuffer(key, np.uint8)
    v[:len(val)] = np.frombuffer(val, np.uint8)
    return np.concatenate([
        np.array([op], "<i4"), k.view("<i4"), v.view("<i4")]).astype("<i4")


def decode_val(words: np.ndarray) -> bytes:
    return words.astype("<i4").tobytes().rstrip(b"\x00")
