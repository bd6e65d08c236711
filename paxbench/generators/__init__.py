"""Traffic generators, one module per ``kind`` of traffic file. Each has
``make(traffic, seed) -> Pool``: every request's bytes made from the
seed before the window opens."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Pool:
    """Pre-made requests, handed out in order (wrapping past the end):
    ``payloads[k]`` is request k's bytes. A mix whose requests name a
    key also gives ``keys[k]``, the key's bytes left-aligned in a
    zero-padded ``[n, width]`` u8 matrix, and ``key_lens[k]``, its
    length (what a client routes by)."""

    payloads: List[bytes]
    keys: Optional[np.ndarray] = None
    key_lens: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.payloads)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per (seed, stream); any whole seed."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def split_rows(mat: np.ndarray, lens: np.ndarray) -> List[bytes]:
    """Rows of a padded ``[n, width]`` u8 matrix, each cut to its length,
    as bytes objects (one join, then slices)."""
    keep = np.arange(mat.shape[1]) < lens[:, None]
    blob = mat[keep].tobytes()
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    o = offs.tolist()
    return [blob[o[i]:o[i + 1]] for i in range(len(lens))]


def decimal_digits(values: np.ndarray, width: int) -> np.ndarray:
    """``[n, width]`` ASCII digits of non-negative ints, zero-padded."""
    v = values.astype(np.uint64)
    out = np.empty((len(v), width), np.uint8)
    for j in range(width - 1, -1, -1):
        out[:, j] = (v % np.uint64(10)).astype(np.uint8) + ord("0")
        v //= np.uint64(10)
    return out


def ascii_decimal(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Non-negative ints written in decimal without padding: a
    ``[n, width]`` u8 matrix of ASCII digits (``width`` the longest),
    each row left-aligned and zero-padded, and each row's length."""
    width = len(str(int(values.max()))) if len(values) else 1
    digits = decimal_digits(values, width)
    nz = digits != ord("0")
    lens = np.where(nz.any(axis=1), width - nz.argmax(axis=1), 1)
    shift = (width - lens)[:, None] + np.arange(width)
    out = np.take_along_axis(digits, np.minimum(shift, width - 1), axis=1)
    out[np.arange(width) >= lens[:, None]] = 0
    return out, lens.astype(np.int64)
