"""Published peaks and the bytes a kernel needs for its inputs.

The H100 SXM's device memory moves 3.35 TB/s (NVIDIA's data sheet, at
the full 700 W power limit); a run prints its card's power limit beside
every share of this peak."""

from __future__ import annotations

HBM_BYTES_PER_S = {"H100": 3.35e12}


def hbm_peak(device_name: str) -> float:
    for k, v in HBM_BYTES_PER_S.items():
        if k in device_name:
            return v
    raise KeyError(f"no published memory rate for {device_name!r}")


def commit_window_bytes(n: int, r: int, w: int) -> int:
    """Bytes one ``commit_window`` launch needs over N instances of an
    R-replica group with a W-row window: of each window row the three
    i32 metadata words it reads (term, type, index), the R ack flags
    and the i32 ack of each instance, its ten scalars (``commit``,
    ``my_term``, ``my_end``, ``maj_old``, ``maj_new``, ``commit1`` i32;
    ``bm_old``, ``bm_new`` i64; ``transit``, ``i_lead`` one byte) and
    its two i32 results."""
    per = 12 * w + r + 4 + (6 * 4 + 2 * 8 + 2) + 2 * 4
    return n * per
