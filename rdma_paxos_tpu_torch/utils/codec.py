"""Byte-stream ↔ int32-word marshalling for log slots.

The reference moves raw bytes (client TCP payloads ≤ 87380 B,
``src/include/dare/message.h:5-9``) straight into log entries. The log stores
payloads as int32 words; the proxy fragments anything larger than one
slot into consecutive SEND entries (lossless for stream replay).
The port's copy of the JAX package's ``utils/codec.py``."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def bytes_to_words(payload: bytes, slot_words: int) -> np.ndarray:
    """Pack bytes into an int32 word row (zero-padded). len(payload) must
    fit one slot; the proxy fragments above."""
    if len(payload) > slot_words * 4:
        raise ValueError("payload exceeds slot capacity; fragment first")
    buf = payload + b"\x00" * (slot_words * 4 - len(payload))
    return np.frombuffer(buf, dtype="<i4").copy()


def words_to_bytes(words: np.ndarray, length: int) -> bytes:
    return words.astype("<i4").tobytes()[:length]


def fragment(payload: bytes, slot_bytes: int) -> List[bytes]:
    """Split an oversize payload into slot-sized chunks (proxy-side;
    replay concatenates them back in log order)."""
    if not payload:
        return [b""]
    return [payload[i:i + slot_bytes]
            for i in range(0, len(payload), slot_bytes)]
