"""redis-benchmark's SET test: ``redis-benchmark -t set -c C -P P -d D
-r R``. Each request is the RESP array of ``SET key:__rand_int__
<value>``: ``__rand_int__`` is a random number below ``-r``, written as
12 zero-padded digits, and the value is ``-d`` bytes of ``x``. The
closed loop (``clients`` connections with ``pipeline`` requests in
flight each) is the harness's; this module makes the bytes."""

from __future__ import annotations

import numpy as np

from paxbench.generators import Pool, decimal_digits, rng_for, split_rows


def command(key_num: int, value: bytes) -> bytes:
    """One request, written plainly (the tests hold ``make`` to it)."""
    key = b"key:%012d" % key_num
    return b"*3\r\n$3\r\nSET\r\n$%d\r\n%s\r\n$%d\r\n%s\r\n" % (
        len(key), key, len(value), value)


def make(traffic: dict, seed: int) -> Pool:
    n = int(traffic["pool"])
    value = b"x" * int(traffic["value_bytes"])
    keys = rng_for(seed, 1).integers(0, int(traffic["keyspace"]), n)
    head = b"*3\r\n$3\r\nSET\r\n$16\r\nkey:"
    tail = b"\r\n$%d\r\n%s\r\n" % (len(value), value)
    width = len(head) + 12 + len(tail)
    mat = np.empty((n, width), np.uint8)
    mat[:, :len(head)] = np.frombuffer(head, np.uint8)
    mat[:, len(head):len(head) + 12] = decimal_digits(keys, 12)
    mat[:, len(head) + 12:] = np.frombuffer(tail, np.uint8)
    return Pool(payloads=split_rows(mat, np.full(n, width, np.int64)))
