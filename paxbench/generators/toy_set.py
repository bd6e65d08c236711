"""redis-benchmark's SET test in the toy app's newline protocol
(``native/toyserver.c``): each request is ``SET key:<12 digits>
<value>\\n``, the key's number a random draw below ``keyspace`` (``-r``)
written as 12 zero-padded digits, the value ``value_bytes`` (``-d``)
alphanumeric bytes drawn from the seed. redis-benchmark sends ``xxx``;
distinct values let a read-back of the app tell a lost or reordered SET
from a kept one. The closed loop is the harness's; this module makes
the bytes."""

from __future__ import annotations

import numpy as np

from paxbench.generators import Pool, decimal_digits, rng_for, split_rows

ALNUM = np.frombuffer(b"0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                      b"abcdefghijklmnopqrstuvwxyz", np.uint8)


def command(key_num: int, value: bytes) -> bytes:
    """One request, written plainly (the tests hold ``make`` to it)."""
    return b"SET key:%012d %s\n" % (key_num, value)


def make(traffic: dict, seed: int) -> Pool:
    n, vb = int(traffic["pool"]), int(traffic["value_bytes"])
    keys = rng_for(seed, 1).integers(0, int(traffic["keyspace"]), n)
    values = ALNUM[rng_for(seed, 2).integers(0, len(ALNUM), (n, vb))]
    head = b"SET key:"
    width = len(head) + 12 + 1 + vb + 1
    mat = np.empty((n, width), np.uint8)
    mat[:, :len(head)] = np.frombuffer(head, np.uint8)
    mat[:, len(head):len(head) + 12] = decimal_digits(keys, 12)
    mat[:, len(head) + 12] = ord(" ")
    mat[:, len(head) + 13:width - 1] = values
    mat[:, width - 1] = ord("\n")
    return Pool(payloads=split_rows(mat, np.full(n, width, np.int64)))
