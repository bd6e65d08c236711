"""YCSB's CoreWorkload ``workloads/workloada`` through YCSB's Redis
binding: ``readproportion`` of reads, each an ``HGETALL <key>``
(``readallfields``), the rest updates, each an ``HMSET <key>
field<k> <value>`` of one field (``writeallfields`` false: ``k``
uniform over ``fieldcount`` fields, the value ``fieldlength`` bytes of
printable ASCII, as ``RandomByteIterator`` draws them). Keys are
CoreWorkload's hashed key names, ``user`` followed by the decimal
``Utils.fnvhash64`` of the record number, the records drawn by
``ScrambledZipfianGenerator`` over ``recordcount`` records. The closed
loop is the harness's; this module makes the bytes, and gives each
request's key for the client to route by."""

from __future__ import annotations

from typing import List

import numpy as np

from paxbench.generators import Pool, ascii_decimal, rng_for

FNV_OFFSET_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 1099511628211
# ScrambledZipfianGenerator: a zipfian over ITEM_COUNT items with the
# precomputed zeta of that count, scrambled by fnvhash64 modulo the
# record count
ITEM_COUNT = 10_000_000_000
ZETAN = 26.46902820178302
ZIPFIAN_CONSTANT = 0.99


def fnvhash64(values: np.ndarray) -> np.ndarray:
    """``Utils.fnvhash64`` over non-negative longs: FNV-1a over the
    value's eight low-first octets, then ``Math.abs`` of the signed
    result."""
    v = values.astype(np.uint64)
    h = np.full(v.shape, FNV_OFFSET_64, np.uint64)
    with np.errstate(over="ignore"):
        for _ in range(8):
            h ^= v & np.uint64(0xFF)
            v >>= np.uint64(8)
            h *= np.uint64(FNV_PRIME_64)
    return np.abs(h.view(np.int64))


def zipfian(rng: np.random.Generator, n: int) -> np.ndarray:
    """``ZipfianGenerator(0, ITEM_COUNT, 0.99, ZETAN).nextValue()``, n
    times."""
    items = ITEM_COUNT + 1
    theta = ZIPFIAN_CONSTANT
    zeta2 = 1.0 + 0.5 ** theta
    alpha = 1.0 / (1.0 - theta)
    eta = (1 - (2.0 / items) ** (1 - theta)) / (1 - zeta2 / ZETAN)
    u = rng.random(n)
    uz = u * ZETAN
    tail = (items * (eta * u - eta + 1) ** alpha).astype(np.int64)
    return np.where(uz < 1.0, 0, np.where(uz < 1.0 + 0.5 ** theta, 1, tail))


def records(rng: np.random.Generator, n: int, recordcount: int
            ) -> np.ndarray:
    """CoreWorkload's ``nextKeynum`` under ``requestdistribution=
    zipfian`` with no inserts: a ScrambledZipfianGenerator over
    ``recordcount + 1`` items, a draw past the last record drawn
    again."""
    out = np.empty(0, np.int64)
    while len(out) < n:
        r = fnvhash64(zipfian(rng, n)) % (recordcount + 1)
        out = np.concatenate([out, r[r < recordcount]])
    return out[:n]


def key_name(record: int) -> bytes:
    """CoreWorkload's ``buildKeyName`` with hashed keys, plainly."""
    return b"user%d" % int(fnvhash64(np.array([record]))[0])


def resp(parts) -> bytes:
    return b"*%d\r\n" % len(parts) + b"".join(
        b"$%d\r\n%s\r\n" % (len(p), p) for p in parts)


def command(read: bool, key: bytes, field: int, value: bytes) -> bytes:
    """One request, written plainly (the tests hold ``make`` to it)."""
    if read:
        return resp([b"HGETALL", key])
    return resp([b"HMSET", key, b"field%d" % field, value])


def make(traffic: dict, seed: int) -> Pool:
    n = int(traffic["pool"])
    flen = int(traffic["fieldlength"])
    rec = records(rng_for(seed, 1), n, int(traffic["recordcount"]))
    read = rng_for(seed, 2).random(n) < float(traffic["readproportion"])
    field = rng_for(seed, 3).integers(0, int(traffic["fieldcount"]), n)
    value = rng_for(seed, 4).integers(ord(" "), ord("~") + 1,
                                      (int((~read).sum()), flen), np.uint8)
    vrow = np.cumsum(~read) - 1           # each update's value row
    kchars, klens = ascii_decimal(fnvhash64(rec).astype(np.uint64))
    keys = np.concatenate([np.broadcast_to(np.frombuffer(b"user", np.uint8),
                                           (n, 4)), kchars], axis=1)
    klens = klens + 4
    fchars, flens = ascii_decimal(field.astype(np.uint64))
    payloads: List[bytes] = [b""] * n
    # rows of one layout (operation, key and field widths) lie at the
    # same offsets: each layout is one block of columns
    kinds, which = np.unique((read * 100 + klens) * 100 + flens,
                             return_inverse=True)
    for i, kind in enumerate(kinds.tolist()):
        rd, kl, fl = kind // 10000, kind // 100 % 100, kind % 100
        idx = np.nonzero(which == i)[0]
        if rd:
            parts = [b"*2\r\n$7\r\nHGETALL\r\n$%d\r\n" % kl, keys[idx, :kl],
                     b"\r\n"]
        else:
            parts = [b"*4\r\n$5\r\nHMSET\r\n$%d\r\n" % kl, keys[idx, :kl],
                     b"\r\n$%d\r\nfield" % (5 + fl), fchars[idx, :fl],
                     b"\r\n$%d\r\n" % flen, value[vrow[idx]], b"\r\n"]
        block = np.concatenate(
            [np.broadcast_to(np.frombuffer(p, np.uint8), (len(idx), len(p)))
             if isinstance(p, bytes) else p for p in parts], axis=1)
        blob, w = block.tobytes(), block.shape[1]
        for j, k in enumerate(idx.tolist()):
            payloads[k] = blob[j * w:(j + 1) * w]
    return Pool(payloads=payloads, keys=keys, key_lens=klens)
