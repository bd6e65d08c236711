"""The traffic generators: deterministic from the seed, framed as their
sources frame requests, keys drawn as YCSB draws them; and the sharded
client's map, which routes every key as the cluster's router does."""

import collections

import numpy as np
import pytest

from paxbench import spec
from paxbench.generators import redis_set, toy_set, ycsb_a

SEED = 2 ** 31 + 12345


def small(name, **kw):
    t = spec.traffic(name)
    t.update(pool=4096, **kw)
    return t


@pytest.mark.parametrize("name", ["set_c256p16", "set_c50", "ycsb_a",
                                  "toy_set_c50"])
def test_same_seed_same_bytes(name):
    t = small(name)
    gen = spec.generator(t["kind"])
    a, b = gen.make(t, SEED), gen.make(t, SEED)
    assert a.payloads == b.payloads
    assert gen.make(t, SEED + 1).payloads != a.payloads


def test_redis_set_is_redis_benchmarks_set():
    t = small("set_c256p16")
    pool = redis_set.make(t, SEED)
    keys = [int(p.split(b"\r\n")[4][4:]) for p in pool.payloads]
    assert all(p == redis_set.command(k, b"xxx")
               for p, k in zip(pool.payloads, keys))
    assert len(pool.payloads[0]) == 45
    assert 0 <= min(keys) and max(keys) < t["keyspace"]
    n, space = len(keys), t["keyspace"]
    assert len(set(keys)) > 0.9 * n * (1 - n / 2 / space)


def test_toy_set_is_redis_benchmarks_set_in_the_toy_protocol():
    t = small("toy_set_c50")
    pool = toy_set.make(t, SEED)
    keys = [int(p[8:20]) for p in pool.payloads]
    values = [p[21:24] for p in pool.payloads]
    assert all(p == toy_set.command(k, v)
               for p, k, v in zip(pool.payloads, keys, values))
    assert {len(p) for p in pool.payloads} == {25}
    assert all(v.isalnum() and v.isascii() for v in values)
    assert 0 <= min(keys) and max(keys) < t["keyspace"]
    n, space = len(keys), t["keyspace"]
    assert len(set(keys)) > 0.9 * n * (1 - n / 2 / space)
    assert len(set(values)) > 0.9 * n       # distinct values, not xxx


def parse_resp(p):
    """A RESP array's bulk strings, read by their lengths."""
    assert p[:1] == b"*"
    n, pos = int(p[1:p.index(b"\r\n")]), p.index(b"\r\n") + 2
    out = []
    for _ in range(n):
        end = p.index(b"\r\n", pos)
        ln = int(p[pos + 1:end])
        out.append(p[end + 2:end + 2 + ln])
        assert p[end + 2 + ln:end + 4 + ln] == b"\r\n"
        pos = end + 4 + ln
    assert pos == len(p)
    return out


def test_ycsb_a_is_hgetall_and_hmset_of_one_field():
    t = small("ycsb_a")
    pool = ycsb_a.make(t, SEED)
    reads = 0
    for i, p in enumerate(pool.payloads):
        parts = parse_resp(p)
        key = pool.keys[i, :pool.key_lens[i]].tobytes()
        assert parts[1] == key and key.startswith(b"user")
        if parts[0] == b"HGETALL":
            reads += 1
            assert p == ycsb_a.command(True, key, 0, b"")
            continue
        assert parts[0] == b"HMSET" and len(parts) == 4
        k = int(parts[2][5:])
        assert parts[2] == b"field%d" % k and 0 <= k < t["fieldcount"]
        value = parts[3]
        assert len(value) == t["fieldlength"]
        assert all(32 <= b <= 126 for b in value)
        assert p == ycsb_a.command(False, key, k, value)
        assert 128 < len(p) <= 256           # two 128 B slots
    assert abs(reads / len(pool.payloads) - t["readproportion"]) < 0.03


def test_ycsb_a_keys_are_hashed_record_names():
    assert ycsb_a.key_name(0) == b"user6284781860667377211"
    records = spec.traffic("ycsb_a")["recordcount"]
    hashed = ycsb_a.fnvhash64(np.arange(records)).tolist()
    names = set(b"user%d" % h for h in hashed)
    assert len(names) == records
    pool = ycsb_a.make(small("ycsb_a"), SEED)
    keys = {pool.keys[i, :n].tobytes() for i, n in enumerate(pool.key_lens)}
    assert keys <= names


def test_ycsb_a_zipfian_top_key_share():
    """ScrambledZipfianGenerator at 0.99: the hottest record takes the
    zipfian's item 0, 1 / zeta(10^10, 0.99), of all draws, the next
    item 1 / 2^0.99 of that."""
    t = spec.traffic("ycsb_a")
    t["pool"] = 1 << 17
    pool = ycsb_a.make(t, SEED)
    keys = [pool.keys[i, :n].tobytes() for i, n in enumerate(pool.key_lens)]
    top = collections.Counter(keys).most_common(2)
    share = [c / len(keys) for _, c in top]
    assert share[0] == pytest.approx(1 / ycsb_a.ZETAN, abs=0.003)
    assert share[1] == pytest.approx(1 / ycsb_a.ZETAN / 2 ** 0.99,
                                     abs=0.002)


@pytest.mark.parametrize("G", [1, 3, 8])
def test_the_client_map_routes_as_the_router(G):
    from rdma_paxos_tpu_torch.shard.router import KeyRouter
    from paxbench.shard import ClientMap, route
    router = KeyRouter(G)
    pool = ycsb_a.make(small("ycsb_a"), SEED)
    got = route(pool, router)
    want = [router.group_of(pool.keys[i, :n].tobytes())
            for i, n in enumerate(pool.key_lens)]
    assert got.tolist() == want
    table = router.to_dict()
    table["ring_checksum"] ^= 1
    with pytest.raises(ValueError):
        ClientMap(table)
