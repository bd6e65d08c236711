"""The traffic generator: deterministic from the seed, framed as its
source frames requests."""

import pytest

from paxbench import spec
from paxbench.generators import redis_set

SEED = 2 ** 31 + 12345


def small(name, **kw):
    t = spec.traffic(name)
    t.update(pool=4096, **kw)
    return t


@pytest.mark.parametrize("name", ["set_c256p16", "set_c50"])
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
