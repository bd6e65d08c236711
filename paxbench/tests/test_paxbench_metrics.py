"""The yardstick's arithmetic: rates over all the work and the whole
window, tails over all requests, readers, and the roofline's bytes."""

import numpy as np
import pytest

from paxbench import peaks, spec
from paxbench.run import metrics_line


def fake_result(lat_ms, acked, window_s, **ctx):
    base = dict(window_s=window_s, acked=acked, steps=10, lat_ms=lat_ms,
                phases={}, conf=spec.config("apus3"), part_s=window_s,
                part_acked=acked, part_steps=10, gc_pause_s=None,
                trace=None, trace_steps=None)
    base.update(ctx)
    return dict(setup_s=12.5, window_s=window_s, acked=acked,
                lat_ms=np.asarray(lat_ms, float), attempted=acked,
                failed=0, checks=dict(unanswered=0), ctx=base,
                memory_peak_bytes=1)


CARD = dict(name="NVIDIA H100 80GB HBM3", power_limit="700.00 W")


def test_rate_is_all_work_over_the_window():
    cell = spec.cell("apus3.set_c256p16")
    line = metrics_line(cell, fake_result(np.ones(5000), 5000, 20.0),
                        False, CARD, 1)
    assert line["metrics"]["acked_ops_per_s"]["value"] == 250.0


def test_tails_are_over_all_requests_and_a_stall_moves_them():
    cell = spec.cell("apus3.set_c256p16")
    lat = np.full(10_000, 10.0)
    calm = metrics_line(cell, fake_result(lat, 10_000, 20.0), False,
                        CARD, 1)["metrics"]["commit_p95_ms"]["value"]
    stalled = lat.copy()
    stalled[:1000] = 500.0             # a stall held 10 % of requests
    hit = metrics_line(cell, fake_result(stalled, 10_000, 20.0), False,
                       CARD, 1)["metrics"]["commit_p95_ms"]["value"]
    assert calm == 10.0 and hit == 500.0
    p99 = spec.reader("commit_p99_ms")
    tail = lat.copy()
    tail[:200] = 300.0                 # 2 %: p99 sees it, p95 does not
    assert p99.read(dict(lat_ms=tail)) == 300.0
    assert p99.read(dict(lat_ms=lat)) == 10.0


def test_line_keys_and_checks_last():
    cell = spec.cell("apus3.set_c256p16")
    line = metrics_line(cell, fake_result(np.ones(2000), 2000, 10.0),
                        False, CARD, 1)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["device"] == dict(platform="gpu", kind=CARD["name"],
                                  count=1, memory_peak_bytes=1)
    assert line["checks"] == dict(unanswered=dict(value=0, limit=0))
    assert set(line["metrics"]) == {"acked_ops_per_s", "commit_p95_ms",
                                    "setup_s"}
    bad = fake_result(np.ones(2000), 2000, 10.0)
    bad["checks"] = dict(unanswered=3)
    assert metrics_line(cell, bad, False, CARD, 1)["correct"] is False


def test_readers_find_nothing_without_a_trace():
    cell = spec.cell("apus3.set_c256p16")
    line = metrics_line(cell, fake_result(np.ones(10), 10, 10.0), True,
                        CARD, 1)
    got = line["metrics"]
    for m in ("kernels_per_step", "commit_window_roofline_pct",
              "device_idle_pct", "gc_pause_pct", "commit_p99_ms",
              "ack_release_ms_per_step"):
        assert m not in got
    assert got["ops_per_step"]["value"] == 1.0


def test_commit_window_bytes_match_the_kernel_table():
    # PERF.md's kernel table: N = 3 at W = 2048 is 0.0221 us at 3.35 TB/s
    need = peaks.commit_window_bytes(3, 3, 2048)
    assert need / 3.35e12 * 1e6 == pytest.approx(0.0221, abs=5e-5)
    need = peaks.commit_window_bytes(192, 3, 2048)
    assert need / 3.35e12 * 1e6 == pytest.approx(1.4120, abs=5e-4)


def test_the_trace_is_aligned_by_either_marker():
    from paxbench.trace import _offset
    dev = [("k", 100.0 + i * 0.01, 100.0 + i * 0.01 + 0.001)
           for i in range(100)]
    # host: capture from 5.0 to 15.0; start marker at 5.0, end at 15.0
    assert _offset([99.99], dev, 5.0, 15.0, 5.0) == (
        pytest.approx(94.99), "start marker")
    assert _offset([101.5], dev, 5.0, 15.0, 5.0) == (
        pytest.approx(86.5), "end marker")
    assert _offset([99.99, 101.5], dev, 5.0, 15.0, 5.0)[1] == "start marker"
    assert _offset([], dev, 5.0, 15.0, 5.0) == (
        pytest.approx(95.0), "first activity")


def test_apply_is_the_engines_apply_phase_per_step():
    r = spec.reader("apply_ms_per_step")
    assert r.read(dict(phases=dict(apply=30_000.0), part_steps=10)) == 3.0
    assert r.read(dict(phases={}, part_steps=10)) is None


class FakeTrace:
    def __init__(self, events):
        self.events = events


def test_the_roofline_counts_every_group_and_replica():
    """N = G x R instances: 24 at ``shard8``, 3 at ``apus3``."""
    r = spec.reader("commit_window_roofline_pct")
    dt = FakeTrace([("commit_window_kernel", 0.0, 8e-6)] * 4)
    got = {}
    for name in ("apus3", "shard8"):
        conf = spec.config(name)
        got[name] = r.read(dict(trace=dt, conf=conf,
                                device_name=CARD["name"]))
    need = peaks.commit_window_bytes(24, 3, 2048)
    assert got["shard8"] == pytest.approx(100 * need / 3.35e12 / 8e-6)
    assert got["shard8"] == pytest.approx(8 * got["apus3"])
    assert got["shard8"] < 100


@pytest.mark.parametrize("per_step, steps, lost", [
    (1, 400, False),        # a sound capture: one launch a step
    (0, 400, True),         # every kernel record gone, copies kept
    (0.01, 400, True),      # 1 % of them kept
    (0, 0, False),          # no step ran while the capture was on
])
def test_a_capture_that_lost_its_kernel_records_is_known(per_step, steps,
                                                         lost):
    from paxbench.trace import kernels_lost
    n = int(per_step * steps)
    events = ([("commit_window_kernel", 0.0, 1e-5)] * n
              + [("Memcpy HtoD (Pageable -> Device)", 0.0, 1e-5)] * 40)
    assert kernels_lost(events, steps) is lost
