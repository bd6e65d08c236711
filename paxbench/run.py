"""``python3 -m paxbench --workload <config>.<traffic> --seed N
--seconds S --trace 0|1``: one run of one cell, printing as its last
line of standard output one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number compared with its limit).

It runs only on a CUDA card and exits non-zero without a result where
there is none, where the port is not the checkout's own, or where JAX or
the JAX package was loaded into the process."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict

T_START = time.perf_counter()


def _env(root: str) -> None:
    """Fixed cache directories inside the checkout; one CPU thread for
    the numerical libraries (the load comes from this one process)."""
    cache = os.path.join(root, "build", "paxbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    for v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[v] = "1"


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="paxbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    return run_main(parse(sys.argv[1:] if argv is None else argv))


def _card() -> Dict:
    import torch
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "unknown"
    return dict(name=name, power_limit=limit)


def metrics_line(cell: dict, res: dict, trace: bool, card: Dict,
                 device_count: int) -> Dict:
    from paxbench import spec
    import numpy as np
    ctx = res["ctx"]
    ctx["device_name"] = card["name"]
    metrics: Dict[str, dict] = {}
    if not trace:
        e2e = dict(acked_ops_per_s=res["acked"] / res["window_s"],
                   setup_s=res["setup_s"])
        if res["lat_ms"].size:
            e2e["commit_p95_ms"] = float(np.percentile(res["lat_ms"], 95))
        for m in cell["end_to_end"]:
            if m["name"] in e2e:
                metrics[m["name"]] = dict(value=e2e[m["name"]],
                                          unit=m["unit"])
    else:
        for m in cell["per_layer"]:
            v = spec.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    device = dict(platform="gpu", kind=card["name"], count=device_count,
                  memory_peak_bytes=res["memory_peak_bytes"])
    line = dict(correct=all(v == 0 for v in res["checks"].values()),
                attempted=res["attempted"],
                failed=res["failed"], metrics=metrics, device=device)
    dt = ctx.get("trace")
    if trace and dt is not None:
        from paxbench import trace as tr
        busy = tr.busy_intervals(dt.events, dt.t0, dt.t1)
        device["busy_s"] = sum(b - a for a, b in busy)
        device["window_s"] = dt.window_s
        phases = [e for e in (ctx.get("phase_events") or [])
                  if e[2] > dt.t0 and e[1] < dt.t1]
        line["breakdown"] = dict(
            device_ops=[list(x) for x in tr.top_ops(dt.events)],
            idle_gaps=[list(x) for x in tr.idle_by_phase(
                tr.gaps(busy, dt.t0, dt.t1), phases)[:10]])
    line["checks"] = {k: dict(value=v, limit=0)
                      for k, v in res["checks"].items()}
    return line


def run_main(args, fault=None) -> int:
    """One run; ``fault`` (a ``faults`` function) is planted under the
    timed path by the control and fault runs only."""
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    _env(root)
    sys.path.insert(0, root)
    from paxbench import spec
    from paxbench.cell import forbidden_modules, run, say
    cell = spec.cell(args.workload, spec.benchmark(__import__(
        "pathlib").Path(root)))
    import torch
    chips = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import rdma_paxos_tpu_torch
    pkg = os.path.dirname(os.path.abspath(rdma_paxos_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        say(f"the port imported is not this checkout's: {pkg}")
        return 2
    torch.set_num_threads(1)
    card = _card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory(prefix="paxbench-") as wd:
        res = run(cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=dev, workdir=wd,
                  t_start=T_START, fault=fault)
    bad = forbidden_modules()
    if bad:
        say(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    line = metrics_line(cell, res, bool(args.trace), card, chips)
    say(f"card {card['name']}, power limit {card['power_limit']}; "
        f"sent {res['sent']}, acked in window {res['acked']}, "
        f"reference {res['reference_s']:.1f} s")
    lat = res["lat_ms"]
    if lat.size:
        # printed in every cell, reported only where BENCHMARK.json lists
        # the cell under the tail metrics
        import numpy as np
        say("tails commit_p95_ms %.4f commit_p99_ms %.4f" % (
            np.percentile(lat, 95), np.percentile(lat, 99)))
    say("diag " + json.dumps(res["diag"]))
    for k, v in res["checks"].items():
        print(f"check {k} = {v} (limit 0)", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
