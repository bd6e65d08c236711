"""Per-host node launcher — the per-machine half of ``benchmarks/run.sh``,
for the port.

Run one of these on every host of the group (here: every process), with
the same coordinator address; each starts its replica daemon, optionally
its unmodified app under the interposition shim, and loops::

    server_idx=0 group_size=3 python -m \\
        rdma_paxos_tpu_torch.runtime.launch_node \\
        --coordinator host0:9900 --workdir /tmp/rp --app-port 7700 \\
        --iterations 2000

The counterpart of the JAX package's ``benchmarks/launch_node.py``, with
its environment (``server_idx``, ``group_size``) and flags. ``--config``
is read by the port's :func:`~rdma_paxos_tpu_torch.config.load_config`,
``--device`` places the replica (the card unless it says ``cpu``), and
the shim and the toy app come from ``native/`` beside the package.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="one replica daemon of a group, per host")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--app-port", type=int, default=0)
    ap.add_argument("--app-cmd", default="")
    ap.add_argument("--iterations", type=int, default=5000)
    ap.add_argument("--period", type=float, default=0.0)
    ap.add_argument("--config", default="")
    ap.add_argument("--device", default="cuda",
                    help="where the replica's state lives: the card "
                         "(default) or cpu")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    idx = int(os.environ["server_idx"])
    n = int(os.environ["group_size"])

    from rdma_paxos_tpu_torch.config import (LogConfig, TimeoutConfig,
                                             load_config)
    from rdma_paxos_tpu_torch.proxy.stablestore import NATIVE_DIR
    from rdma_paxos_tpu_torch.runtime.node import NodeDaemon

    if args.config:
        cfg, timing, _ = load_config(args.config)
    else:
        cfg = LogConfig(n_slots=1024, slot_bytes=256, window_slots=64,
                        batch_slots=64)
        timing = TimeoutConfig(elec_timeout_low=0.5, elec_timeout_high=1.0)

    node = NodeDaemon(cfg, process_id=idx, num_processes=n,
                      coordinator=args.coordinator, workdir=args.workdir,
                      app_port=args.app_port or None, timeout_cfg=timing,
                      device=args.device)
    node.prewarm_burst()     # collective: the burst schedule's first call

    app = None
    if args.app_port:
        cmd = (args.app_cmd.split() if args.app_cmd
               else [os.path.join(NATIVE_DIR, "toyserver"),
                     str(args.app_port)])
        env = dict(os.environ)
        env["LD_PRELOAD"] = os.path.join(NATIVE_DIR, "interpose.so")
        env["RP_PROXY_SOCK"] = node.sock_path
        app = subprocess.Popen(cmd, env=env, stderr=subprocess.DEVNULL)
        time.sleep(0.2)

    try:
        node.run_iterations(args.iterations, period=args.period)
    finally:
        node.close()
        if app is not None:
            app.kill()
            app.wait()


if __name__ == "__main__":
    main()
