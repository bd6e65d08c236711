"""Elastic generation worker — one per host per generation.

Runs the ordinary :class:`~rdma_paxos_tpu_torch.runtime.node.NodeDaemon`
lock-step loop inside the generation's own ``torch.distributed`` gloo
world (rendezvous at the spec's coordinator), bracketed by the elastic
machinery of :mod:`.elastic`:

* boots from the generation's GENESIS row (donor state sanitized by
  :func:`~rdma_paxos_tpu_torch.consensus.snapshot.genesis_row`) when the
  spec names a donor, else fresh;
* rebuilds the local app by replaying the (donor-derived) stable store;
* between rounds of ``--round-iters`` iterations, dumps a consistent
  (state row, store blob, meta) recovery triple and posts the
  controller's round barrier — ``ok=0`` means the world is being rebuilt
  and this worker exits cleanly;
* on ANY collective error (a peer died mid-round) the last recovery
  point on disk stands; the worker exits nonzero and the supervisor
  reports the failure.

The port of the JAX package's ``runtime/elastic_worker.py``. The device
is an explicit ``--device`` (the card unless it says ``cpu``), printed
at start. A gloo survivor of a dead peer gets an exception from the
collective it is in, or waits out the world's timeout (a quarter of the
spec's ``barrier_timeout``), so it always exits well inside the
controller's barrier budget. Neither exit path tears the process group
down: a peer may be gone, and the dump is already on disk. At
generation end the worker prints one ``WORKER_END`` JSON line: its
iterations, protocol steps, ``commit_window`` launches and the time it
spent in :func:`~.elastic.write_rowdump`.

Exit codes: 0 = clean generation end; nonzero = collective/peer failure.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--host-id", type=int, required=True)
    ap.add_argument("--controller", required=True)
    ap.add_argument("--app-port", type=int, default=0)
    ap.add_argument("--round-iters", type=int, default=25)
    ap.add_argument("--cfg-json", default="")
    ap.add_argument("--device", default="cuda",
                    help="where the replica's state lives: the card "
                         "(default) or cpu")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)

    with open(args.spec) as f:
        spec = json.load(f)
    members = [m["host"] for m in spec["members"]]
    slot = members.index(args.host_id)
    M = len(members)
    # bounds the world's rendezvous and every collective: a survivor of
    # a dead peer that gets no exception still exits well inside the
    # controller's barrier budget
    timeout = float(spec.get("barrier_timeout", 120)) / 4
    print(f"worker h{args.host_id}: device={args.device} gen "
          f"{spec['gen']} slot {slot}/{M} gloo timeout {timeout:.1f} s",
          flush=True)

    import numpy as np

    from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
    from rdma_paxos_tpu_torch.consensus.snapshot import genesis_row
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.runtime.elastic import (call, write_dump,
                                                      write_rowdump)
    from rdma_paxos_tpu_torch.runtime.node import NodeDaemon

    if args.cfg_json:
        raw = json.loads(args.cfg_json)
        cfg = LogConfig(**raw.get("log", {}))
        timing = TimeoutConfig(**raw.get("timing", {}))
    else:
        cfg = LogConfig(n_slots=1024, slot_bytes=256, window_slots=64,
                        batch_slots=64)
        timing = TimeoutConfig(elec_timeout_low=0.5, elec_timeout_high=1.0)

    genesis = None
    if int(spec["donor"]) >= 0:
        base = os.path.join(args.workdir, f"gen{spec['gen']}_donor")
        with np.load(f"{base}_row_h{args.host_id}.npz") as z:
            donor_row = {k: z[k] for k in z.files}
        with open(f"{base}_meta_h{args.host_id}.json") as f:
            donor_meta = json.load(f)
        genesis = genesis_row(
            donor_row, group_mask=(1 << M) - 1, epoch=int(spec["epoch"]),
            n_replicas=M, term=int(spec["term_base"]))
        # the store blob matches the donor's HOST applied counter (the
        # device-row apply can lag it by the final iteration's window);
        # raise apply to the store's high-water mark so no member
        # re-applies — and so re-appends — records already in the store
        genesis["apply"] = np.int32(int(donor_meta["applied"]))

    commit_window.launches = 0
    node = NodeDaemon(
        cfg, process_id=slot, num_processes=M,
        coordinator=spec["coordinator"], workdir=args.workdir,
        app_port=args.app_port or None, timeout_cfg=timing,
        host_id=args.host_id, genesis=genesis,
        seed=spec["gen"] * 1000, gen=int(spec["gen"]),
        device=args.device, timeout=timeout)
    # COLLECTIVE: the empty burst that starts the step schedule (no-op
    # when bursts are off)
    node.prewarm_burst()

    if args.app_port:
        # the supervisor starts the app once our proxy socket exists;
        # wait until it accepts before replaying history into it. A
        # missing app is FATAL, not skippable: booting consensus with an
        # app that missed its history bootstrap serves wrong data.
        deadline = time.monotonic() + 120
        while True:
            try:
                socket.create_connection(("127.0.0.1", args.app_port),
                                         timeout=2).close()
                break
            except OSError:
                if time.monotonic() >= deadline:
                    print(f"FATAL: app on port {args.app_port} never "
                          "came up; aborting generation", flush=True)
                    os._exit(1)
                time.sleep(0.1)
    node.bootstrap_from_store()
    print(f"gen {spec['gen']}: bootstrapped app from "
          f"{len(node.store)} store records (applied={node.applied})",
          flush=True)

    gen, rnd = int(spec["gen"]), 0
    tally = dict(steps=node.steps, launches=commit_window.launches,
                 rowdump_s=0.0, rowdumps=0)

    def report(clean: bool) -> None:
        # the counts of the completed steps, and what a call that died
        # in a collective launched beyond them
        print("WORKER_END " + json.dumps(dict(
            host=args.host_id, gen=gen, clean=clean, device=args.device,
            iterations=node.iterations, steps=tally["steps"],
            launches=tally["launches"],
            launches_failed_call=commit_window.launches
            - tally["launches"],
            rowdumps=tally["rowdumps"],
            rowdump_ms=tally["rowdump_s"] * 1e3)), flush=True)

    # Per-iteration RECOVERY POINT on disk: a worker can be killed
    # instantly and un-catchably, so no crash handler can be relied on.
    # After every iteration that advanced the state the (row, meta +
    # live-store length) pair is renamed into place (atomic vs process
    # death); recovery pairs it with the live store trimmed to that
    # length (elastic.best_recovery), so the freshest recovery point —
    # containing every write acked so far — is never more than one
    # iteration old, however the process dies.
    last_progress = None
    try:
        while True:
            row = meta = None
            for _ in range(args.round_iters):
                res = node.iterate()
                tally["steps"] = node.steps
                tally["launches"] = commit_window.launches
                # recovery points only need refreshing when the state
                # advanced — an ack implies progress in that iteration,
                # so acked writes are always covered; idle iterations
                # skip the row serialization + write entirely
                progress = (node.applied, int(res["term"]),
                            int(res["end"]), int(res["commit"]))
                if row is None or progress != last_progress:
                    last_progress = progress
                    row = node.dump_row()
                    meta = node.meta(row)
                    meta.update(gen=gen, round=rnd, host=args.host_id,
                                store_len=len(node.store))
                    t0 = time.perf_counter()
                    write_rowdump(args.workdir, args.host_id, row, meta)
                    tally["rowdump_s"] += time.perf_counter() - t0
                    tally["rowdumps"] += 1
                if node.needs_recovery:
                    # force-pruned past our apply cursor: this world
                    # can no longer serve through us — trigger a
                    # rebuild in which the donor's store restores our
                    # app (our meta carries usable=0: never the donor)
                    raise RuntimeError(
                        "force-pruned past apply cursor; requesting "
                        "world rebuild for snapshot recovery")
                if node.app_dirty:
                    # mis-speculation quarantine: the app executed
                    # input that can no longer commit (deposed mid
                    # flight) and must not serve again. Within a
                    # generation nothing restarts the app process, so
                    # convert the quarantine into a world rebuild —
                    # the supervisor spawns a FRESH app and the next
                    # generation bootstraps it from the committed
                    # store. The store itself is clean (it only ever
                    # holds committed entries), so our dump remains a
                    # usable recovery point.
                    raise RuntimeError(
                        "speculative app diverged (app_dirty); "
                        "requesting world rebuild for an app restart")
            # round barrier + a DURABLE full dump (fsynced triple —
            # the power-loss-safe recovery tier); a fully idle round
            # leaves the previous dump standing
            if row is not None:
                write_dump(args.workdir, args.host_id, row,
                           node.store.dump(), meta)
            try:
                resp, _ = call(
                    args.controller,
                    {"op": "round", "host": args.host_id,
                     "gen": gen, "round": rnd},
                    # must outlive the controller's barrier budget
                    timeout=float(spec.get("barrier_timeout", 120)) + 60)
            except (OSError, ConnectionError):
                resp = {"ok": 0}
            if not resp.get("ok"):
                break
            rnd += 1
    except Exception:
        import traceback
        traceback.print_exc()
        report(clean=False)
        # the per-iteration rowdump on disk is the recovery point; exit
        # hard, with no process-group teardown (a peer is gone)
        sys.stdout.flush()
        os._exit(1)
    node.close()
    report(clean=True)
    # no process-group teardown: peers may already be gone, and the
    # dump is already on disk
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
