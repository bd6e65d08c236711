"""CLI: ``python -m rdma_paxos_tpu_torch.streams verify EXPORT [AUDIT...]``

The port's copy of the JAX package's ``streams/__main__.py``.

Proves a CDC export end-to-end (see :mod:`.cdc`): per-group strictly
increasing indices, chain recomputation over the canonical record
bytes, and — given one or more AuditLedger dump files (the
``replica<me>.audit.json`` the NodeDaemon writes, or a chaos audit
artifact embedding one) — term/digest agreement for every retained
index. Exit 0 when clean; exit 1 naming the first bad ``(term,
index)``."""

from __future__ import annotations

import argparse
import json
import sys

from rdma_paxos_tpu_torch.streams.cdc import verify_export


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m rdma_paxos_tpu_torch.streams")
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("verify", help="verify a CDC export")
    v.add_argument("export", help="CDC JSONL export file")
    v.add_argument("audits", nargs="*",
                   help="AuditLedger dump JSON files to verify "
                        "digests against")
    v.add_argument("--json", action="store_true",
                   help="emit the verdict as JSON")
    args = ap.parse_args(argv)

    dumps = []
    for path in args.audits:
        with open(path, "r", encoding="utf-8") as f:
            dumps.append(json.load(f))
    verdict = verify_export(args.export, dumps)
    if args.json:
        print(json.dumps(verdict, indent=2))
    elif verdict["ok"]:
        print(f"OK: {verdict['records']} records, "
              f"{verdict['checked_digests']} ledger digests checked")
    else:
        term, index = verdict["bad"]
        print(f"FAIL at (term={term}, index={index}): "
              f"{verdict['error']}", file=sys.stderr)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
