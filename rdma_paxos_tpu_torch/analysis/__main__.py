"""``python -m rdma_paxos_tpu_torch.analysis`` — the port's graftlint
CLI, with the flags and exit codes of ``rdma_paxos_tpu/analysis/
__main__.py``.

Exit 0 when every finding is baselined (or none exist), exit 1
otherwise, printing one ``file:line: [pass] message`` per live
finding. ``--json`` writes the full report (live + suppressed +
unused suppressions) for the CI artifact; ``--write-baseline``
records the current live findings as suppression stubs to be
hand-justified (the triage workflow).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from rdma_paxos_tpu_torch.analysis.engine import (
    PASS_IDS, Suppression, default_baseline_path, render_baseline,
    run_analysis)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rdma_paxos_tpu_torch.analysis",
        description="graftlint: repo-native static analysis "
                    "(jit purity, cache-key completeness, lock "
                    "discipline, determinism, thread hygiene)")
    ap.add_argument("passes", nargs="*", metavar="PASS",
                    help="subset of passes to run (default: all of "
                         "%s)" % (", ".join(PASS_IDS)))
    ap.add_argument("--root", default=None,
                    help="repo root to analyze (default: this "
                         "checkout)")
    ap.add_argument("--baseline", default=None,
                    help="suppression file (default: the checked-in "
                         "analysis/baseline.toml)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, suppressions ignored")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the findings report as JSON")
    ap.add_argument("--write-baseline", action="store_true",
                    help="append the current live findings to the "
                         "baseline as to-be-justified suppressions")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    t0 = time.monotonic()
    baseline = (None if args.no_baseline
                else (args.baseline or "auto"))
    report = run_analysis(root=args.root,
                          passes=args.passes or None,
                          baseline=baseline)
    dt = time.monotonic() - t0

    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            f.write(report.to_json())

    for f in report.findings:
        print(f)
    if not args.quiet:
        for s in report.unused_suppressions:
            print("note: unused suppression [%s] %s (%r)" %
                  (s.pass_id, s.file, s.contains))
        print("graftlint: %d finding(s), %d suppressed, %d pass(es) "
              "in %.2fs" % (len(report.findings),
                            len(report.suppressed),
                            len(args.passes or PASS_IDS), dt))

    if args.write_baseline and report.findings:
        path = args.baseline or default_baseline_path(args.root)
        stubs = [Suppression(pass_id=f.pass_id, file=f.file,
                             contains=f.message, reason="")
                 for f in report.findings]
        # APPEND the stubs: the checked-in baseline carries curated
        # comments and section headers that a load/render round-trip
        # would destroy
        exists = os.path.exists(path)
        with open(path, "a", encoding="utf-8") as fh:
            if not exists:
                fh.write("# graftlint baseline — every entry needs a "
                         "one-line justification.\n# Entries match "
                         "by (pass, file, contains [, symbol]) "
                         "message substrings.\n")
            fh.write("\n" + render_baseline(stubs))
        print("appended %d suppression stub(s) to %s — justify them" %
              (len(stubs), path))

    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
