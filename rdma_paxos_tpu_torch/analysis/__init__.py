"""graftlint for the PyTorch package — static analysis of the invariants
the replication engine's correctness rests on, and the runtime lock
sanitizer behind ``RP_SANITIZE=1``.

The port of ``rdma_paxos_tpu/analysis/``: the same five passes, the
same finding format and baseline grammar, run over the
``rdma_paxos_tpu_torch`` tree (``python -m
rdma_paxos_tpu_torch.analysis``). Stdlib only, so it runs on a machine
with no JAX:

``jit-purity``       no host-side symbol (obs, threading, wall clock,
                     unseeded randomness) reachable from the device
                     modules whose code builds the card's step; no host
                     sync (``.item()``, ``.cpu()``, ...) inside the step
                     and its log and lane helpers; and the declared
                     host-pure modules never reach into torch.
``cache-key``        every builder that stores a built program into
                     STEP_CACHE folds each static flag it reads into
                     the cache key.
``lock-discipline``  every access to a ``# guarded-by:``-annotated
                     field happens under the declared lock (or is a
                     justified baseline entry).
``determinism``      no wall clock / unseeded randomness (torch's
                     global generator included) in the chaos, replay,
                     and step-domain modules.
``thread-hygiene``   every spawned thread has a stop/join path; HTTP
                     serving handlers answer errors instead of dying.

Findings are ``Finding(file, line, pass_id, message)``; justified
exceptions live in ``analysis/baseline.toml`` (one ``[[suppress]]``
block each, with a reason). The companion runtime sanitizer
(``analysis/runtime_guard.py``, enabled by ``RP_SANITIZE=1``) turns
the same ``guarded-by`` declarations into per-access lock-ownership
assertions at run time.
"""

from rdma_paxos_tpu_torch.analysis.engine import (  # noqa: F401
    Finding, PASS_IDS, default_baseline_path, load_baseline,
    repo_root, run_analysis)
from rdma_paxos_tpu_torch.analysis.purity import (  # noqa: F401
    DEVICE_MODULES, HOST_PURE_MODULES, HOST_SYNC_MODULES,
    SCAN_PATTERNS)


def jit_purity_findings(root=None):
    """Run ONLY the jit-purity pass (baseline applied) — the single
    source of truth behind the port's jit-purity wrapper tests."""
    report = run_analysis(root=root, passes=("jit-purity",))
    return report.findings


def assert_jit_purity(root=None) -> None:
    """Assert-style wrapper for the tier-1 purity tests: raises
    AssertionError naming every finding if the device/host purity
    contract is violated anywhere."""
    findings = jit_purity_findings(root)
    assert not findings, "jit-purity violations:\n" + "\n".join(
        str(f) for f in findings)
