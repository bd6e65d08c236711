"""jit-purity pass: the device modules stay pure, the host-pure
modules stay off the accelerator — the port of
``rdma_paxos_tpu/analysis/purity.py``.

What it guards in the port: the modules that build and run the card's
replica step (the step itself, the commit-window kernel's wrapper, the
device-list engine's step builders and the transaction lane) reach no
host orchestration, observability, thread or wall clock — a leak there
is a host call on every protocol step. Under ``jax.jit`` a host read of
a traced value cannot exist (JAX refuses it); eager PyTorch refuses
nothing, so this pass is what holds the guarantee that the step makes
no host sync (``HOST_SYNC_MODULES``): no ``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize`` or ``.to("cpu")``
in the step and its log and lane helpers. That claim is what a CUDA
graph capture of the stable step rests on.

The device-module manifest lives HERE, in one place: a change that
adds a device surface extends ``DEVICE_MODULES`` once and every rule —
transitive import provenance, stdlib bans, and the source-pattern scan
— covers it automatically.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from rdma_paxos_tpu_torch.analysis.engine import Finding, SourceTree

PASS_ID = "jit-purity"

# modules whose code builds and runs the card's step (the port's
# counterparts of the compiled surfaces). Everything transitively
# imported from here runs on every protocol step.
DEVICE_MODULES = (
    "rdma_paxos_tpu_torch/consensus/step.py",
    "rdma_paxos_tpu_torch/ops/__init__.py",
    "rdma_paxos_tpu_torch/ops/quorum.py",
    "rdma_paxos_tpu_torch/parallel/mesh.py",
    "rdma_paxos_tpu_torch/txn/lane.py",
)

# no module reachable from a device module may come from these: host
# orchestration, observability, threads, wall clock, global-state
# randomness (a torch.Generator passed in is fine — it is seeded).
FORBIDDEN_DEVICE_IMPORTS = (
    "rdma_paxos_tpu_torch.obs",
    "rdma_paxos_tpu_torch.runtime",
    "rdma_paxos_tpu_torch.chaos",
    "rdma_paxos_tpu_torch.shard",
    "rdma_paxos_tpu_torch.proxy",
    "rdma_paxos_tpu_torch.models",
    "rdma_paxos_tpu_torch.analysis",
    "threading",
    "time",
    "random",
    "socket",
    "subprocess",
    "http",
)

# source-pattern scan over the device modules (comments included —
# an obs call site hiding in dead code is one uncomment away from a
# host call on the step).
SCAN_PATTERNS: Tuple[str, ...] = (
    r"rdma_paxos_tpu_torch\.obs",
    # the catch-all: ANY obs.* reference in a device module is a leak,
    # named submodule or not
    r"\bobs\.",
    r"\.metrics\.(inc|set|observe)\b",
    r"\.trace\.record\b",
    r"\.spans\.\w+\(",
    r"\bAuditLedger\b",
    r"\bFlightRecorder\b",
    r"\bAlertEngine\b",
    r"\bProfilerSession\b",
    r"torch\.profiler",
    r"\bMetricsRegistry\b",
    r"runtime\.reads",
    r"runtime\.repair",
    r"\bLeaseManager\b",
    r"\bReadHub\b",
    r"\breads_served\b",
    r"\bserving_holder\b",
    r"\bRepairController\b",
    r"\binstall_snapshot\b",
    r"\btake_snapshot\b",
    r"\bTimeSeriesStore\b",
    r"\bOpsExporter\b",
    r"\brender_prometheus\b",
    r"\bserve_metrics\b",
    r"\bfleet_view\b",
    r"\bassemble_bundle\b",
    r"\bthreading\b",
)

# the trace boundary's counterpart: a host read of a device value
# inside the step. Under jit these reads cannot exist; in eager
# PyTorch each one is a device sync on every protocol step.
HOST_SYNC_MODULES = (
    "rdma_paxos_tpu_torch/consensus/step.py",
    "rdma_paxos_tpu_torch/consensus/log.py",
    "rdma_paxos_tpu_torch/txn/lane.py",
)
HOST_SYNC_PATTERNS: Tuple[str, ...] = (
    r"\.item\(",
    r"\.tolist\(",
    r"\.cpu\(",
    r"\.numpy\(",
    r"torch\.cuda\.synchronize",
    r"\.to\(\s*[\"']cpu",
)

# the accelerator stack a host-pure module must never import
_ACCEL = ("torch", "triton")

# host-pure modules: pure host orchestration/data-plane code that must
# never reach back into the accelerator stack. Each entry: banned
# import roots (AST-level) + banned source patterns (``\btorch\b`` for
# ``\bjax\b``, ``\bcuda\b`` for ``jnp``, ``DeviceWorld`` — the host
# exchange that replaced XLA's — for ``shard_map``). Modules whose
# docstring names torch to forbid it (hostpath, governor, console,
# tail, epoch, policy) ban torch by IMPORT only.
_PLAIN = (r"\btorch\b", r"\bcuda\b", r"\bDeviceWorld\b")
_IMPORT_ONLY = (r"\bcuda\b", r"\bDeviceWorld\b")
HOST_PURE_MODULES: Dict[str, dict] = {
    "rdma_paxos_tpu_torch/runtime/hostpath.py": dict(
        ban_imports=_ACCEL, patterns=_IMPORT_ONLY),
    "rdma_paxos_tpu_torch/runtime/reads.py": dict(
        ban_imports=_ACCEL, patterns=_PLAIN),
    # the adaptive dispatch governor: pure host control-plane logic —
    # it picks WHICH prewarmed program runs, and must never be able
    # to build one
    "rdma_paxos_tpu_torch/runtime/governor.py": dict(
        ban_imports=_ACCEL + ("numpy",),
        patterns=_IMPORT_ONLY + (r"\bbuild_",)),
    "rdma_paxos_tpu_torch/runtime/repair.py": dict(
        ban_imports=(),
        patterns=(r"torch\.(compile|jit)\b", r"\bDeviceWorld\b")),
    "rdma_paxos_tpu_torch/obs/series.py": dict(
        ban_imports=_ACCEL, patterns=_PLAIN),
    "rdma_paxos_tpu_torch/obs/export.py": dict(
        ban_imports=_ACCEL, patterns=_PLAIN),
    # the unified trace plane: cross-subsystem provenance + blame is
    # pure host bookkeeping — it must never touch the device
    "rdma_paxos_tpu_torch/obs/tracectx.py": dict(
        ban_imports=_ACCEL, patterns=_PLAIN),
    "rdma_paxos_tpu_torch/obs/console.py": dict(
        ban_imports=_ACCEL, patterns=_IMPORT_ONLY),
    # log-as-product streams: scan/watch/CDC are pure host tail
    # followers over already-decoded replay batches
    "rdma_paxos_tpu_torch/streams/__init__.py": dict(
        ban_imports=_ACCEL, patterns=_PLAIN),
    "rdma_paxos_tpu_torch/streams/tail.py": dict(
        ban_imports=_ACCEL, patterns=_IMPORT_ONLY),
    "rdma_paxos_tpu_torch/streams/scan.py": dict(
        ban_imports=_ACCEL, patterns=_PLAIN),
    "rdma_paxos_tpu_torch/streams/watch.py": dict(
        ban_imports=_ACCEL, patterns=_PLAIN),
    "rdma_paxos_tpu_torch/streams/cdc.py": dict(
        ban_imports=_ACCEL + ("numpy",), patterns=_PLAIN),
    # elastic topology: the shared epoch/completion-proof helpers and
    # the load policy are pure host control plane — splits reshape
    # host routing only
    "rdma_paxos_tpu_torch/topology/epoch.py": dict(
        ban_imports=_ACCEL, patterns=_IMPORT_ONLY),
    "rdma_paxos_tpu_torch/topology/policy.py": dict(
        ban_imports=_ACCEL + ("numpy",),
        patterns=_IMPORT_ONLY + (r"\bbuild_",)),
}


def _forbidden(dotted: str) -> Optional[str]:
    for p in FORBIDDEN_DEVICE_IMPORTS:
        if dotted == p or dotted.startswith(p + "."):
            return p
    return None


def _imports_of(mod) -> List[Tuple[str, int]]:
    """(dotted target, line) for every import statement in the module,
    function-level imports included; ``from p import name`` edges
    cover both ``p`` and — when it resolves to a file — ``p.name``."""
    out: List[Tuple[str, int]] = []
    pkg_parts = mod.dotted.split(".")
    # a module's package: drop the leaf (``__init__`` already dropped)
    pkg = pkg_parts[:-1]
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out.append((a.name, node.lineno))
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[: len(pkg) - (node.level - 1)]
                target = ".".join(base + ([node.module]
                                          if node.module else []))
            else:
                target = node.module or ""
            if target:
                out.append((target, node.lineno))
                for a in node.names:
                    out.append((target + "." + a.name, node.lineno))
    return out


def _closure_findings(tree: SourceTree, root_rel: str) -> List[Finding]:
    """BFS the package-internal import graph from one device module;
    flag any reachable forbidden module, naming the import chain."""
    findings: List[Finding] = []
    root_mod = tree.module(root_rel)
    # rel -> (parent rel, import line in parent) for chain rendering
    seen: Dict[str, Optional[Tuple[str, int]]] = {root_rel: None}
    reported = set()       # (module, line, forbidden root) dedupe
    queue = [root_rel]
    while queue:
        rel = queue.pop(0)
        mod = tree.module(rel)
        for dotted, line in _imports_of(mod):
            bad = _forbidden(dotted)
            if bad is not None:
                if (rel, line, bad) in reported:
                    continue
                reported.add((rel, line, bad))
                # report at the DEVICE module (the actionable site):
                # for transitive hits, the chain names the path
                chain = [rel]
                cur = rel
                while seen.get(cur) is not None:
                    cur = seen[cur][0]
                    chain.append(cur)
                chain.reverse()
                first_line = (line if rel == root_rel
                              else _root_import_line(
                                  root_mod, tree, chain[1]))
                findings.append(Finding(
                    file=root_rel, line=first_line, pass_id=PASS_ID,
                    message="forbidden host-side module %r (matches "
                            "%r) reachable from device module via %s "
                            "(%s:%d)" % (dotted, bad,
                                         " -> ".join(chain), rel,
                                         line)))
                continue
            sub = tree.rel_of_dotted(dotted)
            if sub is not None and sub not in seen:
                seen[sub] = (rel, line)
                queue.append(sub)
    return findings


def _root_import_line(root_mod, tree: SourceTree, second_rel: str) -> int:
    """The line in the device module importing the first chain hop."""
    for dotted, line in _imports_of(root_mod):
        if tree.rel_of_dotted(dotted) == second_rel:
            return line
    return 1


def _pattern_findings(tree: SourceTree, rel: str, patterns,
                      what: str = "forbidden source pattern",
                      every: bool = False) -> List[Finding]:
    """One finding per pattern per file (the first matching line), or
    one per matching line with ``every`` (each host sync is a stall)."""
    mod = tree.module(rel)
    out: List[Finding] = []
    for pat in patterns:
        rx = re.compile(pat)
        for i, line in enumerate(mod.lines, 1):
            if rx.search(line):
                out.append(Finding(
                    file=rel, line=i, pass_id=PASS_ID,
                    message="%s %r: %r" %
                            (what, pat, line.strip()[:80])))
                if not every:
                    break     # one finding per pattern per file

    return out


def _host_pure_findings(tree: SourceTree, rel: str,
                        spec: dict) -> List[Finding]:
    mod = tree.module(rel)
    out: List[Finding] = []
    roots = spec.get("ban_imports", ())
    if roots:
        for dotted, line in _imports_of(mod):
            head = dotted.split(".")[0]
            if head in roots:
                out.append(Finding(
                    file=rel, line=line, pass_id=PASS_ID,
                    message="host-pure module imports accelerator "
                            "module %r" % dotted))
    for pat in spec.get("patterns", ()):
        rx = re.compile(pat)
        for i, line in enumerate(mod.lines, 1):
            if rx.search(line):
                out.append(Finding(
                    file=rel, line=i, pass_id=PASS_ID,
                    message="host-pure module matches accelerator "
                            "pattern %r: %r" % (pat,
                                                line.strip()[:80])))
                break
    return out


def run(tree: SourceTree) -> List[Finding]:
    findings: List[Finding] = []
    for rel in DEVICE_MODULES:
        if not tree.has(rel):
            continue          # partial fixture trees
        findings.extend(_closure_findings(tree, rel))
        findings.extend(_pattern_findings(tree, rel, SCAN_PATTERNS))
    for rel in HOST_SYNC_MODULES:
        if tree.has(rel):
            findings.extend(_pattern_findings(tree, rel,
                                              HOST_SYNC_PATTERNS,
                                              what="host sync",
                                              every=True))
    for rel, spec in HOST_PURE_MODULES.items():
        if tree.has(rel):
            findings.extend(_host_pure_findings(tree, rel, spec))
    return findings
