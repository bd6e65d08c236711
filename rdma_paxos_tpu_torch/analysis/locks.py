"""lock-discipline pass: every access to a ``# guarded-by:``-annotated
field happens under its declared lock — the port of
``rdma_paxos_tpu/analysis/locks.py``, with the same grammar over the
port's copies of the same thirteen threaded modules.

This is the single largest class of fixed faults in this repo's
history (ticket-retirement/submit()/_drive_config_change races, the
ReadHub ticket race, the tied-term merge crash): host state shared
between the dispatch thread, the readback thread, and app/client
threads, mutated one forgotten lock away from a race. The fields now
DECLARE their lock in the source, and this pass (plus the
``RP_SANITIZE=1`` runtime proxy in ``runtime_guard.py``) enforces it.

Annotation grammar, on (or directly above) the field's ``__init__``
assignment::

    self.pending = ...          # guarded-by: _host_lock
    self.last = None            # guarded-by: _host_lock [writes]
    self._submitq = ...         # guarded-by: _lock [strict]

- default: reads AND writes must hold the lock statically; the
  runtime sanitizer asserts writes.
- ``[writes]``: only writes are checked (lock-free reads are part of
  the field's published contract — e.g. pointer-swap publication of
  an immutable snapshot).
- ``[strict]``: like the default, and the runtime sanitizer asserts
  READS too (no lock-free read of this field exists anywhere).

Function-level exemptions:

- ``__init__`` bodies (construction precedes sharing);
- functions whose name ends in ``_locked`` (the repo's existing
  caller-holds-the-lock naming contract);
- functions carrying ``# holds-lock: <lockname>`` on or above the
  ``def`` line (documented caller-holds contract without the suffix).

Anything else is a finding; intentional lock-free accesses that are
genuinely safe get a one-line justification in ``baseline.toml``.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Dict, List, Sequence

from rdma_paxos_tpu_torch.analysis.engine import (
    Finding, SourceTree, attr_chain)

PASS_ID = "lock-discipline"

# the threaded runtime modules: where guarded fields are declared AND
# where accesses are checked (attr-name matching also catches e.g.
# ``self.cluster.pending`` reads from the drivers)
LOCK_MODULES = (
    "rdma_paxos_tpu_torch/runtime/sim.py",
    "rdma_paxos_tpu_torch/runtime/driver.py",
    "rdma_paxos_tpu_torch/runtime/sharded_driver.py",
    "rdma_paxos_tpu_torch/runtime/repair.py",
    "rdma_paxos_tpu_torch/runtime/reads.py",
    "rdma_paxos_tpu_torch/runtime/governor.py",
    "rdma_paxos_tpu_torch/shard/cluster.py",
    "rdma_paxos_tpu_torch/streams/__init__.py",
    "rdma_paxos_tpu_torch/streams/scan.py",
    "rdma_paxos_tpu_torch/streams/watch.py",
    "rdma_paxos_tpu_torch/topology/transition.py",
    "rdma_paxos_tpu_torch/topology/policy.py",
    "rdma_paxos_tpu_torch/obs/tracectx.py",
)

_GUARD_RE = re.compile(
    r"#\s*guarded-by:\s*([A-Za-z_]\w*)(?:\s*\[(\w+)\])?")
_FIELD_RE = re.compile(r"self\.([A-Za-z_]\w*)\s*[:=]")
_HOLDS_RE = re.compile(r"#\s*holds-lock:\s*([A-Za-z_]\w*)")

MODES = ("full", "writes", "strict")


@dataclass(frozen=True)
class GuardedField:
    attr: str
    lock: str          # lock attribute name, e.g. "_host_lock"
    mode: str          # "full" | "writes" | "strict"
    file: str
    line: int


def parse_registry_text(text: str, rel: str) -> List[GuardedField]:
    """Extract guarded-field declarations from one module's source.
    The annotated field is the ``self.X = / self.X:`` on the comment's
    own line, else the first such assignment within the next 3 lines
    (annotation-above style)."""
    out: List[GuardedField] = []
    lines = text.splitlines()
    for i, line in enumerate(lines):
        m = _GUARD_RE.search(line)
        if m is None:
            continue
        lock, mode = m.group(1), (m.group(2) or "full")
        for j in range(i, min(i + 4, len(lines))):
            fm = _FIELD_RE.search(lines[j])
            if fm:
                out.append(GuardedField(
                    attr=fm.group(1), lock=lock, mode=mode,
                    file=rel, line=j + 1))
                break
    return out


def build_registry(tree: SourceTree,
                   modules: Sequence[str] = LOCK_MODULES
                   ) -> (Dict[str, GuardedField], List[Finding]):
    """attr -> declaration, plus findings for malformed/conflicting
    declarations (same attr declared under different locks across the
    threaded modules would make name-based checking ambiguous)."""
    reg: Dict[str, GuardedField] = {}
    findings: List[Finding] = []
    for rel in modules:
        if not tree.has(rel):
            continue
        mod = tree.module(rel)
        for gf in parse_registry_text(mod.text, rel):
            if gf.mode not in MODES:
                findings.append(Finding(
                    file=rel, line=gf.line, pass_id=PASS_ID,
                    message="unknown guarded-by mode %r for %r "
                            "(expected one of %s)" %
                            (gf.mode, gf.attr, list(MODES))))
                continue
            prev = reg.get(gf.attr)
            if prev is not None and (prev.lock != gf.lock
                                     or prev.mode != gf.mode):
                findings.append(Finding(
                    file=rel, line=gf.line, pass_id=PASS_ID,
                    message="field %r re-declared as guarded-by %s "
                            "[%s], conflicting with %s:%d (%s [%s])" %
                            (gf.attr, gf.lock, gf.mode, prev.file,
                             prev.line, prev.lock, prev.mode)))
                continue
            reg.setdefault(gf.attr, gf)
    return reg, findings


def _holds_locks(mod, func) -> set:
    """Lock names a function declares it is called under: the
    ``_locked`` suffix (all locks) or ``# holds-lock:`` comments on or
    directly above the def line."""
    if func.name.endswith("_locked"):
        return {"*"}
    locks = set()
    for ln in range(max(0, func.lineno - 2), func.lineno):
        m = _HOLDS_RE.search(mod.lines[ln])
        if m:
            locks.add(m.group(1))
    # decorator lines can push the def down; also scan the def line(s)
    m = _HOLDS_RE.search(mod.lines[func.lineno - 1])
    if m:
        locks.add(m.group(1))
    return locks


def _with_held(mod, node: ast.AST, lock: str, func) -> bool:
    """Is ``node`` lexically inside a ``with`` whose items include an
    expression ending in ``.{lock}`` (any receiver), within ``func``?"""
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.With):
            for item in anc.items:
                chain = attr_chain(item.context_expr)
                if chain and chain.split(".")[-1] == lock:
                    return True
        if anc is func:
            break
    return False


def run(tree: SourceTree,
        modules: Sequence[str] = LOCK_MODULES) -> List[Finding]:
    reg, findings = build_registry(tree, modules)
    if not reg:
        return findings
    for rel in modules:
        if not tree.has(rel):
            continue
        mod = tree.module(rel)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Attribute):
                continue
            gf = reg.get(node.attr)
            if gf is None:
                continue
            is_write = isinstance(node.ctx, (ast.Store, ast.Del))
            if gf.mode == "writes" and not is_write:
                continue
            func = mod.enclosing_function(node)
            if func is None:
                continue          # module-level: import-time, single
            if func.name == "__init__":
                continue          # construction precedes sharing
            held = _holds_locks(mod, func)
            if "*" in held or gf.lock in held:
                continue
            if _with_held(mod, node, gf.lock, func):
                continue
            findings.append(Finding(
                file=rel, line=node.lineno, pass_id=PASS_ID,
                message="%s of %r (guarded-by %s, declared %s:%d) "
                        "outside a `with ...%s` block in %s()" %
                        ("write" if is_write else "read", node.attr,
                         gf.lock, gf.file, gf.line, gf.lock,
                         func.name)))
    return findings
