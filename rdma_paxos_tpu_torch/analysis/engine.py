"""graftlint engine for the PyTorch package: source-tree model,
Finding, baseline, pass runner.

The port of ``rdma_paxos_tpu/analysis/engine.py``, with the same
semantics over the ``rdma_paxos_tpu_torch`` tree. Pure stdlib (ast +
re): the analyzer runs before anything heavy imports, on a machine with
no JAX and without importing torch or numpy itself. Python 3.10
compatible: ``baseline.toml`` is read by a minimal TOML-subset parser
(tomllib only exists from 3.11), which covers exactly the grammar the
baseline uses — ``[[suppress]]`` table arrays of string key/values.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PASS_IDS = ("jit-purity", "cache-key", "lock-discipline",
            "determinism", "thread-hygiene")


def repo_root() -> str:
    """The directory holding the ``rdma_paxos_tpu_torch`` package (the
    analyzer runs on its own checkout unless told otherwise)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def default_baseline_path(root: Optional[str] = None) -> str:
    root = root or repo_root()
    return os.path.join(root, "rdma_paxos_tpu_torch", "analysis",
                        "baseline.toml")


@dataclass(frozen=True)
class Finding:
    """One invariant violation at an exact source location."""

    file: str        # repo-relative, forward slashes
    line: int
    pass_id: str
    message: str

    def __str__(self) -> str:
        return "%s:%d: [%s] %s" % (self.file, self.line, self.pass_id,
                                   self.message)

    def to_dict(self) -> dict:
        return dict(file=self.file, line=self.line,
                    pass_id=self.pass_id, message=self.message)


class ModuleSrc:
    """One parsed source file: text, lines, AST with parent links."""

    def __init__(self, root: str, rel: str):
        self.rel = rel
        self.path = os.path.join(root, rel)
        with open(self.path, "r", encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=rel)
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    @property
    def dotted(self) -> str:
        """``rdma_paxos_tpu_torch/obs/audit.py`` ->
        ``rdma_paxos_tpu_torch.obs.audit`` (packages map to their
        ``__init__``'s dotted name)."""
        mod = self.rel[:-3].replace("/", ".")
        if mod.endswith(".__init__"):
            mod = mod[: -len(".__init__")]
        return mod

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def enclosing_function(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None


class SourceTree:
    """Lazy parsed view of the package source under ``root``."""

    PACKAGE = "rdma_paxos_tpu_torch"

    def __init__(self, root: Optional[str] = None):
        self.root = os.path.abspath(root or repo_root())
        self._cache: Dict[str, ModuleSrc] = {}

    def files(self) -> List[str]:
        out = []
        pkg = os.path.join(self.root, self.PACKAGE)
        for dirpath, dirnames, filenames in os.walk(pkg):
            dirnames[:] = [d for d in sorted(dirnames)
                           if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, fn),
                                          self.root)
                    out.append(rel.replace(os.sep, "/"))
        return out

    def has(self, rel: str) -> bool:
        return os.path.exists(os.path.join(self.root, rel))

    def module(self, rel: str) -> ModuleSrc:
        rel = rel.replace(os.sep, "/")
        m = self._cache.get(rel)
        if m is None:
            m = self._cache[rel] = ModuleSrc(self.root, rel)
        return m

    def rel_of_dotted(self, dotted: str) -> Optional[str]:
        """Dotted module name -> repo-relative path, or None when the
        name does not resolve inside the package tree."""
        base = dotted.replace(".", "/")
        for cand in (base + ".py", base + "/__init__.py"):
            if self.has(cand):
                return cand
        return None


# ---------------------------------------------------------------------------
# baseline (justified suppressions)
# ---------------------------------------------------------------------------

@dataclass
class Suppression:
    pass_id: str
    file: str
    contains: str
    reason: str = ""
    # optional second selector: when set, BOTH substrings must match.
    # Lock-discipline entries use it to pin (field, function) pairs —
    # contains="read of '_tickets'" + symbol="block in step()" — so a
    # FUTURE unlocked access to a different field in the same function
    # is never silently excused by a triaged peek's entry.
    symbol: str = ""
    used: int = field(default=0, compare=False)

    def matches(self, f: Finding) -> bool:
        return (f.pass_id == self.pass_id and f.file == self.file
                and self.contains in f.message
                and (not self.symbol or self.symbol in f.message))


_KV_RE = re.compile(r'^\s*([A-Za-z_][\w-]*)\s*=\s*"((?:[^"\\]|\\.)*)"\s*$')


def _toml_unescape(s: str) -> str:
    return (s.replace("\\\\", "\x00").replace('\\"', '"')
            .replace("\\n", "\n").replace("\\t", "\t")
            .replace("\x00", "\\"))


def _toml_escape(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n").replace("\t", "\\t"))


def load_baseline(path: str) -> List[Suppression]:
    """Parse the TOML subset the baseline uses: comments, blank lines,
    ``[[suppress]]`` headers, and ``key = "string"`` pairs. Anything
    else is an error — the file is machine-written and hand-justified,
    and a silent partial parse would silently drop suppressions."""
    if not os.path.exists(path):
        return []
    entries: List[Suppression] = []
    cur: Optional[dict] = None
    with open(path, "r", encoding="utf-8") as f:
        for ln, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line == "[[suppress]]":
                cur = {}
                entries.append(cur)  # type: ignore[arg-type]
                continue
            m = _KV_RE.match(line)
            if m and cur is not None:
                cur[m.group(1)] = _toml_unescape(m.group(2))
                continue
            raise ValueError(
                "%s:%d: unsupported baseline syntax: %r" %
                (path, ln, line))
    out = []
    for e in entries:
        missing = {"pass", "file", "contains"} - set(e)
        if missing:
            raise ValueError(
                "%s: [[suppress]] entry missing keys %s: %r" %
                (path, sorted(missing), e))
        out.append(Suppression(pass_id=e["pass"], file=e["file"],
                               contains=e["contains"],
                               symbol=e.get("symbol", ""),
                               reason=e.get("reason", "")))
    return out


def render_baseline(entries: Sequence[Suppression],
                    header: str = "") -> str:
    parts = []
    if header:
        parts.append("\n".join("# " + h if h else "#"
                               for h in header.splitlines()))
        parts.append("")
    for e in entries:
        parts.append("[[suppress]]")
        parts.append('pass = "%s"' % _toml_escape(e.pass_id))
        parts.append('file = "%s"' % _toml_escape(e.file))
        parts.append('contains = "%s"' % _toml_escape(e.contains))
        if e.symbol:
            parts.append('symbol = "%s"' % _toml_escape(e.symbol))
        parts.append('reason = "%s"' % _toml_escape(
            e.reason or "TODO: justify this suppression"))
        parts.append("")
    return "\n".join(parts).rstrip() + "\n"


# ---------------------------------------------------------------------------
# pass registry + runner
# ---------------------------------------------------------------------------

def _passes() -> Dict[str, object]:
    # imported here (not at module top) so ``engine`` stays importable
    # from the pass modules without a cycle
    from rdma_paxos_tpu_torch.analysis import (
        cachekey, determinism, hygiene, locks, purity)
    return {
        "jit-purity": purity.run,
        "cache-key": cachekey.run,
        "lock-discipline": locks.run,
        "determinism": determinism.run,
        "thread-hygiene": hygiene.run,
    }


@dataclass
class Report:
    findings: List[Finding]                  # NOT baselined — failures
    suppressed: List[Tuple[Finding, Suppression]]
    unused_suppressions: List[Suppression]
    all_findings: List[Finding]

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return dict(
            ok=self.ok,
            findings=[f.to_dict() for f in self.findings],
            suppressed=[
                dict(finding=f.to_dict(), reason=s.reason)
                for f, s in self.suppressed],
            unused_suppressions=[
                dict(pass_id=s.pass_id, file=s.file,
                     contains=s.contains, reason=s.reason)
                for s in self.unused_suppressions])

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)


def run_analysis(root: Optional[str] = None,
                 passes: Optional[Sequence[str]] = None,
                 baseline: Optional[str] = "auto") -> Report:
    """Run the requested passes (default: all five) over the tree at
    ``root`` and fold the baseline in. ``baseline`` is a path, None
    (no suppression), or "auto" (the checked-in baseline.toml)."""
    tree = SourceTree(root)
    registry = _passes()
    ids = list(passes or PASS_IDS)
    unknown = [p for p in ids if p not in registry]
    if unknown:
        raise ValueError("unknown pass(es): %s (known: %s)" %
                         (unknown, list(registry)))
    all_findings: List[Finding] = []
    for pid in ids:
        all_findings.extend(registry[pid](tree))
    all_findings.sort(key=lambda f: (f.file, f.line, f.pass_id))

    if baseline == "auto":
        baseline = default_baseline_path(tree.root)
    sups = load_baseline(baseline) if baseline else []
    live: List[Finding] = []
    suppressed: List[Tuple[Finding, Suppression]] = []
    for f in all_findings:
        hit = next((s for s in sups if s.matches(f)), None)
        if hit is None:
            live.append(f)
        else:
            hit.used += 1
            suppressed.append((f, hit))
    unused = [s for s in sups if s.used == 0
              and (passes is None or s.pass_id in ids)]
    return Report(findings=live, suppressed=suppressed,
                  unused_suppressions=unused,
                  all_findings=all_findings)


# ---------------------------------------------------------------------------
# small shared AST helpers the passes use
# ---------------------------------------------------------------------------

def attr_chain(node: ast.AST) -> Optional[str]:
    """``self.cluster._host_lock`` -> "self.cluster._host_lock";
    None for expressions that are not a pure Name/Attribute chain."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: ast.AST) -> Dict[str, str]:
    """Local name -> dotted module for plain ``import x [as y]``
    statements anywhere in the module (function-level included)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = a.name
    return out
