"""cache-key pass: every program builder folds every static flag it
reads into its STEP_CACHE key — the port of
``rdma_paxos_tpu/analysis/cachekey.py``.

The port builds its step programs per engine instance today and has no
store site, so the pass finds nothing to check on this tree. It stays
because a per-geometry cache of built programs (CUDA graphs of the
stable step, one per geometry and flag set) is exactly the bug class it
closes.

The bug class this closes: a PR threads a new static build flag (like
``audit=`` or ``telemetry=``) into a builder's ``build_*`` call but
forgets to add it to the cache key — two clusters with different flag
values then silently share one compiled program. The per-geometry
cache-key-guard tests pin one flag combination each; this pass checks
the KEY EXPRESSION itself against the reads, for every builder at
once.

Rule, per ``STEP_CACHE[key] = ...`` (or ``self._STEP_CACHE[...]``)
store site:

- the "miss scope" is the smallest enclosing ``if`` statement (the
  cache-miss guard) or, failing that, the enclosing function;
- candidates are every ``self.<attr>`` read and every free-variable
  name read inside the miss scope (the values that shape the program
  being built), plus any read of a registered static flag anywhere in
  the enclosing function;
- each candidate must appear in the key expression — as an attribute,
  a name, or via the ``COVERED_BY`` map (e.g. ``self.mesh``, the
  ``DeviceLayout``, is covered by its hashable ``.key`` in the key).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from rdma_paxos_tpu_torch.analysis.engine import (
    Finding, SourceTree, attr_chain)

PASS_ID = "cache-key"

# attribute names that are static program-shaping flags wherever they
# are read in a builder (new flags get added HERE, once)
STATIC_FLAGS: Set[str] = {
    "cfg", "R", "_mode", "_fanout", "_audit", "_telemetry", "_txn",
    # the device layout (parallel/mesh.py:DeviceLayout)
    "mesh",
}

# reads that are legitimately NOT in the key because another key
# component fully determines them: candidate -> acceptable witnesses
COVERED_BY: Dict[str, Tuple[str, ...]] = {
    # the layout's hashable form (shape, axes, device names)
    "mesh": ("key",),
}

# never program-shaping: cache plumbing and builder machinery
IGNORED: Set[str] = {
    "self", "STEP_CACHE", "_STEP_CACHE", "get", "dict",
}


def _store_sites(mod) -> List[ast.Assign]:
    out = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t = node.targets[0]
        if isinstance(t, ast.Subscript):
            chain = attr_chain(t.value)
            if chain and chain.split(".")[-1].endswith("STEP_CACHE"):
                out.append(node)
    return out


def _miss_scope(mod, store: ast.Assign) -> ast.AST:
    """Smallest enclosing If (the cache-miss guard), else function,
    else module."""
    func = mod.enclosing_function(store)
    for anc in mod.ancestors(store):
        if isinstance(anc, ast.If):
            return anc
        if anc is func:
            break
    return func if func is not None else mod.tree


def _key_expr(mod, store: ast.Assign) -> Optional[ast.AST]:
    """Resolve the key expression for a store site: the subscript's
    index if it is not a bare name, else the nearest preceding
    assignment to that name in the enclosing function/module."""
    sub = store.targets[0]
    idx = sub.slice
    if not isinstance(idx, ast.Name):
        return idx
    key_name = idx.id
    func = mod.enclosing_function(store) or mod.tree
    best = None
    for node in ast.walk(func):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == key_name
                and node.lineno <= store.lineno):
            if best is None or node.lineno > best.lineno:
                best = node
    return best.value if best is not None else None


def _expr_tokens(expr: ast.AST) -> Set[str]:
    """Every attribute name, bare name, and string constant appearing
    in the key expression — the set of things the key 'contains'."""
    toks: Set[str] = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute):
            toks.add(node.attr)
        elif isinstance(node, ast.Name):
            toks.add(node.id)
        elif isinstance(node, ast.Constant) and isinstance(node.value,
                                                          str):
            toks.add(node.value)
    return toks


def _bound_names(scope: ast.AST) -> Set[str]:
    """Names assigned (or imported/bound) inside the scope — local
    plumbing like ``fn``/``kw``/loop vars, not inputs."""
    bound: Set[str] = set()
    for node in ast.walk(scope):
        if isinstance(node, ast.Name) and isinstance(
                node.ctx, (ast.Store, ast.Del)):
            bound.add(node.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                bound.add((a.asname or a.name).split(".")[0])
    return bound


def _candidates(mod, scope: ast.AST, func,
                exclude: Set[str] = frozenset()) -> Dict[str, int]:
    """candidate name -> first line read. Self-attrs + free names in
    the miss scope; registered static-flag attrs anywhere in the
    enclosing function. ``exclude`` drops the key variable itself."""
    cands: Dict[str, int] = {}
    bound = _bound_names(scope) | set(exclude)
    call_heads: Set[str] = set()
    for node in ast.walk(scope):
        if isinstance(node, ast.Call):
            head = attr_chain(node.func)
            if head is not None and "." not in head:
                call_heads.add(head)

    def _see(name: str, line: int) -> None:
        if name in IGNORED or name in cands:
            return
        cands[name] = line

    for node in ast.walk(scope):
        if isinstance(node, ast.Attribute) and isinstance(node.ctx,
                                                         ast.Load):
            if isinstance(node.value, ast.Name) \
                    and node.value.id == "self":
                _see(node.attr, node.lineno)
        elif isinstance(node, ast.Name) and isinstance(node.ctx,
                                                       ast.Load):
            if node.id in bound or node.id in call_heads:
                continue
            _see(node.id, node.lineno)
    if func is not None:
        for node in ast.walk(func):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.ctx, ast.Load)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and node.attr in STATIC_FLAGS):
                if node.attr not in cands:
                    cands[node.attr] = node.lineno
    return cands


def _covered(name: str, toks: Set[str]) -> bool:
    if name in toks:
        return True
    return any(w in toks for w in COVERED_BY.get(name, ()))


def default_scope(tree: SourceTree) -> List[str]:
    """Every package file mentioning STEP_CACHE stores is a builder
    module — derived, not listed, so new builder homes are
    auto-covered."""
    out = []
    for rel in tree.files():
        if "STEP_CACHE[" in tree.module(rel).text:
            out.append(rel)
    return out


def run(tree: SourceTree,
        scope: Optional[Sequence[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for rel in (scope or default_scope(tree)):
        mod = tree.module(rel)
        for store in _store_sites(mod):
            key = _key_expr(mod, store)
            if key is None:
                findings.append(Finding(
                    file=rel, line=store.lineno, pass_id=PASS_ID,
                    message="STEP_CACHE store whose key expression "
                            "cannot be resolved — use a local "
                            "``key = (...)`` tuple"))
                continue
            toks = _expr_tokens(key)
            miss = _miss_scope(mod, store)
            func = mod.enclosing_function(store)
            idx = store.targets[0].slice
            keyvars = ({idx.id} if isinstance(idx, ast.Name)
                       else set())
            for name, line in sorted(
                    _candidates(mod, miss, func,
                                exclude=keyvars).items(),
                    key=lambda kv: kv[1]):
                if not _covered(name, toks):
                    findings.append(Finding(
                        file=rel, line=line, pass_id=PASS_ID,
                        message="builder reads %r but the STEP_CACHE "
                                "key (line %d) does not carry it — "
                                "two clusters differing in %r would "
                                "share one compiled program" %
                                (name, store.lineno, name)))
    return findings
