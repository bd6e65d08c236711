"""thread-hygiene pass: spawned threads have a stop/join path, and
HTTP serving handlers answer errors rather than die — the port of
``rdma_paxos_tpu/analysis/hygiene.py``.

Two rules, both distilled from fixed faults:

1. every ``threading.Thread(...)`` construction either passes
   ``daemon=True`` (process exit reaps it) or the module contains a
   ``.join(`` call on the attribute/name the thread is bound to (an
   explicit stop path). A non-daemon thread with no join wedges
   interpreter shutdown the first time its loop blocks.

2. every ``do_*`` method of a ``*RequestHandler`` subclass wraps its
   body in ``try`` at the top level — the PR 12 rule: a probe/metrics
   endpoint answers 500, it never kills its own serving thread.
"""

from __future__ import annotations

import ast
from typing import List

from rdma_paxos_tpu_torch.analysis.engine import (
    Finding, SourceTree, attr_chain)

PASS_ID = "thread-hygiene"


def _thread_calls(mod) -> List[ast.Call]:
    out = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain in ("threading.Thread", "Thread"):
                out.append(node)
    return out


def _is_daemon(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon":
            return (isinstance(kw.value, ast.Constant)
                    and bool(kw.value.value))
    return False


def _daemon_assigned(mod) -> bool:
    """``t.daemon = True`` set after construction counts too."""
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Attribute)
                and node.targets[0].attr == "daemon"
                and isinstance(node.value, ast.Constant)
                and bool(node.value.value)):
            return True
    return False


def _thread_names(mod) -> set:
    """Attr/name targets Thread objects are assigned to in this
    module (``self._rb_thread = Thread(...)`` -> ``_rb_thread``)."""
    names = set()
    for call in _thread_calls(mod):
        parent = mod.parent(call)
        if isinstance(parent, ast.Assign):
            for t in parent.targets:
                if isinstance(t, ast.Attribute):
                    names.add(t.attr)
                elif isinstance(t, ast.Name):
                    names.add(t.id)
    return names


def _has_join(mod) -> bool:
    """A ``.join(...)`` call counts as a stop path when its receiver
    is a bare local name (the ``t, self._x = self._x, None; t.join()``
    temp idiom) or an attribute matching a name a Thread was assigned
    to — so an unrelated ``self._sep.join(parts)`` string join can
    never bless an unreaped thread."""
    tnames = _thread_names(mod)
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"):
            recv = node.func.value
            if isinstance(recv, ast.Name):
                return True
            if isinstance(recv, ast.Attribute) and recv.attr in tnames:
                return True
    return False


def _handler_findings(mod, rel: str) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        if not any(
                (attr_chain(b) or "").split(".")[-1].endswith(
                    "RequestHandler")
                for b in node.bases):
            continue
        for item in node.body:
            if (isinstance(item, ast.FunctionDef)
                    and item.name.startswith("do_")):
                body = [s for s in item.body
                        if not (isinstance(s, ast.Expr)
                                and isinstance(s.value, ast.Constant))]
                if not (len(body) == 1
                        and isinstance(body[0], ast.Try)):
                    out.append(Finding(
                        file=rel, line=item.lineno, pass_id=PASS_ID,
                        message="HTTP handler %s.%s must wrap its "
                                "whole body in try/except — serving "
                                "handlers answer errors (500), they "
                                "never kill the serving thread" %
                                (node.name, item.name)))
    return out


def run(tree: SourceTree) -> List[Finding]:
    findings: List[Finding] = []
    for rel in tree.files():
        mod = tree.module(rel)
        if "Thread" in mod.text:
            daemon_later = _daemon_assigned(mod)
            for call in _thread_calls(mod):
                if _is_daemon(call) or daemon_later:
                    continue
                if _has_join(mod):
                    continue
                findings.append(Finding(
                    file=rel, line=call.lineno, pass_id=PASS_ID,
                    message="threading.Thread without daemon=True or "
                            "a .join() stop path in this module — "
                            "the thread has no reaping story"))
        if "RequestHandler" in mod.text:
            findings.extend(_handler_findings(mod, rel))
    return findings
