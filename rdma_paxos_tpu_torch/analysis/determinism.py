"""determinism pass: no wall clock / unseeded randomness in the
chaos, replay, and step-domain modules — the port of
``rdma_paxos_tpu/analysis/determinism.py``.

Chaos verdicts, recorded workloads, and step-domain protocol logic
must replay bit-identically from a seed; a single ``time.time()`` or
global-state ``random.random()`` in those paths silently turns a
reproducer artifact into a flake. ``obs/clock.py`` is the one
sanctioned wall anchor — everything in scope here must either be
step-domain or draw randomness from an explicitly seeded generator
(``random.Random(seed)``, ``np.random.default_rng(seed)``, a
``torch.Generator`` passed as ``generator=``). Where JAX allows
``jax.random`` keys, the port bans torch's global-state generator: a
``torch.rand``/``randn``/``randint``/``randperm``/``bernoulli``/
``multinomial``/``normal`` call with no ``generator=`` keyword, and
``torch.manual_seed`` (reseeding the process-wide generator couples
every caller in the process).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence

from rdma_paxos_tpu_torch.analysis.engine import (
    Finding, SourceTree, import_aliases)

PASS_ID = "determinism"

# the replay-deterministic scope: chaos + step-domain protocol/engine
# code. Drivers/daemons/obs are wall-clock domain by design (poll
# cadences, timeouts, exporters) and are NOT in scope.
SCOPE = (
    "rdma_paxos_tpu_torch/chaos/",
    "rdma_paxos_tpu_torch/consensus/",
    "rdma_paxos_tpu_torch/ops/",
    "rdma_paxos_tpu_torch/parallel/",
    "rdma_paxos_tpu_torch/shard/",
    "rdma_paxos_tpu_torch/runtime/sim.py",
    "rdma_paxos_tpu_torch/runtime/timers.py",
    "rdma_paxos_tpu_torch/runtime/hostpath.py",
    # governor decisions must be pure step-domain functions of the
    # observed inputs (chaos verdicts with a governor attached stay
    # bit-reproducible) — no wall clock, no unseeded randomness
    "rdma_paxos_tpu_torch/runtime/governor.py",
)

# attribute references (calls or not — a ``clock=time.monotonic``
# default argument smuggles the wall clock in just as surely)
BANNED_TIME = {"time", "monotonic", "perf_counter", "perf_counter_ns",
               "monotonic_ns", "time_ns", "sleep", "clock"}
BANNED_DATETIME = {"now", "utcnow", "today"}
# global-state randomness; seeded constructors stay legal
ALLOWED_RANDOM = {"Random", "SystemRandom"}
ALLOWED_NP_RANDOM = {"default_rng", "Generator", "SeedSequence",
                     "BitGenerator", "PCG64", "Philox"}
# torch's sampling functions: legal only with an explicit generator=
TORCH_RNG = {"rand", "randn", "randint", "randperm", "bernoulli",
             "multinomial", "normal"}
# reseeding the process-wide generator (torch.manual_seed,
# torch.cuda.manual_seed[_all], torch.random.manual_seed, torch.seed)
TORCH_GLOBAL_SEED = {"manual_seed", "manual_seed_all", "seed"}


def in_scope(rel: str, scope: Sequence[str] = SCOPE) -> bool:
    return any(rel == s or (s.endswith("/") and rel.startswith(s))
               for s in scope)


def _module_of(aliases: Dict[str, str], node: ast.AST) -> Optional[str]:
    """For ``X.attr`` where X is a Name bound by ``import m as X``,
    the dotted module m; else None."""
    if isinstance(node, ast.Name):
        return aliases.get(node.id)
    return None


def run(tree: SourceTree,
        scope: Sequence[str] = SCOPE) -> List[Finding]:
    findings: List[Finding] = []
    for rel in tree.files():
        if not in_scope(rel, scope):
            continue
        mod = tree.module(rel)
        aliases = import_aliases(mod.tree)
        # from-imports smuggle the same seams as attribute access:
        # ``from time import perf_counter`` is a bare Name at the call
        # site, invisible to the attribute walk below — flag the
        # import itself (the import IS the wall-clock dependency)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ImportFrom) or node.level:
                continue
            if node.module == "time":
                for a in node.names:
                    if a.name in BANNED_TIME:
                        findings.append(Finding(
                            file=rel, line=node.lineno,
                            pass_id=PASS_ID,
                            message="wall clock from-import time.%s "
                                    "in a replay-deterministic module"
                                    % a.name))
            elif node.module == "random":
                for a in node.names:
                    if a.name not in ALLOWED_RANDOM:
                        findings.append(Finding(
                            file=rel, line=node.lineno,
                            pass_id=PASS_ID,
                            message="global-state randomness "
                                    "from-import random.%s — use a "
                                    "seeded random.Random(...)"
                                    % a.name))
            elif node.module == "datetime":
                for a in node.names:
                    if a.name in ("datetime", "date"):
                        findings.append(Finding(
                            file=rel, line=node.lineno,
                            pass_id=PASS_ID,
                            message="wall clock from-import "
                                    "datetime.%s in a replay-"
                                    "deterministic module (its "
                                    ".now()/.today() are wall "
                                    "anchors)" % a.name))
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Attribute):
                continue
            base = _module_of(aliases, node.value)
            if base is None:
                # datetime.datetime.now: Attribute over Attribute
                if (isinstance(node.value, ast.Attribute)
                        and node.value.attr == "datetime"
                        and _module_of(aliases,
                                       node.value.value) == "datetime"
                        and node.attr in BANNED_DATETIME):
                    findings.append(Finding(
                        file=rel, line=node.lineno, pass_id=PASS_ID,
                        message="wall clock datetime.datetime.%s in a "
                                "replay-deterministic module" %
                                node.attr))
                continue
            if base == "time" and node.attr in BANNED_TIME:
                findings.append(Finding(
                    file=rel, line=node.lineno, pass_id=PASS_ID,
                    message="wall clock time.%s in a replay-"
                            "deterministic module (obs/clock.py is "
                            "the single wall anchor)" % node.attr))
            elif base == "random" and node.attr not in ALLOWED_RANDOM:
                findings.append(Finding(
                    file=rel, line=node.lineno, pass_id=PASS_ID,
                    message="global-state randomness random.%s — use "
                            "a seeded random.Random(...)" % node.attr))
            elif (base == "numpy" and isinstance(node.value,
                                                 ast.Attribute)):
                pass    # handled below via numpy.random chain
        # numpy.random.X chains: np.random.<fn> with np aliasing numpy
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Attribute)
                    and node.value.attr == "random"
                    and _module_of(aliases,
                                   node.value.value) == "numpy"
                    and node.attr not in ALLOWED_NP_RANDOM):
                findings.append(Finding(
                    file=rel, line=node.lineno, pass_id=PASS_ID,
                    message="global-state randomness np.random.%s — "
                            "use np.random.default_rng(seed)" %
                            node.attr))
        findings.extend(_torch_rng_findings(mod, rel, aliases))
    return findings


def _torch_root(aliases: Dict[str, str], node: ast.AST) -> bool:
    """Is ``node`` an attribute chain rooted at a name bound to the
    ``torch`` package (``torch.x.y``, ``import torch as t``)?"""
    while isinstance(node, ast.Attribute):
        node = node.value
    return (isinstance(node, ast.Name)
            and aliases.get(node.id, "").split(".")[0] == "torch")


def _torch_rng_findings(mod, rel: str,
                        aliases: Dict[str, str]) -> List[Finding]:
    out: List[Finding] = []
    direct = {}         # from torch import randn [as r] -> local name
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.ImportFrom) and not node.level
                and (node.module or "").split(".")[0] == "torch"):
            for a in node.names:
                if a.name in TORCH_GLOBAL_SEED:
                    out.append(Finding(
                        file=rel, line=node.lineno, pass_id=PASS_ID,
                        message="global-state randomness from-import "
                                "%s.%s — pass a seeded torch.Generator"
                                % (node.module, a.name)))
                elif a.name in TORCH_RNG:
                    direct[a.asname or a.name] = a.name
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.Attribute)
                and node.attr in TORCH_GLOBAL_SEED
                and _torch_root(aliases, node.value)):
            out.append(Finding(
                file=rel, line=node.lineno, pass_id=PASS_ID,
                message="global-state randomness torch %s — pass a "
                        "seeded torch.Generator" % node.attr))
            continue
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr in TORCH_RNG
                and _torch_root(aliases, f.value)):
            name = f.attr
        elif isinstance(f, ast.Name) and f.id in direct:
            name = direct[f.id]
        else:
            continue
        if not any(kw.arg == "generator" for kw in node.keywords):
            out.append(Finding(
                file=rel, line=node.lineno, pass_id=PASS_ID,
                message="global-state randomness torch.%s without "
                        "generator= — pass a seeded torch.Generator"
                        % name))
    return out
