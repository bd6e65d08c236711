"""Per-key-partitioned Wing–Gong linearizability checker (memoized).

The port's copy of the JAX package's ``chaos/linearize.py`` (standard library
and numpy only).

Checks a recorded client history (``chaos.history``) against the KVS
register model: per key, the sequence of PUT/RM/GET operations must
admit a total order that (a) respects real time — an op that completed
before another was invoked precedes it — and (b) is legal for a single
register: every GET returns the latest preceding PUT's value (or
absent after RM / initially).

Linearizability is *compositional* (Herlihy & Wing): a history is
linearizable iff each per-key subhistory is, so the search partitions
by key first — turning one exponential problem into many tiny ones.
Within a key the search is the Wing–Gong/Lowe algorithm with the
porcupine-style memoization: DFS over "which ops are already
linearized" with a visited-set keyed on ``(done-mask, register
value)`` — two search paths reaching the same mask and value have
identical futures, so the second is pruned.

Ambiguous ops (client timed out — fate unknown) may be linearized at
any point after their invocation OR may never have taken effect; the
search branches both ways (reads with unknown results constrain
nothing and are dropped up front). A search that exceeds the state
budget returns ``undecided`` rather than lying either way.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

OK, TIMEOUT = "ok", "timeout"
_ABSENT = None          # register value for "key not present"
_INF = float("inf")


class KeyResult(dict):
    """Per-key verdict: ``ok`` True/False/None (None = undecided),
    plus diagnostics (ops, states explored, and on failure the longest
    linearizable prefix as a witness)."""


def _prepare(ops: List[dict]) -> List[dict]:
    """Filter a key's ops to the checkable set: completed writes/reads
    plus ambiguous writes. Failed ops never took effect (the harness
    only records ``fail`` for definite no-ops, e.g. refused reads);
    ambiguous reads returned nothing to anyone, so they constrain
    nothing."""
    out = []
    for rec in ops:
        if rec["status"] == OK:
            out.append(rec)
        elif rec["status"] == TIMEOUT and rec["op"] in ("put", "rm"):
            out.append(rec)
    return out


def check_key(ops: List[dict], *,
              max_states: int = 500_000) -> KeyResult:
    """Check one key's subhistory (records in ``history.ops()`` form:
    ``op`` in {"put","rm","get"}, ``value`` the written value, ``out``
    the read result, ``inv``/``res`` logical times, ``res`` None for
    ambiguous)."""
    ops = _prepare(ops)
    n = len(ops)
    if n == 0:
        return KeyResult(ok=True, ops=0, states=0)
    # no hard length cap: the done-mask is an arbitrary-precision int
    # and closed-loop clients yield near-sequential histories whose
    # memoized frontier stays tiny; ``max_states`` is the honest budget
    # (exceeding it reports undecided, never a false verdict)
    inv = [rec["inv"] for rec in ops]
    res = [(_INF if rec["res"] is None else rec["res"]) for rec in ops]
    ambiguous = [rec["res"] is None for rec in ops]

    def apply(state, i) -> Tuple[bool, Optional[str]]:
        rec = ops[i]
        if rec["op"] == "put":
            return True, rec["value"]
        if rec["op"] == "rm":
            return True, _ABSENT
        return rec["out"] == state, state        # get

    full = (1 << n) - 1
    seen = set()
    states = 0
    # DFS stack: (done_mask, state, chosen list for witness)
    stack: List[Tuple[int, Optional[str], Tuple[int, ...]]] = [
        (0, _ABSENT, ())]
    best: Tuple[int, ...] = ()
    while stack:
        done, state, path = stack.pop()
        if (done, state) in seen:
            continue
        seen.add((done, state))
        states += 1
        if states > max_states:
            return KeyResult(ok=None, ops=n, states=states,
                             reason="state budget exceeded")
        if done == full:
            return KeyResult(ok=True, ops=n, states=states)
        if len(path) > len(best):
            best = path
        # real-time frontier: op i may linearize next iff no
        # unlinearized op finished before i was invoked
        min_res = min(res[j] for j in range(n) if not done >> j & 1)
        for i in range(n):
            if done >> i & 1 or inv[i] > min_res:
                continue
            legal, nstate = apply(state, i)
            if legal:
                stack.append((done | 1 << i, nstate, path + (i,)))
            if ambiguous[i]:
                # fate unknown: the op may never have executed —
                # discharge it without applying
                stack.append((done | 1 << i, state, path))
    witness = [dict(op=ops[i]["op"], value=ops[i]["value"],
                    out=ops[i]["out"], inv=ops[i]["inv"],
                    res=ops[i]["res"], op_id=ops[i].get("op_id"))
               for i in best]
    return KeyResult(ok=False, ops=n, states=states,
                     linearizable_prefix=witness,
                     unresolved=[ops[i].get("op_id") for i in range(n)
                                 if not (len(best) and i in best)])


def check_history(ops: List[dict], *,
                  max_states: int = 500_000) -> dict:
    """Partition ``ops`` by key and check each subhistory. Returns
    ``{"ok": bool|None, "keys": {key: KeyResult}, "violations":
    [key...], "undecided": [key...]}`` — ``ok`` is True only when
    every key checked clean and none were undecided."""
    by_key: Dict[str, List[dict]] = {}
    for rec in ops:
        by_key.setdefault(rec["key"], []).append(rec)
    keys = {}
    violations, undecided = [], []
    for key in sorted(by_key):
        kr = check_key(by_key[key], max_states=max_states)
        keys[key] = kr
        if kr["ok"] is False:
            violations.append(key)
        elif kr["ok"] is None:
            undecided.append(key)
    ok: Optional[bool] = not violations and not undecided
    if undecided and not violations:
        ok = None
    return dict(ok=ok, keys=keys, violations=violations,
                undecided=undecided,
                ops=sum(kr["ops"] for kr in keys.values()),
                states=sum(kr["states"] for kr in keys.values()))
