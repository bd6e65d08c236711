"""Runtime lock sanitizer — ThreadSanitizer-lite for the host state;
the port of ``rdma_paxos_tpu/analysis/runtime_guard.py``.

Under ``RP_SANITIZE=1`` the engines and drivers wrap themselves in a
dynamic subclass whose ``__setattr__`` (and, for ``[strict]`` fields,
``__getattribute__``) asserts that the lock declared by the field's
``# guarded-by:`` annotation is HELD BY THE ACCESSING THREAD. A
latent readback/dispatch race — the single largest fixed-fault
class in this repo — then fails the offending test at the exact
access instead of corrupting a queue one run in a thousand.

Semantics, derived from the same registry the static
``lock-discipline`` pass reads (``analysis/locks.py``):

- every guarded field: attribute WRITES assert lock ownership;
- ``[strict]`` fields: attribute READS assert too (the declaration
  promises no lock-free read exists);
- ``[writes]``/default fields: reads stay unchecked at runtime —
  the static pass plus ``baseline.toml`` govern those.

``threading.RLock`` carries ownership natively (``_is_owned``);
declared plain ``threading.Lock`` locks are transparently replaced at
guard time with an ownership-tracking wrapper (installation happens in
``__init__``, before the object is shared, so no other reference to
the bare lock can exist yet).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, Optional

SANITIZE_ENV = "RP_SANITIZE"


def sanitize_enabled() -> bool:
    return os.environ.get(SANITIZE_ENV, "") not in ("", "0")


class LockDisciplineError(AssertionError):
    """A guarded field was accessed without its declared lock held."""


class OwnedLock:
    """``threading.Lock`` with ownership tracking — drop-in for the
    ``with``/acquire/release surface the runtime uses."""

    def __init__(self, inner=None):
        self._inner = inner or threading.Lock()
        self._owner: Optional[int] = None

    def acquire(self, *a, **kw) -> bool:
        got = self._inner.acquire(*a, **kw)
        if got:
            self._owner = threading.get_ident()
        return got

    def release(self) -> None:
        self._owner = None
        self._inner.release()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()


def _owned(lock) -> bool:
    probe = getattr(lock, "_is_owned", None)
    if probe is not None:
        return bool(probe())
    # last resort (foreign lock type): held-by-anyone
    return bool(lock.locked())


_SUBCLASS_CACHE: Dict[tuple, type] = {}


def _registry_for(files: Iterable[str], lock_attr: str):
    """(write-checked fields, read-checked fields) declared under
    ``lock_attr`` in the given source files — the static pass's
    ``guarded-by`` grammar, reused verbatim."""
    from rdma_paxos_tpu_torch.analysis.locks import parse_registry_text
    writes, reads = set(), set()
    for path in files:
        try:
            with open(path, "r", encoding="utf-8") as f:
                text = f.read()
        except OSError:
            continue
        for gf in parse_registry_text(text, path):
            if gf.lock != lock_attr:
                continue
            writes.add(gf.attr)
            if gf.mode == "strict":
                reads.add(gf.attr)
    return frozenset(writes), frozenset(reads)


def guard(obj, lock_attr: str, write_fields: Iterable[str],
          read_fields: Iterable[str] = ()):
    """Swap ``obj``'s class for a checking subclass. Idempotent per
    (class, lock, field-set). Returns ``obj``."""
    cls = type(obj)
    if getattr(cls, "__rp_sanitized__", False):
        return obj
    wf, rf = frozenset(write_fields), frozenset(read_fields)
    if not wf and not rf:
        return obj
    lock = getattr(obj, lock_attr)
    if isinstance(lock, type(threading.Lock())):
        # ownership-tracking replacement; see module docstring for
        # why this is safe at construction time
        object.__setattr__(obj, lock_attr, OwnedLock(lock))
    key = (cls, lock_attr, wf, rf)
    sub = _SUBCLASS_CACHE.get(key)
    if sub is None:

        def _check(self, name: str, verb: str) -> None:
            lk = object.__getattribute__(self, lock_attr)
            if not _owned(lk):
                raise LockDisciplineError(
                    "RP_SANITIZE: %s of %s.%s on thread %r without "
                    "%s held (declared guarded-by %s)" %
                    (verb, cls.__name__, name,
                     threading.current_thread().name, lock_attr,
                     lock_attr))

        def __setattr__(self, name, value):
            if name in wf:
                _check(self, name, "write")
            object.__setattr__(self, name, value)

        def __getattribute__(self, name):
            if name in rf:
                _check(self, name, "read")
            return object.__getattribute__(self, name)

        body = dict(__rp_sanitized__=True, __setattr__=__setattr__)
        if rf:
            # every attribute read pays a Python call: only a class with
            # [strict] fields takes it
            body["__getattribute__"] = __getattribute__
        _Sanitized = type(cls.__name__, (cls,), body)
        _Sanitized.__name__ = cls.__name__ + "+sanitized"
        _Sanitized.__qualname__ = _Sanitized.__name__
        sub = _SUBCLASS_CACHE[key] = _Sanitized
    obj.__class__ = sub
    return obj


def maybe_guard(obj, lock_attr: str, *source_files: str):
    """The engines'/drivers' one-line wiring: a no-op unless
    ``RP_SANITIZE=1``; otherwise derive the field sets from the
    ``guarded-by`` annotations in ``source_files`` (usually the
    caller's ``__file__``) and install the proxy."""
    if not sanitize_enabled():
        return obj
    writes, reads = _registry_for(source_files, lock_attr)
    return guard(obj, lock_attr, writes, reads)
