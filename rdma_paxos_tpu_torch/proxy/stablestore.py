"""ctypes binding to the native append-only stable store
(``native/stablestore.cpp`` — the BerkeleyDB RECNO analog of the reference's
``src/db/db-interface.c``).

The port's copy of the JAX package's ``proxy/stablestore.py``. It loads
the repository's shared ``native/libstablestore.so`` by path, built with
``make -C native libstablestore.so`` at first use."""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(NATIVE_DIR, "libstablestore.so")

_lib: Optional[ctypes.CDLL] = None


def atomic_write(path: str, data: bytes, durable: bool = True) -> None:
    """Crash-safe whole-file write: tmp + rename (+ fsyncs when
    ``durable``) — a crash at any point leaves either the old complete
    file or the new complete file, never a mix. ``durable=False`` skips
    the fsyncs: the rename is still atomic against PROCESS death (abort,
    SIGKILL), just not against power loss — right for high-frequency
    recovery points whose loss only widens the recovery window. The
    single implementation for every control file (HardState, elastic
    recovery dumps)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        if durable:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if durable:
        dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                      os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)


_MAGIC = 0x52505353544F5231          # "RPSSTOR1" (stablestore.cpp)


def trimmed_dump(path: str, n: int) -> bytes:
    """Serialize records ``[base, n)`` of the store at ``path`` — used
    to reconstruct the store blob that pairs with a recovery point taken
    when the (still-live, possibly longer) store had ``n`` records. A
    compacted source yields a dump carrying the same base header."""
    import struct
    import tempfile
    src = StableStore(path)
    try:
        if n >= len(src):
            return src.dump()
        if n < src.base:
            # the store was compacted PAST the recovery point: records
            # [n, base) no longer exist, so a trimmed dump would be a
            # silent hole — fail so the caller falls back to a complete
            # recovery source
            raise OSError(
                "store compacted to %d, past recovery point %d"
                % (src.base, n))
        fd, tmp = tempfile.mkstemp(suffix=".trim")
        os.close(fd)
        os.unlink(tmp)               # ss_open creates it fresh
        dst = StableStore(tmp)
        try:
            if src.base:
                # adopt the source's base (empty-store header load)
                dst.load(struct.pack("<QQ", _MAGIC, src.base))
            for i in range(src.base, n):
                dst.append(src.read(i))
            return dst.dump()
        finally:
            dst.close()
            try:
                os.unlink(tmp)
            except OSError:
                pass
    finally:
        src.close()


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        subprocess.run(["make", "-C", NATIVE_DIR, "libstablestore.so"],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(_LIB_PATH)
    lib.ss_open.restype = ctypes.c_void_p
    lib.ss_open.argtypes = [ctypes.c_char_p]
    lib.ss_append.restype = ctypes.c_int64
    lib.ss_append.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_uint32]
    lib.ss_append_many.restype = ctypes.c_int64
    lib.ss_append_many.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint64]
    lib.ss_sync.restype = ctypes.c_int
    lib.ss_sync.argtypes = [ctypes.c_void_p]
    lib.ss_count.restype = ctypes.c_int64
    lib.ss_count.argtypes = [ctypes.c_void_p]
    lib.ss_base.restype = ctypes.c_int64
    lib.ss_base.argtypes = [ctypes.c_void_p]
    lib.ss_compact.restype = ctypes.c_int64
    lib.ss_compact.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.ss_read.restype = ctypes.c_int64
    lib.ss_read.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                            ctypes.c_char_p, ctypes.c_uint32]
    lib.ss_dump_len.restype = ctypes.c_int64
    lib.ss_dump_len.argtypes = [ctypes.c_void_p]
    lib.ss_dump.restype = ctypes.c_int64
    lib.ss_dump.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.c_uint64]
    lib.ss_load.restype = ctypes.c_int64
    lib.ss_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.c_uint64]
    lib.ss_reset.restype = ctypes.c_int
    lib.ss_reset.argtypes = [ctypes.c_void_p]
    lib.ss_close.restype = None
    lib.ss_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class HardState:
    """Durable election state ``(term, voted_term, voted_for)``.

    The reference makes votes durable by replicating them to a majority's
    memory before acking (``rc_replicate_vote``, ``dare_ibv_rc.c:1049``)
    and reading them back on recovery (``rc_get_replicated_vote``). Here
    the device step replicates the pair to live peers' ``vote_rec_*``
    state; this file is the host-side persistence layer the driver writes
    between steps, so a crash-recovered replica restores
    ``max(peer records, this file)``.
    Atomic: temp file + fsync + rename + directory fsync.

    Durability window: the pair is persisted AFTER the step in which the
    vote was gathered and counted, so for that one step the vote exists
    only in live peers' volatile ``vote_rec_*`` memory — the same
    guarantee as the reference, whose ``rc_replicate_vote`` also writes
    only into a majority's volatile remote memory (``dare_ibv_rc.c:1049``);
    recovery therefore always consults the peer records AND this file
    (``recover_vote``), and a whole-cluster power loss inside that window
    is outside both designs' fault model."""

    def __init__(self, path: str):
        self.path = path
        self._last = None

    def save(self, term: int, voted_term: int, voted_for: int) -> None:
        tup = (int(term), int(voted_term), int(voted_for))
        if tup == self._last:
            return
        atomic_write(self.path, np.array(tup, "<i8").tobytes())
        self._last = tup

    def load(self):
        """-> (term, voted_term, voted_for) or None if absent/corrupt."""
        try:
            with open(self.path, "rb") as f:
                b = f.read()
        except FileNotFoundError:
            return None
        if len(b) != 24:
            return None
        t = np.frombuffer(b, "<i8")
        return (int(t[0]), int(t[1]), int(t[2]))


class StableStore:
    """Append-only record store; every committed socket event is persisted
    in log order (store_record analog, db-interface.c:65-96), and the whole
    store serializes into one buffer for joiner snapshot transfer
    (dump_records :98-134)."""

    def __init__(self, path: str):
        self._lib = _load()
        self.path = path
        # host-side progress accounting for health snapshots / metrics
        # (this wrapper is the single append doorway, so counting here
        # covers every record): records/bytes appended through THIS
        # handle since open — the durable truth stays in the file
        self.appended_records = 0
        self.appended_bytes = 0
        self.syncs = 0
        self._h = self._lib.ss_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open stable store at {path}")

    def _handle(self):
        """Live native handle; use-after-close raises instead of handing
        ctypes a NULL to segfault on (e.g. a second driver.stop()).
        NOT a concurrency guard: a thread that read the handle before a
        concurrent close() still races — callers must sequence close()
        after their worker threads exit (ClusterDriver.stop refuses to
        close under a live poll thread for exactly this reason)."""
        h = self._h
        if not h:
            raise ValueError("stable store is closed")
        return h

    def append(self, record: bytes) -> int:
        idx = self._lib.ss_append(self._handle(), record, len(record))
        if idx < 0:
            raise OSError("stable store append failed")
        self.appended_records += 1
        self.appended_bytes += len(record)
        return idx

    def append_framed(self, blob: bytes) -> int:
        """Append a PRE-FRAMED batch (([u32 len][bytes])*) — the zero-
        copy hot path fed by SimCluster's vectorized window decode."""
        if not blob:
            return 0
        n = self._lib.ss_append_many(self._handle(), blob, len(blob))
        if n < 0:
            raise OSError("stable store framed append failed")
        self.appended_records += int(n)
        self.appended_bytes += len(blob)
        return int(n)

    def sync(self) -> None:
        if self._lib.ss_sync(self._handle()) != 0:
            raise OSError("fdatasync failed")
        self.syncs += 1

    def stats(self) -> dict:
        """Health-snapshot summary: absolute record count, compaction
        base, bytes/records appended through this handle, fdatasync
        count, and the backing file size. Safe on a CLOSED store (the
        post-stop ``driver.health()`` call is exactly the post-mortem
        this feeds): native-handle reads degrade to -1 instead of
        raising."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            size = -1
        try:
            records, base = len(self), self.base
        except ValueError:           # handle closed
            records, base = -1, -1
        return dict(records=records, base=base,
                    appended_records=self.appended_records,
                    appended_bytes=self.appended_bytes,
                    syncs=self.syncs, file_bytes=size)

    def __len__(self) -> int:
        """ABSOLUTE record count (base + retained) — indices are stable
        across compaction."""
        return int(self._lib.ss_count(self._handle()))

    @property
    def base(self) -> int:
        """Absolute index of the first retained record (0 unless
        compacted): records below it were dropped after an app-state
        checkpoint covered their effects."""
        return int(self._lib.ss_base(self._handle()))

    def compact(self, upto: int) -> int:
        """Drop records below absolute index ``upto`` (crash-safe
        rewrite+rename). The caller must hold an app-state checkpoint
        taken at exactly ``upto`` — a fresh app is rebuilt as
        checkpoint + replay of [upto, len))."""
        b = self._lib.ss_compact(self._handle(), upto)
        if b < 0:
            raise OSError("stable store compaction failed")
        return int(b)

    def read(self, idx: int, cap: int = 1 << 20) -> bytes:
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.ss_read(self._handle(), idx, buf, cap)
        if n < 0:
            raise IndexError(idx)
        return buf.raw[:min(n, cap)]

    def dump(self) -> bytes:
        n = self._lib.ss_dump_len(self._handle())
        buf = ctypes.create_string_buffer(max(int(n), 1))
        w = self._lib.ss_dump(self._handle(), buf, n)
        if w < 0:
            raise OSError("dump failed")
        return buf.raw[:w]

    def reset(self) -> None:
        """Discard all records (pre-snapshot-load; ss_load appends, so a
        reload without reset would duplicate history)."""
        if self._lib.ss_reset(self._handle()) != 0:
            raise OSError("reset failed")

    def load(self, blob: bytes) -> int:
        n = self._lib.ss_load(self._handle(), blob, len(blob))
        if n < 0:
            raise OSError("malformed dump")
        return int(n)

    def close(self) -> None:
        if self._h:
            self._lib.ss_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
