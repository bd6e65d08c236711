"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``build/torch_kernels/`` under
the repository root, named by a hash of its source and flags so an
edited source rebuilds. All missing libraries are compiled in parallel
(one ``nvcc`` per source, started together). Nothing is prebuilt and
nothing outside the repository is used; a failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> CUDA source, for every ``csrc/*.cu``."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (all when None) that are not built yet,
    in parallel; returns name -> library path. The compiler's report
    (``-Xptxas=-v``: registers, shared memory, spills) is kept beside
    each library as ``<lib>.log``."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    missing = [n for n in names if n not in srcs]
    if missing:
        raise KeyError(f"no CUDA source for {missing} in {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: target(srcs[n]) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if todo:
        cc = nvcc()
        procs = {}
        for n in todo:
            tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (tmp, subprocess.Popen(
                [cc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[n])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        errors = []
        for n, (tmp, p) in procs.items():
            log, _ = p.communicate()
            out[n].with_suffix(".log").write_bytes(log)
            if p.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(f"{srcs[n].name}:\n{log.decode(errors='replace')}")
            else:
                os.replace(tmp, out[n])
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib
