"""Port hygiene: the PyTorch package imports with JAX and the JAX package
blocked, names neither anywhere in its source, keeps copies of the
constants it needs equal to the originals, and never falls back to the
CPU on its own."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import rdma_paxos_tpu.config as jconfig
import rdma_paxos_tpu.consensus.log as jlog
import rdma_paxos_tpu.consensus.state as jstate
import rdma_paxos_tpu.consensus.step as jstep
import rdma_paxos_tpu.ops.quorum as jquorum
import rdma_paxos_tpu.runtime.sim as jsim
import rdma_paxos_tpu_torch.config as tconfig
import rdma_paxos_tpu_torch.consensus.log as tlog
import rdma_paxos_tpu_torch.consensus.state as tstate
import rdma_paxos_tpu_torch.consensus.step as tstep
import rdma_paxos_tpu_torch.ops.quorum as tquorum
import rdma_paxos_tpu_torch.runtime.sim as tsim

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "rdma_paxos_tpu_torch"


def test_imports_with_jax_and_reference_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['rdma_paxos_tpu'] = None\n"
        "import rdma_paxos_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'rdma_paxos_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'rdma_paxos_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_source_names_no_jax(path):
    for line, mod in _imports(ROOT / path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "rdma_paxos_tpu"), (
            f"{path}:{line} imports {mod}")


def test_copied_constants_match_the_reference():
    # config
    for k in ("MAX_BURST_K", "REBASE_STALL_STEPS", "MAX_SERVER_COUNT"):
        assert getattr(tconfig, k) == getattr(jconfig, k), k
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.LogConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.LogConfig)]
    assert jf == tf
    geo = dict(n_slots=64, slot_bytes=32, window_slots=16, batch_slots=8)
    assert tconfig.LogConfig(**geo).slot_words == \
        jconfig.LogConfig(**geo).slot_words
    for bad in (dict(n_slots=48), dict(slot_bytes=30),
                dict(window_slots=128), dict(batch_slots=32),
                dict(rebase_threshold=64), dict(rebase_threshold=1 << 31)):
        for mod in (jconfig, tconfig):
            with pytest.raises(ValueError):
                mod.LogConfig(**dict(geo, **bad))
    # log / state enums and columns
    for a, b in ((tlog.EntryType, jlog.EntryType), (tstate.Role, jstate.Role),
                 (tstate.ConfigState, jstate.ConfigState)):
        assert [(e.name, int(e)) for e in a] == [(e.name, int(e)) for e in b]
    for k in ("M_TYPE", "M_TERM", "M_CONN", "M_REQID", "M_LEN", "M_GIDX",
              "M_GEN", "META_W"):
        assert getattr(tlog, k) == getattr(jlog, k), k
    assert tstate.STATE_FIELDS == tuple(
        f.name for f in dataclasses.fields(jstate.ReplicaState))
    # step columns and readback contract
    for k in ("C_TERM", "C_ROLE", "C_END", "C_COMMIT", "C_LTERM", "C_APPLY",
              "C_TMO", "C_VTERM", "C_VFOR", "C_QDEP", "C_HEAD", "C_N",
              "S_VALID", "S_WSTART", "S_WCOUNT", "S_TERM", "S_PREV",
              "S_COMMIT", "S_HEAD", "S_N", "SCAN_KEYS"):
        assert getattr(tstep, k) == getattr(jstep, k), k
    jout = [f.name for f in dataclasses.fields(jstep.StepOutput)
            if f.default is dataclasses.MISSING]
    assert list(tstep.OUTPUT_FIELDS) == jout
    assert tquorum.R_PAD == jquorum.R_PAD
    assert tsim.SimCluster.K_TIERS == jsim.SimCluster.K_TIERS
    assert tsim.SimCluster.RES_KEYS == jsim.SimCluster.RES_KEYS


def test_entry_points_need_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    cfg = tconfig.LogConfig(n_slots=64, slot_bytes=32, window_slots=16,
                            batch_slots=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.SimCluster(cfg, 3)
    with pytest.raises(RuntimeError):
        tconfig.resolve_device(None)
    with pytest.raises(RuntimeError):
        tconfig.resolve_device("cuda")
    assert tconfig.resolve_device("cpu") == torch.device("cpu")
    assert tsim.SimCluster(cfg, 3, device="cpu").state.term.device.type \
        == "cpu"
