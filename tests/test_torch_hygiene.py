"""Port hygiene: the PyTorch package imports with JAX and the JAX package
blocked, names neither anywhere in its source, keeps copies of the
constants it needs equal to the originals, and never falls back to the
CPU on its own."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rdma_paxos_tpu.config as jconfig
import rdma_paxos_tpu.consensus.log as jlog
import rdma_paxos_tpu.consensus.snapshot as jsnapshot
import rdma_paxos_tpu.runtime.hostpath as jhostpath
import rdma_paxos_tpu.obs.audit as jaudit
import rdma_paxos_tpu.obs.device as jdevice
import rdma_paxos_tpu.obs.metrics as jmetrics
import rdma_paxos_tpu.obs.spans as jspans
import rdma_paxos_tpu.obs.trace as jtrace
import rdma_paxos_tpu.proxy.proxy as jproxy
import rdma_paxos_tpu.runtime.driver as jdriver
import rdma_paxos_tpu.consensus.state as jstate
import rdma_paxos_tpu.consensus.step as jstep
import rdma_paxos_tpu.ops.quorum as jquorum
import rdma_paxos_tpu.runtime.sim as jsim
import rdma_paxos_tpu_torch.config as tconfig
import rdma_paxos_tpu_torch.consensus.log as tlog
import rdma_paxos_tpu_torch.consensus.snapshot as tsnapshot
import rdma_paxos_tpu_torch.convert as tconvert
import rdma_paxos_tpu_torch.runtime.hostpath as thostpath
import rdma_paxos_tpu_torch.obs.audit as taudit
import rdma_paxos_tpu_torch.obs.device as tdevice
import rdma_paxos_tpu_torch.obs.metrics as tmetrics
import rdma_paxos_tpu_torch.obs.spans as tspans
import rdma_paxos_tpu_torch.obs.trace as ttrace
import rdma_paxos_tpu_torch.proxy.proxy as tproxy
import rdma_paxos_tpu_torch.runtime.driver as tdriver
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
        "print(' '.join(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 30
    for mod in ("obs.audit", "obs.device", "consensus.step",
                "runtime.sim", "runtime.driver"):
        assert "rdma_paxos_tpu_torch." + mod in names, mod


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, node.module or ""


SOURCES = sorted(str(p.relative_to(ROOT)) for p in
                 list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"])
assert {"rdma_paxos_tpu_torch/obs/audit.py",
        "rdma_paxos_tpu_torch/obs/device.py"} <= set(SOURCES)


@pytest.mark.parametrize("path", SOURCES)
def test_source_names_no_jax(path):
    """Neither JAX, the JAX package, nor a test module (which may import
    either): the card's machine has no JAX."""
    for line, mod in _imports(ROOT / path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "rdma_paxos_tpu", "tests") \
            and not top.startswith(("test_", "conftest")), (
            f"{path}:{line} imports {mod}")


def test_copied_constants_match_the_reference():
    # config
    for k in ("MAX_BURST_K", "REBASE_STALL_STEPS", "MAX_SERVER_COUNT",
              "DIGEST_EPOCH"):
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
    # the variant fields: the JAX step's optional outputs but the txn
    # lane's (ROADMAP Queue 1, item 13)
    assert list(tstep.VARIANT_FIELDS) == [
        f.name for f in dataclasses.fields(jstep.StepOutput)
        if f.default is None and f.name != "txn_vote"]
    # the audit and telemetry layouts
    tcols = [k for k in vars(tstep) if k.startswith("T_")]
    assert tcols == [k for k in vars(jstep) if k.startswith("T_")]
    assert [getattr(tstep, k) for k in tcols] == [
        getattr(jstep, k) for k in tcols]
    assert taudit.AUDIT_KEYS == jaudit.AUDIT_KEYS
    assert tdevice.NAMES == jdevice.NAMES
    assert tquorum.R_PAD == jquorum.R_PAD
    assert tsim.SimCluster.K_TIERS == jsim.SimCluster.K_TIERS
    assert tsim.SimCluster.RES_KEYS == jsim.SimCluster.RES_KEYS


def _upper_constants(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and isinstance(v, (int, float, str, tuple))}


def test_front_door_constants_match_the_reference():
    jf = [(f.name, f.default)
          for f in dataclasses.fields(jconfig.TimeoutConfig)]
    tf = [(f.name, f.default)
          for f in dataclasses.fields(tconfig.TimeoutConfig)]
    assert jf == tf
    assert tconfig.TimeoutConfig.production() == tconfig.TimeoutConfig(
        **dataclasses.asdict(jconfig.TimeoutConfig.production()))
    # trace event names, metric buckets, span phases, the shim wire ops
    assert _upper_constants(ttrace) == _upper_constants(jtrace)
    assert _upper_constants(tmetrics) == _upper_constants(jmetrics)
    jsp = _upper_constants(jspans)
    tsp = _upper_constants(tspans)
    assert tsp == {k: v for k, v in jsp.items() if k in tsp}
    assert {k for k in jsp if k.startswith("PHASE_")} <= set(tsp)
    assert tspans.StepPhaseProfiler.PHASES == jspans.StepPhaseProfiler.PHASES
    for k in ("OP_HELLO", "OP_CONNECT", "OP_SEND", "OP_CLOSE"):
        assert getattr(tproxy, k) == getattr(jproxy, k), k
    # conn_origin's shift: the origin replica in bits 24+
    conns = np.array([0, 5, (3 << 24) | 9, (127 << 24) | 0xFFFFFF],
                     np.int32)
    assert np.array_equal(tdriver.conn_origin(conns),
                          jdriver.conn_origin(conns))
    assert tdriver.conn_origin((7 << 24) | 1) == 7


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


def test_recovery_surface_matches_the_reference():
    """The recovery slice's copies: the Snapshot record, the error
    classes, the snapshot and stream functions and the driver's recovery
    entry points, with the reference's parameters."""
    import inspect
    jf = [(f.name, f.default) for f in dataclasses.fields(jsnapshot.Snapshot)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tsnapshot.Snapshot)]
    assert jf == tf
    assert tconvert.SNAPSHOT_FIELDS == tuple(n for n, _ in jf)
    assert issubclass(tsnapshot.SnapshotEpochError,
                      tsnapshot.SnapshotVerifyError)
    assert issubclass(tsnapshot.SnapshotVerifyError, RuntimeError)

    def params(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]
    for name in ("take_snapshot", "install_snapshot", "recover_vote",
                 "rebase_offsets", "export_row", "genesis_row",
                 "verify_snapshot"):
        assert params(getattr(tsnapshot, name)) == params(
            getattr(jsnapshot, name)), name
    for name in ("stream_copy", "extend_stream"):
        assert params(getattr(thostpath, name)) == params(
            getattr(jhostpath, name)), name
    for name in ("recover_replica", "reset_app", "checkpoint_app",
                 "_do_recover", "_do_checkpoint", "_do_reset_app",
                 "_drain_admin", "_read_ckpt", "_ckpt_path",
                 "_dump_audit_artifact"):
        assert params(getattr(tdriver.ClusterDriver, name)) == params(
            getattr(jdriver.ClusterDriver, name)), name
