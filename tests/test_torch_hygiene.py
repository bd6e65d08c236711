"""Port hygiene: the PyTorch package imports with JAX and the JAX package
blocked, names neither anywhere in its source, keeps copies of the
constants it needs equal to the originals, and never falls back to the
CPU on its own."""

import ast
import dataclasses
import re
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
                "runtime.sim", "runtime.driver", "runtime.reads",
                "chaos", "chaos.runner", "chaos.faults", "chaos.serialize",
                "txn.records", "shard", "shard.router", "shard.cluster",
                "shard.kvs", "shard.chaos", "runtime.sharded_driver",
                "txn", "txn.lane", "txn.merge", "txn.coordinator",
                "txn.api", "txn.chaos", "topology", "topology.epoch",
                "obs.alerts", "obs.series", "obs.health", "obs.export",
                "obs.tracectx", "runtime.repair", "runtime.governor",
                "streams", "streams.tail", "streams.scan", "streams.watch",
                "streams.cdc", "streams.__main__", "topology.transition",
                "topology.policy", "topology.chaos", "obs.console",
                "obs.__main__", "obs.spans", "config", "parallel.mesh",
                "runtime.host", "runtime.node", "runtime.launch_node",
                "runtime.elastic", "runtime.elastic_worker",
                "analysis", "analysis.__main__", "analysis.engine",
                "analysis.purity", "analysis.cachekey", "analysis.locks",
                "analysis.determinism", "analysis.hygiene",
                "analysis.runtime_guard"):
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


# a string that names a module of the JAX package (``rdma_paxos_tpu.x``,
# never ``rdma_paxos_tpu_torch``): a module spawned by name (``python -m``)
# or imported through importlib escapes the import scan above
JAX_MODULE_NAME = re.compile(r"\brdma_paxos_tpu(?:\.\w|$)")


def _jax_module_strings(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and JAX_MODULE_NAME.search(node.value)):
            yield node.lineno, node.value


def test_jax_module_name_scan_finds_a_spawned_module(tmp_path):
    bad = tmp_path / "spawn.py"
    bad.write_text('argv = ["python", "-m",\n'
                   '        "rdma_paxos_tpu.runtime.elastic_worker"]\n'
                   'mod = f"rdma_paxos_tpu{""}"\n'
                   'ok = "rdma_paxos_tpu_torch.runtime.elastic_worker"\n'
                   'path = "rdma_paxos_tpu/ops/quorum.py:144"\n')
    assert [ln for ln, _ in _jax_module_strings(bad)] == [2, 3]


@pytest.mark.parametrize("path", SOURCES)
def test_source_strings_name_no_jax_module(path):
    """No string constant names a module of the JAX package: the
    supervisor spawns its worker by module name."""
    found = list(_jax_module_strings(ROOT / path))
    assert not found, f"{path}: {found}"


def test_launcher_and_worker_default_to_the_card():
    from rdma_paxos_tpu_torch.runtime import elastic_worker, launch_node
    a = launch_node.parser().parse_args(["--coordinator", "h:1",
                                         "--workdir", "w"])
    b = elastic_worker.parser().parse_args(
        ["--spec", "s", "--workdir", "w", "--host-id", "0",
         "--controller", "c"])
    for args in (a, b):
        assert args.device == "cuda"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tconfig.resolve_device(args.device)


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
    # the variant fields: the JAX step's optional outputs, and its
    # optional inputs (the txn lane's watch)
    assert list(tstep.VARIANT_FIELDS) == [
        f.name for f in dataclasses.fields(jstep.StepOutput)
        if f.default is None]
    assert [f.name for f in dataclasses.fields(tstep.StepInput)] == [
        f.name for f in dataclasses.fields(jstep.StepInput)]
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
    from rdma_paxos_tpu_torch.shard import ShardedCluster
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedCluster(cfg, 3, 2)
    # the mesh engine's default device list is the machine's cards
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"need 6 devices for a 2x3 "
                                         f"mesh, have {have}"):
        ShardedCluster(cfg, 3, 2, mesh=(2, 3))
    assert ShardedCluster(cfg, 3, 2, device="cpu").state.log.buf.shape[:2] \
        == (2, 3)


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


def test_chaos_and_read_copies_match_the_reference():
    """The chaos judge's and the read path's copies: the runner's
    defaults and signature (plus the port's ``device``), the fault DSL's
    ops, the transaction record format, the read-path labels and the
    public signatures, with the reference's values."""
    import inspect

    import rdma_paxos_tpu.chaos.faults as jfaults
    import rdma_paxos_tpu.chaos.runner as jrunner
    import rdma_paxos_tpu.runtime.reads as jreads
    import rdma_paxos_tpu.txn.records as jrecords
    import rdma_paxos_tpu_torch.chaos.faults as tfaults
    import rdma_paxos_tpu_torch.chaos.runner as trunner
    import rdma_paxos_tpu_torch.runtime.reads as treads
    import rdma_paxos_tpu_torch.txn.records as trecords

    def params(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]
    assert dataclasses.asdict(trunner.DEFAULT_KV_CFG) == \
        dataclasses.asdict(jrunner.DEFAULT_KV_CFG)
    tp = params(trunner.NemesisRunner)
    assert tp[-1] == ("device", inspect.Parameter.KEYWORD_ONLY, None)
    assert tp[:-1] == params(jrunner.NemesisRunner)
    assert params(trunner._Workload) == params(jrunner._Workload)
    assert params(trunner.NemesisRunner.replay) == params(
        jrunner.NemesisRunner.replay)
    assert tfaults._OPS == jfaults._OPS
    assert tfaults.MASK_OPS == jfaults.MASK_OPS
    for name in ("generate_schedule", "crash_replica", "restart_replica",
                 "corrupt_slot"):
        assert params(getattr(tfaults, name)) == params(
            getattr(jfaults, name)), name
    # the transaction record format
    assert _upper_constants(trecords) == _upper_constants(jrecords)
    assert {k for k in _upper_constants(trecords)
            if k.startswith("TXN_")} == {
        "TXN_PREPARE", "TXN_COMMIT", "TXN_ABORT", "TXN_MERGE", "TXN_CMD_W"}
    assert trecords.encode_prepare(7, 1, b"key", b"v") == \
        jrecords.encode_prepare(7, 1, b"key", b"v")
    assert trecords.encode_merge(7, 3, 1, b"key", b"v") == \
        jrecords.encode_merge(7, 3, 1, b"key", b"v")
    rec = jrecords.encode_commit(9, 0b101)
    assert trecords.encode_commit(9, 0b101) == rec
    assert trecords.encode_abort(9, 2) == jrecords.encode_abort(9, 2)
    t_dec, j_dec = trecords.decode_record(rec), jrecords.decode_record(rec)
    assert t_dec[:3] == j_dec[:3] and np.array_equal(t_dec[3], j_dec[3])
    # the read path: labels and the public signatures
    assert _upper_constants(treads) == _upper_constants(jreads)
    for name in ("attach", "count_read", "leader_claim", "read_counts"):
        assert params(getattr(treads, name)) == params(
            getattr(jreads, name)), name
    for cls, meth in (("LeaseManager", "__init__"), ("ReadHub", "__init__"),
                      ("ReadHub", "submit"), ("LeaseManager", "revoke_all")):
        assert params(getattr(getattr(treads, cls), meth)) == params(
            getattr(getattr(jreads, cls), meth)), (cls, meth)
    # the trace kinds the chaos judge and the leases record
    for k in ("FAULT_INJECTED", "CRASH_RESTART", "NEMESIS_VIOLATION",
              "LEASE_GRANTED", "LEASE_RENEWED", "LEASE_EXPIRED",
              "LEASE_REVOKED"):
        assert getattr(ttrace, k) == getattr(jtrace, k), k


def test_shard_copies_match_the_reference():
    """The sharded slice's copies: the router's constants, hash and
    serialized form (``to_dict``/``from_dict`` and the tamper guard),
    the public signatures of the engine, KVS, nemesis and driver (plus
    the port's ``device``), and the driver's routing delimiters."""
    import inspect

    import rdma_paxos_tpu.runtime.sharded_driver as jsd
    import rdma_paxos_tpu.shard as jshard
    import rdma_paxos_tpu.shard.chaos as jschaos
    import rdma_paxos_tpu.shard.router as jrouter
    import rdma_paxos_tpu_torch.runtime.sharded_driver as tsd
    import rdma_paxos_tpu_torch.shard as tshard
    import rdma_paxos_tpu_torch.shard.chaos as tschaos
    import rdma_paxos_tpu_torch.shard.router as trouter

    def params(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]
    assert tshard.__all__ == jshard.__all__
    assert _upper_constants(trouter) == _upper_constants(jrouter)
    for name in ("fnv1a32", "_fmix32", "ring_hash", "canon_key"):
        assert params(getattr(trouter, name)) == params(
            getattr(jrouter, name)), name
    for key in (b"", b"k", b"key42", "ключ".encode(), bytes(range(256))):
        assert trouter.fnv1a32(key) == jrouter.fnv1a32(key)
        assert trouter.ring_hash(key) == jrouter.ring_hash(key)
    for meth in ("__init__", "to_dict", "from_dict", "group_of",
                 "install_rule", "remove_rule"):
        if hasattr(jrouter.KeyRouter, meth):
            assert params(getattr(trouter.KeyRouter, meth)) == params(
                getattr(jrouter.KeyRouter, meth)), meth
    r = trouter.KeyRouter(4, overrides=[(b"a", b"c", 2)])
    d = r.to_dict()
    assert d == jrouter.KeyRouter(4, overrides=[(b"a", b"c", 2)]).to_dict()
    assert trouter.KeyRouter.from_dict(d).to_dict() == d
    for mod in (trouter, jrouter):
        with pytest.raises(ValueError, match="checksum mismatch"):
            mod.KeyRouter.from_dict(dict(d, ring_checksum=d[
                "ring_checksum"] ^ 1))
    tp = params(tschaos.ShardNemesisRunner)
    assert tp[-1] == ("device", inspect.Parameter.KEYWORD_ONLY, None)
    assert tp[:-1] == params(jschaos.ShardNemesisRunner)
    assert params(tschaos.keys_for_groups) == params(
        jschaos.keys_for_groups)
    assert tsd.PREFIX_DELIMS == jsd.PREFIX_DELIMS
    # the default key_of is each package's own key_prefix_of
    tp, jp = (params(m.ShardedClusterDriver) for m in (tsd, jsd))
    assert [(n, k) for n, k, _ in tp] == [(n, k) for n, k, _ in jp]
    assert [d for n, _, d in tp if n != "key_of"] == [
        d for n, _, d in jp if n != "key_of"]
    assert dict((n, d) for n, _, d in tp)["key_of"] is tsd.key_prefix_of
    for name in ("read", "read_replica", "can_serve_read", "leaders",
                 "recover_replica", "reset_app", "checkpoint_app",
                 "request_membership"):
        assert params(getattr(tsd.ShardedClusterDriver, name)) == params(
            getattr(jsd.ShardedClusterDriver, name)), name
    from rdma_paxos_tpu.shard.cluster import ShardedCluster as JSC
    from rdma_paxos_tpu_torch.shard.cluster import ShardedCluster as TSC
    for name in ("submit", "submit_many", "partition", "heal",
                 "wedge_apply", "begin_step", "begin_burst", "finish",
                 "step", "step_burst", "redigest", "leader",
                 "leader_hint", "run_until_elected", "place_leaders",
                 "prewarm"):
        assert params(getattr(TSC, name)) == params(getattr(JSC, name)), \
            name
    assert TSC.K_TIERS == JSC.K_TIERS


def test_txn_copies_match_the_reference():
    """The transaction slice's copies: the vote constants, the epoch
    machinery's constants, the mergeable ops, the lazy export map, the
    coordinator's states, the KVS fold's done-ring bound, and the public
    signatures (plus the nemesis's ``device``)."""
    import inspect

    import rdma_paxos_tpu.models.replicated_kvs as jrkvs
    import rdma_paxos_tpu.shard.cluster as jcluster
    import rdma_paxos_tpu.topology.epoch as jepoch
    import rdma_paxos_tpu.txn as jtxn
    import rdma_paxos_tpu.txn.api as japi
    import rdma_paxos_tpu.txn.chaos as jtchaos
    import rdma_paxos_tpu.txn.coordinator as jcoord
    import rdma_paxos_tpu.txn.lane as jlane
    import rdma_paxos_tpu.txn.merge as jmerge
    import rdma_paxos_tpu_torch.models.replicated_kvs as trkvs
    import rdma_paxos_tpu_torch.shard.cluster as tcluster
    import rdma_paxos_tpu_torch.topology as ttopo
    import rdma_paxos_tpu_torch.topology.epoch as tepoch
    import rdma_paxos_tpu_torch.txn as ttxn
    import rdma_paxos_tpu_torch.txn.api as tapi
    import rdma_paxos_tpu_torch.txn.chaos as ttchaos
    import rdma_paxos_tpu_torch.txn.coordinator as tcoord
    import rdma_paxos_tpu_torch.txn.lane as tlane
    import rdma_paxos_tpu_torch.txn.merge as tmerge

    def params(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]
    assert _upper_constants(tlane) == _upper_constants(jlane)
    assert set(_upper_constants(tlane)) == {
        "TXN_NONE", "TXN_PENDING", "TXN_PREPARED", "TXN_CONFLICT"}
    assert _upper_constants(tepoch) == _upper_constants(jepoch)
    assert {"PENDING", "COMPLETE", "INVALIDATED", "RETRY_STEPS"} <= set(
        _upper_constants(tepoch))
    assert set(ttopo.__all__) - {"attach_topology"} <= set(vars(tepoch))
    assert _upper_constants(tmerge) == _upper_constants(jmerge)
    assert {k: v[0] for k, v in tmerge.MERGE_FNS.items()} == {
        k: v[0] for k, v in jmerge.MERGE_FNS.items()}
    assert tmerge._MERGE_OPS == jmerge._MERGE_OPS
    for op in (4, 5, 6):
        for val in (0, 5, -7, 77, 255, 1 << 30):
            raw = tmerge.encode_merge_val(op, val)
            assert raw == jmerge.encode_merge_val(op, val), (op, val)
            assert tmerge.decode_merge_val(op, raw) == \
                jmerge.decode_merge_val(op, raw)
    assert ttxn._LAZY == jtxn._LAZY and ttxn.__all__ == jtxn.__all__
    assert _upper_constants(tcoord) == _upper_constants(jcoord)
    assert tcoord.TxnCoordinator.RETRY_STEPS == \
        jcoord.TxnCoordinator.RETRY_STEPS
    assert tapi._NAMED_OPS == japi._NAMED_OPS
    assert trkvs.TXN_DONE_CAP == jrkvs.TXN_DONE_CAP
    for a, b in ((tcoord.attach_coordinator, jcoord.attach_coordinator),
                 (tcoord.TxnCoordinator, jcoord.TxnCoordinator),
                 (tcoord.Txn, jcoord.Txn), (tapi.transact, japi.transact),
                 (tlane.prepare_vote, jlane.prepare_vote),
                 (tepoch.placement_status, jepoch.placement_status),
                 (ttchaos.run_txn_chaos, jtchaos.run_txn_chaos)):
        assert params(a) == params(b), a
    tp = params(ttchaos.TxnNemesisRunner)
    assert tp[-1] == ("device", inspect.Parameter.KEYWORD_ONLY, None)
    assert tp[:-1] == params(jtchaos.TxnNemesisRunner)
    for tcls, jcls in ((tsim.SimCluster, jsim.SimCluster),
                       (tcluster.ShardedCluster, jcluster.ShardedCluster)):
        for name in ("set_txn_watch", "clear_txn_watch"):
            assert params(getattr(tcls, name)) == params(
                getattr(jcls, name)), (tcls, name)


def test_alert_repair_governor_copies_match_the_reference():
    """The alert and health plane, the repair controller and the
    governor: the constants, rule set and public names copied from the
    JAX package equal the originals."""
    import rdma_paxos_tpu.obs as jobs
    import rdma_paxos_tpu.obs.alerts as jalerts
    import rdma_paxos_tpu.obs.export as jexport
    import rdma_paxos_tpu.obs.health as jhealth
    import rdma_paxos_tpu.obs.series as jseries
    import rdma_paxos_tpu.obs.tracectx as jtracectx
    import rdma_paxos_tpu.runtime.governor as jgov
    import rdma_paxos_tpu.runtime.repair as jrepair
    import rdma_paxos_tpu_torch.obs as tobs
    import rdma_paxos_tpu_torch.obs.alerts as talerts
    import rdma_paxos_tpu_torch.obs.export as texport
    import rdma_paxos_tpu_torch.obs.health as thealth
    import rdma_paxos_tpu_torch.obs.series as tseries
    import rdma_paxos_tpu_torch.obs.tracectx as ttracectx
    import rdma_paxos_tpu_torch.runtime.governor as tgov
    import rdma_paxos_tpu_torch.runtime.repair as trepair
    for k in ("QUARANTINED", "PROBATION", "ESCALATED"):
        assert getattr(trepair, k) == getattr(jrepair, k), k
    assert [r["name"] for r in talerts.default_rules()] == [
        r["name"] for r in jalerts.default_rules()]
    assert talerts.default_rules() == jalerts.default_rules()
    for k in ("PAGE", "WARN", "KINDS"):
        assert getattr(talerts, k) == getattr(jalerts, k), k
    for k in ("HEALTH_FIELDS", "CLUSTER_HEALTH_FIELDS"):
        assert getattr(thealth, k) == getattr(jhealth, k), k
    for k in ("DEFAULT_CAPACITY", "SUBSYS_PIDS", "OTHER_SUBSYS_PID",
              "BLAME_PHASES"):
        assert getattr(ttracectx, k) == getattr(jtracectx, k), k
    assert tgov.SHED_RULE == jgov.SHED_RULE
    assert tuple(tgov.SERIAL) == tuple(jgov.SERIAL)
    assert tgov.Decision._fields == jgov.Decision._fields
    assert tspans.CP_PID == jspans.CP_PID
    assert tspans.READS_PID == jspans.READS_PID
    # public signatures of the copied entry points
    import inspect
    for a, b in ((trepair.RepairController.__init__,
                  jrepair.RepairController.__init__),
                 (tgov.DispatchGovernor.__init__,
                  jgov.DispatchGovernor.__init__),
                 (tgov.attach_governor, jgov.attach_governor),
                 (tgov.HintGovernor.__init__, jgov.HintGovernor.__init__),
                 (talerts.AlertEngine.__init__, jalerts.AlertEngine.__init__),
                 (tseries.TimeSeriesStore.__init__,
                  jseries.TimeSeriesStore.__init__),
                 (texport.OpsExporter.__init__, jexport.OpsExporter.__init__),
                 (ttracectx.TraceContext.__init__,
                  jtracectx.TraceContext.__init__)):
        assert str(inspect.signature(a)) == str(inspect.signature(b)), a
    # the facade exports what the JAX one does (audit, device and their
    # classes resolved on first use), and each name resolves
    assert set(tobs.__all__) == set(jobs.__all__)
    assert all(getattr(tobs, n) is not None for n in tobs.__all__)
    # the drivers take the JAX drivers' arguments
    for a, b in ((tdriver.ClusterDriver.__init__,
                  jdriver.ClusterDriver.__init__),):
        ta = set(inspect.signature(a).parameters) - {"device"}
        assert ta == set(inspect.signature(b).parameters)


def test_streams_topology_console_copies_match_the_reference():
    """The streams, topology and console slice's copies: the codec and
    op constants the tail redeclares, the controller's phases and seed
    conn namespace, the policy's rule names, the console's bundle
    constants, and the public signatures (plus the nemesis's
    ``device``)."""
    import inspect

    import rdma_paxos_tpu.models.replicated_kvs as jrkvs
    import rdma_paxos_tpu.obs.console as jconsole
    import rdma_paxos_tpu.streams as jstreams
    import rdma_paxos_tpu.streams.cdc as jcdc
    import rdma_paxos_tpu.streams.scan as jscan
    import rdma_paxos_tpu.streams.tail as jtail
    import rdma_paxos_tpu.streams.watch as jwatch
    import rdma_paxos_tpu.topology as jtopo
    import rdma_paxos_tpu.topology.chaos as jtchaos
    import rdma_paxos_tpu.topology.policy as jpolicy
    import rdma_paxos_tpu.topology.transition as jtrans
    import rdma_paxos_tpu_torch.models.kvs as tkvs
    import rdma_paxos_tpu_torch.models.replicated_kvs as trkvs
    import rdma_paxos_tpu_torch.obs.console as tconsole
    import rdma_paxos_tpu_torch.streams as tstreams
    import rdma_paxos_tpu_torch.streams.cdc as tcdc
    import rdma_paxos_tpu_torch.streams.scan as tscan
    import rdma_paxos_tpu_torch.streams.tail as ttail
    import rdma_paxos_tpu_torch.streams.watch as twatch
    import rdma_paxos_tpu_torch.topology as ttopo
    import rdma_paxos_tpu_torch.topology.chaos as ttchaos
    import rdma_paxos_tpu_torch.topology.policy as tpolicy
    import rdma_paxos_tpu_torch.topology.transition as ttrans

    def params(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]
    for tm, jm in ((ttail, jtail), (tcdc, jcdc), (tpolicy, jpolicy),
                   (ttrans, jtrans), (tconsole, jconsole)):
        assert _upper_constants(tm) == _upper_constants(jm), tm
    assert {"KEY_BYTES", "VAL_BYTES", "CMD_BYTES", "OP_PUT", "OP_GET",
            "OP_RM"} <= set(_upper_constants(ttail))
    assert ttail.KEY_BYTES == tkvs.KEY_W * 4
    assert ttail.VAL_BYTES == tkvs.VAL_W * 4
    assert ttail.CMD_BYTES == tkvs.CMD_W * 4
    assert (ttail.OP_PUT, ttail.OP_GET, ttail.OP_RM) == (
        tkvs.OP_PUT, tkvs.OP_GET, tkvs.OP_RM)
    assert ttrans.TopologyController.SEED_CLIENT_BASE == \
        jtrans.TopologyController.SEED_CLIENT_BASE
    assert tstreams.__all__ == jstreams.__all__
    for a, b in ((tstreams.StreamHub.__init__, jstreams.StreamHub.__init__),
                 (tstreams.StreamHub.scan, jstreams.StreamHub.scan),
                 (tstreams.StreamHub.subscribe,
                  jstreams.StreamHub.subscribe),
                 (tstreams.attach, jstreams.attach),
                 (tscan.ScanManager.__init__, jscan.ScanManager.__init__),
                 (twatch.WatchHub.__init__, jwatch.WatchHub.__init__),
                 (tcdc.CDCWriter.__init__, jcdc.CDCWriter.__init__),
                 (tcdc.verify_export, jcdc.verify_export),
                 (ttopo.attach_topology, jtopo.attach_topology),
                 (ttrans.TopologyController.__init__,
                  jtrans.TopologyController.__init__),
                 (tpolicy.TopologyPolicy.__init__,
                  jpolicy.TopologyPolicy.__init__),
                 (trkvs.ReplicatedKVS.items_in_range,
                  jrkvs.ReplicatedKVS.items_in_range),
                 (ttchaos.run_topology_chaos, jtchaos.run_topology_chaos),
                 (tconsole.assemble_bundle, jconsole.assemble_bundle),
                 (tconsole.fleet_view, jconsole.fleet_view)):
        assert params(a) == params(b), a
    tp = params(ttchaos.TopologyNemesisRunner)
    assert tp[-1] == ("device", inspect.Parameter.KEYWORD_ONLY, None)
    assert tp[:-1] == params(jtchaos.TopologyNemesisRunner)


def test_host_world_and_profiler_copies_match_the_reference():
    """The one-replica-per-process slice and the rest of ``obs``: the
    host driver's output keys and public signatures (plus ``device``
    and ``timeout``), the spmd builders' flags, ``ClusterConfig``'s
    fields, and the profiler half's constants and signatures."""
    import dataclasses
    import inspect

    import rdma_paxos_tpu.config as jconfig
    import rdma_paxos_tpu.obs.device as jdevice
    import rdma_paxos_tpu.obs.spans as jspans
    import rdma_paxos_tpu.parallel.mesh as jmesh
    import rdma_paxos_tpu.runtime.host as jhost
    import rdma_paxos_tpu_torch.config as tconfig
    import rdma_paxos_tpu_torch.obs.device as tdevice
    import rdma_paxos_tpu_torch.obs.spans as tspans
    import rdma_paxos_tpu_torch.parallel.mesh as tmesh
    import rdma_paxos_tpu_torch.runtime.host as thost

    def params(fn, drop=()):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()
                if p.name not in drop]
    assert thost.OUT_KEYS == jhost.OUT_KEYS
    jd, td = jhost.HostReplicaDriver, thost.HostReplicaDriver
    for name in ("install_genesis", "restore_hardstate", "make_input",
                 "_pack_batch", "step", "step_burst", "step_scan", "rebase",
                 "export_local_row", "fetch_local_window"):
        assert params(getattr(td, name)) == params(getattr(jd, name)), name
    assert params(td.__init__, ("device", "timeout")) == params(jd.__init__)
    assert [p[0] for p in params(td.__init__)][-2:] == ["device", "timeout"]
    for t, j in ((tmesh.build_spmd_step, jmesh.build_spmd_step),
                 (tmesh.build_spmd_burst, jmesh.build_spmd_burst),
                 (tmesh.build_spmd_scan, jmesh.build_spmd_scan)):
        drop = ("use_pallas", "interpret", "donate")
        tp, jp = params(t), params(j, drop)
        assert [p[0] for p in tp][:2] == [p[0] for p in jp][:2]
        assert tp[3:] == jp[3:], t          # the flags after the world
    assert tconfig.MAX_SERVER_COUNT == jconfig.MAX_SERVER_COUNT
    assert [(f.name, f.default) for f in dataclasses.fields(
        tconfig.ClusterConfig)] == [(f.name, f.default) for f in
                                    dataclasses.fields(jconfig.ClusterConfig)]
    assert params(tconfig.load_config) == params(jconfig.load_config)
    for k in ("HOST_PHASE_PID", "DEVICE_PID_BASE", "MAX_DEVICE_EVENTS"):
        assert getattr(tdevice, k) == getattr(jdevice, k), k
    for t, j in ((tdevice.ProfilerSession.__init__,
                  jdevice.ProfilerSession.__init__),
                 (tdevice.merge_timeline, jdevice.merge_timeline),
                 (tdevice.load_profiler_dir, jdevice.load_profiler_dir),
                 (tdevice.program_report, jdevice.program_report),
                 (tdevice.write_program_report,
                  jdevice.write_program_report),
                 (tspans.breakdown, jspans.breakdown),
                 (tspans.format_breakdown, jspans.format_breakdown),
                 (tspans.main, jspans.main)):
        assert params(t) == params(j), t
    for name in ("start", "expired", "maybe_stop", "stop", "chrome_events",
                 "summary"):
        assert hasattr(tdevice.ProfilerSession, name), name


def test_node_and_elastic_copies_match_the_reference():
    """The per-host daemon's and the elastic plane's public signatures
    (plus the daemon's ``device`` and ``timeout`` and the supervisor's
    ``worker_device``) and constants."""
    import inspect

    import rdma_paxos_tpu.runtime.elastic as jel
    import rdma_paxos_tpu.runtime.node as jnode
    import rdma_paxos_tpu_torch.runtime.elastic as tel
    import rdma_paxos_tpu_torch.runtime.node as tnode

    def params(fn, drop=()):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()
                if p.name not in drop]
    jd, td = jnode.NodeDaemon, tnode.NodeDaemon
    for name in ("iterate", "run_iterations", "prewarm_burst", "_on_event",
                 "_ingest_audit", "health", "bootstrap_from_store",
                 "reset_app", "dump_row", "meta", "close"):
        assert params(getattr(td, name)) == params(getattr(jd, name)), name
    assert params(td.__init__, ("device", "timeout")) == params(jd.__init__)
    assert [p[0] for p in params(td.__init__)][-2:] == ["device", "timeout"]
    assert (td.BURST_K, td.REBASE_STALL_STEPS) == (jd.BURST_K,
                                                   jd.REBASE_STALL_STEPS)
    for name in ("_send_msg", "_recv_exact", "_recv_msg", "call",
                 "dump_path", "write_dump", "read_dump", "rowdump_path",
                 "write_rowdump", "read_rowdump", "best_recovery"):
        assert params(getattr(tel, name)) == params(getattr(jel, name)), name
    assert params(tel.GroupController.__init__) == params(
        jel.GroupController.__init__)
    assert params(tel.ElasticSupervisor.__init__, ("worker_device",)) == \
        params(jel.ElasticSupervisor.__init__)


def test_device_list_copies_match_the_reference():
    """The single-controller engines' slice: the axis names, the
    layouts' signatures, the group builders' (the device layout in the
    mesh's place, the flags after it) and ``cap_scan_tiers``'."""
    import inspect

    import rdma_paxos_tpu.parallel.mesh as jmesh
    import rdma_paxos_tpu.runtime.sim as jsim
    import rdma_paxos_tpu_torch.parallel.mesh as tmesh
    import rdma_paxos_tpu_torch.runtime.sim as tsim

    def params(fn, drop=()):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()
                if p.name not in drop]
    assert (tmesh.REPLICA_AXIS, tmesh.GROUP_AXIS) == (jmesh.REPLICA_AXIS,
                                                      jmesh.GROUP_AXIS)
    for name in ("make_replica_mesh", "build_mesh_2d", "group_sharding"):
        assert params(getattr(tmesh, name)) == params(getattr(jmesh, name))
    for name in ("build_spmd_group_step", "build_spmd_group_burst",
                 "build_spmd_group_scan"):
        tp = params(getattr(tmesh, name))
        jp = params(getattr(jmesh, name), ("use_pallas", "interpret",
                                           "donate"))
        assert tp == jp, name
    assert params(tsim.cap_scan_tiers) == params(jsim.cap_scan_tiers)
