"""Port parity of graftlint and the runtime lock sanitizer: the port's
``rdma_paxos_tpu_torch/analysis/`` against the JAX package's
``analysis/``, on the CPU.

* the port's counterpart of each test of ``tests/test_analysis.py``,
  with its fixtures written under ``rdma_paxos_tpu_torch/`` (the
  jit-purity fixtures name torch where JAX's name jax), plus the
  port-only rules: the host-sync scan of the step, the torch
  global-generator ban, and no store site for the cache-key pass;
* every non-purity fixture written under both package roots and run
  through both analyzers: equal findings once the package prefix is
  mapped, equal baseline matching and equal CLI exit codes;
* the registry parity: each of the thirteen lock modules of the port
  declares every JAX declaration whose field it assigns, with the same
  lock and mode;
* the real tree: zero live findings, zero unused suppressions, every
  baseline entry justified, the CLI running with torch, numpy and JAX
  all blocked;
* the sanitizer: ``RP_SANITIZE=1`` arms the eleven objects of both
  packages alike, and the sanitized pipelined driver, read hub, streams
  hub, sharded engine and spmd engine are bit-equal to the JAX
  package's sanitized runs on the same record;
* one case for each JAX ``assert_jit_purity`` wrapper's contract."""

import ast
import json
import os
import re
import subprocess
import sys
import threading
import time

import pytest
import torch

from rdma_paxos_tpu.analysis import engine as jengine
from rdma_paxos_tpu.analysis import locks as jlocks
from rdma_paxos_tpu.analysis import runtime_guard as jguard
from rdma_paxos_tpu.analysis.__main__ import main as jlint_main
from rdma_paxos_tpu_torch.analysis import (
    assert_jit_purity, cachekey, locks, purity, run_analysis)
from rdma_paxos_tpu_torch.analysis.__main__ import main as lint_main
from rdma_paxos_tpu_torch.analysis.engine import (
    Finding, PASS_IDS, SourceTree, Suppression, default_baseline_path,
    load_baseline, render_baseline, repo_root)
from rdma_paxos_tpu_torch.analysis.runtime_guard import (
    LockDisciplineError, OwnedLock, guard, maybe_guard)
from tests.test_torch_sim import jax_step_cache_restored  # noqa: F401

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "rdma_paxos_tpu_torch"
JPKG = "rdma_paxos_tpu"
TIMERS = dict(elec_timeout_low=1e9, elec_timeout_high=2e9)
CONNECT, SEND = 2, 3


def _write(root, rel, text):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return path


def _run(root, pass_id):
    return run_analysis(root=str(root), passes=(pass_id,),
                        baseline=None).findings


# ---------------------------------------------------------------------------
# jit-purity fixtures
# ---------------------------------------------------------------------------

def test_jit_purity_catches_direct_host_import(tmp_path):
    _write(tmp_path, PKG + "/consensus/step.py",
           "import torch\nimport threading\n")
    fs = _run(tmp_path, "jit-purity")
    assert any(f.file == PKG + "/consensus/step.py"
               and f.line == 2 and "threading" in f.message
               for f in fs), fs


def test_jit_purity_catches_transitive_obs_reachability(tmp_path):
    _write(tmp_path, PKG + "/consensus/step.py",
           "from rdma_paxos_tpu_torch.consensus import helper\n")
    _write(tmp_path, PKG + "/consensus/helper.py",
           "import numpy\nfrom rdma_paxos_tpu_torch.obs import metrics\n")
    fs = _run(tmp_path, "jit-purity")
    assert len(fs) == 1
    f = fs[0]
    # reported at the DEVICE module, chain names the indirection
    assert f.file == PKG + "/consensus/step.py"
    assert f.line == 1
    assert "helper" in f.message and PKG + ".obs" in f.message


def test_jit_purity_catches_source_pattern(tmp_path):
    _write(tmp_path, PKG + "/parallel/mesh.py",
           "import torch\n\n\ndef f(state, obs):\n"
           "    obs.metrics.inc('boom')\n")
    fs = _run(tmp_path, "jit-purity")
    assert any(f.line == 5 and "metrics" in f.message for f in fs), fs


def test_jit_purity_catches_host_pure_regression(tmp_path):
    _write(tmp_path, PKG + "/runtime/hostpath.py",
           "import numpy as np\nimport torch\n")
    fs = _run(tmp_path, "jit-purity")
    assert any(f.file == PKG + "/runtime/hostpath.py"
               and f.line == 2 and "accelerator" in f.message
               for f in fs), fs


def test_jit_purity_silent_on_clean_fixture(tmp_path):
    _write(tmp_path, PKG + "/consensus/step.py",
           "import torch\n"
           "from rdma_paxos_tpu_torch.consensus.log import M_GIDX\n")
    _write(tmp_path, PKG + "/consensus/log.py", "M_GIDX = 0\n")
    _write(tmp_path, PKG + "/runtime/hostpath.py",
           "import numpy as np\n")
    assert _run(tmp_path, "jit-purity") == []


def test_jit_purity_catches_host_sync_in_the_step(tmp_path):
    """The port's counterpart of the trace boundary: every host read of
    a device value in the step and its log and lane helpers is a
    finding, one per line."""
    _write(tmp_path, PKG + "/consensus/step.py",
           "import torch\n\n\ndef f(x):\n"
           "    n = int(x.sum().item())\n"
           "    y = x.cpu()\n"
           "    z = x.to('cpu')\n"
           "    torch.cuda.synchronize()\n"
           "    return n, y.numpy(), z.tolist(), x.item()\n")
    _write(tmp_path, PKG + "/txn/lane.py",
           "import torch\n\n\ndef g(x):\n    return x + 1\n")
    fs = _run(tmp_path, "jit-purity")
    assert all(f.file == PKG + "/consensus/step.py"
               and "host sync" in f.message for f in fs), fs
    got = sorted((f.line, p) for f in fs for p in
                 purity.HOST_SYNC_PATTERNS if repr(p) in f.message)
    assert len(got) == len(fs) == 7
    assert got == sorted([
        (5, r"\.item\("), (6, r"\.cpu\("), (7, r"\.to\(\s*[\"']cpu"),
        (8, r"torch\.cuda\.synchronize"), (9, r"\.item\("),
        (9, r"\.tolist\("), (9, r"\.numpy\(")])


# ---------------------------------------------------------------------------
# cache-key fixtures
# ---------------------------------------------------------------------------

_BUILDER_BAD = """\
STEP_CACHE = {}


class Engine:
    def _build(self, elections):
        key = (self.cfg, self.R, elections)
        fn = STEP_CACHE.get(key)
        if fn is None:
            fn = build_step(self.cfg, self.R, audit=self._audit,
                            elections=elections)
            STEP_CACHE[key] = fn
        return fn
"""

_BUILDER_OK = _BUILDER_BAD.replace(
    "key = (self.cfg, self.R, elections)",
    "key = (self.cfg, self.R, elections)"
    " + (('audit',) if self._audit else ())")

# the port's layout flag: a builder reading the device layout must key
# on its hashable form
_BUILDER_MESH = _BUILDER_BAD.replace(
    "audit=self._audit,", "mesh=self.mesh,").replace(
    "key = (self.cfg, self.R, elections)",
    "key = (self.cfg, self.R, elections, self.mesh.key)")


def test_cache_key_catches_missing_flag(tmp_path):
    _write(tmp_path, PKG + "/runtime/builder.py", _BUILDER_BAD)
    fs = _run(tmp_path, "cache-key")
    assert len(fs) == 1
    f = fs[0]
    assert f.file == PKG + "/runtime/builder.py"
    assert "'_audit'" in f.message and f.line == 9, f


def test_cache_key_silent_when_flag_in_key(tmp_path):
    _write(tmp_path, PKG + "/runtime/builder.py", _BUILDER_OK)
    assert _run(tmp_path, "cache-key") == []
    _write(tmp_path, PKG + "/runtime/builder.py", _BUILDER_MESH)
    assert _run(tmp_path, "cache-key") == []
    _write(tmp_path, PKG + "/runtime/builder.py", _BUILDER_MESH.replace(
        ", self.mesh.key)", ")"))
    fs = _run(tmp_path, "cache-key")
    assert len(fs) == 1 and "'mesh'" in fs[0].message, fs


def test_cache_key_clean_on_main_builders():
    """The port builds its programs per engine instance: no store site
    exists, so the pass runs clean and checks nothing — yet."""
    report = run_analysis(passes=("cache-key",), baseline=None)
    assert report.findings == [], [str(f) for f in report.findings]
    tree = SourceTree()
    assert [rel for rel in cachekey.default_scope(tree)
            if cachekey._store_sites(tree.module(rel))] == []
    assert cachekey.STATIC_FLAGS == {
        "cfg", "R", "_mode", "_fanout", "_audit", "_telemetry", "_txn",
        "mesh"}


# ---------------------------------------------------------------------------
# lock-discipline fixtures
# ---------------------------------------------------------------------------

_LOCKMOD_BAD = """\
import threading


class Engine:
    def __init__(self):
        self._host_lock = threading.RLock()
        self.pending = []       # guarded-by: _host_lock

    def good(self):
        with self._host_lock:
            return len(self.pending)

    def bad(self):
        self.pending.append(1)

    def also_fine_locked(self):
        return self.pending

    # holds-lock: _host_lock
    def documented(self):
        return self.pending
"""


def test_lock_discipline_flags_unlocked_access(tmp_path):
    _write(tmp_path, PKG + "/runtime/sim.py", _LOCKMOD_BAD)
    fs = _run(tmp_path, "lock-discipline")
    assert len(fs) == 1
    f = fs[0]
    assert f.line == 14 and "bad()" in f.message and \
        "pending" in f.message, f


def test_lock_discipline_honors_writes_mode_and_conflict(tmp_path):
    mod = _LOCKMOD_BAD.replace("# guarded-by: _host_lock",
                               "# guarded-by: _host_lock [writes]")
    _write(tmp_path, PKG + "/runtime/sim.py", mod)
    assert _run(tmp_path, "lock-discipline") == []   # reads exempt
    # conflicting re-declaration across modules is itself a finding
    _write(tmp_path, PKG + "/runtime/driver.py",
           "class D:\n"
           "    def __init__(self):\n"
           "        self.pending = []   # guarded-by: _lock\n")
    fs = _run(tmp_path, "lock-discipline")
    assert any("re-declared" in f.message for f in fs), fs


# ---------------------------------------------------------------------------
# determinism fixtures
# ---------------------------------------------------------------------------

def test_determinism_catches_wall_clock_and_global_rng(tmp_path):
    _write(tmp_path, PKG + "/chaos/faults.py",
           "import random\nimport time\n"
           "rng = random.Random('seed:1')\n"
           "def bad():\n"
           "    return time.time() + random.random()\n")
    fs = _run(tmp_path, "determinism")
    msgs = [f.message for f in fs]
    assert any("time.time" in m for m in msgs), msgs
    assert any("random.random" in m for m in msgs), msgs
    assert all(f.line == 5 for f in fs), fs   # Random('seed:1') legal


def test_determinism_catches_from_imports(tmp_path):
    _write(tmp_path, PKG + "/chaos/faults.py",
           "from time import perf_counter\n"
           "from datetime import datetime\n"
           "from random import randint\n")
    fs = _run(tmp_path, "determinism")
    msgs = [f.message for f in fs]
    assert any("time.perf_counter" in m for m in msgs), msgs
    assert any("datetime.datetime" in m for m in msgs), msgs
    assert any("random.randint" in m for m in msgs), msgs
    assert [f.line for f in fs] == [1, 2, 3]


def test_determinism_silent_on_seeded_fixture(tmp_path):
    _write(tmp_path, PKG + "/chaos/faults.py",
           "import random\nimport numpy as np\nimport torch\n"
           "rng = random.Random('x:3')\n"
           "g = np.random.default_rng(7)\n"
           "tg = torch.Generator().manual_seed(7)\n"
           "x = torch.randint(0, 9, (3,), generator=tg)\n")
    assert _run(tmp_path, "determinism") == []


def test_determinism_catches_torch_global_generator(tmp_path):
    """Where JAX allows ``jax.random`` keys, the port bans torch's
    process-wide generator: sampling without ``generator=`` and
    reseeding it."""
    _write(tmp_path, PKG + "/chaos/faults.py",
           "import torch\n"
           "import torch as T\n"
           "g = torch.Generator().manual_seed(3)\n"
           "a = torch.rand(3, generator=g)\n"
           "b = T.randn(2)\n"
           "torch.manual_seed(0)\n"
           "torch.cuda.manual_seed_all(0)\n"
           "from torch import randperm, manual_seed\n"
           "c = randperm(5)\n"
           "d = randperm(5, generator=g)\n"
           "e = torch.bernoulli(a)\n")
    # out of scope: the same text in a driver module is not checked
    _write(tmp_path, PKG + "/runtime/driver.py", "import torch\n"
           "torch.manual_seed(0)\n")
    fs = _run(tmp_path, "determinism")
    assert all(f.file == PKG + "/chaos/faults.py" for f in fs), fs
    assert [(f.line, f.message.split(" ")[2]) for f in
            sorted(fs, key=lambda f: (f.line, f.message))] == [
        (5, "torch.randn"), (6, "torch"), (7, "torch"),
        (8, "from-import"), (9, "torch.randperm"),
        (11, "torch.bernoulli")], [str(f) for f in fs]


# ---------------------------------------------------------------------------
# thread-hygiene fixtures
# ---------------------------------------------------------------------------

def test_thread_hygiene_catches_unreaped_thread(tmp_path):
    _write(tmp_path, PKG + "/obs/srv.py",
           "import threading\n"
           "def spawn(fn):\n"
           "    t = threading.Thread(target=fn)\n"
           "    t.start()\n"
           "    return t\n")
    fs = _run(tmp_path, "thread-hygiene")
    assert len(fs) == 1 and fs[0].line == 3, fs


def test_thread_hygiene_accepts_daemon_or_join(tmp_path):
    _write(tmp_path, PKG + "/obs/srv.py",
           "import threading\n"
           "def spawn(fn):\n"
           "    t = threading.Thread(target=fn, daemon=True)\n"
           "    t.start()\n"
           "    u = threading.Thread(target=fn)\n"
           "    u.start()\n"
           "    u.join()\n")
    assert _run(tmp_path, "thread-hygiene") == []
    _write(tmp_path, PKG + "/obs/srv.py",
           "import threading\n"
           "def spawn(fn):\n"
           "    t = threading.Thread(target=fn)\n"
           "    t.daemon = True\n"
           "    t.start()\n")
    assert _run(tmp_path, "thread-hygiene") == []


_STRING_JOIN = ("import threading\n"
                "class S:\n"
                "    def spawn(self, fn):\n"
                "        self._w = threading.Thread(target=fn)\n"
                "        self._w.start()\n"
                "    def fmt(self, parts):\n"
                "        return self._sep.join(parts)\n")
_THREAD_JOIN = _STRING_JOIN.replace(
    "    def fmt(self, parts):\n",
    "    def stop(self):\n        self._w.join()\n"
    "    def fmt(self, parts):\n")


def test_thread_hygiene_string_join_blesses_nothing(tmp_path):
    _write(tmp_path, PKG + "/obs/srv.py", _STRING_JOIN)
    fs = _run(tmp_path, "thread-hygiene")
    assert len(fs) == 1 and fs[0].line == 4, fs
    _write(tmp_path, PKG + "/obs/srv.py", _THREAD_JOIN)
    assert _run(tmp_path, "thread-hygiene") == []


_HANDLER_BARE = ("from http.server import BaseHTTPRequestHandler\n"
                 "class H(BaseHTTPRequestHandler):\n"
                 "    def do_GET(self):\n"
                 "        self.wfile.write(b'x')\n")
_HANDLER_WRAPPED = ("from http.server import BaseHTTPRequestHandler\n"
                    "class H(BaseHTTPRequestHandler):\n"
                    "    def do_GET(self):\n"
                    "        try:\n"
                    "            self.wfile.write(b'x')\n"
                    "        except Exception:\n"
                    "            pass\n")


def test_thread_hygiene_flags_bare_http_handler(tmp_path):
    _write(tmp_path, PKG + "/obs/srv.py", _HANDLER_BARE)
    fs = _run(tmp_path, "thread-hygiene")
    assert len(fs) == 1 and "try/except" in fs[0].message, fs
    _write(tmp_path, PKG + "/obs/srv.py", _HANDLER_WRAPPED)
    assert _run(tmp_path, "thread-hygiene") == []


def test_thread_hygiene_covers_the_port_only_threads():
    """The threads the port added (the driver's readback thread, the
    device world's workers, the elastic plane's servers) are seen by the
    pass, and each is a daemon or joined."""
    from rdma_paxos_tpu_torch.analysis import hygiene
    tree = SourceTree()
    want = {"runtime/driver.py": 2, "parallel/mesh.py": 1,
            "runtime/elastic.py": 5}
    for rel, n in want.items():
        mod = tree.module(PKG + "/" + rel)
        calls = hygiene._thread_calls(mod)
        assert len(calls) == n, rel
        assert all(hygiene._is_daemon(c) for c in calls) or \
            hygiene._has_join(mod), rel
    assert [f for f in hygiene.run(tree)
            if f.file.split("/", 1)[1] in want] == []


# ---------------------------------------------------------------------------
# baseline + CLI
# ---------------------------------------------------------------------------

def test_baseline_roundtrip_and_matching(tmp_path):
    entries = [Suppression(pass_id="determinism",
                           file=PKG + "/chaos/faults.py",
                           contains="time.time",
                           reason='has "quotes" and\nnewline')]
    path = tmp_path / "b.toml"
    path.write_text(render_baseline(entries, header="hdr"))
    back = load_baseline(str(path))
    assert len(back) == 1
    assert back[0].contains == "time.time"
    assert back[0].reason == 'has "quotes" and\nnewline'
    f = Finding(file=PKG + "/chaos/faults.py", line=3,
                pass_id="determinism", message="wall clock time.time")
    assert back[0].matches(f)
    assert not back[0].matches(
        Finding(file="other.py", line=3, pass_id="determinism",
                message="wall clock time.time"))


def test_baseline_symbol_pins_field_and_function(tmp_path):
    s = Suppression(pass_id="lock-discipline", file="f.py",
                    contains="read of '_tickets'",
                    symbol="block in step()", reason="peek")
    excused = Finding(file="f.py", line=9, pass_id="lock-discipline",
                      message="read of '_tickets' (guarded-by x) "
                              "outside a `with ...x` block in step()")
    other_field = Finding(file="f.py", line=9,
                          pass_id="lock-discipline",
                          message="write of 'last' (guarded-by x) "
                                  "outside a `with ...x` block in "
                                  "step()")
    other_fn = Finding(file="f.py", line=9, pass_id="lock-discipline",
                       message="read of '_tickets' (guarded-by x) "
                               "outside a `with ...x` block in "
                               "drain()")
    assert s.matches(excused)
    assert not s.matches(other_field)
    assert not s.matches(other_fn)


def test_write_baseline_appends_preserving_comments(tmp_path):
    _write(tmp_path, PKG + "/chaos/faults.py",
           "import time\nT = time.time\n")
    base = tmp_path / "b.toml"
    base.write_text("# hand-curated header\n"
                    "# ---- section marker ----\n")
    rc = lint_main(["--root", str(tmp_path), "--baseline", str(base),
                    "--write-baseline", "-q", "determinism"])
    assert rc == 1
    text = base.read_text()
    assert "# hand-curated header" in text
    assert "# ---- section marker ----" in text
    assert len(load_baseline(str(base))) == 1


def test_baseline_rejects_malformed(tmp_path):
    p = tmp_path / "b.toml"
    p.write_text("[[suppress]]\npass = unquoted\n")
    with pytest.raises(ValueError):
        load_baseline(str(p))
    p.write_text('[[suppress]]\npass = "x"\n')   # missing keys
    with pytest.raises(ValueError):
        load_baseline(str(p))


def test_cli_exit_semantics_and_json(tmp_path, capsys):
    _write(tmp_path, PKG + "/chaos/faults.py",
           "import time\nT = time.time\n")
    out_json = str(tmp_path / "findings.json")
    rc = lint_main(["--root", str(tmp_path), "--no-baseline",
                    "--json", out_json, "determinism"])
    assert rc == 1
    doc = json.load(open(out_json))
    assert doc["ok"] is False and len(doc["findings"]) == 1
    printed = capsys.readouterr().out
    assert PKG + "/chaos/faults.py:2" in printed
    base = tmp_path / "b.toml"
    base.write_text(render_baseline([Suppression(
        pass_id="determinism", file=PKG + "/chaos/faults.py",
        contains="time.time", reason="fixture")]))
    rc = lint_main(["--root", str(tmp_path), "--baseline", str(base),
                    "--json", out_json, "determinism"])
    assert rc == 0
    doc = json.load(open(out_json))
    assert doc["ok"] is True and len(doc["suppressed"]) == 1


def test_cli_write_baseline_records_stubs(tmp_path, capsys):
    _write(tmp_path, PKG + "/chaos/faults.py",
           "import time\nT = time.time\n")
    base = str(tmp_path / "b.toml")
    rc = lint_main(["--root", str(tmp_path), "--baseline", base,
                    "--write-baseline", "determinism"])
    assert rc == 1                  # recording does not bless
    entries = load_baseline(base)
    assert len(entries) == 1
    rc = lint_main(["--root", str(tmp_path), "--baseline", base,
                    "determinism"])
    assert rc == 0                  # now suppressed


# ---------------------------------------------------------------------------
# the real tree
# ---------------------------------------------------------------------------

def test_graftlint_clean_on_this_checkout():
    """All five passes over the port's tree, its baseline applied: zero
    live findings, zero unused suppressions, the baseline exercised,
    well inside the 60 s budget."""
    t0 = time.monotonic()
    report = run_analysis()
    dt = time.monotonic() - t0
    assert report.findings == [], [str(f) for f in report.findings]
    assert report.unused_suppressions == [], [
        (s.pass_id, s.file, s.contains)
        for s in report.unused_suppressions]
    assert report.suppressed, "baseline should be exercised"
    assert dt < 60.0, "analysis must stay under the CI budget"
    assert PASS_IDS == jengine.PASS_IDS


def test_jit_purity_wrapper_contract():
    assert_jit_purity()            # must not raise on this checkout
    assert os.path.isdir(os.path.join(repo_root(), PKG))
    assert repo_root() == ROOT
    assert default_baseline_path() == os.path.join(
        ROOT, PKG, "analysis", "baseline.toml")


def test_every_baseline_entry_is_justified_and_used():
    entries = load_baseline(default_baseline_path())
    assert entries
    for e in entries:
        assert e.file.startswith(PKG + "/") and os.path.exists(
            os.path.join(ROOT, e.file)), e
        assert len(e.reason) > 20 and "TODO" not in e.reason, e
    report = run_analysis()
    used = {id(s) for _f, s in report.suppressed}
    assert len(used) == len(entries)


def test_analysis_imports_only_the_stdlib():
    """Nothing of torch, numpy or JAX is imported by the analyzer (the
    CLI runs before anything heavy, on a machine with no JAX)."""
    pkg = os.path.join(ROOT, PKG, "analysis")
    for fn in sorted(os.listdir(pkg)):
        if not fn.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(pkg, fn)).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert (top in sys.stdlib_module_names
                        or n.startswith(PKG + ".analysis")), (fn, n)


def test_cli_runs_with_torch_numpy_and_jax_blocked(tmp_path):
    out = tmp_path / "report.json"
    code = ("import sys, runpy\n"
            "for m in ('torch', 'numpy', 'jax', 'jaxlib', "
            "'rdma_paxos_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"sys.argv = ['graftlint', '--json', {str(out)!r}]\n"
            "runpy.run_module('rdma_paxos_tpu_torch.analysis', "
            "run_name='__main__')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "0 finding(s)" in p.stdout
    doc = json.loads(out.read_text())
    assert doc["ok"] and doc["suppressed"] and \
        not doc["unused_suppressions"]
    # and the JAX package's own CLI still passes its tree
    assert jlint_main(["-q"]) == 0


def test_purity_manifests_name_the_port_counterparts():
    jp = __import__("rdma_paxos_tpu.analysis.purity", fromlist=["x"])
    swap = (lambda s: s.replace(JPKG + "/", PKG + "/", 1)
            .replace(JPKG + ".", PKG + ".", 1))
    assert purity.DEVICE_MODULES == tuple(map(swap, jp.DEVICE_MODULES))
    assert purity.FORBIDDEN_DEVICE_IMPORTS == tuple(
        map(swap, jp.FORBIDDEN_DEVICE_IMPORTS))
    assert set(purity.HOST_PURE_MODULES) == set(
        map(swap, jp.HOST_PURE_MODULES))
    assert [p.replace("torch", "jax") for p in purity.SCAN_PATTERNS] == [
        p.replace(r"rdma_paxos_tpu\.", r"rdma_paxos_tpu_jax\.")
        for p in jp.SCAN_PATTERNS]
    for rel, spec in jp.HOST_PURE_MODULES.items():
        t = purity.HOST_PURE_MODULES[swap(rel)]
        assert ("numpy" in spec["ban_imports"]) == (
            "numpy" in t["ban_imports"]), rel
        assert ("jax" in spec["ban_imports"]) == (
            "torch" in t["ban_imports"]), rel
    assert locks.LOCK_MODULES == tuple(map(swap, jlocks.LOCK_MODULES))


# ---------------------------------------------------------------------------
# parity of the two analyzers on every non-purity fixture
# ---------------------------------------------------------------------------

PARITY_FIXTURES = {
    "cache-key-bad": ("cache-key", {"runtime/builder.py": _BUILDER_BAD}),
    "cache-key-ok": ("cache-key", {"runtime/builder.py": _BUILDER_OK}),
    "lock-bad": ("lock-discipline", {"runtime/sim.py": _LOCKMOD_BAD}),
    "lock-writes-conflict": ("lock-discipline", {
        "runtime/sim.py": _LOCKMOD_BAD.replace(
            "# guarded-by: _host_lock", "# guarded-by: _host_lock [writes]"),
        "runtime/driver.py": "class D:\n    def __init__(self):\n"
                             "        self.pending = []   # guarded-by: "
                             "_lock\n"}),
    "lock-strict-and-bad-mode": ("lock-discipline", {
        "runtime/reads.py": _LOCKMOD_BAD.replace(
            "# guarded-by: _host_lock", "# guarded-by: _host_lock [strict]"),
        "streams/scan.py": "class S:\n    def __init__(self):\n"
                           "        self.x = 0   # guarded-by: _slock "
                           "[loose]\n    def f(self):\n"
                           "        self.x = 1\n"}),
    "determinism-wall-clock": ("determinism", {
        "chaos/faults.py": "import random\nimport time\n"
                           "rng = random.Random('seed:1')\ndef bad():\n"
                           "    return time.time() + random.random()\n"}),
    "determinism-from-imports": ("determinism", {
        "chaos/faults.py": "from time import perf_counter\n"
                           "from datetime import datetime\n"
                           "from random import randint\n"}),
    "determinism-numpy-and-seeded": ("determinism", {
        "shard/x.py": "import numpy as np\nimport random\n"
                      "g = np.random.default_rng(7)\n"
                      "h = np.random.randint(3)\n"
                      "r = random.Random(1)\n"}),
    "thread-unreaped": ("thread-hygiene", {
        "obs/srv.py": "import threading\ndef spawn(fn):\n"
                      "    t = threading.Thread(target=fn)\n"
                      "    t.start()\n    return t\n"}),
    "thread-string-join": ("thread-hygiene", {"obs/srv.py": _STRING_JOIN}),
    "thread-join": ("thread-hygiene", {"obs/srv.py": _THREAD_JOIN}),
    "thread-bare-handler": ("thread-hygiene",
                            {"obs/srv.py": _HANDLER_BARE}),
    "thread-wrapped-handler": ("thread-hygiene",
                               {"obs/srv.py": _HANDLER_WRAPPED}),
}


def _norm(f) -> tuple:
    """A JAX finding in the port's terms (the package prefix mapped)."""
    return (f.file.replace(JPKG + "/", PKG + "/", 1), f.line, f.pass_id,
            re.sub(r"\brdma_paxos_tpu\b", PKG, f.message))


@pytest.mark.parametrize("name", sorted(PARITY_FIXTURES))
def test_findings_baseline_and_exit_codes_match_jax(name, tmp_path,
                                                     capsys):
    pass_id, files = PARITY_FIXTURES[name]
    roots = {}
    for side, pkg in (("j", JPKG), ("t", PKG)):
        roots[side] = tmp_path / side
        for rel, text in files.items():
            _write(roots[side], pkg + "/" + rel, text)
    jf = jengine.run_analysis(root=str(roots["j"]), passes=(pass_id,),
                              baseline=None).findings
    tf = run_analysis(root=str(roots["t"]), passes=(pass_id,),
                      baseline=None).findings
    assert [_norm(f) for f in jf] == [_norm(f) for f in tf]
    # baseline matching: the first finding suppressed, an unused entry
    # reported, on both
    rcs = {}
    for side, pkg, mod, main in (("j", JPKG, jengine, jlint_main),
                                 ("t", PKG, None, lint_main)):
        fs = jf if side == "j" else tf
        sup = []
        if fs:
            sup.append(Suppression(pass_id=pass_id, file=fs[0].file,
                                   contains=fs[0].message[:40],
                                   reason="fixture"))
        sup.append(Suppression(pass_id=pass_id, file=pkg + "/nowhere.py",
                               contains="never", reason="fixture"))
        base = roots[side] / "b.toml"
        base.write_text(render_baseline(sup))
        run = (mod.run_analysis if mod else run_analysis)
        rep = run(root=str(roots[side]), passes=(pass_id,),
                  baseline=str(base))
        rcs[side] = (
            [_norm(f) for f in rep.findings],
            [_norm(f) for f, _s in rep.suppressed],
            [s.file.replace(JPKG + "/", PKG + "/", 1)
             for s in rep.unused_suppressions],
            main(["--root", str(roots[side]), "--no-baseline", "-q",
                  pass_id]),
            main(["--root", str(roots[side]), "--baseline", str(base),
                  "-q", pass_id]))
    capsys.readouterr()
    assert rcs["j"] == rcs["t"]
    assert rcs["t"][3] == (1 if tf else 0)


# ---------------------------------------------------------------------------
# the lock declarations: the port keeps every JAX one it can
# ---------------------------------------------------------------------------

def _assigned(text: str) -> set:
    """Attributes a module assigns on ``self``."""
    out = set()
    for node in ast.walk(ast.parse(text)):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        for t in targets:
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                out.add(t.attr)
    return out


@pytest.mark.parametrize("jrel,trel", list(zip(jlocks.LOCK_MODULES,
                                               locks.LOCK_MODULES)))
def test_lock_registry_keeps_every_jax_declaration(jrel, trel):
    """For each threaded module, every JAX ``guarded-by`` declaration
    whose field the port's module assigns is declared in the port too,
    under the same lock and mode."""
    assert jrel.replace(JPKG + "/", PKG + "/", 1) == trel
    jtext = open(os.path.join(ROOT, jrel), encoding="utf-8").read()
    ttext = open(os.path.join(ROOT, trel), encoding="utf-8").read()
    tdecl = {g.attr: (g.lock, g.mode)
             for g in locks.parse_registry_text(ttext, trel)}
    assigned = _assigned(ttext)
    missing = [(g.attr, g.lock, g.mode, tdecl.get(g.attr))
               for g in jlocks.parse_registry_text(jtext, jrel)
               if g.attr in assigned and tdecl.get(g.attr) != (g.lock,
                                                               g.mode)]
    assert not missing, f"{trel}: {missing}"


# ---------------------------------------------------------------------------
# runtime sanitizer: unit level
# ---------------------------------------------------------------------------

class _Toy:
    def __init__(self):
        self._lock = threading.Lock()
        self.q = []            # write-guarded in the tests below
        self.name = "free"


def test_owned_lock_tracks_ownership():
    lk = OwnedLock()
    assert not lk._is_owned()
    with lk:
        assert lk._is_owned() and lk.locked()
        seen = []
        t = threading.Thread(
            target=lambda: seen.append(lk._is_owned()))
        t.start()
        t.join()
        assert seen == [False]   # held, but not by THAT thread
    assert not lk._is_owned() and not lk.locked()


def test_guard_write_and_strict_read_checks():
    obj = _Toy()
    guard(obj, "_lock", write_fields=("q",), read_fields=("q",))
    assert type(obj).__name__ == "_Toy+sanitized"
    with pytest.raises(LockDisciplineError):
        obj.q = [1]
    with pytest.raises(LockDisciplineError):
        len(obj.q)
    with obj._lock:
        obj.q = [1]
        assert len(obj.q) == 1
    obj.name = "still-free"      # unguarded fields stay unchecked
    # a class with no [strict] field gets no read hook at all
    plain = guard(_Toy(), "_lock", write_fields=("q",))
    assert "__getattribute__" not in type(plain).__dict__
    assert "__getattribute__" in type(obj).__dict__


def test_maybe_guard_noop_without_env(monkeypatch):
    monkeypatch.delenv("RP_SANITIZE", raising=False)
    obj = _Toy()
    maybe_guard(obj, "_lock", __file__)
    assert type(obj).__name__ == "_Toy"
    obj.q = [2]                  # unchecked


class _Waiter:
    """A guarded write right after a condition wait, the shape of the
    watch hub's waits."""

    def __init__(self, cv_first: bool):
        self._lock = threading.Lock()
        if cv_first:
            self._cv = threading.Condition(self._lock)
        self.ready = False     # guarded-by: _lock
        self.n = 0             # guarded-by: _lock
        maybe_guard(self, "_lock", __file__)
        if not cv_first:
            self._cv = threading.Condition(self._lock)

    def wait_then_count(self):
        with self._lock:
            self._cv.wait_for(lambda: self.ready, 10)
            self.n = self.n + 1

    def release(self):
        with self._lock:
            self.ready = True
            self._cv.notify_all()


@pytest.mark.parametrize("cv_first", [False, True])
def test_condition_on_the_guarded_lock_keeps_ownership(cv_first,
                                                       monkeypatch):
    """A condition built on the bare lock before the guard reacquires
    it behind the ownership wrapper's back: the waiter's next guarded
    write reads as unowned (a false error). Built on the guarded lock —
    as the port's watch hub builds ``_wcv`` — ownership follows every
    wait."""
    monkeypatch.setenv("RP_SANITIZE", "1")
    w = _Waiter(cv_first)
    assert type(w).__name__ == "_Waiter+sanitized"
    errors = []

    def waiter():
        try:
            w.wait_then_count()
        except LockDisciplineError as e:
            errors.append(e)
    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.1)
    w.release()
    th.join(10)
    assert not th.is_alive()
    if cv_first:
        assert errors and "write of _Waiter.n" in str(errors[0])
    else:
        assert not errors and w.n == 1


# ---------------------------------------------------------------------------
# runtime sanitizer: the eleven wired objects of both packages
# ---------------------------------------------------------------------------

def _sides():
    from rdma_paxos_tpu import streams as jstreams
    from rdma_paxos_tpu import txn as jtxn
    from rdma_paxos_tpu import topology as jtopo
    from rdma_paxos_tpu.config import LogConfig as JCfg
    from rdma_paxos_tpu.obs import Observability as JObs
    from rdma_paxos_tpu.obs.tracectx import TraceContext as JTrace
    from rdma_paxos_tpu.runtime import reads as jreads
    from rdma_paxos_tpu.runtime.governor import DispatchGovernor as JGov
    from rdma_paxos_tpu.runtime.sim import SimCluster as JSim
    from rdma_paxos_tpu.shard import ShardedCluster as JSh
    from rdma_paxos_tpu.shard import ShardedKVS as JSKVS
    from rdma_paxos_tpu.topology.policy import TopologyPolicy as JPol
    from rdma_paxos_tpu_torch import streams, topology, txn
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.obs import Observability
    from rdma_paxos_tpu_torch.obs.tracectx import TraceContext
    from rdma_paxos_tpu_torch.runtime import reads
    from rdma_paxos_tpu_torch.runtime.governor import DispatchGovernor
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    from rdma_paxos_tpu_torch.shard import ShardedCluster, ShardedKVS
    from rdma_paxos_tpu_torch.topology.policy import TopologyPolicy
    return dict(
        j=dict(Sim=JSim, Sh=JSh, SKVS=JSKVS, Cfg=JCfg, Obs=JObs,
               reads=jreads, streams=jstreams, txn=jtxn, topo=jtopo,
               Gov=JGov, Trace=JTrace, Pol=JPol, kw={}, pkg=JPKG),
        t=dict(Sim=SimCluster, Sh=ShardedCluster, SKVS=ShardedKVS,
               Cfg=LogConfig, Obs=Observability, reads=reads,
               streams=streams, txn=txn, topo=topology,
               Gov=DispatchGovernor, Trace=TraceContext,
               Pol=TopologyPolicy, kw=dict(device="cpu"), pkg=PKG))


ARM_GEO = dict(n_slots=64, slot_bytes=128, window_slots=16, batch_slots=8)


def _sim(m):
    return m["Sim"](m["Cfg"](**ARM_GEO), 3, **m["kw"])


def _sharded(m, **kw):
    return m["Sh"](m["Cfg"](**ARM_GEO), 3, 2, **kw, **m["kw"])


def _hub(m):
    c = _sim(m)
    c.obs = m["Obs"]()
    m["reads"].attach(c)
    return m["streams"].attach(c)


# (site, builder of the guarded object, a field it declares)
ARMED = {
    "runtime/sim.py SimCluster": (_sim, "last"),
    "shard/cluster.py ShardedCluster": (_sharded, "pending"),
    "runtime/reads.py ReadHub": (lambda m: m["reads"].ReadHub(), "failed"),
    "runtime/governor.py DispatchGovernor": (
        lambda m: m["Gov"](batch_slots=8), "decision"),
    "txn/coordinator.py TxnCoordinator": (
        lambda m: m["txn"].attach_coordinator(
            m["SKVS"](_sharded(m, txn=True), cap=64)), "_next_tid"),
    "obs/tracectx.py TraceContext": (lambda m: m["Trace"](), "_open"),
    "topology/transition.py TopologyController": (
        lambda m: m["topo"].attach_topology(
            m["SKVS"](_sharded(m), cap=64)), "_phase"),
    "topology/policy.py TopologyPolicy": (lambda m: m["Pol"](), "_mine"),
    "streams/__init__.py StreamHub": (_hub, "_hsteps"),
    "streams/watch.py WatchHub": (lambda m: _hub(m).watch, "events_total"),
    "streams/scan.py ScanManager": (lambda m: _hub(m).scans,
                                    "pages_served"),
}


@pytest.mark.parametrize("site", sorted(ARMED))
def test_rp_sanitize_arms_both_packages_alike(site, monkeypatch):
    """``RP_SANITIZE=1`` arms each of the eleven wired objects in both
    packages: the class reads ``<Name>+sanitized`` and an off-lock
    write of a declared field raises; unset, neither is armed."""
    build, field = ARMED[site]
    sides = _sides()
    jerr = jguard.LockDisciplineError
    for env in ("1", None):
        if env:
            monkeypatch.setenv("RP_SANITIZE", env)
        else:
            monkeypatch.delenv("RP_SANITIZE")
        names = {}
        for s, m in sides.items():
            obj = build(m)
            names[s] = type(obj).__name__
            assert type(obj).__module__.split(".")[0] == m["pkg"]
            if env:
                lock = [k for k in ("_host_lock", "_lock", "_wlock",
                                    "_slock") if hasattr(obj, k)][0]
                err = LockDisciplineError if s == "t" else jerr
                with pytest.raises(err):
                    setattr(obj, field, getattr(obj, field))
                with getattr(obj, lock):
                    setattr(obj, field, getattr(obj, field))
            if hasattr(obj, "fail_all"):
                obj.fail_all("test done")
            if hasattr(obj, "close") and s == "t":
                obj.close()
        assert names["j"] == names["t"]
        assert names["t"].endswith("+sanitized") == bool(env), names


def test_the_port_wires_every_jax_guard_site():
    """The eleven ``maybe_guard`` calls of the JAX package have their
    counterparts, each in the same file under the same lock."""
    pat = re.compile(r"maybe_guard\(self, \"(\w+)\"")

    def sites(pkg):
        out = []
        for dirpath, _d, files in os.walk(os.path.join(ROOT, pkg)):
            if "analysis" in dirpath:
                continue
            for fn in files:
                if fn.endswith(".py"):
                    path = os.path.join(dirpath, fn)
                    for lock in pat.findall(open(path).read()):
                        out.append((os.path.relpath(path, os.path.join(
                            ROOT, pkg)), lock))
        return sorted(out)
    assert sites(PKG) == sites(JPKG)
    assert len(sites(PKG)) == 11


# ---------------------------------------------------------------------------
# runtime sanitizer: sanitized runs held against the JAX package's
# ---------------------------------------------------------------------------

def _drive_record(d, n=160):
    """The pipelined record of ``tests/test_analysis.py``: one
    connection, ``n`` pre-queued SENDs through the leader's handler;
    returns the committed stream and the ack statuses."""
    d.cluster.run_until_elected(0)
    d.step()
    assert d.leader() == 0
    handler = d._make_handler(0)
    conn = (0 << 24) | 31
    assert not isinstance(handler(CONNECT, conn, b""), int)
    evs = [handler(SEND, conn, b"s%03d" % i) for i in range(n)]
    d.run(period=0.001)
    for i, ev in enumerate(evs):
        assert ev.done.wait(30), f"ack {i} never released"
    time.sleep(0.1)          # let follower replay frontiers settle
    d.stop()
    assert d.loop_error is None, d.loop_error
    return [list(s) for s in d.cluster.replayed], [ev.status for ev in evs]


def test_sanitized_pipelined_driver_workload(monkeypatch):
    """A pipeline=2 driver workload runs clean under RP_SANITIZE=1 on
    both packages, commits the same streams, overlaps dispatches, and
    an off-lock write of a guarded field is caught at the access."""
    from rdma_paxos_tpu.config import LogConfig as JCfg
    from rdma_paxos_tpu.config import TimeoutConfig as JTO
    from rdma_paxos_tpu.runtime.driver import ClusterDriver as JDriver
    from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
    from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
    monkeypatch.setenv("RP_SANITIZE", "1")
    geo = dict(n_slots=128, slot_bytes=64, window_slots=32, batch_slots=8)
    jd = JDriver(JCfg(**geo), 3, timeout_cfg=JTO(**TIMERS), pipeline=2)
    td = ClusterDriver(LogConfig(**geo), 3,
                       timeout_cfg=TimeoutConfig(**TIMERS), pipeline=2,
                       device="cpu")
    try:
        for d in (jd, td):
            assert type(d.cluster).__name__ == "SimCluster+sanitized"
        j_streams, j_st = _drive_record(jd)
        t_streams, t_st = _drive_record(td)
    finally:
        jd.stop()
        td.stop()
    assert t_st == j_st == [0] * 160
    assert t_streams == j_streams
    assert [p for (t, _c, _q, p) in t_streams[0] if t == SEND] == [
        b"s%03d" % i for i in range(160)]
    assert td.cluster.max_inflight_dispatches >= 2, (
        "pipelining never engaged — the sanitize run must cover the "
        "dispatch/readback overlap")
    # the deliberate race: mutate a guarded field off-lock
    with pytest.raises(LockDisciplineError):
        td.cluster.pending = [[] for _ in range(3)]
    with td.cluster._host_lock:
        td.cluster.pending = [[] for _ in range(3)]


def test_sanitized_read_hub_strict(monkeypatch):
    """ReadHub._q is [strict] on both packages: a lock-free READ trips
    the sanitizer, the locked read path does not, and both hubs
    report the same status."""
    monkeypatch.setenv("RP_SANITIZE", "1")
    from rdma_paxos_tpu.runtime.reads import ReadHub as JHub
    from rdma_paxos_tpu_torch.runtime.reads import ReadHub
    hubs = (JHub(), ReadHub())
    for hub, err in zip(hubs, (jguard.LockDisciplineError,
                               LockDisciplineError)):
        assert hub.pending_count() == 0
        with pytest.raises(err):
            len(hub._q)
        with hub._lock:
            assert len(hub._q) == 0
    assert hubs[0].status() == hubs[1].status()


def test_rp_sanitize_arms_streams_hubs(monkeypatch):
    """The streams hub, its watch and its scans are armed on both
    packages; the guarded surface works end to end (puts watched and
    scanned, equal across the packages) and an unlocked write of a
    guarded field is caught."""
    monkeypatch.setenv("RP_SANITIZE", "1")
    from tests.test_torch_streams import (
        SIDES, cluster, ev, put_committed, serve_blocking)
    out = {}
    for s in ("j", "t"):
        m = SIDES[s]
        c, hub = cluster(m)
        for x in (c, c.reads, hub, hub.watch, hub.scans):
            assert type(x).__name__.endswith("+sanitized"), x
        c.run_until_elected(0)
        kv = m["KVS"](c, cap=256)
        sub = hub.subscribe(0)
        for i in range(6):
            put_committed(c, kv, 0, b"k%d" % i, b"v%d" % i, i + 1)
        assert hub.watch.wait_caught_up({0: hub.tails[0].length()})
        events = [ev(e) for e in sub.poll(64)]
        items = serve_blocking(c, lambda: hub.scan_all(prefix=b"k"))
        err = (jguard.LockDisciplineError if s == "j"
               else LockDisciplineError)
        with pytest.raises(err):
            hub.watch.events_total = 99
        with pytest.raises(err):
            hub.scans.pages_served = 0
        # the condition is built on the guarded lock (port) — waits keep
        # ownership
        if s == "t":
            assert hub.watch._wcv._lock is hub.watch._wlock
            assert isinstance(hub.watch._wlock, OwnedLock)
        out[s] = (events, items, hub.watch.status(),
                  [list(x) for x in c.replayed])
        hub.fail_all("test done")
    assert out["t"] == out["j"]
    assert [e[5] for e in out["t"][0]] == [b"k%d" % i for i in range(6)]


def test_sanitized_sharded_engine_matches_jax(monkeypatch):
    """``tests/test_torch_shard.py``'s seeded group script — serial
    steps, bursts, scans and pipelined bursts in flight — on both
    sanitized engines, compared after every dispatch."""
    monkeypatch.setenv("RP_SANITIZE", "1")
    from tests import test_torch_shard as ts
    made = []
    orig = (ts.JSharded, ts.ShardedCluster)

    def keep(cls):
        def build(*a, **kw):
            c = cls(*a, **kw)
            made.append(c)
            return c
        return build
    monkeypatch.setattr(ts, "JSharded", keep(orig[0]))
    monkeypatch.setattr(ts, "ShardedCluster", keep(orig[1]))
    ts.run_groups(3, steps=24)
    assert [type(c).__name__ for c in made] == [
        "ShardedCluster+sanitized"] * 2
    assert made[1].max_inflight_dispatches >= 2


def test_sanitized_spmd_engine_matches_jax(monkeypatch):
    """The spmd engine (the port's on ``["cpu"] * 3``, one worker thread
    per entry) sanitized on both packages through the seeded recorded
    workload, compared after every dispatch."""
    monkeypatch.setenv("RP_SANITIZE", "1")
    from tests.test_torch_sim import run_workload
    j, t = run_workload(3, "gather", 0, steps=30, spmd=True)
    try:
        assert type(j).__name__ == type(t).__name__ == \
            "SimCluster+sanitized"
        assert max(len(s) for s in t.replayed) > 20
        with pytest.raises(LockDisciplineError):
            t.last = None
    finally:
        t.close()


# ---------------------------------------------------------------------------
# the JAX jit-purity wrappers' contracts, on the port
# ---------------------------------------------------------------------------

# wrapper (JAX test) -> (a seeded violation of its rule: file, text)
WRAPPERS = {
    "test_audit.py::test_jit_safety_scan_covers_audit_module": (
        "consensus/step.py", "from rdma_paxos_tpu_torch.obs.audit import "
                             "AuditLedger\n"),
    "test_device_obs.py::test_jit_safety_scan_covers_device_module": (
        "ops/quorum.py", "import torch\n\n\ndef f():\n"
                         "    return torch.profiler.profile()\n"),
    "test_ops_plane.py::test_jit_safety_scan_covers_ops_plane_modules": (
        "obs/series.py", "import torch\n"),
    "test_reads.py::test_jit_safety_scan_covers_reads_module": (
        "runtime/reads.py", "import torch\n"),
    "test_repair.py::test_jit_safety_scan_covers_repair_surface": (
        "runtime/repair.py", "import torch\nf = torch.compile\n"),
    "test_spans.py::test_no_obs_reachable_from_jitted_modules": (
        "parallel/mesh.py", "def f(self):\n"
                            "    self.obs.spans.stamp('x')\n"),
    "test_txn.py::test_jit_safety_scan_covers_txn_lane": (
        "txn/lane.py", "import time\n"),
}


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_jit_purity_wrapper_contracts(wrapper, tmp_path):
    """Each JAX ``assert_jit_purity`` wrapper's contract holds on the
    port: the real tree passes, and a seeded violation of that
    wrapper's rule fails."""
    assert_jit_purity()
    rel, text = WRAPPERS[wrapper]
    if rel == "txn/lane.py":
        assert PKG + "/txn/lane.py" in purity.DEVICE_MODULES
    if rel in ("obs/series.py", "runtime/reads.py", "runtime/repair.py"):
        assert PKG + "/" + rel in purity.HOST_PURE_MODULES
    _write(tmp_path, PKG + "/" + rel, text)
    with pytest.raises(AssertionError, match=re.escape(PKG + "/" + rel)):
        assert_jit_purity(root=str(tmp_path))
