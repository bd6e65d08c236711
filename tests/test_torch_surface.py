"""The port's whole public surface against the JAX package's, read from
the source (an AST walk, no imports).

For every ``.py`` of ``rdma_paxos_tpu/``: the module exists at the same
path in ``rdma_paxos_tpu_torch/``, and every public top-level def, class
and assignment (``__version__`` and ``__all__`` included), and every
public method and class attribute of a public class, exists there too;
in the port a name may also be imported (``from ... import name``)
rather than defined again.
A literal ``__all__`` lists the same names in both. A name may be
skipped only through :data:`EXEMPT`, which names its counterpart or its
reason; an exemption whose name the port has, or the JAX package no
longer has, is stale and fails. The port's own modules are
:data:`PORT_EXTRAS`. A self-test on a small tree shows the checker
catches a missing module, name, method and stale exemption."""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "rdma_paxos_tpu"
PORT_PKG = ROOT / "rdma_paxos_tpu_torch"

# "module:name" -> its counterpart in the port, or why it has none
EXEMPT = {
    "ops/quorum.py:commit_scan_pallas":
        "the Pallas TPU kernel; its counterpart is ops/quorum.py:"
        "commit_scan, which launches csrc/commit_scan.cu on the card",
}

# modules the port has and the JAX package has not
PORT_EXTRAS = {
    "convert.py": "numpy converters between the two packages' states, "
                  "for the parity tests",
    "ops/_build.py": "builds csrc/*.cu with nvcc and binds it by ctypes",
    "parallel/graph.py": "the stable step recorded as a CUDA graph and "
                         "replayed; JAX compiles the step instead",
    "runtime/launch_node.py": "the port's launcher of one NodeDaemon "
                              "beside its interposed app",
}


def _public(name: str) -> bool:
    return not name.startswith("_") or (
        len(name) > 4 and name.startswith("__") and name.endswith("__"))


def _flat(body):
    """Statements of a body, with those under a top-level ``if`` or
    ``try`` lifted (names defined conditionally are still defined)."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _flat(node.body)
            yield from _flat(node.orelse)
        elif isinstance(node, ast.Try):
            for part in (node.body, node.orelse, node.finalbody,
                         *(h.body for h in node.handlers)):
                yield from _flat(part)
        else:
            yield node


def _targets(node):
    if isinstance(node, ast.Assign):
        for t in node.targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    yield n.id
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and isinstance(
            node.target, ast.Name):
        yield node.target.id


def public_surface(path: Path) -> set:
    """The module's public names: ``name`` for a top-level def, class or
    assignment, ``Class.name`` for a public class's public method or
    class attribute."""
    out = set()
    for node in _flat(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if not _public(node.name):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                for b in _flat(node.body):
                    names = ([b.name] if isinstance(b, (
                        ast.FunctionDef, ast.AsyncFunctionDef))
                        else list(_targets(b)))
                    out.update(f"{node.name}.{n}" for n in names
                               if not n.startswith("_"))
        else:
            out.update(n for n in _targets(node) if _public(n))
    return out


def port_names(path: Path) -> set:
    """:func:`public_surface` plus the public names a top-level
    ``from ... import`` binds: a port module may re-export a constant
    from another port module instead of defining a second copy."""
    out = public_surface(path)
    for node in _flat(ast.parse(path.read_text()).body):
        if isinstance(node, ast.ImportFrom):
            out.update(n for n in (a.asname or a.name for a in node.names)
                       if _public(n) and n != "*")
    return out


def literal_all(path: Path):
    """The module's ``__all__`` when it is a literal list, else None."""
    for node in _flat(ast.parse(path.read_text()).body):
        if "__all__" in _targets(node) and isinstance(node, ast.Assign):
            try:
                return sorted(ast.literal_eval(node.value))
            except ValueError:
                return None
    return None


def modules(pkg: Path) -> list:
    return sorted(str(p.relative_to(pkg)) for p in pkg.rglob("*.py")
                  if "__pycache__" not in p.parts)


def surface_gaps(jax_pkg: Path, port_pkg: Path, exempt: dict,
                 extras: dict) -> list:
    """Every way the port's surface falls short of the JAX package's,
    as readable strings (empty when the surfaces match)."""
    gaps = []
    jmods, tmods = set(modules(jax_pkg)), set(modules(port_pkg))
    for m in sorted(jmods - tmods):
        gaps.append(f"module {m}: no port")
    for m in sorted(tmods - jmods - set(extras)):
        gaps.append(f"module {m}: neither in the JAX package nor an extra")
    for m in sorted(set(extras) - (tmods - jmods)):
        gaps.append(f"extra {m}: stale (not a port-only module)")
    used = set()
    for m in sorted(jmods & tmods):
        jnames = public_surface(jax_pkg / m)
        tnames = port_names(port_pkg / m)
        for name in sorted(jnames - tnames):
            key = f"{m}:{name}"
            if key in exempt:
                used.add(key)
            else:
                gaps.append(f"{key}: missing in the port")
        ja, ta = literal_all(jax_pkg / m), literal_all(port_pkg / m)
        if ja is not None and ta != ja:
            gaps.append(f"{m}:__all__ differs: {ja} != {ta}")
    for key in sorted(set(exempt) - used):
        gaps.append(f"{key}: stale exemption (present in the port or "
                    f"gone from the JAX package)")
    return gaps


JAX_MODULES = modules(JAX_PKG)


def test_the_port_has_the_whole_surface():
    assert surface_gaps(JAX_PKG, PORT_PKG, EXEMPT, PORT_EXTRAS) == []


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_surface(module):
    """One module's names (a failure names the module)."""
    port = PORT_PKG / module
    assert port.is_file(), f"{module}: no port"
    missing = sorted(
        n for n in public_surface(JAX_PKG / module)
        - port_names(port) if f"{module}:{n}" not in EXEMPT)
    assert missing == []


def test_every_exemption_and_extra_is_explained():
    for key, why in {**EXEMPT, **PORT_EXTRAS}.items():
        assert len(why.split()) >= 5, key
    for key in EXEMPT:
        module, name = key.split(":")
        assert name in public_surface(JAX_PKG / module), key
        assert name not in port_names(PORT_PKG / module), key


def test_the_names_this_surface_closed():
    """The names the port lacked before its surface was checked whole."""
    for module, names in {
            "__init__.py": {"__version__"},
            "runtime/hostpath.py": {"VECTORIZED", "set_vectorized",
                                    "__all__"},
            "consensus/step.py": {"group_step", "I32_MIN"},
            "runtime/sim.py": {"assemble_frames", "redigest_fn",
                               "STEP_CACHE"}}.items():
        assert names <= port_names(PORT_PKG / module), module


def test_version_is_the_project_version():
    def version(path: Path) -> str:
        for node in ast.parse(path.read_text()).body:
            if "__version__" in _targets(node):
                return ast.literal_eval(node.value)
    project = re.search(r'^version\s*=\s*"([^"]+)"',
                        (ROOT / "pyproject.toml").read_text(), re.M)
    assert version(PORT_PKG / "__init__.py") == project.group(1)
    assert version(JAX_PKG / "__init__.py") == project.group(1)


# ---------------------------------------------------------------------------
# the checker catches what it should, on a small tree
# ---------------------------------------------------------------------------

JAX_TREE = {
    "__init__.py": '__version__ = "1"\n__all__ = ["f"]\n',
    "a.py": ("X = 1\n_private = 2\nif True:\n    Y = 3\n"
             "def f():\n    pass\n"
             "class C:\n    k = 1\n    def m(self):\n        pass\n"
             "    def _h(self):\n        pass\n"),
    "sub/b.py": "def g():\n    pass\n",
}


def _write(root: Path, files: dict) -> Path:
    for rel, text in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    return root


@pytest.mark.parametrize("change,gap", [
    (lambda t: t.pop("sub/b.py"), "module sub/b.py: no port"),
    (lambda t: t.update({"a.py": t["a.py"].replace("X = 1\n", "")}),
     "a.py:X: missing in the port"),
    (lambda t: t.update({"a.py": t["a.py"].replace("    Y = 3\n",
                                                   "    pass\n")}),
     "a.py:Y: missing in the port"),
    (lambda t: t.update({"a.py": t["a.py"].replace(
        "    def m(self):\n        pass\n", "")}),
     "a.py:C.m: missing in the port"),
    (lambda t: t.update({"a.py": t["a.py"].replace("    k = 1\n", "")}),
     "a.py:C.k: missing in the port"),
    (lambda t: t.update({"__init__.py": '__all__ = ["f"]\n'}),
     "__init__.py:__version__: missing in the port"),
    (lambda t: t.update({"__init__.py": '__version__ = "1"\n'
                                        '__all__ = ["f", "g"]\n'}),
     "__init__.py:__all__ differs: ['f'] != ['f', 'g']"),
    (lambda t: t.update({"extra.py": "Z = 1\n"}),
     "module extra.py: neither in the JAX package nor an extra"),
    (lambda t: t.update({"a.py": t["a.py"].replace(
        "X = 1\n", "import X\nfrom m import _X as X2\n")}),
     "a.py:X: missing in the port"),
])
def test_checker_catches_a_gap(tmp_path, change, gap):
    jax_pkg = _write(tmp_path / "j", JAX_TREE)
    port = dict(JAX_TREE)
    assert surface_gaps(jax_pkg, _write(tmp_path / "same", port), {},
                        {}) == []
    change(port)
    gaps = surface_gaps(jax_pkg, _write(tmp_path / "t", port), {}, {})
    assert gaps == [gap]


def test_checker_honours_and_expires_exemptions(tmp_path):
    jax_pkg = _write(tmp_path / "j", JAX_TREE)
    port = dict(JAX_TREE, **{"a.py": JAX_TREE["a.py"].replace(
        "def f():\n    pass\n", "")})
    port_pkg = _write(tmp_path / "t", port)
    assert surface_gaps(jax_pkg, port_pkg, {}, {}) == [
        "a.py:f: missing in the port"]
    assert surface_gaps(jax_pkg, port_pkg, {"a.py:f": "why"}, {}) == []
    # the port grew the name: the exemption is stale
    assert surface_gaps(jax_pkg, _write(tmp_path / "t2", JAX_TREE),
                        {"a.py:f": "why"}, {}) == [
        "a.py:f: stale exemption (present in the port or gone from the "
        "JAX package)"]
    # a name the port imports counts as present, and stales an exemption
    imported = dict(port, **{"a.py": port["a.py"] + "from m import f\n"})
    assert surface_gaps(jax_pkg, _write(tmp_path / "t4", imported),
                        {}, {}) == []
    assert surface_gaps(jax_pkg, _write(tmp_path / "t5", imported),
                        {"a.py:f": "why"}, {}) == [
        "a.py:f: stale exemption (present in the port or gone from the "
        "JAX package)"]
    # an extra module the JAX package also has is stale as an extra
    assert surface_gaps(jax_pkg, _write(tmp_path / "t3", JAX_TREE), {},
                        {"a.py": "why"}) == [
        "extra a.py: stale (not a port-only module)"]
