"""The port's public surface against the JAX package's, and its deployment
units against the JAX package's.

Names: both packages are walked with ``ast``, neither imported.  For every
module of ``ka9q_sdr_tpu`` the port's module of the same path must hold
every public (no leading underscore) top-level function and class and
every name in ``__all__``; for every ``__init__.py`` also every name it
imports (the re-exports).  The programs at the root of the repo pair the
same way with their twins in the port: ``bench.py`` with
``ka9q_sdr_tpu_torch/bench.py`` and ``tools/<name>.py`` with
``ka9q_sdr_tpu_torch/tools/<name>.py``.  Only ``BY_DESIGN`` is exempt: the
names that ROADMAP.md §1 "Not ported, by design" leaves out.

Units: every ``deploy/*.service`` has a unit of the same name in
``ka9q_sdr_tpu_torch/deploy/`` whose ``ExecStart`` is the same command
token for token with the app's module renamed, with the same ``Nice``,
``DynamicUser``, ``Restart`` and ``RestartSec``; the app is in the port's
``__main__.APPS`` and its ``build_parser()`` takes the flags (to the same
values as the JAX app's parser, where the JAX app has one).
"""

import ast
import importlib
import shlex
from pathlib import Path

import pytest

from ka9q_sdr_tpu_torch.__main__ import APPS

ROOT = Path(__file__).resolve().parent.parent
JAX = ROOT / "ka9q_sdr_tpu"
PORT = ROOT / "ka9q_sdr_tpu_torch"

#: Left out by design (ROADMAP.md §1): the real-dtype packing of a TPU
#: runtime's jit boundary and the wrappers built on it (each replaced by
#: the port's captured graphs), the MXU FFT, and the JAX configuration
#: (the port's twin is ``configure_torch``), and the probe that asks only
#: whether the MXU FFT wins on a TPU.  None: the whole module.
BY_DESIGN = {
    "ops/packing.py": None,
    "ops/__init__.py": {"c2r", "r2c", "tree_c2r", "tree_r2c"},
    "models/bank.py": {"bank_step_packed", "bank_step_packed_i16",
                       "bank_scan_packed_i16"},
    "models/receiver.py": {"receiver_step_packed", "receiver_scan_packed"},
    "ops/fftfilt.py": {"fft_mxu"},
    "utils/runtime.py": {"configure_jax"},
    "tools/fft24_probe.py": None,
}

MODULES = sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))
#: the root's programs, each paired with the port's file of the same path
SCRIPTS = ["bench.py"] + sorted(p.relative_to(ROOT).as_posix()
                                for p in (ROOT / "tools").glob("*.py"))


def _source(rel: str) -> Path:
    """The JAX side of `rel`: a root program or a module of the package."""
    return ROOT / rel if rel in SCRIPTS else JAX / rel


def public_names(path: Path) -> set[str]:
    """Top-level public functions and classes, ``__all__``, and in an
    ``__init__.py`` the names it imports."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            out |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if any(isinstance(t, ast.Name) and t.id == "__all__"
                   for t in targets):
                out |= set(ast.literal_eval(node.value))
    return {n for n in out if not n.startswith("_")}


@pytest.mark.parametrize("rel", MODULES + SCRIPTS)
def test_port_has_every_public_name(rel):
    exempt = BY_DESIGN.get(rel, set())
    want = public_names(_source(rel))
    if exempt is None:
        assert not (PORT / rel).exists()
        return
    assert (PORT / rel).exists(), f"the port has no {rel}"
    missing = want - public_names(PORT / rel) - exempt
    assert not missing, f"{rel}: the port lacks {sorted(missing)}"


def test_by_design_list_is_current():
    """Each exempt name is one the JAX module has and the port lacks: the
    list names nothing that was ported or that JAX dropped."""
    for rel, names in BY_DESIGN.items():
        assert _source(rel).exists(), rel
        if names is None:
            continue
        assert names <= public_names(_source(rel)), rel
        assert not names & public_names(PORT / rel), rel


JAX_UNITS = sorted(p.name for p in (ROOT / "deploy").glob("*.service"))


def _unit(path: Path) -> tuple[dict, list[str]]:
    """A unit's [Service] keys and its comment lines."""
    keys, comments, section = {}, [], None
    for line in path.read_text().splitlines():
        line = line.strip()
        if line.startswith("#"):
            comments.append(line)
        elif line.startswith("["):
            section = line
        elif "=" in line and section == "[Service]":
            k, v = line.split("=", 1)
            keys[k] = v
    return keys, comments


def test_the_port_has_the_same_units():
    port = sorted(p.name for p in (PORT / "deploy").glob("*.service"))
    assert port == JAX_UNITS and len(port) == 14


@pytest.mark.parametrize("name", JAX_UNITS)
def test_port_unit_matches(name):
    jkeys, _ = _unit(ROOT / "deploy" / name)
    tkeys, comments = _unit(PORT / "deploy" / name)
    jcmd, tcmd = shlex.split(jkeys["ExecStart"]), shlex.split(tkeys["ExecStart"])
    assert jcmd[:2] == ["/usr/bin/python3", "-m"]
    assert jcmd[2].startswith("ka9q_sdr_tpu.apps.")
    app = jcmd[2].rsplit(".", 1)[1]
    assert tcmd == jcmd[:2] + [f"ka9q_sdr_tpu_torch.apps.{app}"] + jcmd[3:]
    for key in ("Nice", "DynamicUser", "Restart", "RestartSec"):
        assert tkeys.get(key) == jkeys.get(key), key
    assert not any("TPU" in c for c in comments)
    assert app in APPS
    mod = importlib.import_module(f"ka9q_sdr_tpu_torch.apps.{app}")
    args = mod.build_parser().parse_args(tcmd[3:])
    jmod = importlib.import_module(f"ka9q_sdr_tpu.apps.{app}")
    if hasattr(jmod, "build_parser"):
        assert vars(args) == vars(jmod.build_parser().parse_args(jcmd[3:]))
    elif hasattr(jmod, "build_args"):
        assert vars(args) == vars(jmod.build_args(jcmd[3:]))
