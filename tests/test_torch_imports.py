"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro``, so the port
installs and runs on a GPU machine without either."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=[str(f.relative_to(ROOT)) for f in FILES])
def test_source_imports_neither_jax_nor_the_reference(path):
    bad = _top_level_imports(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_every_module_loads_neither_jax_nor_the_reference():
    modules = sorted(
        ".".join(f.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for f in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "BAD []" in r.stdout, r.stdout


NEW_MODULES = ("core.perfmodel", "runtime", "runtime.monitor", "runtime.controller",
               "runtime.trace", "obs", "obs.registry", "obs.events", "obs.telemetry")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_adaptive_runtime_and_obs_modules_are_checked(module):
    """The adaptive runtime, the perf model and the telemetry bundle are
    among the files both checks above walk; the event schema they validate
    against ships inside the port."""
    base = PORT.joinpath(*module.split("."))
    path = base.with_suffix(".py")
    if not path.exists():
        path = base / "__init__.py"
    assert path in FILES
    assert (PORT / "obs" / "event_schema.json").is_file()


SLICE_10_MODULES = ("launch.mesh", "launch.hier_gate", "launch.train", "train.trainer")


@pytest.mark.parametrize("module", SLICE_10_MODULES)
def test_launch_and_pod_modules_are_checked(module):
    """The multi-process launcher, the process groups, the hierarchical
    trainer and its gate are among the files both checks above walk."""
    assert PORT.joinpath(*module.split(".")).with_suffix(".py") in FILES


LAUNCH_TOOL_MODULES = ("launch.analytic_costs", "launch.hlo_analysis", "launch.overlap_gate",
                       "launch.sharded_gate", "launch.dryrun", "launch.dryrun_sweep",
                       "launch.dryrun_summary", "launch.roofline_report")


@pytest.mark.parametrize("module", LAUNCH_TOOL_MODULES)
def test_launch_tool_modules_are_checked(module):
    """The gates, the trace analysis, the analytic costs and the dry run
    with its reports are among the files both checks above walk."""
    assert PORT.joinpath(*module.split(".")).with_suffix(".py") in FILES


def test_only_the_pallas_helpers_and_the_tp_shardings_have_no_counterpart():
    """Every module of the JAX package has one in the port, but
    ``kernels/common.py`` (Pallas helpers) and ``launch/shardings.py``
    (tensor-parallel shardings; the port trains data-parallel only)."""
    ref = ROOT / "src" / "repro"
    missing = sorted(str(f.relative_to(ref)) for f in ref.rglob("*.py")
                     if not (PORT / f.relative_to(ref)).exists())
    assert missing == ["kernels/common.py", "launch/shardings.py"]
