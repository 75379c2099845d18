"""Nothing the benchmark imports is JAX or the JAX package ``repro``, and
the plain reference imports nothing of the program.  Names are compared
by their top-level part whole: ``repro_torch`` begins with ``repro``."""
import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_no_benchmark_module_imports_jax_or_repro():
    assert _sources()
    for path in _sources():
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        names = set(_imports(path))
        assert "repro_torch" not in names, path
        assert not names & FORBIDDEN, path


def test_the_top_level_name_is_compared_whole():
    assert "repro_torch" not in FORBIDDEN
    assert "repro_torch.apps".split(".")[0] not in FORBIDDEN
    assert "repro.apps".split(".")[0] in FORBIDDEN


def test_a_run_loads_no_forbidden_module():
    """Everything a run imports, the program included, in a fresh process."""
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "import bench.run, bench.control\n"
        "from bench.lib import harness, inputs, trace, traffic, work\n"
        "from bench.systems import graph_jobs\n"
        "import repro_torch.apps, repro_torch.core.reorder\n"
        "import repro_torch.kernels.edge_map.ops\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
