"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import neither
JAX nor anything of ``repro``, and the entry points never move to the CPU
without being asked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    out = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        out.append(".".join(parts))
    return out


def test_importing_every_module_pulls_in_no_jax_and_no_repro():
    mods = _modules()
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib')) or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(mods) >= 20


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_to_arrays_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.apps import to_arrays
    from repro_torch.device import resolve_device
    from repro_torch.graph import datasets

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = datasets.load("kr", "test")
    with pytest.raises(RuntimeError, match="CUDA"):
        to_arrays(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        to_arrays(g, backend="ell")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert to_arrays(g, device="cpu").in_deg.device.type == "cpu"


def test_kernel_wrapper_takes_plain_version_only_for_cpu_tensors():
    from repro_torch.kernels.edge_map import ell_edge_map

    x = torch.ones(4, dtype=torch.float32, device="meta")
    idx = torch.zeros((8, 8), dtype=torch.int32, device="meta")
    deg = torch.zeros(8, dtype=torch.int32, device="meta")
    before = ell_edge_map.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        ell_edge_map(x, idx, deg, row_tile=8, width_tile=8)
    assert ell_edge_map.launches == before


def test_kernel_build_is_keyed_by_sources_and_needs_nvcc(monkeypatch, tmp_path):
    """Nothing is compiled at import; a build without nvcc raises (never a
    silent fallback), and the library name changes with the flags."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.edge_map import edge_map

    src = edge_map._SOURCE
    assert src.exists() and src.suffix == ".cu"
    assert _build._key(src, ["-DK5_REDUCE=0"]) != _build._key(src, ["-DK5_REDUCE=1"])
    assert _build.build_dir().parts[-2:] == ("build", "repro_torch")
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "Path", lambda p: tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_libraries(src, {"sum": ["-DK5_REDUCE=0"]})
    assert not any(tmp_path.glob("*.so"))
