"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import neither
JAX nor anything of ``repro``, and the entry points never move to the CPU
without being asked."""
import ast
import importlib
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


def test_the_source_scan_covers_every_package_of_the_port():
    scanned = {p.relative_to(PORT).parts[0] for p in SOURCES if PORT in p.parents}
    for pkg in ("apps", "cachesim", "configs", "core", "data", "graph",
                "kernels", "launch", "lm", "obs", "pack", "stream"):
        assert pkg in scanned
    assert ROOT / "chip_smoke.py" in SOURCES


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


def test_quickstart_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.launch import quickstart

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main(["--scale", "test"])


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


def test_kernel_build_key_covers_the_shared_headers(monkeypatch, tmp_path):
    """K4 and K1 include ``kernels/csrc/row_spmv.cuh``: an edit there must
    change both libraries' names, so no stale library is loaded."""
    from repro_torch.kernels import _build

    # by path: each package re-exports a function under its module's name
    mods = [importlib.import_module(f"repro_torch.kernels.{m}")
            for m in ("pack_spmv.pack_spmv", "csr_spmv.csr_spmv")]
    header = _build.SHARED_CSRC / "row_spmv.cuh"
    for src in (m._SOURCE for m in mods):
        assert '#include "../../csrc/row_spmv.cuh"' in src.read_text()
        assert (src.parent / "../../csrc/row_spmv.cuh").resolve() == header
    copy = tmp_path / header.name
    copy.write_text(header.read_text())
    monkeypatch.setattr(_build, "SHARED_CSRC", tmp_path)
    before = [_build._key(m._SOURCE, []) for m in mods]
    copy.write_text(header.read_text() + "// edited\n")
    after = [_build._key(m._SOURCE, []) for m in mods]
    assert all(a != b for a, b in zip(before, after))


def test_load_all_builds_every_kernel_source_in_one_call(monkeypatch):
    """``load_all`` hands every kernel's source to one ``load_many`` call (so
    all ``nvcc``s start together) and binds each library to its wrapper."""
    from repro_torch import kernels
    from repro_torch.kernels import _build

    seen = []

    def fake_load_many(jobs):
        seen.extend(jobs)
        return [{name: None for name in variants} for _, variants in jobs]

    bound = []
    monkeypatch.setattr(_build, "load_many", fake_load_many)
    for name in kernels.KERNEL_MODULES:
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        monkeypatch.setattr(mod, "_bind", lambda libs, n=name: bound.append(n))
    kernels.load_all()
    assert [src.name for src, _ in seen] == [
        "edge_map.cu", "pack_spmv.cu", "csr_spmv.cu", "hist_bin.cu",
        "gather_embed.cu"]
    assert all(src.exists() for src, _ in seen)
    assert bound == list(kernels.KERNEL_MODULES)
