"""Build and load the port's CUDA kernels: ``nvcc`` at first use, ``ctypes``.

Each kernel source is compiled into a shared library with a plain C
interface (no PyTorch headers, so ``nvcc`` takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC [-D...] -o lib<name>.so <source>.cu

Libraries land in ``build/repro_torch/`` at the root of the checkout (listed
in ``.gitignore``), under a name keyed by a hash of the sources in the
kernel's ``csrc/`` directory, the headers the kernels share
(``kernels/csrc/``) and the flags, so an edited source rebuilds and an
unchanged one loads at once.  A kernel includes nothing of the repo from
outside those two directories, so the key covers everything its library
includes.  All variants
of all sources of one call are compiled by ``nvcc`` processes started
together.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

__all__ = ["NVCC_FLAGS", "SHARED_CSRC", "build_dir", "load_libraries",
           "load_many"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: Headers more than one kernel includes (``#include "../../csrc/..."``).
SHARED_CSRC = Path(__file__).resolve().parent / "csrc"


def build_dir() -> Path:
    """``<checkout>/build/repro_torch`` (src/repro_torch/kernels → 3 up)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build at first use "
                       "and need the CUDA toolkit on PATH or in /usr/local/cuda")


def _key(source: Path, flags: Sequence[str]) -> str:
    h = hashlib.sha256()
    for d in (source.parent, SHARED_CSRC):
        for f in sorted(d.glob("*.cu*")):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    return h.hexdigest()[:16]


def load_libraries(source: Path,
                   variants: Dict[str, Sequence[str]]) -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load one library per variant of ``source``.

    ``variants`` maps a variant name to its extra ``nvcc`` flags (e.g.
    ``{"sum": ["-DK5_REDUCE=0"], ...}``).  Returns name → ``ctypes.CDLL``.
    Raises ``RuntimeError`` with the compiler's output if a build fails.
    """
    return load_many([(source, variants)])[0]


def load_many(jobs: Sequence[Tuple[Path, Dict[str, Sequence[str]]]]
              ) -> List[Dict[str, ctypes.CDLL]]:
    """:func:`load_libraries` for several sources, every ``nvcc`` started
    before the first is waited for.  Returns one name → CDLL map per job."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    targets = [{name: out_dir / f"lib{src.stem}_{name}_{_key(src, flags)}.so"
                for name, flags in variants.items()}
               for src, variants in jobs]
    missing = [(src, flags, libs[name])
               for (src, variants), libs in zip(jobs, targets)
               for name, flags in variants.items() if not libs[name].exists()]
    nvcc = _nvcc() if missing else None
    procs = []
    for src, flags, lib in missing:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp), str(src)]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib, cmd))
    failures = []
    for proc, tmp, lib, cmd in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)  # atomic: a reader never sees half
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return [{name: ctypes.CDLL(str(lib)) for name, lib in libs.items()}
            for libs in targets]
