# Hand-written CUDA kernels of the port, each beside its plain PyTorch version.
from importlib import import_module

#: The module of each kernel's wrapper (its ``_SOURCE``, ``_VARIANTS`` and
#: ``_bind``).  By path: each package re-exports a function under its own
#: module's name (``pack_spmv``, ``hist_bin``), shadowing the submodule.
KERNEL_MODULES = ("edge_map.edge_map", "pack_spmv.pack_spmv",
                  "csr_spmv.csr_spmv", "hist_bin.hist_bin")


def load_all() -> None:
    """Build (first use) and bind every kernel library of the port — K5, K4,
    K1 and hist_bin — with all their ``nvcc`` processes started together."""
    from . import _build

    mods = [import_module(f"{__name__}.{m}") for m in KERNEL_MODULES]
    libs = _build.load_many([(m._SOURCE, m._VARIANTS) for m in mods])
    for m, lib in zip(mods, libs):
        m._bind(lib)
