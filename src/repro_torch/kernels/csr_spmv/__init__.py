# K1: degree-binned ELL SpMV, CUDA kernel + plain PyTorch version.
from .csr_spmv import ell_spmv, load_kernels  # noqa: F401
from .ops import EllGroup, dbg_spmv, ell_pack_groups  # noqa: F401
from .ref import csr_spmv_ref, ell_spmv_ref  # noqa: F401
