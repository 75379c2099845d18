# K4: SpMV over the packed hot segment, CUDA kernel + plain PyTorch version.
from .ops import decode_cold_tiles, pack_spmv  # noqa: F401
from .pack_spmv import ID_DTYPES, hot_spmv, load_kernels  # noqa: F401
from .ref import hot_spmv_ref, ids_as_int64  # noqa: F401
