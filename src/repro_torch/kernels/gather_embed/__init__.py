# K2, the hot/cold split embedding gather: CUDA kernel + plain PyTorch version.
from .gather_embed import ID_DTYPES, hot_gather, load_kernels  # noqa: F401
from .ops import gather_backward, gather_rows, split_gather  # noqa: F401
from .ref import gather_ref, hot_gather_ref, split_gather_ref  # noqa: F401
