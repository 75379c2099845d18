# DBG binning (hist_bin): CUDA kernel + plain PyTorch version + Listing 1.
from .hist_bin import MAX_BINS, hist_bin, load_kernels  # noqa: F401
from .ops import dbg_bin, stable_mapping_from_groups  # noqa: F401
from .ref import assign_bins_ref, hist_bin_ref, histogram_ref  # noqa: F401
