# DBG binning (hist_bin) and the stable rank: CUDA kernels + plain PyTorch
# versions + Listing 1.
from .hist_bin import (MAX_BINS, TILE, bin_tiles, group_tiles,  # noqa: F401
                       hist_bin, load_kernels, stable_rank)
from .ops import dbg_bin, stable_mapping_from_groups  # noqa: F401
from .ref import (assign_bins_ref, hist_bin_ref, histogram_ref,  # noqa: F401
                  stable_mapping_ref)
