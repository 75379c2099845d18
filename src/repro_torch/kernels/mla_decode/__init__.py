# The absorbed MLA decode attention over the latent cache: CUDA kernel + plain
# PyTorch version.
from .mla_decode import (HEADS, LATENT, ROPE, TILE,  # noqa: F401
                         latent_attention, load_kernels, slice_rows)
from .ref import latent_attention_ref  # noqa: F401
