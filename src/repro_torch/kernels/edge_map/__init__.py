from .edge_map import (REDUCE_IDENTITY, edge_map_tile_bytes,  # noqa: F401
                       ell_edge_map, load_kernels, reduce_identity)
from .ops import (EllTileGroup, ell_tiles, fused_edge_map,  # noqa: F401
                  fused_edge_map_bytes)
from .ref import ell_edge_map_ref  # noqa: F401
