from .edge_map import (REDUCE_IDENTITY, SEGMENT_LANES,  # noqa: F401
                       edge_map_tile_bytes, ell_edge_map, load_kernels,
                       reduce_identity, row_segments)
from .ops import (EllTileGroup, ell_tiles, fused_edge_map,  # noqa: F401
                  fused_edge_map_bytes)
from .ref import ell_edge_map_ref  # noqa: F401
