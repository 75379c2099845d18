from .edge_map import (REDUCE_IDENTITY, SEGMENT_LANES,  # noqa: F401
                       edge_map_tile_bytes, ell_edge_map, load_kernels,
                       reduce_identity, row_segments)
from .ops import (EllTileGroup, coo_tiles, ell_tiles,  # noqa: F401
                  fused_edge_map, fused_edge_map_bytes, refresh_alive)
from .ref import ell_edge_map_ref  # noqa: F401
