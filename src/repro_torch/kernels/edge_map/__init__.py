from .edge_map import (REDUCE_IDENTITY, SEGMENT_LANES,  # noqa: F401
                       edge_map_tile_bytes, ell_edge_map, load_kernels,
                       reduce_identity, row_segments)
from .ops import (ClassTable, EllTileGroup, ShardedTileGroup,  # noqa: F401
                  TileSet, coo_tiles, coo_tiles_sharded, ell_tiles,
                  ell_tiles_sharded, fused_edge_map, fused_edge_map_bytes,
                  refresh_alive)
from .ref import ell_edge_map_ref  # noqa: F401
