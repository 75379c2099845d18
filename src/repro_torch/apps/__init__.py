from . import engine  # noqa: F401
from .bc import bc  # noqa: F401
from .engine import (BACKENDS, EdgeMapBackend, EllBackend,  # noqa: F401
                     FlatBackend, GraphArrays, edge_map_pull, edge_map_push,
                     out_edge_sum, resolve_backend, to_arrays, vertex_map)
from .pagerank import pagerank  # noqa: F401
from .pagerank_delta import pagerank_delta  # noqa: F401
from .pagerank_dist import make_graph_mesh, pagerank_dist  # noqa: F401
from .radii import radii, radii_sources  # noqa: F401
from .sssp import sssp  # noqa: F401

# App registry with direction + degree type used for reordering (Table VIII)
APP_INFO = {
    "pr": {"fn": pagerank, "degree": "out", "mode": "pull"},
    "prd": {"fn": pagerank_delta, "degree": "in", "mode": "push"},
    "sssp": {"fn": sssp, "degree": "in", "mode": "push"},
    "bc": {"fn": bc, "degree": "out", "mode": "pull-push"},
    "radii": {"fn": radii, "degree": "out", "mode": "pull-push"},
}
