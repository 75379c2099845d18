# The paper's cache model: exact LRU stack distances over property traces.
# The port's copy of ``repro.cachesim`` (numpy only).
from . import simulator, trace  # noqa: F401
from .simulator import (  # noqa: F401
    CacheLevels,
    amat_cycles,
    miss_curve,
    mpka,
    mpka_pinned,
    scaled_hierarchy,
    stack_distances,
    stack_distances_np,
)
from .trace import (  # noqa: F401
    DEFAULT_TRACE_LEN,
    STRUCT_REGION,
    flat_structure,
    interleave_structure,
    property_trace,
    to_blocks,
)
