# The paper's degree-based grouping (DBG) framework, on the host in numpy.
from . import reorder  # noqa: F401
from .reorder import (  # noqa: F401
    GroupingSpec,
    ReorderResult,
    TECHNIQUES,
    dbg,
    dbg_spec,
    group_reorder,
    reorder_graph,
)
