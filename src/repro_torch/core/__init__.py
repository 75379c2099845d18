# The paper's degree-based grouping (DBG) framework, on the host in numpy,
# with its evaluation's skew tables (stats) and the Gorder baseline.
from . import gorder_lite, reorder, stats  # noqa: F401
from .reorder import (  # noqa: F401
    GroupingSpec,
    ReorderResult,
    TECHNIQUES,
    dbg,
    dbg_spec,
    group_reorder,
    reorder_graph,
)
