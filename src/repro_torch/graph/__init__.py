from . import csr, datasets, generators  # noqa: F401
from .csr import CSR, Graph, from_edges, relabel, validate  # noqa: F401
