"""PyTorch/CUDA port of the DBG graph-reordering system (``repro``).

Mirrors ``repro``'s layout — ``graph``, ``core``, ``kernels.edge_map``,
``apps`` — and imports nothing of it, nor JAX.  Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.
"""
