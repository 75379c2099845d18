"""Logical-axis activation placements.

Port of ``repro.dist.constrain`` on DTensor.  Model code annotates
intermediates with LOGICAL axis names (``constrain(x, "batch", None,
"model")``); the caller decides which mesh axes are live with the
``activation_sharding(mesh)`` context manager.  Outside the context, or on
a plain tensor, every call returns its input: the one-device path is
unchanged, bitwise.

Logical → mesh translation:

  ``batch``  → every live data-parallel axis, in mesh order (``pod``, ``data``)
  ``seq``    → the tensor axis (``model``): Megatron sequence parallelism
  ``model`` / ``data`` / ``pod`` → themselves, when live

A dimension's axes are dropped when they do not evenly divide it, when
the mesh lacks them, or when an earlier dimension of the same tensor uses
them (``sharding._enforce_one``, the reference's rules).  Where any axis
is left, the tensor is redistributed to exactly that spec (the dimensions
it does not name replicated), as ``with_sharding_constraint`` fixes the
whole sharding; where none is left, it is returned as it is.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import torch

from .sharding import _enforce_one, mesh_shape, placements

__all__ = ["activation_sharding", "axis_size", "constrain", "einsum", "full",
           "is_sharded", "positions", "replicate", "reshape"]

# data-parallel mesh axes in the order they appear in production meshes
_BATCH_AXES = ("pod", "data")
_LOGICAL = {"batch": _BATCH_AXES, "seq": ("model",)}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.sizes: Optional[Dict[str, int]] = None


_CTX = _Ctx()


@contextlib.contextmanager
def activation_sharding(mesh):
    """Let activation constraints target ``mesh``'s axes (a
    ``DeviceMesh``) inside the block."""
    prev = (_CTX.mesh, _CTX.sizes)
    _CTX.mesh, _CTX.sizes = mesh, mesh_shape(mesh)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.sizes = prev


def _resolve(name: Optional[str]) -> Tuple[str, ...]:
    """Logical activation axis -> tuple of live mesh axes (may be empty)."""
    if name is None or _CTX.sizes is None:
        return ()
    return tuple(a for a in _LOGICAL.get(name, (name,)) if a in _CTX.sizes)


def axis_size(name: str) -> int:
    """Product of the mesh-axis sizes a logical axis maps to; 0 when
    inactive.  Model code reads it for layout decisions (head-sharded or
    sequence-sharded attention when ``n_heads % axis_size("model")``)."""
    axes = _resolve(name)
    if not axes:
        return 0
    prod = 1
    for a in axes:
        prod *= _CTX.sizes[a]
    return prod


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x, *axes):
    """Redistribute DTensor ``x`` to the placements of its logical
    ``axes``; ``x`` itself outside ``activation_sharding``, for a plain
    tensor, or where the drop rules leave no axis."""
    if _CTX.sizes is None or not is_sharded(x):
        return x
    raw = tuple(_resolve(name) or None for _, name in zip(x.shape, axes))
    spec = _enforce_one(tuple(x.shape), raw, _CTX.sizes)
    if all(e is None for e in spec):
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def replicate(x, dims=None):
    """DTensor ``x`` with dimensions ``dims`` (all when None) gathered
    whole on every rank (their ``Shard`` placements made ``Replicate``);
    a pending sum is reduced too.  Used where an op has no sharding
    strategy; ``x`` itself for a plain tensor."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    want = [Replicate() if (not isinstance(p, Shard)
                            or dims is None or p.dim in dims) else p
            for p in x.placements]
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``.  A DTensor whose split DTensor cannot carry
    through the reshape (a dimension split 16 ways unflattened into 4
    heads) is gathered whole first: on every dimension but the batch, then
    on all.  The backward's reshape of the gradient takes the same way out
    (a merge of heads unflattens its gradient).  GSPMD reshards such
    cases itself; DTensor raises."""
    if not is_sharded(x):
        return x.reshape(*shape)
    return _Reshape.apply(x, shape)


def _reshaped(x, shape):
    try:
        return x.reshape(*shape)
    except RuntimeError:
        pass
    try:
        return replicate(x, range(1, x.dim())).reshape(*shape)
    except RuntimeError:
        return replicate(x).reshape(*shape)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return _reshaped(x, shape)

    @staticmethod
    def backward(ctx, grad):
        return _reshaped(grad, ctx.shape), None


def einsum(equation: str, *operands) -> torch.Tensor:
    """``torch.einsum``.  Where DTensor cannot carry the operands' splits
    through einsum's own reshapes (24 heads split 16 ways), they are
    gathered whole on every dimension but the batch first.  For paths
    without a backward (decode)."""
    if not any(is_sharded(t) for t in operands):
        return torch.einsum(equation, *operands)
    try:
        return torch.einsum(equation, *operands)
    except RuntimeError:
        return torch.einsum(equation, *(replicate(t, range(1, t.dim()))
                                        for t in operands))


def full(ref: torch.Tensor, shape, fill, dtype) -> torch.Tensor:
    """``torch.full(shape, fill)`` on ``ref``'s device; for a DTensor
    ``ref``, a DTensor split as ``ref`` is on the leading dimensions of the
    same size (the others replicated), each rank holding its shard only.
    A plain tensor of an activation's global shape would be replicated
    whole on every rank."""
    if not is_sharded(ref):
        return torch.full(shape, fill, dtype=dtype, device=ref.device)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    shape = tuple(shape)
    out = [p if isinstance(p, Shard) and p.dim < len(shape)
           and shape[p.dim] == ref.shape[p.dim] else Replicate()
           for p in ref.placements]
    local_shape, _ = compute_local_shape_and_global_offset(
        shape, ref.device_mesh, out)
    return DTensor.from_local(
        torch.full(local_shape, fill, dtype=dtype,
                   device=ref.to_local().device),
        ref.device_mesh, out, run_check=False)


def positions(x: torch.Tensor) -> torch.Tensor:
    """(B, S) int32 positions ``0..S-1`` of ``x`` (B, S, ...); for a
    DTensor, split as ``x`` is on its first two dimensions (a rank holding
    a slice of the sequence holds its positions)."""
    b, s = x.shape[0], x.shape[1]
    if not is_sharded(x):
        return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    out = [p if isinstance(p, Shard) and p.dim < 2 else Replicate()
           for p in x.placements]
    (lb, ls), (_, off) = compute_local_shape_and_global_offset(
        (b, s), x.device_mesh, out)
    dev = x.to_local().device
    local = torch.arange(off, off + ls, dtype=torch.int32,
                         device=dev).expand(lb, ls)
    return DTensor.from_local(local, x.device_mesh, out, run_check=False)
