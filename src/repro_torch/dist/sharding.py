"""Parameter placements from logical axes: the LM's sharding rules.

Port of ``repro.dist.sharding`` on ``torch.distributed.tensor``.  Every
weight has logical axes (``("embed", "heads")`` …) read from its
state-dict name, and these translate to mesh axes:

  FSDP:  ``embed``/``embed_fsdp``          → ``data`` (and ``pod`` when
         ``fsdp_over_pods``): ZeRO-3 falls out of DTensor's propagation
  TP:    ``heads``/``kv_heads``/``ff``/``vocab``/``experts`` → ``model``

A spec is a plain tuple with one entry per dimension: ``None``, a mesh
axis name, or a tuple of names (major first).  The reference stacks the
layers of its scanned periods and its encoder on a leading dimension,
which its rules leave replicated; the port keeps one tensor per layer, so
its spec for a parameter is the reference's spec for the same stacked
leaf, computed on the stacked shape, with that first entry dropped.
``enforce_divisibility`` then drops, per dimension, the mesh axes that do
not evenly divide it, are absent from the mesh or are used twice, so one
table serves every arch at every size.

A mesh here is a ``DeviceMesh`` with ``mesh_dim_names``, or any mapping of
axis name to size (the rules are pure: the tests pass sizes alone).
:func:`placements` turns a spec into the DTensor ``Shard``/``Replicate``
placements over a ``DeviceMesh``, and :func:`shard_model` places every
parameter of a model so.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

__all__ = ["batch_spec", "cache_specs", "enforce_divisibility",
           "local_bytes", "logical_axes", "mesh_shape", "param_specs",
           "placements", "shard_cache", "shard_model", "stack_size"]

Logical = Tuple[Optional[str], ...]
Spec = Tuple[Any, ...]

# path-suffix -> logical axes for the trailing dims of the leaf.  Keys are
# (parent, leaf) pairs; single-name keys match the leaf name alone.
_RULES: Dict[Tuple[str, ...], Logical] = {
    # embedding (the DBG hot/cold vocab split)
    ("embed", "hot"): (None, "embed_fsdp"),
    ("embed", "cold"): ("vocab", None),
    ("embed", "table"): ("vocab", None),
    ("embed", "unembed"): (None, "vocab"),
    # attention / MLA
    ("q", "w"): ("embed", "heads"),
    ("k", "w"): ("embed", "kv_heads"),
    ("v", "w"): ("embed", "kv_heads"),
    ("o", "w"): ("heads", "embed"),
    ("kv_down", "w"): ("embed", None),
    ("k_rope", "w"): ("embed", None),
    ("k_up", "w"): (None, "heads"),
    ("v_up", "w"): (None, "heads"),
    # dense MLP (also MoE shared experts)
    ("up", "w"): ("embed", "ff"),
    ("gate", "w"): ("embed", "ff"),
    ("down", "w"): ("ff", "embed"),
    # MoE routed experts: stacked raw tensors, no {"w": ...} wrapper
    ("chan", "gate"): ("experts", "embed", "ff"),
    ("chan", "up"): ("experts", "embed", "ff"),
    ("chan", "down"): ("experts", "ff", "embed"),
    ("router", "w"): ("embed", None),
    # SSD / RG-LRU mixers
    ("in_proj", "w"): ("embed", "ff"),
    ("out_proj", "w"): ("ff", "embed"),
    ("in_x", "w"): ("embed", "ff"),
    ("in_gate", "w"): ("embed", "ff"),
    ("rg_w", "w"): ("ff", "ff"),
    ("ig_w", "w"): ("ff", "ff"),
    ("out", "w"): ("ff", "embed"),
    ("conv_w",): (None, "ff"),
    ("A_log",): ("heads",),
    ("D",): ("heads",),
    ("dt_bias",): ("heads",),
    ("lam",): ("ff",),
    # norms / misc
    ("scale",): ("embed",),
    ("prefix_proj", "w"): ("embed", "embed"),
}

_TP_AXES = ("heads", "kv_heads", "ff", "vocab", "experts")


def stack_size(cfg, name: str) -> int:
    """The size of the leading dimension the reference stacks parameter
    ``name`` on, or 0 where its leaf is not stacked: a layer of a whole
    pattern period (``layers.{i}``, i below ``n_periods · len(pattern)``)
    is one of ``n_periods``, an encoder layer one of ``n_enc_layers``; a
    tail layer, the embedding and the final norm are not stacked."""
    parts = name.split(".")
    if parts[0] == "layers":
        plen = len(cfg.layer_pattern())
        n_periods = cfg.n_layers // plen
        return n_periods if int(parts[1]) < n_periods * plen else 0
    if parts[0] == "encoder":
        return cfg.n_enc_layers
    return 0


def _names(name: str) -> Tuple[str, ...]:
    """The dict keys of a state-dict name (layer indices carry no name, as
    the reference's sequence keys and stacking dims carry none)."""
    return tuple(p for p in name.split(".") if not p.isdigit())


def _logical_for(name: str, ndim: int) -> Logical:
    names = _names(name)
    rule: Optional[Logical] = None
    for span in (2, 1):
        if len(names) >= span and names[-span:] in _RULES:
            rule = _RULES[names[-span:]]
            break
    if rule is None or ndim < len(rule):
        return (None,) * ndim
    # leading stacking dims stay replicated
    return (None,) * (ndim - len(rule)) + rule


def _to_mesh_axes(logical: Logical, fsdp_over_pods: bool) -> Spec:
    fsdp = ("pod", "data") if fsdp_over_pods else ("data",)
    entries = []
    used: set = set()
    for name in logical:
        if name in ("embed", "embed_fsdp"):
            axes = tuple(a for a in fsdp if a not in used)
        elif name in _TP_AXES:
            axes = ("model",) if "model" not in used else ()
        else:
            axes = ()
        if not axes:
            entries.append(None)
            continue
        used.update(axes)
        entries.append(axes[0] if len(axes) == 1 else axes)
    return tuple(entries)


def _stacked(cfg, name: str, shape) -> Tuple[int, Tuple[int, ...]]:
    n = stack_size(cfg, name)
    return (1, (n,) + tuple(shape)) if n else (0, tuple(shape))


def logical_axes(model: nn.Module) -> Dict[str, Logical]:
    """``{name: logical axes}`` for every parameter of ``model`` (an ``LM``),
    the stacking entry dropped."""
    out = {}
    for name, p in model.named_parameters():
        k, shape = _stacked(model.cfg, name, p.shape)
        out[name] = _logical_for(name, len(shape))[k:]
    return out


def param_specs(model: nn.Module, fsdp_over_pods: bool = False,
                mesh=None) -> Dict[str, Spec]:
    """``{name: spec}`` for every parameter of ``model`` (an ``LM``: its
    ``cfg`` tells the stacked layers; ``meta`` tensors will do).  Without
    ``mesh`` the specs are mesh-agnostic and may over-shard, as the
    reference's; with one, :func:`enforce_divisibility` has been applied on
    the reference's stacked shape."""
    sizes = None if mesh is None else mesh_shape(mesh)
    out = {}
    for name, p in model.named_parameters():
        k, shape = _stacked(model.cfg, name, p.shape)
        spec = _to_mesh_axes(_logical_for(name, len(shape)), fsdp_over_pods)
        if sizes is not None:
            spec = _enforce_one(shape, spec, sizes)
        out[name] = spec[k:]
    return out


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def batch_spec(mesh) -> Tuple[Any, ...]:
    """Leading-dim entry for batch-sharded inputs: ``(*batch_spec(mesh),
    …)``.  A 1-tuple whose element may itself be a tuple of mesh axes
    (``("pod", "data")`` on multi-pod meshes), so the batch dim folds over
    every data-parallel axis."""
    names = [a for a in ("pod", "data") if a in mesh_shape(mesh)]
    if not names:
        return (None,)
    return (names[0] if len(names) == 1 else tuple(names),)


def cache_specs(cache: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Decode-cache specs, the structure of ``lm.model.init_cache``'s
    ``cache``: dim 0 (the batch) over the data axes, everything else
    replicated; ``len`` (host lengths) has none.  The reference's
    period-stacked leaves carry their batch on dim 1, the port's per-layer
    caches on dim 0.  Its rule reads dim 0 of a ring's ``pos`` plane too
    (the window's slots, no batch), and so does the port's."""
    (bentry,) = batch_spec(mesh)

    def spec_for(key, t):
        ndim = t.dim()
        if ndim == 0:
            return ()
        return (bentry,) + (None,) * (ndim - 1)

    out: Dict[str, Any] = {"len": ()}
    out["layers"] = [{k: spec_for(k, t) for k, t in layer.items()}
                     for layer in cache["layers"]]
    for key in ("cross_k", "cross_v"):
        if key in cache:
            out[key] = spec_for(key, cache[key])
    return out


def _axes_tuple(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def _enforce_one(shape: Tuple[int, ...], spec: Spec,
                 sizes: Mapping[str, int]) -> Spec:
    entries = []
    used: set = set()
    for i, entry in enumerate(spec):
        axes = tuple(a for a in _axes_tuple(entry)
                     if a in sizes and a not in used)
        prod = 1
        for a in axes:
            prod *= int(sizes[a])
        if not axes or prod <= 1 or i >= len(shape) or shape[i] % prod != 0:
            entries.append(None)
            continue
        used.update(axes)
        entries.append(axes[0] if len(axes) == 1 else axes)
    return tuple(entries)


def enforce_divisibility(shape, spec: Spec, mesh) -> Spec:
    """Drop (per dimension) mesh axes that do not evenly divide the
    dimension, that ``mesh`` lacks, or that an earlier dimension used."""
    return _enforce_one(tuple(shape), tuple(spec), mesh_shape(mesh))


def placements(spec: Spec, mesh) -> list:
    """The DTensor placements over ``mesh`` (a ``DeviceMesh``) of a tensor
    with ``spec``: ``Shard(d)`` on each mesh dim that dimension ``d`` names,
    ``Replicate()`` on the others.  A dimension over two axes
    (``("pod", "data")``) is split by the first, then by the second, as
    the mesh orders them; a spec listing them the other way raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes_tuple(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec entry {entry} is not in the mesh's order "
                             f"{tuple(names)}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return out


def shard_model(model: nn.Module, mesh, fsdp_over_pods: bool = False
                ) -> Dict[str, Spec]:
    """Turn every parameter of ``model`` (an ``LM``) into a DTensor over
    ``mesh`` with the placements of its spec (:func:`param_specs` with
    divisibility enforced), in place; each rank keeps its own shard.  The
    model's values are taken as every rank's (a replicated start, as a
    seeded ``init_params`` gives).  Returns the specs."""
    from torch.distributed.tensor import distribute_tensor

    specs = param_specs(model, fsdp_over_pods, mesh=mesh)
    for name, p in list(model.named_parameters()):
        owner = model.get_submodule(name.rpartition(".")[0])
        leaf = name.rpartition(".")[2]
        dt = distribute_tensor(p.detach(), mesh, placements(specs[name], mesh))
        setattr(owner, leaf, nn.Parameter(dt, requires_grad=p.requires_grad))
    return specs


def shard_cache(cache: Dict[str, Any], mesh) -> Dict[str, Any]:
    """``lm.model.init_cache``'s cache with every tensor made a DTensor over
    ``mesh`` placed by :func:`cache_specs` (divisibility enforced), in
    place; ``len`` (host lengths) and ``len_dev`` stay as they are.
    Returns the cache."""
    from torch.distributed.tensor import distribute_tensor

    specs = cache_specs(cache, mesh)

    def put(t, spec):
        spec = enforce_divisibility(t.shape, spec, mesh)
        return distribute_tensor(t, mesh, placements(spec, mesh))

    cache["layers"] = [{k: put(t, specs["layers"][i][k])
                        for k, t in layer.items()}
                       for i, layer in enumerate(cache["layers"])]
    for key in ("cross_k", "cross_v"):
        if key in cache:
            cache[key] = put(cache[key], specs[key])
    return cache


def local_bytes(t: torch.Tensor) -> int:
    """Bytes of this rank's shard of ``t`` (a DTensor or a plain tensor)."""
    local = t.to_local() if hasattr(t, "to_local") else t
    return local.numel() * local.element_size()
