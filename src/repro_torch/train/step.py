"""Training step: AdamW, a global-norm clip and a warmup-cosine schedule.

Port of ``repro.train.step`` as plain functions on an ``LM``'s tensors.
Master weights stay in the model (float32 as built); the forward runs in
``compute_dtype`` through ``torch.func.functional_call`` on cast copies, so
the gradients land on the masters.  The update is the reference's own rule
in its order of operations (``torch.optim.AdamW`` and ``clip_grad_norm_``
differ in their epsilon and clip formulas): the clip scale
``min(1, clip / max(‖g‖, 1e-9))``, bias-corrected moments,
``m̂ / (√v̂ + eps)`` plus decoupled weight decay on the reference's leaves
of two or more dimensions.  The reference stacks the layers of its scanned
periods and its encoder, so there a norm's scale is a (periods, d) leaf
and decays, while a tail layer's scale and the final norm's do not;
:func:`decays` keeps that rule by name.  The optimizer state is ``{"m": {name: tensor}, "v": {...},
"step": int32 scalar}`` by state-dict name.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..dist.constrain import is_sharded
from ..dist.sharding import stack_size
from ..lm import model as model_mod

__all__ = ["OptConfig", "cast_params", "decays", "init_opt",
           "make_train_step"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compute_dtype: str = "bfloat16"
    grad_accum: int = 1       # microbatches per step (activation peak / A)
    loss_chunk: int = 0       # CE over sequence chunks; 0 = full logits
    moment_dtype: str = "float32"  # bfloat16 halves the optimizer state


def init_opt(model: nn.Module, moment_dtype=torch.float32) -> Dict[str, Any]:
    """Zero moments beside every parameter, on its device, and step 0."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    return {"m": {n: torch.zeros_like(p, dtype=moment_dtype)
                  for n, p in params.items()},
            "v": {n: torch.zeros_like(p, dtype=moment_dtype)
                  for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def decays(cfg: ArchConfig, name: str, p: torch.Tensor) -> bool:
    """Whether ``name`` takes weight decay: its rank in the reference's
    tree, one more than here for a layer of a stacked period or of the
    (stacked) encoder, is >= 2."""
    return p.dim() + bool(stack_size(cfg, name)) >= 2


def _schedule(step: torch.Tensor, oc: OptConfig) -> torch.Tensor:
    warm = torch.clamp((step + 1) / max(1, oc.warmup), max=1.0)
    prog = torch.clamp((step - oc.warmup) / max(1, oc.total_steps - oc.warmup),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return oc.lr * warm * (0.1 + 0.9 * cos)


def _global_norm(tensors) -> torch.Tensor:
    """The L2 norm over every element of ``tensors``; over every shard of
    DTensors (a plain, replicated result)."""
    return _whole(torch.sqrt(sum(t.float().square().sum() for t in tensors)))


def _whole(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a plain tensor: a DTensor's full value on every rank."""
    return t.full_tensor() if is_sharded(t) else t


def _rows(t: torch.Tensor, j: int, a: int) -> torch.Tensor:
    """Rows ``j, j + a, ...`` of ``t``; of a DTensor batch split on rows,
    each rank takes them of its own rows (the same rows in another order
    when ``a`` divides the rows per rank; a loss sums them alike)."""
    if is_sharded(t):
        from torch.distributed.tensor import DTensor, Shard

        local = t.to_local()
        if (any(isinstance(p, Shard) and p.dim == 0 for p in t.placements)
                and local.shape[0] % a == 0):
            return DTensor.from_local(local[j::a], t.device_mesh,
                                      t.placements, run_check=False)
    return t[j::a]


def cast_params(model: nn.Module, dtype) -> Dict[str, torch.Tensor]:
    """``{name: parameter cast to dtype}`` for floating parameters (the
    others as they are): the tensors ``functional_call`` runs the model on.
    The casts are differentiable, so gradients reach the parameters."""
    return {n: p.to(dtype) if p.is_floating_point() else p
            for n, p in model.named_parameters()}


class _Loss(nn.Module):
    """The model's loss as a module, for ``functional_call``."""

    def __init__(self, model: nn.Module, loss_chunk: int):
        super().__init__()
        self.model = model
        self.loss_chunk = loss_chunk

    def forward(self, tokens, labels, prefix=None, frames=None):
        return model_mod.loss_fn(self.model, tokens, labels, prefix=prefix,
                                 frames=frames, loss_chunk=self.loss_chunk)


def make_train_step(cfg: ArchConfig, oc: OptConfig):
    """Returns ``train_step(model, opt, batch) -> metrics``.

    ``batch``: ``{"tokens", "labels"}`` (B, S) integer tensors on the
    model's device, and the stub inputs of the families that take them
    (``prefix``, ``frames``).  A sharded model (``dist.sharding.
    shard_model``) takes DTensor batches split on rows: the step runs on
    every rank's shards, the gradients reduced to the parameters'
    placements, the norm over every shard.

    The step updates the model's parameters and ``opt``
    in place, leaves the float32 master gradients in each parameter's
    ``grad``, and returns ``{"loss", "grad_norm", "lr"}`` as device scalars:
    nothing is read back to the host.  Its halves are attributes:
    ``grads_of(model, batch) -> loss`` and ``apply(model, opt) ->
    {"grad_norm", "lr"}``."""
    cdtype = _DTYPES[oc.compute_dtype]
    mdtype = _DTYPES[oc.moment_dtype]

    def backward(loss_mod, model, batch):
        params = (cast_params(model, cdtype) if cdtype != torch.float32
                  else dict(model.named_parameters()))
        params = {"model." + n: p for n, p in params.items()}
        with model_mod.on_mesh(model):
            loss = torch.func.functional_call(
                loss_mod, params, (batch["tokens"], batch["labels"],
                                   batch.get("prefix"), batch.get("frames")))
            loss.backward()
        return _whole(loss.detach())

    def grads_of(model, batch):
        for p in model.parameters():
            p.grad = None
        loss_mod = _Loss(model, oc.loss_chunk)
        a = oc.grad_accum
        if a <= 1:
            return backward(loss_mod, model, batch)
        # microbatch j holds rows j, j + a, j + 2a, ... as the reference's
        # reshape (B/a, a) then moveaxis splits them
        loss = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
        for j in range(a):
            loss = loss + backward(
                loss_mod, model, {k: _rows(v, j, a) for k, v in batch.items()})
        inv = 1.0 / a
        for p in model.parameters():
            p.grad.mul_(inv)
        return loss * inv

    @torch.no_grad()
    def update(model, opt, gnorm):
        scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        step = opt["step"]
        lr = _schedule(step, oc)
        t = step.float() + 1.0
        b1c = 1.0 - oc.b1 ** t
        b2c = 1.0 - oc.b2 ** t
        for name, p in model.named_parameters():
            g = p.grad
            if is_sharded(p) and g.placements != p.placements:
                g = g.redistribute(p.device_mesh, p.placements)
            g = g.float() * scale
            m, v = opt["m"][name], opt["v"][name]
            # float32 moments update in place; others through a copy
            m32 = (m if m.dtype == torch.float32 else m.float()).mul_(oc.b1)
            m32.add_(g, alpha=1 - oc.b1)
            v32 = (v if v.dtype == torch.float32 else v.float()).mul_(oc.b2)
            v32.addcmul_(g, g, value=1 - oc.b2)
            delta = (m32 / b1c).div_((v32 / b2c).sqrt_().add_(oc.eps))
            if decays(cfg, name, p):  # decoupled weight decay
                delta.add_(p.float(), alpha=oc.weight_decay)
            p.copy_(p.float() - lr * delta)
            opt["m"][name] = m32.to(mdtype)
            opt["v"][name] = v32.to(mdtype)
        opt["step"] = step + 1
        return lr

    def apply(model, opt) -> Dict[str, torch.Tensor]:
        gnorm = _global_norm(p.grad for p in model.parameters())
        with model_mod.on_mesh(model):
            return {"grad_norm": gnorm, "lr": update(model, opt, gnorm)}

    def train_step(model, opt, batch) -> Dict[str, torch.Tensor]:
        loss = grads_of(model, batch)
        return {"loss": loss, **apply(model, opt)}

    # its two halves, for timing each: the gradients, then the update
    train_step.grads_of = grads_of
    train_step.apply = apply
    return train_step
