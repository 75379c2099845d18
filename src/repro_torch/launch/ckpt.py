"""Fault-tolerant checkpoints: atomic, versioned, device-independent.

Port of ``repro.launch.ckpt``, with its protocol: a checkpoint is written
into a temporary directory and published by one ``os.replace``; the step is
in the directory's name; a manifest lists the last ``keep`` checkpoints,
and a corrupt or partial one is skipped on restore, which falls back to the
one before.  The state is the model's parameters, the optimizer's moments
and step, the data cursor and a generator's state: all that a bitwise
resume needs.

Tensors are saved by state-dict name (``torch.save`` of name → CPU tensor,
read back with ``weights_only=True``), not by leaf position, and restored
onto the devices of the model and optimizer they are loaded into: saved on
the card, a checkpoint restores on the CPU bit for bit, and back — the
one-device counterpart of the reference's restore onto any mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional

import torch
from torch import nn

__all__ = ["list_checkpoints", "restore_latest", "save_checkpoint"]

_MANIFEST = "manifest.json"


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: t.detach().to("cpu", copy=True) for k, t in tensors.items()}


def save_checkpoint(root: str, step: int, model: nn.Module,
                    opt: Dict[str, Any], data_cursor: int,
                    rng_state: Optional[torch.Tensor] = None,
                    keep: int = 3) -> str:
    """Write ``ckpt_{step:08d}`` under ``root`` atomically and keep the last
    ``keep`` checkpoints; returns its path.  ``opt`` is ``train.step``'s
    state (``m`` and ``v`` by parameter name, ``step``); ``rng_state`` a
    ``torch.Generator``'s ``get_state()``."""
    os.makedirs(root, exist_ok=True)
    name = f"ckpt_{step:08d}"
    tmp = tempfile.mkdtemp(dir=root, prefix=".tmp_")
    try:
        torch.save(_host(model.state_dict()), os.path.join(tmp, "params.pt"))
        state = {f"{key}.{n}": t for key in ("m", "v")
                 for n, t in opt[key].items()}
        state["step"] = opt["step"]
        torch.save(_host(state), os.path.join(tmp, "opt.pt"))
        meta = {"step": int(step), "data_cursor": int(data_cursor),
                "rng_state": (None if rng_state is None
                              else rng_state.cpu().tolist())}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        final = os.path.join(root, name)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _update_manifest(root, keep)
    return os.path.join(root, name)


def _update_manifest(root: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(root)
                   if d.startswith("ckpt_")
                   and os.path.isdir(os.path.join(root, d)))
    for old in ckpts[:-keep]:
        shutil.rmtree(os.path.join(root, old), ignore_errors=True)
    tmpf = os.path.join(root, _MANIFEST + ".tmp")
    with open(tmpf, "w") as f:
        json.dump({"checkpoints": ckpts[-keep:]}, f)
    os.replace(tmpf, os.path.join(root, _MANIFEST))


def list_checkpoints(root: str) -> List[str]:
    mf = os.path.join(root, _MANIFEST)
    if not os.path.exists(mf):
        return []
    with open(mf) as f:
        return json.load(f)["checkpoints"]


def _load(path: str, model: nn.Module, opt: Dict[str, Any]):
    """Read and check one checkpoint against ``model``'s and ``opt``'s
    names, shapes and dtypes, onto their devices; change nothing yet."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    params = torch.load(os.path.join(path, "params.pt"), map_location="cpu",
                        weights_only=True)
    state = torch.load(os.path.join(path, "opt.pt"), map_location="cpu",
                       weights_only=True)
    want = model.state_dict()
    if set(params) != set(want):
        raise ValueError(f"parameter names differ: "
                         f"{sorted(set(params) ^ set(want))[:4]}")
    for n, t in want.items():
        if params[n].shape != t.shape or params[n].dtype != t.dtype:
            raise ValueError(f"{n}: saved {tuple(params[n].shape)} "
                             f"{params[n].dtype}, model {tuple(t.shape)} "
                             f"{t.dtype}")
    moments = {}
    for key in ("m", "v"):
        moments[key] = {}
        for n, t in opt[key].items():
            s = state[f"{key}.{n}"]
            if s.shape != t.shape or s.dtype != t.dtype:
                raise ValueError(f"{key}.{n}: saved {tuple(s.shape)} "
                                 f"{s.dtype}, optimizer {tuple(t.shape)} "
                                 f"{t.dtype}")
            moments[key][n] = s.to(t.device)
    if len(state) != 2 * len(opt["m"]) + 1:
        raise ValueError("optimizer state names differ")
    params = {n: params[n].to(t.device) for n, t in want.items()}
    step = state["step"].to(opt["step"].device)
    return meta, params, moments, step


def restore_latest(root: str, model: nn.Module,
                   opt: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Load the newest valid checkpoint under ``root`` into ``model`` and
    ``opt`` in place, onto their devices, and return ``{"step",
    "data_cursor", "rng_state", "path"}``; ``None`` when there is none.
    A corrupt or partial checkpoint is skipped (a crash while saving falls
    back to the one before)."""
    for name in reversed(list_checkpoints(root)):
        path = os.path.join(root, name)
        try:
            meta, params, moments, step = _load(path, model, opt)
        except Exception as e:  # corrupt or partial: try the one before
            print(f"[ckpt] skipping {name}: {e}")
            continue
        model.load_state_dict(params, strict=True)
        for key in ("m", "v"):
            opt[key].update(moments[key])
        opt["step"] = step
        rng = meta["rng_state"]
        return {"step": meta["step"], "data_cursor": meta["data_cursor"],
                "rng_state": (None if rng is None
                              else torch.tensor(rng, dtype=torch.uint8)),
                "path": path}
    return None
