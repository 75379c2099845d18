"""Multi-pod dry run: every (arch × shape × mesh) cell's step, once, on
placeholder ranks.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell's step on 256 or 512 placeholder host devices and reads XLA's memory
and cost analyses.  The port has no compiler to ask, so it runs the step:
one process joins a fake process group (``torch.testing``'s ``"fake"``
backend: collectives return at once and move nothing) of 256 or 512 ranks
as rank 0, builds the model on ``meta`` (no memory) as DTensors over the
production mesh (``launch.mesh``), and runs the train, prefill or decode
step once on ``meta`` inputs split as the reference splits them.  One
dispatch mode sees every op that reaches this rank's local shards (it lets
DTensor turn each global op into local ops and collectives first:
``FlopCounterMode`` entered around DTensor ops counts the global product,
and ``CommDebugMode`` counts collectives, not their bytes) and counts:

* ``flops`` — each local op's FLOPs by ``torch.utils.flop_counter``'s
  formulas (the ones ``FlopCounterMode`` uses), so the count is of the
  shards: a product split on both axes of a (16, 16) mesh counts 1/256 of
  itself, and on a (1, 1) mesh the count is the unsharded step's;
* ``bytes_accessed`` — the sum over local ops of their input and output
  bytes: an unfused upper bound, not XLA's fused count;
* ``collective_bytes`` — per kind (the reference's names), the local
  result bytes of each collective DTensor issued, and their ``total``.  On
  a CPU mesh DTensor moves a shard to another dimension by an all-gather
  and a slice, where on the card it would issue an all-to-all;
* memory — ``argument_bytes``, the local bytes of the step's inputs
  (parameters, optimizer state, batch or cache); ``output_bytes``, of what
  it returns or updates; ``temp_bytes``, the peak of the bytes that ops
  allocated and that were still alive (followed by storage), and
  ``peak_bytes`` = argument + temp, as the reference adds them.  These
  are counts on the host, not measurements of a device.

``roofline`` prices the per-device counts with ``roofline.analysis.
roofline_terms`` on ``HW.profile()`` (the H100's): its ``link_bw`` is
infinite, so ``collective_s`` is 0 and the output says so.

Results go to a JSON file, one key per cell, written after each cell, so
an interrupted run resumes; a ``long_500k`` cell of an arch with full
attention is skipped, as in the reference.

Usage (CPU only)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b \\
      --shape train_4k --mesh single --reduced --out /tmp/dr.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCH_IDS, get_config
from ..configs.base import SHAPES, ArchConfig, ShapeCell, reduced
from ..dist import sharding as shd
from ..dist.constrain import activation_sharding
from ..lm import model as model_mod
from ..roofline import analysis as roofline
from ..train import step as train_step_mod
from .mesh import make_production_mesh

__all__ = ["Counters", "fake_world", "input_batch", "lower_cell", "mesh_for",
           "run"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# collective op names -> the reference's kinds (DTensor issues no permute;
# a collective of another kind is counted under its op's name)
_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
          ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counters(TorchDispatchMode):
    """Per-rank counts of the ops under it (module docstring): ``flops``,
    ``bytes``, ``collectives`` by kind, and the ``live``/``peak`` bytes of
    storages allocated inside it."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives = {k: 0 for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._seen = set()
        self._quiet = 0
        self._restore = None

    def __enter__(self):
        # DTensor infers an op's output shape by running it on meta tensors
        # of the GLOBAL shape; those runs reach this mode too and are not
        # this rank's work, so they are left uncounted
        from torch.distributed.tensor import DTensor

        prop = DTensor._op_dispatcher.sharding_propagator
        real = prop._propagate_tensor_meta_non_cached

        def quiet(*args, **kwargs):
            self._quiet += 1
            try:
                return real(*args, **kwargs)
            finally:
                self._quiet -= 1

        prop._propagate_tensor_meta_non_cached = quiet
        self._restore = (prop, real)
        return super().__enter__()

    def __exit__(self, *exc):
        prop, real = self._restore
        prop._propagate_tensor_meta_non_cached = real
        return super().__exit__(*exc)

    def _freed(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def _track(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self.live += n
            weakref.finalize(st, self._freed, key, n)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor turns it into local ops first
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        packet = func._overloadpacket
        name = str(packet)
        if "_c10d_functional" in name or name.startswith("c10d"):
            if "wait" not in name and "wrap" not in name:  # not transfers
                kind = next((k for s, k in _KINDS if s in name), name)
                self.collectives[kind] = self.collectives.get(kind, 0) + sum(
                    _nbytes(t) for t in _tensors(out))
            return out
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in _tensors(out))
        if not getattr(func, "is_view", False):
            self._track(out)
        return out


# ---------------------------------------------------------------------------
# ranks, meshes, inputs
# ---------------------------------------------------------------------------


def fake_world(n: int) -> None:
    """Make this process rank 0 of a fake group of ``n`` ranks (replacing a
    group of another size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def mesh_for(kind: str):
    """The mesh of a ``--mesh`` value: ``single`` (16, 16), ``multi``
    (2, 16, 16), ``podsN`` (N, 16, 16); the fake group sized to it."""
    from torch.distributed.device_mesh import DeviceMesh

    if kind.startswith("pods"):
        n = int(kind[4:])
        fake_world(n * 256)
        return DeviceMesh("cpu", torch.arange(n * 256).reshape(n, 16, 16),
                          mesh_dim_names=("pod", "data", "model"))
    fake_world(512 if kind == "multi" else 256)
    return make_production_mesh(multi_pod=kind == "multi", device="cpu")


def _placed(shape, dtype, spec, mesh):
    from torch.distributed.tensor import distribute_tensor

    spec = shd.enforce_divisibility(shape, spec, mesh)
    return distribute_tensor(torch.empty(shape, dtype=dtype, device="meta"),
                             mesh, shd.placements(spec, mesh))


def input_batch(cfg: ArchConfig, cell: ShapeCell, mesh) -> Dict[str, Any]:
    """One cell's model inputs on ``meta``, split on the batch axes as the
    reference's ``input_specs`` splits them."""
    bspec = shd.batch_spec(mesh)
    b, s = cell.global_batch, cell.seq_len
    out: Dict[str, Any] = {}
    if cell.kind in ("train", "prefill"):
        s_text = s - cfg.prefix_len if cfg.prefix_len else s
        out["tokens"] = _placed((b, s_text), torch.int32, (*bspec, None), mesh)
        if cell.kind == "train":
            out["labels"] = _placed((b, s_text), torch.int32, (*bspec, None),
                                    mesh)
        if cfg.prefix_len:
            out["prefix"] = _placed((b, cfg.prefix_len, cfg.d_model),
                                    torch.bfloat16, (*bspec, None, None), mesh)
        if cfg.n_enc_layers:
            out["frames"] = _placed((b, s, cfg.d_model), torch.bfloat16,
                                    (*bspec, None, None), mesh)
    else:  # decode: one new token against a seq_len cache
        out["token"] = _placed((b, 1), torch.int32, (*bspec, None), mesh)
    return out


def _local_bytes(tree) -> int:
    return sum(shd.local_bytes(t) for t in _tensors(tree))


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def lower_cell(cfg: ArchConfig, cell: ShapeCell, mesh,
               oc_overrides: Optional[Dict[str, Any]] = None,
               fsdp_over_pods: bool = False) -> Dict[str, Any]:
    """Run one cell's step once on ``mesh`` (a ``DeviceMesh`` of a fake
    group) and return its counts (the reference's keys)."""
    t0 = time.time()
    batch = input_batch(cfg, cell, mesh)
    dtype = torch.float32 if cell.kind == "train" else torch.bfloat16
    model = model_mod.LM(cfg, device="meta", dtype=dtype)
    shd.shard_model(model, mesh, fsdp_over_pods=fsdp_over_pods)
    counts = Counters()
    if cell.kind == "train":
        oc = train_step_mod.OptConfig(**(oc_overrides or {}))
        mdtype = (torch.bfloat16 if oc.moment_dtype == "bfloat16"
                  else torch.float32)
        opt = train_step_mod.init_opt(model, mdtype)
        args = (model, opt, batch)
        step = train_step_mod.make_train_step(cfg, oc)
        argument = _local_bytes((list(model.parameters()), opt, batch))
        with activation_sharding(mesh), counts:
            out = step(*args)
        output = _local_bytes((list(model.parameters()), opt, out))
    elif cell.kind == "prefill":
        argument = _local_bytes((list(model.parameters()), batch))
        with torch.no_grad(), activation_sharding(mesh), counts:
            logits, _ = model_mod.forward(
                model, batch["tokens"], prefix=batch.get("prefix"),
                frames=batch.get("frames"), last_only=True)
            out = logits[:, -1]
        output = _local_bytes(out)
    else:  # decode
        cache = model_mod.init_cache(cfg, cell.global_batch,
                                     max_len=cell.seq_len, device="meta",
                                     dtype=torch.bfloat16)
        shd.shard_cache(cache, mesh)
        model_mod.set_lengths(cache, cell.seq_len - 1)  # the last slot
        argument = _local_bytes((list(model.parameters()), cache, batch))
        with activation_sharding(mesh), counts:
            out = model_mod.decode_step(model, cache, batch["token"])
        output = _local_bytes(out)
    n_devices = int(mesh.size())
    coll = dict(counts.collectives)
    coll["total"] = sum(coll.values())
    flops, bytes_acc = float(counts.flops), float(counts.bytes)
    return {
        "arch": cfg.arch_id,
        "shape": cell.name,
        "kind": cell.kind,
        "mesh": "x".join(str(int(v)) for v in mesh.shape),
        "n_devices": n_devices,
        "seconds_to_run": round(time.time() - t0, 1),
        "per_device": {
            "flops": flops,
            "bytes_accessed": bytes_acc,
            "collective_bytes": coll,
            "argument_bytes": argument,
            "output_bytes": output,
            "temp_bytes": counts.peak,
            "peak_bytes": argument + counts.peak,
        },
        "roofline": roofline.roofline_terms(flops, bytes_acc, coll["total"]),
    }


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def run(arch_ids, shape_names, meshes, out_path: str,
        reduced_for_test: bool = False,
        oc_overrides: Optional[Dict[str, Any]] = None,
        variant: str = "", fsdp_over_pods: bool = False,
        cfg_overrides: Optional[Dict[str, Any]] = None) -> int:
    """Every (mesh × arch × shape) cell into ``out_path``'s JSON (cells
    already ``ok`` there are kept and not run again); returns the number
    of cells that failed."""
    try:
        with open(out_path) as f:
            results = json.load(f)
    except (OSError, ValueError):
        results = {}
    failures = 0
    for mesh_kind in meshes:
        mesh = mesh_for(mesh_kind)
        for arch in arch_ids:
            cfg = get_config(arch)
            if cfg_overrides:
                cfg = dataclasses.replace(cfg, **cfg_overrides)
            if reduced_for_test:
                cfg = reduced(cfg)
            for sname in shape_names:
                cell = SHAPES[sname]
                key = f"{arch}|{sname}|{mesh_kind}"
                if variant:
                    key += f"|{variant}"
                if key in results and results[key].get("status") == "ok":
                    continue
                if sname == "long_500k" and not cfg.sub_quadratic:
                    results[key] = {
                        "status": "skipped",
                        "reason": "pure full-attention arch — sub-quadratic "
                                  "required for 500k (DESIGN.md §4)",
                    }
                    _save(out_path, results)
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                try:
                    r = lower_cell(cfg, cell, mesh, oc_overrides=oc_overrides,
                                   fsdp_over_pods=fsdp_over_pods)
                    r["status"] = "ok"
                    results[key] = r
                    print(f"[dryrun] {key}: OK "
                          f"(run {r['seconds_to_run']}s, "
                          f"peak {r['per_device']['peak_bytes'] / 2**30:.2f}"
                          f" GiB counted, dominant "
                          f"{r['roofline']['dominant']})", flush=True)
                except Exception as e:  # one cell's failure is its record
                    failures += 1
                    results[key] = {"status": "error", "error": str(e)[:2000],
                                    "traceback": traceback.format_exc()[-4000:]}
                    print(f"[dryrun] {key}: FAIL {e}", flush=True)
                _save(out_path, results)
    return failures


def _save(path: str, results) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1)
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default="experiments/dryrun.json")
    ap.add_argument("--reduced", action="store_true",
                    help="use reduced configs (CI smoke)")
    ap.add_argument("--variant", default="")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--fsdp-pods", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    oc_over = {}
    if args.grad_accum > 1:
        oc_over["grad_accum"] = args.grad_accum
    if args.loss_chunk:
        oc_over["loss_chunk"] = args.loss_chunk
    if args.moment_dtype != "float32":
        oc_over["moment_dtype"] = args.moment_dtype
    failures = run(archs, shapes, meshes, args.out,
                   reduced_for_test=args.reduced,
                   oc_overrides=oc_over or None, variant=args.variant,
                   fsdp_over_pods=args.fsdp_pods,
                   cfg_overrides=({"seq_parallel": True} if args.seq_parallel
                                  else None))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
