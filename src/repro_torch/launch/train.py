"""End-to-end training driver: fault-tolerant and resumable.

    python -m repro_torch.launch.train [--arch olmo_1b] [--preset tiny]
        [--steps 50] [--batch 8] [--seq 256] [--ckpt-dir DIR] [--device cpu]

Port of ``repro.launch.train`` with its presets and flags: the ``reduced``
config of ``--arch`` at ``--preset``, weights from a seeded
``torch.Generator``, the Zipf token stream with the DBG vocabulary
reordering (``--no-dbg-vocab`` turns it off; integration K2), float32
compute.  It resumes from the newest valid checkpoint, checkpoints every
``--ckpt-every`` steps and on SIGTERM/SIGINT before it exits, and logs a
step slower than ``--step-deadline-s`` as a straggler.  The data cursor is
the step, so a resumed run replays exactly.  It exits 0 only if the loss
decreased (the mean of the last fifth of the run's steps below the mean of
the first fifth), or when stopped by a signal.  Runs on the CUDA card
unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import tempfile
import time

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import reduced
from ..core.vocab import reorder_vocab
from ..data.pipeline import DataConfig, ZipfPipeline
from ..device import resolve_device
from ..lm import model as model_mod
from ..train import step as step_mod
from . import ckpt as ckpt_mod

PRESETS = {
    # ~100M params: a real (if small) model
    "m100": dict(n_layers=8, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
                 vocab_size=32768, hot_vocab_rows=2048),
    # tiny smoke preset
    "tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
                 vocab_size=2048, hot_vocab_rows=256),
}


def dbg_stream(cfg, batch: int, seq: int, dbg_vocab: bool = True):
    """The driver's token stream at ``cfg``'s vocabulary: the Zipf
    pipeline, remapped by the DBG vocabulary reordering unless
    ``dbg_vocab`` is False, whose hot rows set ``hot_vocab_rows`` (at
    least 128).  Returns (config, pipeline, reordering or None)."""
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch)
    pipe = ZipfPipeline(dc)
    if not dbg_vocab:
        return cfg, pipe, None
    vr = reorder_vocab(pipe.frequencies(), row_multiple=128)
    cfg = dataclasses.replace(cfg, hot_vocab_rows=max(
        128, min(cfg.hot_vocab_rows, vr.hot_rows)))
    return cfg, ZipfPipeline(dc, vocab_map=vr), vr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--step-deadline-s", type=float, default=120.0)
    ap.add_argument("--no-dbg-vocab", action="store_true",
                    help="ablation: disable the DBG vocabulary reordering")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced(get_config(args.arch), **PRESETS[args.preset], remat=False)
    cfg, pipe, vr = dbg_stream(cfg, args.batch, args.seq,
                               not args.no_dbg_vocab)
    print(f"[train] arch={cfg.arch_id} preset={args.preset} "
          f"d={cfg.d_model} L={cfg.n_layers} V={cfg.vocab_size} device={dev}")
    if vr is not None:
        print(f"[train] DBG vocab: hot_rows={cfg.hot_vocab_rows} "
              f"coverage={vr.coverage:.3f}")

    gen = torch.Generator().manual_seed(0)
    model = model_mod.init_params(cfg, seed=0, device=dev)
    opt = step_mod.init_opt(model)
    oc = step_mod.OptConfig(lr=args.lr, warmup=20, total_steps=args.steps,
                            compute_dtype="float32")
    train_step = step_mod.make_train_step(cfg, oc)

    start_step = 0
    restored = ckpt_mod.restore_latest(args.ckpt_dir, model, opt)
    if restored:
        start_step = restored["step"]
        gen.set_state(restored["rng_state"])
        print(f"[train] resumed from step {start_step}")

    stop = {"now": False}

    def handle(sig, frame):  # preemption-safe shutdown
        print(f"[train] signal {sig}: checkpoint + exit")
        stop["now"] = True

    previous = {s: signal.signal(s, handle)
                for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        t_start = time.time()
        losses = []
        for step_i in range(start_step, args.steps):
            t0 = time.time()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.batch(step_i).items()}
            metrics = train_step(model, opt, batch)
            losses.append(float(metrics["loss"]))
            dt = time.time() - t0
            if dt > args.step_deadline_s:
                print(f"[train][straggler] step {step_i} took {dt:.1f}s "
                      f"(deadline {args.step_deadline_s}s)")
            if step_i % 10 == 0 or step_i == args.steps - 1:
                print(f"[train] step {step_i} loss {losses[-1]:.4f} "
                      f"({dt:.2f}s/step)", flush=True)
            if (step_i + 1) % args.ckpt_every == 0 or stop["now"]:
                path = ckpt_mod.save_checkpoint(
                    args.ckpt_dir, step_i + 1, model, opt,
                    data_cursor=step_i + 1, rng_state=gen.get_state())
                print(f"[train] checkpoint -> {path}")
            if stop["now"]:
                return 0
    finally:
        for s, h in previous.items():
            signal.signal(s, h)

    if not losses:
        print("[train] nothing to do: the checkpoint is at the last step")
        return 0
    n = max(1, len(losses) // 5)
    first, last = np.mean(losses[:n]), np.mean(losses[-n:])
    print(f"[train] done in {time.time() - t_start:.0f}s; "
          f"loss {first:.4f} -> {last:.4f} "
          f"({'DECREASED' if last < first else 'NOT decreased'})")
    return 0 if last < first else 1


if __name__ == "__main__":
    raise SystemExit(main())
