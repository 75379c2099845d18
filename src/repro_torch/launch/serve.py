"""Batched LM serving entry point: token-by-token prefill + greedy decode.

    python -m repro_torch.launch.serve [--arch yi_9b] [--batch 4]
        [--prompt-len 32] [--max-new 32] [--device cpu]

Port of ``repro.launch.serve``: the ``reduced`` config of ``--arch``, weights
and prompt drawn from seeded ``torch.Generator``s.  Runs on the CUDA card
unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..configs.base import reduced
from ..device import resolve_device
from ..lm import model as model_mod
from ..lm.serve import generate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced(get_config(args.arch), remat=False)
    model = model_mod.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    t0 = time.perf_counter()
    out = generate(model, prompt, max_new=args.max_new)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = args.batch * (args.prompt_len + args.max_new)
    print(f"[serve] arch={cfg.arch_id} batch={args.batch} device={dev} "
          f"generated {tuple(out.shape)} in {dt:.1f}s ({toks/dt:.1f} tok/s)")
    if not (int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size):
        raise RuntimeError("generated ids outside the vocabulary")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
