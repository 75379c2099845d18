#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the CUDA card of this machine.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cells, their configurations, mixes
and metrics are named in ``BENCHMARK.json`` and found under ``bench/``
(``bench/lib/harness.py``).  The program under test is ``repro_torch``
from ``src/``; nothing here imports JAX or the JAX package ``repro``.
The kernels build into ``build/`` inside the checkout at first use.

Prints the run's result as the last line of standard output, and every
compared number beside its limit as the last lines of standard error.
Exits non-zero, printing no result, without enough CUDA cards, on a card
missing from ``bench/peaks.json``, or if a forbidden module was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read (nvidia-smi failed)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench.lib import harness

    spec = harness.load_spec(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA card(s); this "
              "process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(device)
    peaks = json.loads((ROOT / "bench" / "peaks.json").read_text())
    if name not in peaks:
        print(f"no peak of {name!r} in bench/peaks.json: a roofline needs "
              "the data sheet's peak", file=sys.stderr)
        return 3
    print(f"device: {power_limit()}; peak {peaks[name]['hbm_bytes_per_s']} "
          f"B/s ({peaks[name]['source']})", file=sys.stderr)
    result, compared = harness.run_cell(spec, args.seed, args.seconds,
                                        bool(args.trace), device, T0,
                                        peaks[name])
    return harness.finish(result, compared)


if __name__ == "__main__":
    sys.exit(main())
