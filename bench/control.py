#!/usr/bin/env python3
"""The control of a cell's check: the plain reference, put in the program's
place and computed in bfloat16 (the precision below the float32 the
program states), judged by the cell's own comparison.

    python3 bench/control.py --workload <cell> --seeds 11,12,13

For each seed it makes the cell's inputs, takes the first
``sample_per_app`` jobs of each app from the seed's job stream, and prints
every compared number of the control beside the cell's limit, then one
JSON line with the worst over the seeds.  A limit holds only if the
control fails at least one of the cell's numbers.  The benchmark's own
runs never run this; it needs no program set-up, as the control does not
run the program.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(spec, seeds, device):
    """Worst control number of each compared name over ``seeds``, and the
    per-seed numbers."""
    import torch

    from bench.lib.harness import Spans
    from bench.reference import compare
    from bench.systems.graph_jobs import Problem, worst

    per_seed = {}
    for seed in seeds:
        problem = Problem(spec.config, spec.mix, seed, device,
                          Spans(lambda: None))
        edges = problem.reference_edges()
        k = int(spec.check["sample_per_app"])
        need = {e["app"]: k for e in spec.mix["jobs"]}
        found = {}
        stream = problem.jobs()
        while any(need.values()):
            app, p = next(stream)
            if need[app] == 0:
                continue
            need[app] -= 1
            want = compare.run(app, edges, p, torch.float64)
            got = compare.run(app, edges, p, torch.bfloat16)
            worst(found, compare.numbers(app, got, want))
        per_seed[seed] = found
    total = {}
    for found in per_seed.values():
        worst(total, found)
    return total, per_seed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, three or more")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench.lib import harness

    if not torch.cuda.is_available():
        print("the control runs on the CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec(ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    total, per_seed = readings(spec, seeds, torch.device("cuda", 0))
    limits = spec.check["limits"]
    for seed, found in per_seed.items():
        for k, v in sorted(found.items()):
            print(f"control seed {seed} {k}: {v!r} limit {limits.get(k)!r}",
                  file=sys.stderr)
    fails = sorted(k for k, v in total.items() if not v <= limits[k])
    print(json.dumps({"workload": args.workload, "seeds": seeds,
                      "control": total, "limits": limits,
                      "control_fails": fails,
                      "seconds": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
