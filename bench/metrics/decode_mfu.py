"""Model FLOP utilisation of LM decoding, in %: the model FLOPs of every
step of the measured window (``bench.lib.lm_work.step_flops``: 2 per
active weight per token, plus the absorbed attention over the rows the
program counted, ``lm.mla_decode.cache_rows``) per second of that window,
over the data sheet's dense bf16 peak of the card
(``bench/peak_flops.json``)."""
import json
from pathlib import Path

from bench.lib.lm_work import step_flops

PEAKS = Path(__file__).resolve().parents[1] / "peak_flops.json"


def read(run):
    import torch

    w = run.window
    rows = w.counters.get("lm.mla_decode.cache_rows", 0)
    if (run.traced is None or "step_tokens" not in run.sizes or not rows
            or not torch.cuda.is_available()):
        return None
    peak = json.loads(PEAKS.read_text()).get(torch.cuda.get_device_name(0))
    if peak is None:
        return None
    flops = step_flops(run.spec.config,
                       run.sizes["step_tokens"] * len(w.jobs), rows)
    return 100.0 * flops / w.seconds / peak["bf16_dense_flops_per_s"]
