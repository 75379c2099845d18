"""Faults planted in the program under the LM decode cell, to show that its
check reads each as not correct:

* ``renormalised_topk``: the top-k probabilities renormalised to sum 1;
* ``no_mscale2``: the softmax scale without YaRN's ``mscale``²;
* ``no_latent_norm``: the latent cached and expanded without its RMSNorm;
* ``fp8_cache``: the latent cache held in fp8 (e4m3): every row written,
  and the resident histories, rounded through it.

Each patches the program only; the reference and the check are left as
they are.  On a card, from the root of a checkout:

    python3 -m bench.tests.plant <fault> --workload deepseek-v2-lite.decode \\
        --seed <n> --seconds <s> --trace 0
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[2]
FAULTS = ("renormalised_topk", "no_mscale2", "no_latent_norm", "fp8_cache")


def _fp8(t):
    import torch

    return t.to(torch.float8_e4m3fn).to(t.dtype)


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` in it, inside."""
    from bench.systems import lm_decode
    from repro_torch.lm import layers

    if fault == "renormalised_topk":
        config = lm_decode.program_config
        patch = mock.patch.object(
            lm_decode, "program_config", lambda c: dataclasses.replace(
                config(c), moe_norm_topk=True))
    elif fault == "no_mscale2":
        patch = mock.patch.object(
            layers.MlaDims, "scale",
            property(lambda d: 1.0 / math.sqrt(d.d_nope + d.d_rope)))
    elif fault == "no_latent_norm":
        patch = mock.patch.object(
            layers, "_latent",
            lambda params, x, dims: x @ params["kv_down"]["w"])
    elif fault == "fp8_cache":
        write, init = layers.DecodeAt.write, lm_decode.Cell.__init__

        def write_fp8(self, cache, rows):
            write(self, cache, _fp8(rows.to(cache.dtype)))

        def init_fp8(self, *args, **kw):
            init(self, *args, **kw)
            for layer in self.cache["layers"]:
                for t in layer.values():
                    t.copy_(_fp8(t))

        patch = contextlib.ExitStack()
        patch.enter_context(mock.patch.object(layers.DecodeAt, "write",
                                              write_fp8))
        patch.enter_context(mock.patch.object(lm_decode.Cell, "__init__",
                                              init_fp8))
    else:
        raise ValueError(f"no fault {fault!r}; known: {FAULTS}")
    with patch:
        yield


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    fault = argv.pop(0)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from bench import run

    with planted(fault):
        return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
