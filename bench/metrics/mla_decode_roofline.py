"""The MLA decode kernel's share of its roofline, in %: the latent cache's
bytes every decode step of the traced window read (the rows the program
counted, ``lm.mla_decode.cache_rows``, summed over layers, times a row's
bytes: each cached byte read once) at the data sheet's bandwidth, over
the device time of the kernel's launches in that window
(``bench.lib.lm_work.MLA_DECODE_KERNELS``)."""
from bench.lib.lm_work import MLA_DECODE_KERNELS


def read(run):
    t = run.traced
    if t is None or "cache_row_bytes" not in run.sizes:
        return None
    rows = t.counters.get("lm.mla_decode.cache_rows", 0)
    seconds = t.trace.seconds_matching(MLA_DECODE_KERNELS)
    if not rows or seconds <= 0:
        return None
    least = rows * run.sizes["cache_row_bytes"] / run.peak["hbm_bytes_per_s"]
    return 100.0 * least / seconds
