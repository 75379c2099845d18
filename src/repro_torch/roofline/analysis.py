"""Hardware roofline profiles for the port's cost model.

Port of ``repro.roofline.analysis``'s ``HW`` and ``HW_PROFILES``: the
profile ``repro_torch.tune.cost`` prices every candidate through.  The
reference's profiles are a TPU v5e and the Pallas interpreter on a host
CPU; neither describes the port's device, so neither is copied.  The port
has one profile, ``"h100"``, whose numbers ``chip_smoke.py``
(``measure_hw``) measured on the card:

  * ``hbm_bw`` — a timed device-to-device copy of 2 GiB (read + write bytes
    over the copy's time);
  * ``peak_flops`` — a timed float32 ``torch.matmul`` of 8192 x 8192 x
    8192 with TF32 off (the float32 pipes outside the tensor cores, the
    type the edge maps compute in);
  * ``dispatch_overhead`` — 0: the reference prices one Pallas grid step
    of the interpreter; the port's kernels launch per group of tile
    classes, not once per grid step, so no configuration of the space
    changes how many launches one pass makes per grid step;
  * ``link_bw`` — infinite: one card prices no collective.  The sharded
    engine (``repro_torch.dist``) runs, but the link rate between cards
    has not been measured: that waits for a machine with four cards.

``model_flops`` and ``roofline_terms`` are the reference's, copied: the
dry run (``repro_torch.launch.dryrun``) prices each cell with them.  With
the ``"h100"`` profile ``link_bw`` is infinite, so ``collective_s`` is 0
and ``roofline_terms`` says so.  The reference's XLA parsers
(``parse_hlo_costs``, ``parse_collective_bytes`` and their helpers) read
XLA's optimized HLO text, which the port never produces, and are not
ported: the dry run's dispatch-mode counters take their role.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

__all__ = ["HW", "HW_PROFILES", "model_flops", "roofline_terms"]


@dataclasses.dataclass(frozen=True)
class HW:
    """A hardware roofline profile (the reference's fields).

    ``HW.profile()`` is ``"h100"``, the one profile (no environment
    variable chooses it until a second one exists).
    ``dispatch_overhead`` is a fixed cost per kernel grid step, charged by
    ``tune.cost.app_seconds`` when it is not 0.
    """

    peak_flops: float   # operations/s of the priced type
    hbm_bw: float       # bytes/s
    link_bw: float      # bytes/s per link
    dispatch_overhead: float = 0.0  # s per kernel grid step
    name: str = ""

    @classmethod
    def profile(cls, name: Optional[str] = None) -> "HW":
        """Look up a named profile; ``None`` is ``"h100"``.  Unknown names
        raise with the known list."""
        if name is None:
            name = "h100"
        try:
            return HW_PROFILES[name]
        except KeyError:
            raise ValueError(
                f"unknown hardware profile {name!r}; known profiles: "
                f"{', '.join(sorted(HW_PROFILES))}") from None


#: name -> profile.  ``h100``: NVIDIA H100 80GB HBM3 at a 700.00 W power
#: limit, measured by ``chip_smoke.measure_hw``: the 2 GiB copy in 1.420 ms
#: (3.0248e12 B/s, 90% of the data sheet's 3.35e12) and the float32 matmul
#: in 21.515 ms (51.104e12 operations/s, 76% of its 67e12); PERF.md, the
#: serving cell.
HW_PROFILES: Dict[str, HW] = {
    "h100": HW(peak_flops=51.104e12, hbm_bw=3.0248e12, link_bw=math.inf,
               dispatch_overhead=0.0, name="h100"),
}


def model_flops(n_active_params: float, tokens: float, kind: str) -> float:
    """6·N·D for a train step; 2·N·D for forward-only (prefill/decode)."""
    return (6.0 if kind == "train" else 2.0) * n_active_params * tokens


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float,
                   hw: Optional[HW] = None) -> Dict[str, object]:
    """The three roofline terms in seconds, the dominant one and the bound
    (the reference's), on ``hw`` (``HW.profile()`` when None).  Where the
    profile's ``link_bw`` is infinite (unmeasured), ``collective_s`` is 0
    and ``collective_note`` says so."""
    hw = HW.profile() if hw is None else hw
    c = flops_per_device / hw.peak_flops
    m = bytes_per_device / hw.hbm_bw
    n = collective_bytes_per_device / hw.link_bw
    dominant = max(("compute", c), ("memory", m), ("collective", n),
                   key=lambda kv: kv[1])[0]
    out: Dict[str, object] = {"compute_s": c, "memory_s": m,
                              "collective_s": n, "dominant": dominant,
                              "bound_s": max(c, m, n)}
    if math.isinf(hw.link_bw):
        out["collective_note"] = (
            f"link_bw of the {hw.name!r} profile is infinite (no link rate "
            "measured): collective_s is 0, not a measurement")
    return out
