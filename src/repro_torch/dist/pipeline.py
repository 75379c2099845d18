"""GPipe-style pipeline parallelism over S ranks.

Port of ``repro.dist.pipeline``: S stages over M microbatches in
M + S - 1 ticks, the reference's fill / steady / drain schedule with its
(S - 1) bubble ticks.  Each rank of ``group`` holds its own stage's
parameters (the reference shards a stacked stage dim over its ``pipe``
axis); activations hop to the next rank with ``dist.batch_isend_irecv``
(the reference's ring ``ppermute``).  Rank 0 feeds a fresh microbatch each
tick, the last rank collects finished ones, and an all-reduce (the
reference's ``psum``) returns the result on every rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["pipeline_apply"]


def pipeline_apply(stage_fn, params, microbatches: torch.Tensor, group=None
                   ) -> torch.Tensor:
    """Apply the S = ``group`` size stages to M microbatches.

    ``stage_fn(stage_params, h) -> h``: one stage, ``h`` of the
    microbatch's shape; ``params``: this rank's stage parameters (any
    object ``stage_fn`` takes); ``microbatches``: (M, *mb_shape), the same
    on every rank.  Returns (M, *mb_shape) on every rank: identical to
    applying the stages in rank order to each microbatch."""
    n_stages = dist.get_world_size(group)
    i = dist.get_rank(group)
    n_micro = int(microbatches.shape[0])
    nxt = dist.get_global_rank(group, (i + 1) % n_stages) if group else (
        (i + 1) % n_stages)
    prv = dist.get_global_rank(group, (i - 1) % n_stages) if group else (
        (i - 1) % n_stages)
    h_prev = torch.zeros_like(microbatches[0])
    out = torch.zeros_like(microbatches)
    for t in range(n_micro + n_stages - 1):
        h_in = microbatches[min(t, n_micro - 1)] if i == 0 else h_prev
        y = stage_fn(params, h_in)
        # the microbatch fed at tick f leaves the last stage at tick
        # f + S - 1, so tick t drains microbatch t - (S - 1)
        mb = t - (n_stages - 1)
        if i == n_stages - 1 and 0 <= mb < n_micro:
            out[mb] = y
        if n_stages > 1:
            h_next = torch.empty_like(y)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, h_next, prv, group)])
            for r in reqs:
                r.wait()
            h_prev = h_next
    # only the last rank filled its buffer; the sum replicates it
    dist.all_reduce(out, group=group)
    return out
