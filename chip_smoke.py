#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA card and the CUDA
toolkit (``nvcc``): the kernels are built from ``src/repro_torch`` at first
use.  It imports nothing of JAX and nothing of the JAX package ``repro``.

Phases (any failure raises, and the script exits non-zero):
  1. device: the card's name and power limit from ``nvidia-smi``;
  2. build: compile (or load) the libraries of all five TPU kernels' ports
     — K5, K4, K1, hist_bin (with the stable-rank kernel in its source) and
     K2 — the two ``NARROW_BUILDS`` of K5's sum and hist_bin's
     ``HIST_BIN_BUILDS``, with every ``nvcc`` started together;
  3. K5 vs its plain version on the card, over every static variant, on all
     rows of every tile class of the ``kr`` registry graph at ``small`` scale
     (uint16 ids) and of the main-path graph (int32 ids), a class wider
     than 1,024 lanes through its segment list: min/max bitwise, sums within
     2e-6 · (1 + max|y|), and every sum on the hub class bitwise equal over
     two calls;
  4. the main path: a ``kr``-signature RMAT graph (a=.57, b=.19, c=.19,
     average degree 20) at 2^21 vertices, reordered with DBG on out-degree,
     then PageRank (original and DBG orderings), PageRank-delta, SSSP, BC and
     Radii on ``backend="ell"``, each held to the ``flat`` oracle on the same
     card; K5's launch count must grow in every app; then each app's warm
     median (``warm_median``: one warm-up run, then the median, min and max
     of ``EVAL_REPS`` runs on the host clock, synced at each end) on ``ell``
     and ``flat``;
  5. times at the main path's PageRank pull: K5, its plain version, one
     library call (cuSPARSE SpMV through ``torch.sparse``) and the bound;
     K5 per tile class (device time alone, the host's issue time hidden
     behind a device sleep) with its lanes per row and its launches (two for a
     class wider than 1,024 lanes: pieces, then the fold; the hub class
     named); on the hub class the split against a block per whole row, and
     on each narrower class the kept narrow kernel against two builds of
     K5's sum that batch every thread's loads and none (``NARROW_BUILDS``),
     the three bitwise equal;
  6. the packed path on the same graphs: ``backend="packed"`` (hot slot
     tables + decoded cold tiles; the weighted graph packed in a worker
     beside the flat oracles and the unweighted pack, nothing timed until
     both are done) for the five apps against ``flat``,
     ``pack_spmv`` (K4) and ``dbg_spmv`` (K1) against the flat pull and the
     CSR oracle, and ``dbg_bin`` (hist_bin, then the stable-rank kernel)
     against the host DBG mapping, bitwise; every kernel's launch count,
     read from zero, must be positive; the apps' warm medians on
     ``packed``;
  7. K4, K1 and hist_bin vs their plain versions on the card at the packed
     path's shapes: K4 on every hot table of the main-path graph (uint32
     ids), of ``kr``/small (uint16) and of a 256-vertex graph (uint8), each
     unweighted and weighted, as ``pack_spmv`` calls it (``max_deg`` and
     the segment list); a split table also twice and through the list the
     wrapper builds, bitwise; K1 on every DBG group, walking the degrees
     and every lane, each against the plain version and the two bitwise
     against each other; hist_bin on the out-degrees, also with bounds that
     do not end in 0; ``dbg_bin`` against the plain path (``hist_bin_ref``,
     then ``stable_mapping_ref``) bitwise, and the stable mapping from the
     plain groups alone, at V of 0, 1, a tile and a tile ± 1, 3 tiles + 5,
     2^21 and 2^21 + 5, K of 1, 7, 8 and 32, every vertex in one group;
  8. times of K4, K1, hist_bin and the stable rank at their packed-path
     calls, beside their plain versions, one library call each and their
     bounds (K1 both ways, per DBG group, with the bound over the real
     lanes and over the padded planes), each from an idle device and on the
     device alone; K4 per hot table too, with its lane group, pieces and
     launches (2 for a split table, else 1); the whole ``dbg_bin`` both
     ways beside its bound, its plain path and a library path
     (``searchsorted``, a stable ``argsort`` inverted with ``scatter_``),
     and its launches (one of each kernel); hist_bin also as its two-op
     comparison build (``HIST_BIN_BUILDS``: a memset, then atomics), checked
     bitwise;
  9. the paper's evaluation on the phase-4 graph (nothing regenerated): the
     orderings of ``EVAL_ORDERINGS`` (the paper's five techniques, the
     original order and ``random_vertex``), each built once as ``ell``
     (``original`` and ``dbg`` reuse phase 4's backends), with its host
     reorder seconds (each reorder runs one ordering ahead in a worker,
     beside the previous ordering's host work, and is waited for before
     anything is timed) and one pull on the device alone over a (V,) vector
     and over a (V, 8) plane (64 MiB at 2^21, past the L2); the five apps
     on the same problem (the main path's root and Radii sources mapped
     through each ordering, SSSP on phase 4's weighted graph
     relabelled), held after mapping back to the
     original order's results (PageRank in phase 4's band, SSSP and Radii
     bitwise, BC's levels bitwise and centrality within 1e-5); each app's
     warm median; one run with ``obs.counters`` installed, bitwise equal,
     whose K5 launches must equal its passes times K5's launches per pass
     (read from the tiles), with its passes, edges, modeled bytes and
     modeled GB/s; PageRank-delta and BC also timed with the counters
     installed; the cache model's L1/L2/L3 MPKA and AMAT of each
     ordering's pull trace (``cachesim``, ``DEFAULT_TRACE_LEN``
     accesses); Tables I-IV (``core.stats``) once; and one PageRank run
     traced (``EVAL_TRACED``'s build and the run), saved, loaded back
     through ``load_trace``, with one ``engine.build_backend`` span and an
     ``edge_map`` counter event per pass; it prints a ``paper_eval`` JSON
     line;
 10. the streaming plane on phase 4's weighted DBG graph (nothing
     regenerated; phase 4's backends freed): a ``StreamService``
     (``STREAM_CONFIG``: the fused PageRank push, DBG regrouped every
     batch, a compaction threshold that only the final batch crosses) whose
     ``_on_apply`` hook also feeds an unfused ``IncrementalPageRank`` and a
     fused ``IncrementalSSSP`` from the main path's root, beside the
     service's own unfused SSSP; the reference churn benchmark's traffic
     (``ChurnStream``: 75% inserts drawn by degree + 1, weights in [1, 16),
     deletions uniform over the alive edges), ``STREAM_BATCHES`` batches of
     each of ``STREAM_SIZES`` edges, then one batch of
     ``STREAM_INSERT_ONLY`` inserts alone, whose SSSP refreshes must relax
     from the new edges without a full recompute.  After every batch:
     fused SSSP bitwise equal to the unfused, fused PageRank within 1e-8 of
     the unfused (at 2^21 vertices; held in units of 1/V), and K5's
     launches in each fused refresh equal to its passes x the launches per
     pass over the tiles it rode (the base classes with their alive
     planes, and the ``coo_tiles`` delta tile); after the first series and
     after the insert-only batch the fused PageRank within 1e-5 of
     ``apps.pagerank`` on ``flat`` of the snapshot, and after the last the
     fused SSSP bitwise equal to ``apps.sssp``.  Per batch it prints the
     deployment's ingest (less the comparison consumers' folds, printed
     apart), apply, folds, regroup, tile (alive refresh, ``coo_tiles``) and
     refresh seconds and iterations, per series their median [min-max];
     the cold solves, the ``DeltaGraph``, the compaction and the resync;
     one fused and one unfused push on the device alone (each twice
     bitwise, against each other in the sum band) beside the fused push's
     bound over the real lanes; one ``locality()``; the phase's peak
     device memory; and a ``stream`` JSON line;
 11. the serving plane on phase 4's weighted DBG graph (nothing
     regenerated): the card's copy and float32 matmul rates beside the
     port's ``"h100"`` roofline profile (``measure_hw``); the reference's
     tuning workflow on the card (``tune.search.sweep`` of PageRank and
     SSSP on the registry's ``kr`` at ``TUNE_SCALE``, SSSP's switch point
     refined, every chosen backend held to ``flat``), then a lighter sweep
     on the served graph itself (at ``TUNE_SCALE`` the card's sweep picks
     ``flat``, which is 4x slower at 2^21), and the plan of both families
     set active;
     ``GraphServeService(backend="auto", incremental_publish=True)``
     answering ``SERVE_QUERIES`` queries at each width of ``SERVE_WIDTHS``
     on version 0 (bursts of K SSSP roots, then K one-hot PageRank roots; a
     warm run, then a timed one) through the plan's backends, one K5 pass
     per iteration over the (V, K) plane: QPS, latency p50/p99, occupancy,
     seconds per batch and per ``engine.solve.*`` span, iterations and K5
     launches per width; every SSSP lane bitwise equal to ``apps.sssp`` on
     the same backend with the same iterations, every PageRank lane within
     phase 4's band of its K = 1 twin, one uniform lane within it of
     ``apps.pagerank``; then ``SERVE_CHURN_BURSTS`` bursts of a
     ``SERVE_CHURN_EDGES``-edge ``ChurnStream`` batch (O(delta) publishes,
     queries on the stream backend) + 8 queries, every version pinned, the
     first and last churned versions forced and re-solved on ``flat`` (SSSP
     bitwise, PageRank in the band), ingest and publish seconds, QPS and
     ``health()``; then K5 over a (V, 8) plane (``time_plane``) from an
     idle device and on the device alone, beside 8 pulls of one column,
     cuSPARSE SpMM and the bound, and one ``batched_sssp`` push step at
     K = 8; it prints a ``serve`` JSON line;
 12. the sharded engine (``repro_torch.dist``) on a one-rank NCCL group
     over phase 4's weighted DBG graph: ``pagerank_dist`` on ``ell`` /
     ``replicate_hot`` (its layout built on the host, its shard uploaded)
     against phase 4's single-device ``ell`` PageRank (within 1.1e-7, and
     in phase 4's band), its layout's pull and push (sum/min/max, weights
     on and off) against the single-device engine (min/max bitwise, sums
     in the band), ``sssp_sharded_stream`` bitwise against ``apps.sssp``,
     and a ``ShardedStreamService`` on the registry's ``kr`` at
     ``DIST_STREAM_SCALE`` beside the single-device service over
     ``DIST_STREAM_BATCHES`` ``ChurnStream`` batches (seed 3) of
     ``DIST_STREAM_EDGES`` edges (SSSP bitwise from three roots per batch,
     PageRank within 2e-8 of a full single-device solve of the snapshot
     and 1e-5 of the service's incremental one, the regroups routed through
     ``apply_remaps_to``); K5's launches on the path, counted from zero over
     the sharded calls alone, must be positive; then K5 over every shard's
     pull and push tiles of the ``DIST_K5_SHARDS``-shard layout (each table
     built from the global vector, as the exchange delivers it) against its
     plain version, hub-class sums twice bitwise; per-shard edges, halo and
     hot sizes of both policies at ``DIST_SHARDS`` with ``shard_graph``'s
     host seconds (those layouts are built in a thread beside phases 3-11);
     the sharded pull from an idle device and on the device alone beside
     the single-device pull, and the sharded PageRank's warm median beside
     the single-device one; it prints a ``dist`` JSON line;
 13. (the graph state freed) K2 vs its plain version on the card, bitwise:
     ``hot_gather`` and the split gather, float32 and bfloat16, at reduced
     widths, at Yi-9B's (H 8192, C 57,344, D 4096) on 8,192 DBG-remapped
     Zipf ids, and at a T that is not a multiple of 32; all-hot and
     all-cold batches, int64 and strided ids too;
 14. the LM serving path at reduced size, card against CPU, every block
     kind (``LM_PARITY``): reduced Yi-9B (GQA), OLMo-1B, DeepSeek-V2-Lite
     (MLA + MoE), Grok-1 (MoE), RecurrentGemma-9B (RG-LRU + local
     attention, window 8: the ring wraps), Mamba2-780M (SSD), PaliGemma-3B
     (the VLM prefix) and SeamlessM4T (the enc-dec stub), same weights,
     ``generate`` (batch 2, prompt 8, 8 new): logits of every step within
     rtol 1e-4, atol 1e-5, tokens equal, the MoE's expert choices equal at
     every call; ``forward`` over 16 tokens with the family's ``prefix`` or
     ``frames`` in the same band;
 15. the LM serving path at full width: Yi-9B (48 layers, d_model 4096,
     float32, random weights from a seeded generator on the card) serves 4
     requests of 32 Zipf prompt tokens (DBG vocabulary) + 32 greedy tokens;
     K2 must launch once per ``decode_step`` (64), every token lies in the
     vocabulary, the last logits are finite, and the split gather of the
     served ids equals its plain version bitwise;
 16. K2's times at the decode call (T = 4) and at T = 8,192 Zipf ids, beside
     the plain version, ``F.embedding`` over the joined table and the
     bound, from an idle device and on the device alone; the wrapper's host
     time per call; and, under ``torch.profiler``, the device operations
     of one ``embed_lookup`` at a prefill and at a decode step (1 each) and
     of one hist_bin (1) and one dbg_bin call (2) at phase 8's call, read
     together here: in runs that first profiled in phase 8, phase 16's
     profile of the prefill lookup held no device event;
 17. the full-sequence forward at full width: Yi-9B's ``forward`` over
     phase 15's served (4, 64) tokens, every position within the
     reference's decode band (rtol 2e-2, atol 2e-4) of ``generate``'s step
     logits, ``last_only`` within rtol 1e-4, atol 1e-5 of the full call's
     last position, one K2 launch per call, its time from an idle device;
 18. (Yi-9B freed) training: OLMo-1B at its published config (16 layers,
     d_model 2048, vocabulary 50,304, non-parametric LayerNorm, remat) from
     seeded weights on ``launch.train``'s DBG-reordered Zipf stream, B = 4,
     S = 2,048, bf16 compute on float32 masters: one warm-up and
     ``TRAIN_TIMED`` timed steps (ms per step, tokens/s, TFLOP/s by the
     formula printed, peak memory, the embedding backward's ms); checks:
     loss and grad norm finite, every parameter changed by step 1, the
     master gradients of ``embed.hot``/``embed.cold`` nonzero on exactly
     the rows the ids read, K2 launches = forward passes, the embedding
     backward twice bitwise and within 1e-6 relative of the CPU's; the
     step split into gradients and update (CUDA events) and one step's
     kernels by class under ``torch.profiler`` (busy and idle share); then
     reduced Yi-9B (GQA) and OLMo-1B, card against CPU: 3 float32 steps
     (loss, grad norm 1e-5 relative; parameters ``PARITY_PARAM_ATOL``) and
     the forward at S = 1,024 in phase 14's band; then the driver
     (``launch.train.main``, ``DRIVER_ARGS``) for ``DRIVER_STEPS`` steps
     straight, and preempted halfway by a SIGTERM and resumed, checkpoints
     under ``build/``: final parameters and optimizer state bitwise equal, the
     straight run's return code 0 (the loss decreased); a ``train`` JSON
     line;
 19. (OLMo-1B freed) the remaining block kinds at full width and depth,
     float32, seeded weights drawn on the card, one model at a time
     (``BLOCK_ARCHS``): DeepSeek-V2-Lite-16B (27 layers of MLA + MoE, 64
     experts top-6 + 2 shared), RecurrentGemma-9B (38 layers, RG-LRU and
     local attention) and Mamba2-780M (48 SSD layers); each one's bytes
     predicted before it is allocated, then served as phase 15 serves
     Yi-9B (4 requests of 32 Zipf prompt tokens + 32 greedy tokens, K2
     once per decode step, tokens in the vocabulary, the last logits
     finite); ``forward(last_only=True)`` over the served tokens against
     the last decode step in the reference's decode band (DeepSeek at
     capacity factor ``BLOCK_CF_CHECK``, where neither drops a slot;
     Mamba2's forward, last decode step and their gap each within
     ``FORWARD_REL_L2`` of a float64 forward), and the slots the published
     capacity factor drops in that forward; ms per decode step, one step
     under ``torch.profiler`` (busy time, launches), peak memory; every
     call through the model's entry points (the warm-up, the served
     steps, the forwards, the profiled steps) counted from zero for every
     kernel, K2 as expected and no graph kernel; an ``lm_blocks`` JSON
     line;
 20. the sharded LM (A12.7): phase 18's model, weights and batches, one
     warm-up and ``SHARDED_STEPS`` steps unsharded (its end state kept on
     the host), then the same through ``dist.sharding.shard_model`` on a
     one-rank NCCL ``DeviceMesh`` (1, 1) (``launch.mesh.make_host_mesh``),
     the batches ``Shard(0)`` on ``data``, under ``activation_sharding``:
     loss, grad norm and every parameter within ``PARITY_PARAM_ATOL`` of
     the unsharded step, every parameter a DTensor; K2 once per step
     (counted from zero around each step), no graph kernel; ms per step
     beside the unsharded one and phase 18's.  One card holds every axis
     at size 1: this checks DTensor, NCCL and K2 inside the step, not the
     exchange between cards; an ``lm_sharded`` JSON line;
 21. the new block kinds trained (A12.8): ``TRAIN_BLOCK_ARCHS`` at their
     published widths, Mamba2-780M at its 48 layers, DeepSeek-V2-Lite-16B
     and RecurrentGemma-9B cut to the depth whose float32 masters,
     gradients and two Adam moments (16 bytes a parameter) fit in
     ``TRAIN_BLOCKS_GIB`` beside an activation allowance (``_train_depth``,
     counted on ``meta``); one warm-up and ``TRAIN_BLOCK_STEPS`` steps each
     on phase 18's stream settings, bf16 compute on float32 masters at
     ``TRAIN_BLOCKS_LR``, the loss over chunks of
     ``TRAIN_BLOCKS_LOSS_CHUNK`` positions; checks: loss and grad norm
     finite, grad norm > 0, every parameter changed by step 1 (float64
     sums), the first batch's loss lower after the steps than at step 1,
     K2 once per forward pass, no graph kernel; ms per step, tokens/s,
     peak memory; an ``lm_train_blocks`` JSON line;
 22. the MLA decode kernel (``kernels.mla_decode``) at the
     ``deepseek-v2-lite.decode`` cell's shapes: 32 sequences of lengths
     drawn on the card in [4,096, 32,768], a bf16 cache against the plain
     path within ``MLA_REL_L2`` relative L2, the float32 variant within
     ``MLA_F32_REL_L2``, one DeepSeek-V2-Lite layer's ``mla_decode``
     launching it once (counted from zero just before); its times beside
     one ``scaled_dot_product_attention`` call of the same function and
     the bound (the rows read once); an ``mla_decode`` JSON line.

It prints the ``kernels`` JSON line (a kernel's time is ``ms`` from an idle
device and ``device_ms`` on the device alone, its library call's
``library_ms`` and ``library_device_ms``, its worst error against the plain
version ``max_abs_err``, the TPU kernel it replaces ``replaces``, its
launches on each path ``launches_by_path``, ``stream``, ``serve`` and
``dist`` among them; K5's ``dist`` times the sharded pull beside the
single-device one; K5's ``stream_push`` times one push over the stream's tiles, its
``bound_ms`` over the real lanes and ``padded_bound_ms`` over the planes,
and its ``serve_plane`` one pull over the serving graph's (V, 8) plane
beside 8 one-column pulls, cuSPARSE SpMM and the bound, with one
``batched_sssp`` push step at K = 8; K1's ``ms`` and
``bound_ms`` are
its degree walk's, ``padded_ms`` and ``padded_bound_ms`` its every-lane
path's; K2's ``launches_by_path`` has ``lm_forward``, ``lm_train`` and
``lm_blocks`` (the full-width forward, the timed training steps, and every
call of phase 19; every kernel's ``lm_blocks`` is counted), ``lm_sharded``
and ``lm_train_blocks`` (phases 20 and 21, every kernel counted) and its ``lm_train`` the
plain backward's ms per step; hist_bin's ``dbg_bin_*`` keys time its caller, the device DBG,
``device_ops_per_call`` counts its device operations, and ``two_ops_ms`` and
``two_ops_device_ms`` time its two-op comparison build; ``stable_rank``
replaces no TPU kernel, and its ``replaces`` names the reference's XLA
stable mapping; nor does ``latent_attention``, the MLA decode, whose
``replaces`` names the reference's ``mla_decode`` and whose home path
``lm_mla`` is phase 22's layer call) and, as its last line,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import shutil
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
LOG2_VERTICES = 21         # main-path graph: 2,097,152 vertices
REPS = 20                  # timed calls per measurement (median)
PLAIN_CHUNK_LANES = 1 << 24  # rows per plain-version call, in lanes
SLEEP_CYCLES = 2_000_000   # ~1 ms of device sleep ahead of a device-only time
# K5's sum built with the narrow kernel's batch threshold forced (phase 5)
NARROW_BUILDS = {"batched": ["-DK5_REDUCE=0", "-DK5_BATCH_ABOVE=0"],
                 "unbatched": ["-DK5_REDUCE=0", "-DK5_BATCH_ABOVE=32"]}
# hist_bin with its histogram from a memset and K atomics per block, not
# the last block's fold (phase 8)
HIST_BIN_BUILDS = {"two_ops": ["-DHIST_BIN_TWO_OPS=1"]}
LM_ARCH = "yi_9b"          # the LM serving path's model, at full width
# the LM paths' own kernels: K2 and the MLA decode (any other is a graph
# kernel, which no LM path launches)
LM_KERNELS = ("hot_gather", "latent_attention")
# phase 22: the MLA decode kernel at the deepseek-v2-lite.decode cell's
# shapes: 32 sequences, lengths drawn log-uniformly in [4,096, 32,768], a
# room of 32,768 + 1,024 rows; the bf16 kernel's band against the plain path
# in float32 (relative L2 over the whole output; measured ~2e-3: the
# probabilities and the output rounded to bf16), the float32 variant's
MLA_BATCH, MLA_HISTORY, MLA_ROOM = 32, (4096, 32768), 32768 + 1024
MLA_REL_L2, MLA_F32_REL_L2 = 5e-3, 1e-5
LM_BATCH, LM_PROMPT, LM_NEW = 4, 32, 32  # requests, prompt and new tokens
K2_ZIPF_T = 8192           # Zipf ids of K2's large check and timing
# phase 14: every block kind at reduced size, card against CPU
# (RecurrentGemma's window 8: its ring of 8 slots wraps over 16 positions)
LM_PARITY = (("yi_9b", dict(n_kv_heads=2)), ("olmo_1b", {}),
             ("deepseek_v2_lite_16b", {}), ("grok_1_314b", {}),
             ("recurrentgemma_9b", dict(window=8)), ("mamba2_780m", {}),
             ("paligemma_3b", {}), ("seamless_m4t_large_v2", {}))
# phase 19: the remaining block kinds at full width and depth, float32:
# MLA + MoE (64 experts, top-6, 2 shared), RG-LRU + local attention, SSD
BLOCK_ARCHS = ("deepseek_v2_lite_16b", "recurrentgemma_9b", "mamba2_780m")
BLOCK_CF_CHECK = 8.0  # the MoE forward held to decode drops no slot here
# forward(last_only) against the last decode step: the reference's decode
# band (rtol 2e-2, atol 2e-4) elementwise.  Mamba2's 48 SSD layers amplify
# float32 rounding past it: at 48 layers of reduced width the reference's
# own forward and decode miss it 1.65x at the last position, 6.6x over all
# 64 (tests/test_torch_lm_recurrent.py::test_mamba2_at_depth_drifts_as_the_
# reference_does).  There the forward, the last decode step and the gap
# between them are each held to FORWARD_REL_L2 (relative L2) of a float64
# forward of the same weights, which this phase runs each time: float32
# rounding sits ~1e-3 from it at full width, a wrong layer O(1)
# (ROADMAP C; PERF.md §6).
FORWARD_REL_L2 = {"mamba2_780m": 5e-3}
# phase 17: the full-sequence forward over phase 15's served tokens
FORWARD_REPS = 5
# phase 18: OLMo-1B trained at its published widths on the Zipf stream
TRAIN_ARCH = "olmo_1b"
TRAIN_BATCH, TRAIN_SEQ = 4, 2048   # 8,192 tokens per step
TRAIN_TIMED = 5                    # timed steps, after one warm-up step
TRAIN_OPT = dict(lr=3e-4, warmup=2, total_steps=6, compute_dtype="bfloat16")
TRAIN_PARITY_STEPS = 3             # reduced models, card against CPU
# their parameters after 3 steps at lr 1e-3: 2.9e-5 apart at most, every
# element (the logits differ by up to ~5e-5 relative between cuBLAS and the
# CPU, and Adam divides by √v); PERF.md §6
PARITY_PARAM_ATOL = 1e-4
# the driver (launch.train) straight, then preempted halfway by a SIGTERM
# and resumed
DRIVER_ARGS = ["--preset", "m100", "--batch", "8", "--seq", "256"]
DRIVER_STEPS = 60                  # 100 until phases 20 and 21
# phase 20: phase 18's model through shard_model on a one-rank NCCL mesh
SHARDED_STEPS = 3                  # after one warm-up step
# phase 21: the new block kinds trained at published widths: Mamba2 at its
# depth, DeepSeek-V2-Lite and RecurrentGemma cut to what fits (_train_depth)
TRAIN_BLOCK_ARCHS = ("mamba2_780m", "deepseek_v2_lite_16b",
                     "recurrentgemma_9b")
TRAIN_BLOCK_STEPS = 3              # after one warm-up step
TRAIN_BLOCKS_GIB = 70              # masters, gradients, moments, activations
TRAIN_BLOCKS_SLACK_GIB = 6         # activations besides the logits
# the loss over chunks of positions: over RecurrentGemma's 256,000-row
# unembedding, 8,192 tokens' logits in bfloat16 and float32 and their
# gradients come to ~25 GB at once (12 bytes a logit, by arithmetic)
TRAIN_BLOCKS_LOSS_CHUNK = 512
# Adam's first steps move every weight by ~lr; at this rate each model's
# first batch scores lower after the steps (ROADMAP C)
TRAIN_BLOCKS_LR = 3e-5
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 (tensor cores)
EVAL_REPS = 5              # timed warm runs per app (median), after one warm-up
# the paper's orderings (Fig. 3: random_vertex destroys structure), phase 9
EVAL_ORDERINGS = ("original", "sort", "hubsort", "hubcluster", "dbg",
                  "gorder_lite", "random_vertex")
EVAL_TRACED = "sort"       # phase 9 traces this ordering's build and a PageRank
# phase 10: the reference churn benchmark's traffic (benchmarks/stream_churn.py)
# with its 256-edge series left out: on the H100's host that series took
# ~60 s of a phase that ran 448 s (PERF.md, the stream cell), and the script
# must stay inside its time limit; for the same reason each series runs
# STREAM_BATCHES batches, not the 10 the phase began with (phases 11 to 21
# came after it; 3 until phases 20 and 21)
STREAM_SIZES = (1024, 4096)       # edges per batch, one series each
STREAM_BATCHES = 2                # batches per series, all on one service
STREAM_INSERT_FRAC = 0.75
# the incremental_dbg policy (regroup every batch) with the fused PageRank
# push; the threshold puts exactly the final batch over it: 6,144 edges of
# churn before it, 10,240 with it, against 0.0002 x 41,943,040 = 8,388.6
STREAM_CONFIG = dict(pr_fused_push=True, regroup_every=1,
                     compact_threshold=0.0002)
# then one batch of inserts alone: the incremental SSSP relaxation
STREAM_INSERT_ONLY = 4096
# phase 11: the serving plane (the reference's serve_qps workload on
# benchmarks/serve_qps.py's settings, its churn apart), tuned on the card
TUNE_SCALE = "large"               # the registry kr the tuner sweeps
SERVE_WIDTHS = (1, 2, 4, 8)        # K: lanes per batch
SERVE_QUERIES = 96                 # queries per width (K = 8: 12 batches)
SERVE_CHURN_BURSTS = 5             # then churn: bursts of ingest + queries
SERVE_CHURN_EDGES = 1024           # edges per churn batch
HW_COPY_BYTES = 2 << 30            # the timed copy behind the H100 profile
# phase 12: the sharded engine on one NCCL rank
DIST_SHARDS = (2, 4, 8)            # per-shard halo and hot sizes, both policies
DIST_K5_SHARDS = 4                 # K5 vs plain over every shard's tiles
DIST_STREAM_SCALE = "large"        # the sharded stream's kr (200,000 vertices)
DIST_STREAM_BATCHES = 4            # ChurnStream batches (seed 3)
DIST_STREAM_EDGES = 1024           # edges per batch
DIST_PR_ATOL = 1.1e-7              # sharded PageRank vs the single-device one
# the sharded stream's full solve (L-inf tol 1e-9) against a full
# single-device solve of the service's snapshot; against the service's
# incremental PageRank, phase 10's band of incremental vs full (1e-5)
STREAM_PR_ATOL = 2e-8
STREAM_SERVICE_ATOL = 1e-5
HW_MATMUL_N = 8192                 # the timed float32 matmul, n^3
STREAM_KEYS = ("ingest_s", "edges_per_s", "apply_s", "folds_s", "regroup_s",
               "moved", "extra_folds_s", "ingest_total_s", "tiles_s",
               "alive_s", "coo_s", "pr_fused_s", "pr_fused_iters",
               "pr_flat_s", "pr_flat_iters", "sssp_fused_s", "sssp_flat_s",
               "sssp_iters", "pr_gap", "pr_gap_v")


def log(msg: str) -> None:
    print(msg, flush=True)


def _sync():
    import torch

    torch.cuda.synchronize()


def _ell_launches():
    from repro_torch.kernels.edge_map import ell_edge_map

    return ell_edge_map.launches


def _wrappers():
    """Kernel name → (wrapper, source, TPU kernel it replaces)."""
    from repro_torch.kernels.csr_spmv import ell_spmv
    from repro_torch.kernels.edge_map import ell_edge_map
    from repro_torch.kernels.gather_embed import hot_gather
    from repro_torch.kernels.hist_bin import hist_bin, stable_rank
    from repro_torch.kernels.mla_decode import latent_attention
    from repro_torch.kernels.pack_spmv import hot_spmv

    k = "src/repro_torch/kernels"
    return {
        "ell_edge_map": (ell_edge_map, f"{k}/edge_map/csrc/edge_map.cu",
                         "src/repro/kernels/edge_map/edge_map.py:159"),
        "hot_spmv": (hot_spmv, f"{k}/pack_spmv/csrc/pack_spmv.cu",
                     "src/repro/kernels/pack_spmv/pack_spmv.py:58"),
        "ell_spmv": (ell_spmv, f"{k}/csr_spmv/csrc/csr_spmv.cu",
                     "src/repro/kernels/csr_spmv/csr_spmv.py:47"),
        "hist_bin": (hist_bin, f"{k}/hist_bin/csrc/hist_bin.cu",
                     "src/repro/kernels/hist_bin/hist_bin.py:49"),
        # no TPU kernel: the XLA stable mapping beside hist_bin_pallas
        "stable_rank": (stable_rank, f"{k}/hist_bin/csrc/hist_bin.cu",
                        "src/repro/kernels/hist_bin/ops.py:30"),
        "hot_gather": (hot_gather, f"{k}/gather_embed/csrc/gather_embed.cu",
                       "src/repro/kernels/gather_embed/gather_embed.py:36"),
        # no TPU kernel: the reference re-expands the latent cache in XLA
        "latent_attention": (latent_attention,
                             f"{k}/mla_decode/csrc/mla_decode.cu",
                             "src/repro/lm/layers.py:395"),
    }


def _reset_launches():
    for fn, _, _ in _wrappers().values():
        fn.launches = 0


def _read_launches():
    return {name: fn.launches for name, (fn, _, _) in _wrappers().items()}


def _launched(acc, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` and the launches it made by kernel, each also
    added into ``acc``: a path's count over its own calls only, where
    checks between them launch the same kernels."""
    c0 = _read_launches()
    out = fn(*args, **kwargs)
    made = {n: c - c0[n] for n, c in _read_launches().items()}
    for n, c in made.items():
        acc[n] = acc.get(n, 0) + c
    return out, made


def _chunked(fn, rows, width, *planes):
    """``fn(*row_chunks)`` over row chunks of at most ``PLAIN_CHUNK_LANES``
    lanes, concatenated: a plain version's (R, W) intermediates stay small
    on the hub tables."""
    import torch

    step = max(1, PLAIN_CHUNK_LANES // max(1, width))
    return torch.cat([fn(*(None if p is None else p[a:a + step]
                           for p in planes))
                      for a in range(0, rows, step)])


# ---------------------------------------------------------------- phase 3
def _assert_close(got, want, reduce, what):
    import torch

    if reduce in ("min", "max"):
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{what}: {bad} lanes differ (must be bitwise)")
        return 0.0
    fin = torch.isfinite(want)
    scale = 1.0 + float(want[fin].abs().max()) if bool(fin.any()) else 1.0
    err = float((got - want).abs().max())
    if not err <= 2e-6 * scale:
        raise AssertionError(f"{what}: max err {err} > {2e-6 * scale}")
    return err


def _plain(x, idx, deg, w=None, alive=None, init_rows=None, **kw):
    """K5's plain version over row chunks (``_chunked``): its (R, W, K)
    intermediates stay small on the hub class."""
    from repro_torch.kernels.edge_map import ell_edge_map_ref

    return _chunked(lambda i, d, ww, a, ir: ell_edge_map_ref(
        x, i, d, w=ww, alive=a, init_rows=ir, **kw),
        idx.shape[0], idx.shape[1], idx, deg, w, alive, init_rows)


def variant_grid(tiles, num_vertices, device, seed):
    """K5 against its plain version over every static variant, on all rows of
    every tile class (a wide class through its segment list); every sum on a
    wide class twice, bitwise.  Returns (variants checked, max |err| of the
    sums, sums checked twice)."""
    import torch

    from repro_torch.kernels.edge_map import ell_edge_map

    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    v = num_vertices
    planes = []
    for t in tiles:
        idx, deg = t.idx, t.deg
        r, w = idx.shape
        planes.append(dict(idx=idx, deg=deg, segments=t.segments,
                           w=rand(r, w),
                           alive=(rand(r, w) < 0.8).to(torch.int8),
                           init1=rand(r), init8=rand(r, 8)))
    xs = {1: rand(v), 8: rand(v, 8)}
    frs = {"shared": (rand(v) < 0.5).to(torch.int8),
           "planar": (rand(v, 8) < 0.5).to(torch.int8)}
    n, max_err, twice = 0, 0.0, 0
    for reduce, weight, frontier, alive, init, k in itertools.product(
            ("sum", "min", "max"), ("none", "unit", "plane"),
            ("none", "shared", "planar"), (False, True), (False, True), (1, 8)):
        if frontier == "planar" and k == 1:
            continue
        neutral = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}[reduce]
        for p in planes:
            r, w = p["idx"].shape
            kw = dict(reduce=reduce, w=p["w"] if weight == "plane" else None,
                      unit_weights=weight == "unit",
                      frontier=None if frontier == "none" else frs[frontier],
                      alive=p["alive"] if alive else None,
                      init_rows=p[f"init{k}"] if init else None,
                      neutral=neutral)
            got = ell_edge_map(xs[k], p["idx"], p["deg"],
                               segments=p["segments"], row_tile=r,
                               width_tile=w, **kw)
            want = _plain(xs[k], p["idx"], p["deg"], **kw)
            if reduce == "sum" and p["segments"] is not None:
                again = ell_edge_map(xs[k], p["idx"], p["deg"],
                                     segments=p["segments"], row_tile=r,
                                     width_tile=w, **kw)
                if not torch.equal(got, again):
                    raise AssertionError(
                        f"sum/{weight}/{frontier}/alive={alive}/init={init}/"
                        f"K={k}: two calls on the ({r}, {w}) class differ")
                twice += 1
            max_err = max(max_err, _assert_close(
                got, want, reduce,
                f"{reduce}/{weight}/{frontier}/alive={alive}/init={init}/K={k}"
                f" on a ({r}, {w}) {p['idx'].dtype} tile"))
        n += 1
    # Radii's plane: {0,1} lanes through float32 with int8's finite identity
    reach = (rand(v, 8) < 0.3).to(torch.float32)
    for p in planes:
        r, w = p["idx"].shape
        kw = dict(reduce="max", identity=-128.0)
        got = ell_edge_map(reach, p["idx"], p["deg"], segments=p["segments"],
                           row_tile=r, width_tile=w, **kw)
        _assert_close(got, _plain(reach, p["idx"], p["deg"], **kw),
                      "max", "radii identity")
    _sync()
    return n + 1, max_err, twice


# ---------------------------------------------------------------- phase 4
def build_graphs(log2_vertices=LOG2_VERTICES, seed=0):
    """The kr-signature RMAT graph at 2^log2 vertices (host, numpy), its DBG
    reordering on out-degree, a weighted copy of that for SSSP, and the
    host reorder's result (its mapping is what ``dbg_bin`` must give)."""
    from repro_torch.core.reorder import reorder_graph
    from repro_torch.graph import datasets, generators

    spec = datasets.REGISTRY["kr"]
    v = 1 << log2_vertices
    t0 = time.perf_counter()
    g = generators.rmat(v, int(v * spec.avg_degree), seed=seed, name="kr",
                        **spec.extra)
    t1 = time.perf_counter()
    g_dbg, res = reorder_graph(g, "dbg", degree_source="out")
    t2 = time.perf_counter()
    gw_dbg = generators.with_weights(g_dbg, seed=seed + 1)
    t3 = time.perf_counter()
    log(f"graph: kr-signature RMAT V={g.num_vertices} E={g.num_edges} "
        f"(generate {t1 - t0:.1f} s; DBG reorder {res.seconds:.2f} s "
        f"(mapping + CSR rebuild), {res.num_groups} groups; weighted copy "
        f"{t3 - t2:.1f} s)")
    return g, g_dbg, gw_dbg, res


def app_runs(v, sources, root=0):
    """App name -> the call on a backend: the five apps as the main path
    runs them (SSSP takes the weighted backend)."""
    from repro_torch import apps

    return {
        "pagerank": lambda ga: apps.pagerank(ga),
        # The default absolute epsilon (1e-7) is above the first-round delta
        # (0.15 / V) once V > 1.5M, so nothing would be active; a threshold
        # of 1% of the uniform rank (Ligra's relative epsilon2) keeps the
        # push frontier meaningful at this size.
        "pagerank_delta": lambda ga: apps.pagerank_delta(
            ga, epsilon=0.01 / v),
        "sssp": lambda ga: apps.sssp(ga, root),
        "bc": lambda ga: apps.bc(ga, root),
        "radii": lambda ga: apps.radii(ga, sources),
    }


def warm_median(fn, reps=None):
    """One warm-up call of ``fn()``, then ``reps`` (``EVAL_REPS``) timed
    calls on the host clock, each between two device syncs: the median,
    min and max seconds, and the last call's output."""
    import statistics

    out = fn()
    _sync()
    times = []
    for _ in range(reps or EVAL_REPS):
        _sync()
        t = time.perf_counter()
        out = fn()
        _sync()
        times.append(time.perf_counter() - t)
    return dict(median_s=statistics.median(times), min_s=min(times),
                max_s=max(times)), out


def _span(t, prefix=""):
    """``median [min-max]`` of a ``warm_median`` record (keys ``prefix`` +
    ``median_s``, ...)."""
    return (f"{t[prefix + 'median_s']:.4f} [{t[prefix + 'min_s']:.4f}-"
            f"{t[prefix + 'max_s']:.4f}]")


def main_path(g, g_dbg, gw_dbg, device):
    """Run the five apps on ``ell`` and on ``flat``, once each, checked;
    return the backends, the runs and per-app records."""
    import torch

    from repro_torch import apps

    t0 = time.perf_counter()
    backends = {}
    for key, graph in (("orig", g), ("dbg", g_dbg), ("dbg_w", gw_dbg)):
        backends[key] = (apps.to_arrays(graph, backend="flat", device=device),
                         apps.to_arrays(graph, backend="ell", device=device))
    _sync()
    log(f"backends built in {time.perf_counter() - t0:.1f} s "
        f"(ell classes: {[len(b[1].in_tiles) for b in backends.values()]})")

    sources = apps.radii_sources(g_dbg.num_vertices, 8,
                                 generator=torch.Generator().manual_seed(0))
    fns = app_runs(g_dbg.num_vertices, sources)
    runs = {"pagerank[original]": ("orig", fns["pagerank"]),
            "pagerank[dbg]": ("dbg", fns["pagerank"]),
            "pagerank_delta": ("dbg", fns["pagerank_delta"]),
            "sssp": ("dbg_w", fns["sssp"]),
            "bc": ("dbg", fns["bc"]),
            "radii": ("dbg", fns["radii"])}
    records = {}
    for name, (key, fn) in runs.items():
        flat, ell = backends[key]
        per = {}
        for bname, ga in (("ell", ell), ("flat", flat)):
            n0 = _ell_launches()
            _sync()
            t = time.perf_counter()
            out = fn(ga)
            _sync()
            per[bname] = (out, time.perf_counter() - t, _ell_launches() - n0)
        (eo, es, el), (fo, fs, fl) = per["ell"], per["flat"]
        if el == 0:
            raise AssertionError(f"{name}: K5 was never launched on ell")
        if fl != 0:
            raise AssertionError(f"{name}: flat launched K5")
        iters = _compare_app(name, eo, fo)
        records[name] = dict(ell_first_s=es, flat_first_s=fs, launches=el,
                             iters=iters)
        log(f"app {name}: ell {es:.3f} s, flat {fs:.3f} s (first runs), "
            f"iterations {iters}, K5 launches {el}")
    return backends, runs, records


def time_apps(runs, backends, records, names):
    """Warm medians (``warm_median``) of every app on each backend of
    ``names`` (index into ``backends[key]``), into ``records``."""
    for app, (key, fn) in runs.items():
        for bname, i in names.items():
            t, _ = warm_median(lambda: fn(backends[key][i]))
            records[app].update({f"{bname}_{k}": x for k, x in t.items()})


def _rank_gap(got, want, what):
    """``got`` against ``want`` in units of the uniform rank 1/V (rtol
    1e-4, atol 2e-4 / V, phase 4's band): the worst gap as a share of the
    band, which must not pass 1.  The reference's atol 1e-7 at a
    2,000-vertex graph is 2e-4 of that unit, and rtol 1e-4 covers the
    summation-order noise of hub rows with ~10^5 in-edges; a lane missing
    from a row of average degree moves its rank by ~4%."""
    v = want.shape[0]
    a, b = got.double() * v, want.double() * v
    used = float(((a - b).abs() / (2e-4 + 1e-4 * b.abs())).max())
    if not used <= 1.0:
        raise AssertionError(f"{what}: ranks differ by {used:.3g}x the band "
                             "(rtol 1e-4, atol 2e-4 / V)")
    return used


def _compare_app(name, eo, fo):
    import torch

    def same(a, b, what):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {what} differ (must be bitwise)")

    def close(a, b, what, rtol, atol):
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            err = float((a - b).abs().max())
            raise AssertionError(f"{name}: {what} max err {err}")

    if name.startswith("pagerank"):
        (r1, i1), (r2, i2) = eo, fo
        if not (torch.isfinite(r1).all() and r1.shape == r2.shape):
            raise AssertionError(f"{name}: ranks not finite")
        used = _rank_gap(r1, r2, name)
        log(f"  {name}: worst rank gap {used:.3g} of the band")
        if abs(i1 - i2) > 1:
            raise AssertionError(f"{name}: iterations {i1} vs {i2}")
        return (i1, i2)
    if name == "sssp":
        (d1, i1), (d2, i2) = eo, fo
        same(d1, d2, "distances")
        if i1 != i2:
            raise AssertionError(f"{name}: iterations {i1} vs {i2}")
        if not bool(torch.isfinite(d1).any()):
            raise AssertionError(f"{name}: nothing reached")
        return i1
    if name == "bc":
        (c1, dist1, l1), (c2, dist2, l2) = eo, fo
        if l1 != l2:
            raise AssertionError(f"{name}: levels {l1} vs {l2}")
        same(dist1, dist2, "BFS levels")
        if not bool(torch.isfinite(c1).all()):
            raise AssertionError(f"{name}: centrality not finite")
        close(c1, c2, "centrality", 1e-5, 1e-5)
        return l1
    (ra1, i1), (ra2, i2) = eo, fo
    same(ra1, ra2, "radii")
    if i1 != i2:
        raise AssertionError(f"{name}: iterations {i1} vs {i2}")
    return i1


# ---------------------------------------------------------------- phase 5
def _events_ms(fn, reps, device_only=False):
    """Median over ``reps`` calls of the time between two events around
    ``fn()``.  From an idle device that includes the host's time to issue
    ``fn``'s launches; with ``device_only`` the device first sleeps
    (``SLEEP_CYCLES``) while the host issues them, so the time is the
    device's alone."""
    import statistics

    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _with_build(module, libs, fn):
    """``fn()`` with the wrapper module ``module`` (under
    ``repro_torch.kernels``) bound to ``libs`` (variant → a comparison
    build's library), then its kept entries back."""
    from importlib import import_module

    m = import_module(f"repro_torch.kernels.{module}")
    kept = dict(m.load_kernels())
    m._bind(libs)
    try:
        return fn()
    finally:
        m._KERNELS.update(kept)


def time_pull(flat, ell, reps, narrow_builds):
    """K5, its plain version and cuSPARSE at the PageRank pull of the main
    path (DBG ordering): one full edge map each."""
    import torch

    from repro_torch.kernels._wrap import lanes_per_row
    from repro_torch.kernels.edge_map import (ell_edge_map, ell_edge_map_ref,
                                              fused_edge_map,
                                              fused_edge_map_bytes,
                                              row_segments)

    v = ell.num_vertices
    dev = ell.out_deg.device
    x = (torch.rand(v, generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev) / ell.out_deg.clamp(min=1))
    tiles = ell.in_tiles

    def call(t, segments):
        return ell_edge_map(x, t.idx, t.deg, segments=segments,
                            row_tile=t.idx.shape[0], width_tile=t.idx.shape[1])

    def kernels():
        return fused_edge_map(tiles, x, v, reduce="sum")

    def plain():
        return [ell_edge_map_ref(x, t.idx, t.deg) for t in tiles]

    n0 = _ell_launches()
    got = kernels()
    launches_per_call = _ell_launches() - n0
    if launches_per_call != _k5_launches(tiles):
        raise AssertionError(f"timed pull: {launches_per_call} K5 launches, "
                             f"the tiles call for {_k5_launches(tiles)}")
    want = flat.pull(x, reduce="sum")
    err = _assert_close(got, want, "sum", "timed pull vs flat")
    for t, b in zip(tiles, plain()):
        err = max(err, _assert_close(call(t, t.segments), b, "sum",
                                     "timed pull vs plain"))

    ms = _events_ms(kernels, reps)
    device_ms = _events_ms(kernels, reps, True)
    plain_ms = _events_ms(plain, reps)
    per_class = []
    for t in tiles:
        r, w = t.idx.shape
        edges = int(t.deg.sum())
        share = (edges * t.idx.element_size() + r * 8) / HBM_BYTES_PER_S * 1e3
        n0 = _ell_launches()
        kept = call(t, t.segments)
        launches = _ell_launches() - n0
        # what the wrapper launched: the split's two kernels above 1,024
        # lanes (a block per piece of a row, then the fold), one below
        if launches != (2 if w > 1024 else 1):
            raise AssertionError(f"class {(r, w)}: {launches} K5 launches")
        group = lanes_per_row(w)
        c = dict(shape=(r, w), dtype=str(t.idx.dtype).replace("torch.", ""),
                 edges=edges, max_deg=int(t.deg.max()), group=group,
                 launches=launches, bound_share_ms=share,
                 segments=None if t.segments is None else int(t.segments.shape[0]),
                 ms=_events_ms(lambda t=t: call(t, t.segments), reps, True))
        if t.segments is not None:
            # the other design on the same inputs: a block per whole row
            # (one segment per row)
            whole = torch.from_numpy(row_segments(t.deg.cpu().numpy(), w))
            whole = whole.to(dev)
            c["block_per_row_ms"] = _events_ms(lambda t=t: call(t, whole),
                                               reps, True)
        else:
            c["lanes_per_thread"] = -(-w // group)
            for name, lib in narrow_builds.items():
                got = _with_build("edge_map.edge_map", {"sum": lib},
                                  lambda t=t: call(t, None))
                if not torch.equal(got, kept):
                    raise AssertionError(f"class {(r, w)}: the {name} build "
                                         "differs from the kept kernel")
                c[f"{name}_ms"] = _with_build(
                    "edge_map.edge_map", {"sum": lib},
                    lambda t=t: _events_ms(lambda: call(t, None), reps, True))
        per_class.append(c)
    ga = ell.ga
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(ga.in_ptr, ga.in_src,
                                      torch.ones_like(ga.in_w), size=(v, v),
                                      check_invariants=False)
    lib = (csr @ x[:, None])[:, 0]
    err_lib = float((lib - want).abs().max())
    library_ms = _events_ms(lambda: csr @ x[:, None], reps)
    library_device_ms = _events_ms(lambda: csr @ x[:, None], reps, True)

    # The least the card could move: valid lanes of the id plane, deg and y
    # per class, x once; one add per edge.
    edges = int(ga.num_edges)
    need = v * 4 + sum(int(t.deg.sum()) * t.idx.element_size()
                       + t.idx.shape[0] * 8 for t in tiles)
    bound_bytes_ms = need / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = edges / FP32_OPS_PER_S * 1e3
    padded = fused_edge_map_bytes(tiles, v)
    return dict(
        launches_per_call=launches_per_call, ms=ms, device_ms=device_ms,
        plain_ms=plain_ms, library_ms=library_ms,
        library_device_ms=library_device_ms,
        bound_ms=max(bound_bytes_ms, bound_ops_ms),
        bound_by="bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        bound_bytes=need, padded_bytes=padded,
        padded_bound_ms=padded / HBM_BYTES_PER_S * 1e3,
        max_abs_err=err, library_max_abs_err=err_lib,
        per_class=per_class)


# ---------------------------------------------------------------- phase 6
def packed_path(g, g_dbg, gw_dbg, res, device):
    """The packed-storage path on the main-path graphs: the five apps on
    ``backend="packed"`` against ``flat``, ``pack_spmv`` (K4) and
    ``dbg_spmv`` (K1) against the flat pull and the CSR oracle, ``dbg_bin``
    (hist_bin) against the host DBG mapping.  Returns what phases 7-8 reuse."""
    import numpy as np
    import torch

    from repro_torch import apps
    from repro_torch.core.reorder import dbg_spec
    from repro_torch.kernels.csr_spmv import (csr_spmv_ref, dbg_spmv,
                                              ell_pack_groups)
    from repro_torch.kernels.hist_bin import dbg_bin
    from repro_torch.kernels.pack_spmv import pack_spmv
    from repro_torch.pack import flat_csr_nbytes

    def build_packed(graph):
        t0 = time.perf_counter()
        pb = apps.to_arrays(graph, backend="packed", device=device)
        _sync()
        return pb, time.perf_counter() - t0

    # the weighted graph packs in a worker beside the flat oracles and the
    # unweighted pack (the packer's numpy passes release the GIL); nothing
    # is timed until both are done
    pool = ThreadPoolExecutor(1)
    weighted = pool.submit(build_packed, gw_dbg)
    t0 = time.perf_counter()
    flats = {"dbg": apps.to_arrays(g_dbg, backend="flat", device=device),
             "dbg_w": apps.to_arrays(gw_dbg, backend="flat", device=device)}
    _sync()
    log(f"packed path: flat oracles rebuilt in {time.perf_counter() - t0:.1f} s")
    packs = {}
    for key, graph in (("dbg", g_dbg), ("dbg_w", gw_dbg)):
        t0 = time.perf_counter()
        pb, build_s = (build_packed(graph) if key == "dbg"
                       else weighted.result())
        pg = pb.packed
        a = pg.in_adj
        where = " in the worker" if key == "dbg_w" else ""
        log(f"  packed backend {key}: {build_s:.1f} s{where} (host pack "
            f"{pg.pack_seconds:.1f} s; {time.perf_counter() - t0:.1f} s "
            f"waited for it here); in-direction hot tables "
            f"{[(h.num_rows, h.stride) for h in a.hot]} {a.hot[0].idx.dtype}, "
            f"packing factor {a.packing_factor:.3f}, cold rows "
            f"{a.cold.num_rows} / edges {a.cold.num_edges}; out-direction "
            f"hot tables {[(h.num_rows, h.stride) for h in pg.out_adj.hot]}; "
            f"bytes per edge "
            f"{pg.bytes_per_edge():.3f} (flat CSR "
            f"{flat_csr_nbytes(graph) / (2 * graph.num_edges):.3f}); K5 "
            f"tile classes {[tuple(t.idx.shape) for t in pb.in_tiles]}")
        packs[key] = pb
    pool.shutdown()

    sources = apps.radii_sources(g_dbg.num_vertices, 8,
                                 generator=torch.Generator().manual_seed(0))
    fns = app_runs(g_dbg.num_vertices, sources)
    runs = {"pagerank[dbg]": ("dbg", fns["pagerank"]),
            "pagerank_delta": ("dbg", fns["pagerank_delta"]),
            "sssp": ("dbg_w", fns["sssp"]),
            "bc": ("dbg", fns["bc"]),
            "radii": ("dbg", fns["radii"])}
    records = {}
    for name, (key, fn) in runs.items():
        per = {}
        for bname, ga in (("packed", packs[key]), ("flat", flats[key])):
            n0 = _ell_launches()
            _sync()
            t = time.perf_counter()
            out = fn(ga)
            _sync()
            per[bname] = (out, time.perf_counter() - t, _ell_launches() - n0)
        (po, ps, pl), (fo, fs, fl) = per["packed"], per["flat"]
        if pl == 0:
            raise AssertionError(f"{name}: K5 was never launched on packed")
        if fl != 0:
            raise AssertionError(f"{name}: flat launched K5")
        iters = _compare_app(name, po, fo)
        records[name] = dict(packed_first_s=ps, flat_first_s=fs, launches=pl,
                             iters=iters)
        log(f"  app {name}: packed {ps:.3f} s, flat {fs:.3f} s (first "
            f"runs), iterations {iters}, K5 launches {pl}")

    v = g_dbg.num_vertices
    gen = torch.Generator(device=device).manual_seed(2)
    x = torch.rand(v, generator=gen, device=device)
    pull = flats["dbg"].pull(x, reduce="sum")
    t0 = time.perf_counter()
    y = pack_spmv(x, packs["dbg"].packed.in_adj)
    _sync()
    t1 = time.perf_counter()
    err = _assert_close(y, pull, "sum", "pack_spmv vs the flat pull")
    yw = pack_spmv(x, packs["dbg_w"].packed.in_adj)
    ga = flats["dbg_w"].ga
    want_w = csr_spmv_ref(x, ga.in_src, ga.in_ptr, ga.in_w)
    err_w = _assert_close(yw, want_w, "sum", "weighted pack_spmv vs csr_spmv_ref")
    log(f"  pack_spmv: max |err| {err:.3g} vs the flat pull, {err_w:.3g} "
        f"weighted vs csr_spmv_ref ({t1 - t0:.1f} s per call: host planes "
        f"copied to the card and the cold tail decoded, as in the reference)")

    bounds = dbg_spec(float(g_dbg.in_degrees().mean())).boundaries
    t0 = time.perf_counter()
    groups = ell_pack_groups(g_dbg, bounds, row_tile=64, width_tile=128,
                             device=device)
    _sync()
    t1 = time.perf_counter()
    yd = dbg_spmv(x, groups, v, row_tile=64, width_tile=128)
    err_d = _assert_close(yd, pull, "sum", "dbg_spmv vs the flat pull")
    log(f"  dbg_spmv: max |err| {err_d:.3g} vs the flat pull; K1 groups "
        f"{[tuple(gr.idx.shape) for gr in groups]} packed in {t1 - t0:.1f} s")

    out_deg = g.out_degrees()
    spec = dbg_spec(max(1.0, float(out_deg.mean())))
    deg_t = torch.from_numpy(out_deg.astype(np.int32)).to(device)
    b_t = torch.tensor(spec.boundaries, dtype=torch.int32, device=device)
    mapping, _, hist = dbg_bin(deg_t, b_t)
    if not torch.equal(mapping.cpu(), torch.from_numpy(res.mapping)):
        bad = int((mapping.cpu() != torch.from_numpy(res.mapping)).sum())
        raise AssertionError(f"dbg_bin mapping differs from the host DBG "
                             f"mapping at {bad} vertices (must be bitwise)")
    log(f"  dbg_bin: mapping equals the host DBG mapping bitwise; histogram "
        f"{hist.tolist()}")
    return dict(flats=flats, packs=packs, groups=groups, records=records,
                runs=runs,
                deg_t=deg_t, b_t=b_t, out_deg=out_deg, spec=spec,
                max_err={"hot_spmv": max(err, err_w), "ell_spmv": err_d})


# ---------------------------------------------------------------- phase 7
def new_kernel_grid(pk, small, device):
    """K4, K1 and hist_bin against their plain versions on the card (K4 as
    ``pack_spmv`` calls it, with each table's ``max_deg`` and segment list;
    a split table also through the wrapper's own list, and twice, bitwise);
    returns the worst sum error of K4 and of K1, K4's id widths and the
    number of split K4 tables checked."""
    import torch

    from repro_torch.graph import datasets, generators
    from repro_torch.kernels.csr_spmv import ell_spmv, ell_spmv_ref
    from repro_torch.kernels.hist_bin import hist_bin, hist_bin_ref
    from repro_torch.kernels.pack_spmv import hot_spmv, hot_spmv_ref, hot_tables
    from repro_torch.pack import pack_graph

    gen = torch.Generator(device=device).manual_seed(3)
    spec = datasets.REGISTRY["kr"]
    tiny = generators.rmat(256, 256 * int(spec.avg_degree), seed=2,
                           name="kr", **spec.extra)
    pg_main = pk["packs"]["dbg"].packed
    pg_small, pg_tiny = pack_graph(small), pack_graph(tiny)
    err4, checked, widths, split = 0.0, [], set(), 0
    for label, pg in (("main", pg_main), ("kr/small", pg_small),
                      ("256-vertex", pg_tiny)):
        v = pg.num_vertices
        x = torch.rand(v, generator=gen, device=device)
        for direction in ("in_adj", "out_adj"):
            for t in hot_tables(getattr(pg, direction), device=device,
                                row_tile=1, width_tile=1):
                idx, deg = t.idx, t.deg
                r, s = idx.shape
                widths.add(idx.element_size())
                for w in (None, torch.rand((r, s), generator=gen,
                                           device=device)):
                    what = (f"K4 on a {label} {direction} ({r}, {s}) "
                            f"{idx.dtype} table, w={w is not None}")
                    got = hot_spmv(x, idx, deg, w, max_deg=t.max_deg,
                                   segments=t.segments, row_tile=r,
                                   width_tile=s)
                    ref = _chunked(lambda i, d, ww: hot_spmv_ref(x, i, d, ww),
                                   r, s, idx, deg, w)
                    err4 = max(err4, _assert_close(got, ref, "sum", what))
                    if t.segments is not None:
                        # twice, and through the list the wrapper builds
                        for again in (hot_spmv(x, idx, deg, w,
                                               max_deg=t.max_deg,
                                               segments=t.segments,
                                               row_tile=r, width_tile=s),
                                      hot_spmv(x, idx, deg, w, row_tile=r,
                                               width_tile=s)):
                            if not torch.equal(got, again):
                                raise AssertionError(f"{what}: two split "
                                                     "calls differ")
                        split += 1
                checked.append((label, direction, r, s))
    _sync()
    log(f"  K4 vs plain: {len(checked)} hot tables x (unweighted, weighted) "
        f"agree, id widths {sorted(widths)} bytes, max |err| {err4:.3g}; "
        f"{split} split calls bitwise equal over two calls and with the "
        "wrapper's own list")

    x = torch.rand(pk["flats"]["dbg"].num_vertices, generator=gen,
                   device=device)
    err1 = 0.0
    for gr in pk["groups"]:
        r, w = gr.idx.shape
        got = ell_spmv(x, gr.idx, gr.w, deg=gr.deg, max_deg=gr.max_deg,
                       segments=gr.segments, row_tile=r, width_tile=w)
        every = ell_spmv(x, gr.idx, gr.w, row_tile=r, width_tile=w)
        if not torch.equal(got, every):
            raise AssertionError(f"K1 on a ({r}, {w}) group: the degree walk "
                                 "and the every-lane path differ (must be "
                                 "bitwise on a finite x)")
        for y, d, what in ((got, gr.deg, "degree walk"),
                           (every, None, "every lane")):
            ref = _chunked(lambda i, ww, dd: ell_spmv_ref(x, i, ww, deg=dd),
                           r, w, gr.idx, gr.w, d)
            err1 = max(err1, _assert_close(y, ref, "sum",
                                           f"K1 ({what}) on a ({r}, {w}) group"))
    _sync()
    log(f"  K1 vs plain: {len(pk['groups'])} groups agree, the degree walk and "
        f"the every-lane path each against the plain version (max |err| "
        f"{err1:.3g}) and bitwise against each other")

    deg_t, b_t = pk["deg_t"], pk["b_t"]
    for bounds in (b_t, b_t[:-1].contiguous()):  # the second ends above 0
        got, ref = hist_bin(deg_t, bounds), hist_bin_ref(deg_t, bounds)
        for a, b, what in zip(got, ref, ("groups", "histogram")):
            if not torch.equal(a, b):
                raise AssertionError(f"hist_bin {what} differ from the plain "
                                     f"version (bounds {bounds.tolist()})")
    _sync()
    log("  hist_bin vs plain: groups and histograms bitwise equal, bounds "
        f"{b_t.tolist()} and {b_t[:-1].tolist()}")
    log(f"  dbg_bin vs plain: {dbg_bin_grid(deg_t, b_t)}")
    return err4, err1, widths, split


def dbg_bin_grid(deg_t, b_t):
    """``dbg_bin`` on the card (the binning kernel, then the rank kernel)
    against the plain path (``hist_bin_ref``, then ``stable_mapping_ref``)
    bitwise, and ``stable_mapping_from_groups`` on the plain groups, on
    shapes that stress the tiles: V of 0, 1, a tile and a tile ± 1, the
    main-path graph's 2^21 and 2^21 + 5; K = 1, 8 (DBG), 7 (ending above
    0) and 32; every vertex in one group.  Returns a summary line."""
    import torch

    from repro_torch.kernels.hist_bin import (TILE, dbg_bin, hist_bin_ref,
                                              stable_mapping_from_groups,
                                              stable_mapping_ref)

    dev = deg_t.device
    v = deg_t.shape[0]
    wide = torch.arange(31 * 16, -1, -16, dtype=torch.int32, device=dev)
    median = deg_t.float().median().int().reshape(1)
    longer = torch.cat([deg_t, deg_t[:5]])
    cases = [(deg_t, b_t), (deg_t, b_t[:-1].contiguous()), (deg_t, wide),
             (deg_t, median), (longer, b_t), (longer, wide),
             (torch.zeros(v, dtype=torch.int32, device=dev), b_t),  # all last
             (deg_t + int(b_t.max()), b_t)]                         # all first
    for n in (0, 1, TILE - 1, TILE, TILE + 1, 3 * TILE + 5):
        for b in (b_t, wide, median):
            cases.append((deg_t[:n], b))
    shapes = set()
    for d, b in cases:
        k = b.shape[0]
        what = f"dbg_bin at V = {d.shape[0]}, K = {k}"
        mapping, groups, hist = dbg_bin(d, b)
        ref_groups, ref_hist = hist_bin_ref(d, b)
        ref_mapping = stable_mapping_ref(ref_groups, k)
        for got, want, name in ((groups, ref_groups, "groups"),
                                (hist, ref_hist, "histogram"),
                                (mapping, ref_mapping, "mapping"),
                                (stable_mapping_from_groups(ref_groups, k),
                                 ref_mapping, "stable_mapping_from_groups")):
            if got.dtype != want.dtype or not torch.equal(got, want):
                bad = int((got != want).sum()) if got.shape == want.shape else -1
                raise AssertionError(f"{what}: {name} differs from the plain "
                                     f"path at {bad} places (must be bitwise)")
        shapes.add((d.shape[0], k))
    _sync()
    return (f"{len(cases)} cases bitwise equal (mapping, groups, histogram, "
            f"and the mapping from the plain groups alone), (V, K) in "
            f"{sorted(shapes)}")


# ---------------------------------------------------------------- phase 8
def _bound(nbytes, ops):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def _library_csr(crow, col, vals, shape):
    import torch

    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, col, vals, size=shape,
                                       check_invariants=False)


def time_hot_spmv(pk, reps):
    """K4 at ``pack_spmv``'s call on the main-path graph: one launch per hot
    group of the in-adjacency, on the planes padded as ``pack_spmv`` pads
    them; cuSPARSE over the same rows as the library yardstick.  Each time
    is taken from an idle device (``ms``) and on the device alone
    (``device_ms``), the whole call and each table."""
    import numpy as np
    import torch

    from repro_torch.graph.csr import ragged_offsets
    from repro_torch.kernels._wrap import lanes_per_row
    from repro_torch.kernels.pack_spmv import hot_spmv, hot_spmv_ref, hot_tables

    adj = pk["packs"]["dbg"].packed.in_adj
    dev = pk["deg_t"].device
    tables, cols, degs = hot_tables(adj, device=dev), [], []
    for t in tables:
        h = t.group
        at = ragged_offsets(np.arange(h.num_rows, dtype=np.int64) * h.stride,
                            h.deg.astype(np.int64))
        cols.append(h.idx.ravel()[at].astype(np.int64))
        degs.append(h.deg.astype(np.int64))
    v = adj.num_vertices
    x = torch.rand(v, generator=torch.Generator(device=dev).manual_seed(4),
                   device=dev)

    def one(t):  # as ops.pack_spmv calls it
        return hot_spmv(x, t.idx, t.deg, max_deg=t.max_deg,
                        segments=t.segments, row_tile=64, width_tile=128)

    def kernels():
        return [one(t)[:t.group.num_rows] for t in tables]

    def plain():
        return [_chunked(lambda ii, dd: hot_spmv_ref(x, ii, dd),
                         t.idx.shape[0], t.idx.shape[1], t.idx,
                         t.deg)[:t.group.num_rows] for t in tables]

    n0 = hot_spmv.launches
    got = torch.cat(kernels())
    per_call = hot_spmv.launches - n0
    err = _assert_close(got, torch.cat(plain()), "sum", "timed K4 vs plain")
    deg_all = np.concatenate(degs)
    crow = np.zeros(deg_all.size + 1, np.int64)
    np.cumsum(deg_all, out=crow[1:])
    col = torch.from_numpy(np.concatenate(cols)).to(dev)
    csr = _library_csr(torch.from_numpy(crow).to(dev), col,
                       torch.ones(col.shape[0], device=dev),
                       (deg_all.size, v))
    lib_err = float(((csr @ x[:, None])[:, 0] - got).abs().max())
    edges = int(deg_all.sum())
    itemsize = adj.hot[0].idx.dtype.itemsize
    bound_ms, bound_by = _bound(v * 4 + edges * itemsize + deg_all.size * 8,
                                edges)
    per_table = []
    for t, dh in zip(tables, degs):
        n0 = hot_spmv.launches
        one(t)
        group = lanes_per_row(t.max_deg)
        launches = hot_spmv.launches - n0
        # what the wrapper launched: the split's two kernels for a 256-lane
        # group (a block per piece of a row, then the fold), one below
        if launches != (2 if group == 256 else 1):
            raise AssertionError(f"K4 table {tuple(t.idx.shape)}: {launches} "
                                 "launches")
        per_table.append(dict(
            shape=tuple(t.idx.shape),
            dtype=str(t.idx.dtype).replace("torch.", ""),
            edges=int(dh.sum()), max_deg=t.max_deg, group=group,
            segments=(None if t.segments is None
                      else int(t.segments.shape[0])),
            launches=launches,
            ms=_events_ms(lambda t=t: one(t), reps),
            device_ms=_events_ms(lambda t=t: one(t), reps, True)))
    return dict(ms=_events_ms(kernels, reps),
                device_ms=_events_ms(kernels, reps, True),
                plain_ms=_events_ms(plain, reps),
                library_ms=_events_ms(lambda: csr @ x[:, None], reps),
                library_device_ms=_events_ms(lambda: csr @ x[:, None], reps,
                                             True),
                launches_per_call=per_call, max_abs_err=err,
                library_max_abs_err=lib_err, bound_ms=bound_ms,
                bound_by=bound_by, edges=edges, rows=int(deg_all.size),
                per_table=per_table)


def time_ell_spmv(pk, reps):
    """K1 at ``dbg_spmv``'s call on the main-path graph (64 x 128 geometry):
    one launch per DBG group, with the groups' degrees (``ms``) and without
    (``padded_ms``); cuSPARSE over the in-CSR as the yardstick."""
    import torch

    from repro_torch.kernels._wrap import lanes_per_row
    from repro_torch.kernels.csr_spmv import ell_spmv, ell_spmv_ref

    groups = pk["groups"]
    ga = pk["flats"]["dbg"].ga
    v = ga.num_vertices
    dev = ga.device
    x = torch.rand(v, generator=torch.Generator(device=dev).manual_seed(5),
                   device=dev)

    def one(gr, walk=True):
        kw = (dict(deg=gr.deg, max_deg=gr.max_deg, segments=gr.segments)
              if walk else {})
        return ell_spmv(x, gr.idx, gr.w, row_tile=64, width_tile=128, **kw)

    def kernels():
        return [one(gr) for gr in groups]

    def padded():
        return [one(gr, False) for gr in groups]

    def plain():
        return [_chunked(lambda i, w, d: ell_spmv_ref(x, i, w, deg=d),
                         gr.idx.shape[0], gr.idx.shape[1], gr.idx, gr.w,
                         gr.deg) for gr in groups]

    n0 = ell_spmv.launches
    got = kernels()
    per_call = ell_spmv.launches - n0
    err = 0.0
    for a, b, c in zip(got, plain(), padded()):
        err = max(err, _assert_close(a, b, "sum", "timed K1 vs plain"))
        if not torch.equal(a, c):
            raise AssertionError("timed K1: degree walk != every-lane path")
    csr = _library_csr(ga.in_ptr, ga.in_src, torch.ones_like(ga.in_w), (v, v))
    lanes = sum(gr.idx.numel() for gr in groups)
    edges = sum(int(gr.deg.sum()) for gr in groups)
    rows = sum(gr.idx.shape[0] for gr in groups)
    # The degree walk must read the real lanes' ids and weights, x once, and
    # deg and y per row; the every-lane path reads every lane and no deg.
    bound_ms, bound_by = _bound(edges * 8 + v * 4 + rows * 8, 2 * edges)
    padded_bound_ms, _ = _bound(lanes * 8 + v * 4 + rows * 4, 2 * lanes)
    return dict(ms=_events_ms(kernels, reps),
                device_ms=_events_ms(kernels, reps, True),
                plain_ms=_events_ms(plain, reps),
                padded_ms=_events_ms(padded, reps),
                library_ms=_events_ms(lambda: csr @ x[:, None], reps),
                library_device_ms=_events_ms(lambda: csr @ x[:, None], reps,
                                             True),
                launches_per_call=per_call, max_abs_err=err,
                bound_ms=bound_ms, bound_by=bound_by,
                padded_bound_ms=padded_bound_ms, lanes=lanes, edges=edges,
                per_group=[(tuple(gr.idx.shape), int(gr.deg.sum()),
                            lanes_per_row(gr.max_deg),
                            _events_ms(lambda gr=gr: one(gr), reps),
                            _events_ms(lambda gr=gr: one(gr, False), reps))
                           for gr in groups])


def time_hist_bin(pk, reps, builds):
    """hist_bin at ``dbg_bin``'s call (the main-path graph's out-degrees),
    ``torch.searchsorted`` + ``torch.bincount`` as its yardstick, and its
    two-op comparison build (``builds["two_ops"]``); the whole
    device DBG (``dbg_bin``: hist_bin, then the rank kernel) beside its
    plain path, a library path (``searchsorted``, a stable ``argsort``
    inverted with ``scatter_``) and the host mapping; the rank kernel
    alone; each from an idle device and on the device alone.  (Phase 12
    lists the device operations of one hist_bin and one dbg_bin call.)"""
    import statistics

    import torch

    from repro_torch.core.reorder import group_reorder
    from repro_torch.kernels.hist_bin import (bin_tiles, dbg_bin, hist_bin,
                                              hist_bin_ref, stable_mapping_ref,
                                              stable_rank)

    deg_t, b_t = pk["deg_t"], pk["b_t"]
    v, k = deg_t.shape[0], b_t.shape[0]
    asc = b_t.flip(0).contiguous()
    ids = torch.arange(v, device=deg_t.device)

    def library():
        g = (k - 1) - (torch.searchsorted(asc, deg_t, right=True) - 1)
        return g, torch.bincount(g, minlength=k)

    def library_rank(g):
        return torch.empty_like(ids).scatter_(
            0, torch.argsort(g, stable=True), ids)

    def dbg_library():
        return library_rank((k - 1) - (torch.searchsorted(
            asc, deg_t, right=True) - 1))

    def dbg_plain():
        g, _ = hist_bin_ref(deg_t, b_t)
        return stable_mapping_ref(g, k)

    n0 = hist_bin.launches
    groups, hist = hist_bin(deg_t, b_t)
    per_call = hist_bin.launches - n0
    ref_groups, ref_hist = hist_bin_ref(deg_t, b_t)
    err = max(float((groups - ref_groups).abs().max()),
              float((hist - ref_hist).abs().max()))
    if err != 0.0:
        raise AssertionError(f"timed hist_bin differs from the plain version "
                             f"by {err} (must be bitwise)")
    lg, lh = library()
    if not (torch.equal(lg.to(torch.int32), groups)
            and torch.equal(lh.to(torch.int32), hist)):
        raise AssertionError("searchsorted + bincount disagree with hist_bin")
    n0, r0 = hist_bin.launches, stable_rank.launches
    mapping, _, _ = dbg_bin(deg_t, b_t)
    dbg_launches = (hist_bin.launches - n0, stable_rank.launches - r0)
    if dbg_launches != (1, 1):
        raise AssertionError(f"dbg_bin launched (hist_bin, stable_rank) "
                             f"{dbg_launches} times, not (1, 1)")
    ref_mapping = dbg_plain()
    for got, name in ((mapping, "dbg_bin"), (dbg_library(), "the library "
                                                "path (argsort + scatter_)")):
        if not torch.equal(got, ref_mapping):
            raise AssertionError(f"timed {name} differs from the plain "
                                 "mapping (must be bitwise)")
    _, hist_t, tiles = bin_tiles(deg_t, b_t)
    host = []
    for _ in range(3):
        t = time.perf_counter()
        group_reorder(pk["out_deg"], pk["spec"])
        host.append(time.perf_counter() - t)
    bound_ms, bound_by = _bound(v * 8 + k * 8, v * k)
    # dbg_bin must read the degrees and write the groups and the int64
    # mapping: 16 bytes per vertex; the rank alone reads the groups and
    # writes the mapping: 12
    dbg_bound_ms, _ = _bound(v * 16 + k * 8, v * k)
    rank_bound_ms, rank_bound_by = _bound(v * 12 + (tiles.numel() + k) * 4,
                                          0)

    def rank():
        return stable_rank(groups, hist_t, tiles)

    r0 = stable_rank.launches
    rank_err = float((rank() - ref_mapping).abs().max())
    rank_per_call = stable_rank.launches - r0
    if rank_err != 0.0:
        raise AssertionError(f"timed stable_rank differs from the plain "
                             f"mapping by {rank_err} (must be bitwise)")
    def two_ops():  # the histogram from a memset and atomics
        got = hist_bin(deg_t, b_t)
        if not (torch.equal(got[0], groups) and torch.equal(got[1], hist)):
            raise AssertionError("hist_bin's two-op build differs from the "
                                 "kept kernel (must be bitwise)")
        return (_events_ms(lambda: hist_bin(deg_t, b_t), reps),
                _events_ms(lambda: hist_bin(deg_t, b_t), reps, True))

    two_ms, two_device_ms = _with_build(
        "hist_bin.hist_bin", {"all": builds["two_ops"]}, two_ops)
    rank_out = dict(
        ms=_events_ms(rank, reps), device_ms=_events_ms(rank, reps, True),
        plain_ms=_events_ms(lambda: stable_mapping_ref(groups, k), reps),
        library_ms=_events_ms(lambda: library_rank(groups), reps),
        library_device_ms=_events_ms(lambda: library_rank(groups), reps,
                                     True),
        launches_per_call=rank_per_call, max_abs_err=rank_err,
        bound_ms=rank_bound_ms,
        bound_by=rank_bound_by)
    return dict(ms=_events_ms(lambda: hist_bin(deg_t, b_t), reps),
                device_ms=_events_ms(lambda: hist_bin(deg_t, b_t), reps, True),
                plain_ms=_events_ms(lambda: hist_bin_ref(deg_t, b_t), reps),
                library_ms=_events_ms(library, reps),
                library_device_ms=_events_ms(library, reps, True),
                launches_per_call=per_call, max_abs_err=err,
                bound_ms=bound_ms, bound_by=bound_by,
                two_ops_ms=two_ms, two_ops_device_ms=two_device_ms,
                dbg_bin_ms=_events_ms(lambda: dbg_bin(deg_t, b_t), reps),
                dbg_bin_device_ms=_events_ms(lambda: dbg_bin(deg_t, b_t), reps,
                                             True),
                dbg_bin_bound_ms=dbg_bound_ms,
                dbg_bin_plain_ms=_events_ms(dbg_plain, reps),
                dbg_bin_library_ms=_events_ms(dbg_library, reps),
                dbg_bin_library_device_ms=_events_ms(dbg_library, reps, True),
                host_mapping_ms=statistics.median(host) * 1e3,
                stable_rank=rank_out)


# ---------------------------------------------------------------- phase 9
def _same(a, b):
    """Bitwise equality of two app outputs (tuples of tensors and ints)."""
    import torch

    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


def _mapped_back(app, out, m):
    """An app's output under an ordering with mapping ``m`` (original id ->
    new id, a device tensor), indexed by original vertex id."""
    if app == "bc":
        c, dist, levels = out
        return c[m], dist[m], levels
    y, it = out
    return y[m], it


K5_BATCH_ABOVE = 4        # csrc/edge_map.cu's batch threshold and the
K5_LAUNCH_CLASSES = 8     # narrow classes one grouped launch takes at most


def _k5_launches(tiles, extra=()):
    """K5's launches of one ``fused_edge_map`` on the card, from the tiles
    alone: two for each class wider than 1,024 lanes (pieces, then the
    fold); one for every ``K5_LAUNCH_CLASSES`` narrow classes of one kind
    (id width, weight and alive planes, batching); each extra class its
    own."""
    from collections import Counter

    from repro_torch.kernels._wrap import lanes_per_row

    kinds, n = Counter(), 0
    for t in tiles:
        width = t.idx.shape[1]
        group = lanes_per_row(width)
        if not t.num_rows:
            continue
        if group == 256:
            n += 2
        else:
            kinds[t.idx.element_size(), t.w is not None, t.alive is not None,
                  width > K5_BATCH_ABOVE * group] += 1
    n += sum(-(-c // K5_LAUNCH_CLASSES) for c in kinds.values())
    return n + sum(2 if lanes_per_row(t.idx.shape[1]) == 256 else 1
                   for t in extra)


def _cache_model(graph):
    """L1/L2/L3 MPKA and AMAT of ``graph``'s pull trace, capped at
    ``DEFAULT_TRACE_LEN`` accesses, on the hierarchy scaled to its size."""
    from repro_torch import cachesim

    t0 = time.perf_counter()
    levels = cachesim.scaled_hierarchy(graph.num_vertices)
    d = cachesim.stack_distances(cachesim.to_blocks(cachesim.property_trace(
        graph, "pull", max_len=cachesim.DEFAULT_TRACE_LEN)))
    out = dict(cachesim.mpka(d, levels), amat_cycles=cachesim.amat_cycles(
        d, levels), accesses=int(d.shape[0]))
    out["seconds"] = time.perf_counter() - t0
    return out


def paper_eval(g, g_dbg, gw_dbg, res, ells, device):
    """The paper's evaluation at the main path's size: every ordering of
    ``EVAL_ORDERINGS`` x the five apps on ``ell``, held to the original
    order after mapping back; warm medians; a counted run per cell against
    K5's launches; the cache model per ordering; Tables I-IV; one traced
    PageRank.  ``ells`` holds phase 4's ``orig``, ``dbg`` and ``dbg_w``
    ell backends.  Returns the rows of the ``paper_eval`` line and the
    tables."""
    import gc

    import numpy as np
    import torch

    from repro_torch import apps
    from repro_torch.core import stats
    from repro_torch.graph import csr
    from repro_torch.launch.quickstart import reordered
    from repro_torch.obs import MetricsRegistry, counters
    from repro_torch.obs import trace as obs_trace

    v = g.num_vertices
    inv_dbg = np.empty(v, np.int64)
    inv_dbg[res.mapping] = np.arange(v, dtype=np.int64)
    # the main path's SSSP/BC root (0) and Radii sources, drawn in DBG ids,
    # as original ids: the DBG ordering runs phase 4's problem
    root = int(inv_dbg[0])
    sources = inv_dbg[apps.radii_sources(
        v, 8, generator=torch.Generator().manual_seed(0)).numpy()]
    tables = json.loads(json.dumps({  # numpy scalars as plain floats
        "hot_vertices": stats.hot_vertex_stats(g),
        "hot_per_cache_block": stats.hot_per_cache_block(g),
        "hot_footprint_mb": stats.hot_footprint_mb(g),
        "degree_ranges": stats.degree_range_distribution(g)}))
    log(f"  Table I (hot vertices, % of V and of E): "
        f"{tables['hot_vertices']}")
    log(f"  Table II (hot vertices per cache block): "
        f"{tables['hot_per_cache_block']:.4f}; Table III (hot footprint): "
        f"{tables['hot_footprint_mb']:.4f} MB")
    log(f"  Table IV (hot vertices by degree range): "
        f"{tables['degree_ranges']}")

    rows, want, trace_tr = [], {}, None
    relabel_pool = ThreadPoolExecutor(1)
    # The host reorders run one ordering ahead in a worker, beside the
    # previous ordering's relabel, ell builds and cache model (numpy's sorts
    # release the GIL), each submitted in an ordering whose host section is
    # long (not dbg's, which reuses phase 4's backends); an ordering waits
    # for a reorder still running before it times anything.  A reorder's
    # printed seconds are its own, timed inside it.
    ahead = [o for o in EVAL_ORDERINGS if o not in ("original", "dbg")]
    reorder_pool, reorders = ThreadPoolExecutor(1), {}

    def reorder_ahead():
        if ahead:
            name = ahead.pop(0)
            reorders[name] = reorder_pool.submit(reordered, g, name)

    for ordering in EVAL_ORDERINGS:
        t0 = time.perf_counter()
        if ordering == "original":
            g_x, mapping, reorder_s = g, np.arange(v, dtype=np.int64), 0.0
        elif ordering == "dbg":
            g_x, mapping, reorder_s = g_dbg, res.mapping, res.seconds
        else:
            if ordering not in reorders:
                reorder_ahead()
            g_x, r = reorders.pop(ordering).result()
            mapping, reorder_s = r.mapping, r.seconds
        if ordering != "dbg":
            reorder_ahead()
        t1 = time.perf_counter()
        # SSSP's weighted copy, relabelled in a thread beside the ell build
        # and the cache model (numpy's sorts release the GIL); joined before
        # anything is timed
        relabel = (None if ordering == "dbg" else relabel_pool.submit(
            csr.relabel, gw_dbg, mapping[inv_dbg]))
        traced = ordering == EVAL_TRACED
        if ordering in ("original", "dbg"):  # phase 4's backends
            ell = ells["orig" if ordering == "original" else "dbg"]
        else:
            if traced:  # the trace holds this build's span
                trace_tr = obs_trace.enable()
            ell = apps.to_arrays(g_x, backend="ell", device=device)
            obs_trace.disable()
        cache = _cache_model(g_x)
        gw_x = gw_dbg if relabel is None else relabel.result()
        t2 = time.perf_counter()
        ell_w = (ells["dbg_w"] if ordering == "dbg"
                 else apps.to_arrays(gw_x, backend="ell", device=device))
        _sync()
        t3 = time.perf_counter()
        for f in reorders.values():  # nothing of the host runs while timed
            f.result()
        t4 = time.perf_counter()
        # the layer under the apps: one PageRank-shaped pull (K5 over every
        # class) on the device alone, in this ordering
        x = torch.rand(v, generator=torch.Generator(device=device)
                       .manual_seed(2), device=device)
        pull_ms = _events_ms(lambda: ell.pull(x, reduce="sum"), REPS,
                             device_only=True)
        # the same pull over a (V, 8) plane, 64 MiB at 2^21: past the L2
        x8 = torch.rand(v, 8, generator=torch.Generator(device=device)
                        .manual_seed(3), device=device)
        pull8_ms = _events_ms(lambda: ell.pull(x8, reduce="sum"), REPS,
                              device_only=True)
        log(f"  ordering {ordering}: host reorder {reorder_s:.2f} s (mapping "
            f"+ CSR rebuild; {t1 - t0:.1f} s waited for it here), the "
            f"weighted relabel beside the ell build and the cache model "
            f"{t2 - t1:.1f} s, the weighted ell {t3 - t2:.1f} s, the "
            f"next ordering's reorder {t4 - t3:.1f} s more; one pull on "
            f"the device alone {pull_ms:.4f} ms, over a (V, 8) plane "
            f"{pull8_ms:.4f} ms; cache model of the pull "
            f"trace ({cache['accesses']} accesses, {cache['seconds']:.1f} "
            f"s): L1 {cache['l1_mpka']:.2f}, L2 {cache['l2_mpka']:.2f}, L3 "
            f"{cache['l3_mpka']:.2f} MPKA, AMAT {cache['amat_cycles']:.3f} "
            "cycles")
        m = torch.from_numpy(mapping).to(device)
        fns = app_runs(v, torch.from_numpy(mapping[sources]),
                       root=int(mapping[root]))
        for app, fn in fns.items():
            ga = ell_w if app == "sssp" else ell
            t, out = warm_median(lambda: fn(ga))
            if ordering == "original":
                want[app] = out
            else:
                try:
                    _compare_app(app, _mapped_back(app, out, m), want[app])
                except AssertionError as e:
                    raise AssertionError(f"{ordering}: {e}") from None
            # one counted run: bitwise the same output, K5's launches from
            # the counters' passes and the tiles
            n0 = _ell_launches()
            c = counters.install(registry=MetricsRegistry())
            try:
                counted = fn(ga)
            finally:
                counters.uninstall()
            _sync()
            launches = _ell_launches() - n0
            if not _same(counted, out):
                raise AssertionError(f"{ordering} {app}: the counted run's "
                                     "output differs (must be bitwise)")
            s = c.summary()
            passes = {d: int(s.get(f"edge_map.passes.ell.{d}", 0))
                      for d in ("pull", "push", "out_sum")}
            expect = ((passes["pull"] + passes["push"])
                      * _k5_launches(ga.in_tiles))
            if launches == 0 or launches != expect:
                raise AssertionError(
                    f"{ordering} {app}: {launches} K5 launches, the counters' "
                    f"passes {passes} give {expect}")
            row = dict(ordering=ordering, app=app, **t, reorder_s=reorder_s,
                       pull_device_ms=pull_ms, pull8_device_ms=pull8_ms,
                       iters=out[-1], launches=launches, passes=passes,
                       edges=int(s["edge_map.edges"]),
                       model_bytes=int(s["edge_map.model_bytes"]),
                       model_gb_per_s=s["edge_map.model_bytes"]
                       / t["median_s"] / 1e9,
                       **{k: cache[k] for k in ("l1_mpka", "l2_mpka",
                                                "l3_mpka", "amat_cycles")})
            if app in ("pagerank_delta", "bc"):  # the counters' own cost
                counters.install(registry=MetricsRegistry())
                try:
                    ti, _ = warm_median(lambda: fn(ga))
                finally:
                    counters.uninstall()
                row.update({f"instrumented_{k}": x for k, x in ti.items()})
            if traced and app == "pagerank":
                row["trace_events"] = _traced_pagerank(trace_tr, fn, ga, out)
            rows.append(row)
            cost = ("" if "instrumented_median_s" not in row else
                    f"; counters installed {_span(row, 'instrumented_')}")
            log(f"    {app}: {_span(t)} s{cost}, iterations "
                f"{row['iters']}, K5 launches {launches}, passes {passes}, "
                f"edges {row['edges']}, modeled {row['model_bytes']} B "
                f"({row['model_gb_per_s']:.1f} GB/s, the reference's model "
                f"over the padded planes)")
        del ell, ell_w, g_x, gw_x, m, x, x8
        gc.collect()
        torch.cuda.empty_cache()
    relabel_pool.shutdown()
    reorder_pool.shutdown()
    # The DBG ordering's backends are phase 4's and still on the card: its
    # five apps timed again after every other ordering show how far a cell
    # drifts within the phase.
    fns = app_runs(v, torch.from_numpy(res.mapping[sources]),
                   root=int(res.mapping[root]))
    for row in rows:
        if row["ordering"] == "dbg":
            ga = ells["dbg_w"] if row["app"] == "sssp" else ells["dbg"]
            t, _ = warm_median(lambda: fns[row["app"]](ga))
            row.update({f"again_{k}": x for k, x in t.items()})
            log(f"    dbg {row['app']} again, after the other orderings: "
                f"{_span(t)} s (first {_span(row)})")
    return rows, tables


def _traced_pagerank(tr, fn, ga, want):
    """One PageRank run on ``ga`` with the counters installed and tracing
    on (``tr`` already holds the backend's ``engine.build_backend`` span),
    saved to a temporary file and loaded back through ``load_trace``: the
    output bitwise equal to ``want``, one ``edge_map`` counter event per
    pass.  Returns the trace's event count."""
    import os
    import tempfile

    from repro_torch.obs import MetricsRegistry, counters, load_trace
    from repro_torch.obs import trace as obs_trace

    obs_trace.enable(tr)
    c = counters.install(registry=MetricsRegistry())
    try:
        out = fn(ga)
    finally:
        counters.uninstall()
        obs_trace.disable()
    _sync()
    if not _same(out, want):
        raise AssertionError("the traced PageRank's output differs (must be "
                             "bitwise)")
    passes = sum(v for k, v in c.summary().items()
                 if k.startswith("edge_map.passes."))
    with tempfile.TemporaryDirectory() as d:
        events = load_trace(tr.save(os.path.join(d, "trace.json")))[
            "traceEvents"]
    builds = [e for e in events
              if e["ph"] == "X" and e["name"] == "engine.build_backend"]
    samples = [e for e in events if e["ph"] == "C" and e["name"] == "edge_map"]
    if len(builds) != 1 or len(samples) != passes:
        raise AssertionError(f"trace: {len(builds)} engine.build_backend "
                             f"spans, {len(samples)} edge_map counter events "
                             f"for {passes} passes")
    log(f"    trace of one PageRank run: {len(events)} events, valid; the "
        f"build span {builds[0]['dur'] / 1e6:.2f} s, {len(samples)} counter "
        f"events = passes")
    return len(events)


# ---------------------------------------------------------------- phase 10
class ChurnStream:
    """The reference churn benchmark's update stream
    (``benchmarks/stream_churn.py``, ``ChurnStream``): inserts draw their
    endpoints preferentially by degree + 1, deletions uniformly over the
    current alive edges; ``weights`` draws insert weights uniform in
    [1, 16) from the same generator, as ``generators.with_weights`` does."""

    def __init__(self, g, insert_frac: float = 0.75, seed: int = 0):
        import numpy as np

        self.rng = np.random.default_rng(seed)
        self.insert_frac = insert_frac
        out_p = (g.out_degrees() + 1.0)
        in_p = (g.in_degrees() + 1.0)
        self._out_cum = np.cumsum(out_p / out_p.sum())
        self._in_cum = np.cumsum(in_p / in_p.sum())

    def _pick(self, cum, k):
        import numpy as np

        # clip: float rounding can leave cum[-1] a hair under 1.0
        idx = np.searchsorted(cum, self.rng.random(k))
        return np.minimum(idx, cum.shape[0] - 1).astype(np.int64)

    def next_batch(self, dg, batch_size: int):
        n_add = int(round(batch_size * self.insert_frac))
        n_del = batch_size - n_add
        add_src = self._pick(self._out_cum, n_add)
        add_dst = self._pick(self._in_cum, n_add)
        es, ed, _ = dg.alive_edges()
        idx = self.rng.choice(es.shape[0], size=min(n_del, es.shape[0]),
                              replace=False)
        return add_src, add_dst, es[idx], ed[idx]

    def inserts(self, n: int):
        """``n`` inserts alone, endpoints drawn as ``next_batch`` draws
        them."""
        return self._pick(self._out_cum, n), self._pick(self._in_cum, n)

    def weights(self, n: int):
        import numpy as np

        return self.rng.uniform(1.0, 16.0, size=n).astype(np.float32)


class _Timed:
    """Wraps ``name`` of ``module`` for the phase, for the functions that
    open no span of their own: each call synced at its end, its seconds
    (and, with ``keep``, its result) recorded.  Leaving the block raises if
    no call came through the wrapper (the call site moved)."""

    def __init__(self, module, name, keep=False):
        self.module, self.name, self.keep = module, name, keep
        self.fn = getattr(module, name)
        self.seconds, self.results, self.calls = [], [], 0

    def __call__(self, *args, **kw):
        t = time.perf_counter()
        out = self.fn(*args, **kw)
        _sync()
        self.seconds.append(time.perf_counter() - t)
        self.calls += 1
        if self.keep:
            self.results.append(out)
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, exc_type, *exc):
        setattr(self.module, self.name, self.fn)
        if exc_type is None and not self.calls:
            raise AssertionError(f"{self.module.__name__}.{self.name} was "
                                 "never called through its timer")

    def take(self):
        """Seconds since the last ``take`` (summed), and the results."""
        s, r = sum(self.seconds), self.results
        self.seconds, self.results = [], []
        return s, r


def _median_span(xs):
    import statistics

    return dict(median=statistics.median(xs), min=min(xs), max=max(xs))


def _span_seconds(events):
    """Seconds of each complete span among trace ``events``, summed by name."""
    out = {}
    for e in events:
        if e["ph"] == "X":
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e6
    return out


def _stream_service(gw, root, device):
    """The stream service of phase 10 (``STREAM_CONFIG``) on ``gw``, with
    the reference's ``_on_apply`` hook feeding two more consumers on its
    ``DeltaGraph``: an unfused ``IncrementalPageRank`` and a fused
    ``IncrementalSSSP`` from ``root``.  Their folds are not the
    deployment's work: ``on_apply_s`` holds the last batch's seconds of
    them.  Returns the service and the seconds of its ``DeltaGraph`` and
    of the rest of its construction."""
    from repro_torch.stream import (IncrementalPageRank, IncrementalSSSP,
                                    StreamConfig, StreamService)
    from repro_torch.stream import service as service_mod

    class Service(StreamService):
        def __init__(self, g, config):
            super().__init__(g, config, device=device)
            self.pr_flat = IncrementalPageRank(
                self.dg, damping=config.damping, epsilon=config.pr_epsilon,
                max_iters=config.pr_max_iters, device=device)
            self.sssp_fused = IncrementalSSSP(self.dg, root,
                                              use_fused_push=True,
                                              device=device)
            self.on_apply_s = 0.0

        def _on_apply(self, result):
            t = time.perf_counter()
            self.pr_flat.ingest(result)
            self.sssp_fused.ingest(result)
            self.on_apply_s = time.perf_counter() - t

    t0 = time.perf_counter()
    with _Timed(service_mod, "DeltaGraph") as made:
        svc = Service(gw, StreamConfig(**STREAM_CONFIG))
    total = time.perf_counter() - t0
    return svc, made.seconds[0], total - made.seconds[0]


def stream_plane(gw, root, device):
    """The streaming plane at the main path's size: phase 4's weighted DBG
    graph under ``STREAM_SIZES`` x ``STREAM_BATCHES`` batches of the
    reference churn benchmark's traffic, then one batch of
    ``STREAM_INSERT_ONLY`` inserts, all on one service, the fused PageRank
    and SSSP on K5 over the base+delta tiles beside the unfused
    edge-parallel ones; checked and timed per batch.  Apply, regroup,
    compaction and the service's own folds are read from its spans.
    Returns the ``stream`` JSON record and K5's launches over the drive."""
    import gc

    import numpy as np
    import torch

    from repro_torch import apps
    from repro_torch.obs import trace as obs_trace
    from repro_torch.stream import incremental

    v = gw.num_vertices
    # fused vs unfused PageRank: the reference's CPU band of 1e-8 at 2^21
    # vertices, held in units of the mean rank 1/V so that a smaller
    # rehearsal keeps its meaning
    pr_band = 1e-8 * 2**21 / v
    out = dict(vertices=v, edges=gw.num_edges, config=STREAM_CONFIG,
               root=root, sizes=list(STREAM_SIZES), batches=STREAM_BATCHES,
               insert_only=STREAM_INSERT_ONLY, pr_band=pr_band)
    timers = [_Timed(incremental, "stream_push_tiles", keep=True),
              _Timed(incremental, "refresh_alive"),
              _Timed(incremental, "coo_tiles")]
    push_tiles, alive_t, coo_t = timers

    def tile_parts(rec):
        """The alive refresh's and ``coo_tiles``' seconds since the last
        call, added into ``rec``."""
        for key, tm in (("alive_s", alive_t), ("coo_s", coo_t)):
            rec[key] = rec.get(key, 0.0) + tm.take()[0]

    def refresh(fn, passes, fused):
        """One consumer's refresh ``fn()``: its result, seconds, K5
        launches and ``stream_push_tiles`` seconds; a fused refresh's
        launches must equal ``passes()`` x the launches per pass over the
        tiles it rode, an unfused one launches none."""
        n0 = _ell_launches()
        t = time.perf_counter()
        res = fn()
        _sync()
        dt = time.perf_counter() - t
        launches = _ell_launches() - n0
        tiles_s, tiles = push_tiles.take()
        if fused:
            want = sum(passes() * _k5_launches(b, d) for b, d in tiles)
            if len(tiles) > 1 or launches != want:
                raise AssertionError(f"fused refresh: {launches} K5 launches "
                                     f"for {passes()} passes over "
                                     f"{len(tiles)} tile sets (want {want})")
        elif launches or tiles:
            raise AssertionError(f"unfused refresh launched K5 {launches}x")
        return res, dt, launches, tiles_s

    def pr_gap(label):
        """max|fused - unfused PageRank|, held to ``pr_band``."""
        gap = float(np.abs(svc.pr.rank - svc.pr_flat.rank).max())
        if not gap <= pr_band:
            raise AssertionError(f"{label}: fused PageRank {gap} from unfused "
                                 f"(band {pr_band:.3g})")
        return gap

    def full_check(label, last=False):
        """PageRank (and after the last batch SSSP) recomputed on ``flat``
        of the current snapshot, against the fused consumers."""
        t = time.perf_counter()
        snap = svc.snapshot()
        ga = apps.to_arrays(snap, backend="flat", device=device)
        full, it = apps.pagerank(ga, tol=1e-10, max_iters=256)
        full = full.cpu().numpy()
        gap = float(np.abs(svc.pr.rank - full).max())
        if not gap <= 1e-5:
            raise AssertionError(f"{label}: fused PageRank {gap} from a full "
                                 "recompute (band 1e-5)")
        rec = dict(pagerank_gap=gap, pagerank_iters=int(it))
        if last:
            d, _ = apps.sssp(ga, root)
            if not np.array_equal(svc.sssp_fused.dist, d.cpu().numpy()):
                raise AssertionError(f"{label}: fused SSSP differs from a "
                                     "full recompute (must be bitwise)")
            rec["sssp_bitwise"] = True
        del ga, snap
        gc.collect()
        torch.cuda.empty_cache()
        rec["seconds"] = time.perf_counter() - t
        log(f"  {label}: fused PageRank within {gap:.3g} of a full recompute "
            f"on flat ({it} iterations, tol 1e-10)"
            + ("; fused SSSP bitwise equal to apps.sssp" if last else "")
            + f" ({rec['seconds']:.1f} s)")
        return rec

    def batch(size, draw_s, a_s, a_d, a_w, d_s=None, d_d=None):
        """One ingest and every consumer's refresh, checked; its record.
        ``ingest_s`` is the deployment's: ``IngestStats.total_seconds``
        less the comparison consumers' folds (``extra_folds_s``)."""
        n0 = len(tr.events)
        st = svc.ingest(add_src=a_s, add_dst=a_d, add_w=a_w,
                        del_src=d_s, del_dst=d_d)
        spans = _span_seconds(tr.events[n0:])
        ingest_s = st.total_seconds - svc.on_apply_s
        rec = dict(size=size, batch=st.batch_index, draw_s=draw_s,
                   apply_s=st.apply_seconds, folds_s=spans["stream.refresh"],
                   regroup_s=st.regroup_seconds,
                   moved=st.moved_vertices, compacted=st.compacted,
                   ingest_s=ingest_s,
                   edges_per_s=(st.inserted + st.deleted) / ingest_s,
                   extra_folds_s=svc.on_apply_s,
                   ingest_total_s=st.total_seconds)
        if st.compacted:
            # the service resynced its own PageRank; the unfused consumer
            # sheds its noise the same way
            svc.pr_flat.resync()
            rec["compact_s"] = spans["stream.compact"]
        resync = svc.pr._needs_full_residual
        (_, rec["pr_fused_s"], rec["pr_fused_launches"],
         pr_tiles_s) = refresh(
            svc.pagerank, lambda: svc.pr.last_iters + resync, True)
        rec["pr_fused_iters"] = svc.pr.last_iters
        _, rec["pr_flat_s"], _, _ = refresh(svc.pr_flat.query, None, False)
        rec["pr_flat_iters"] = svc.pr_flat.last_iters
        d_u, rec["sssp_flat_s"], _, _ = refresh(lambda: svc.sssp(root), None,
                                                False)
        (d_f, rec["sssp_fused_s"], rec["sssp_fused_launches"],
         sssp_tiles_s) = refresh(svc.sssp_fused.query,
                                 lambda: svc.sssp_fused.last_iters, True)
        rec["tiles_s"] = pr_tiles_s + sssp_tiles_s
        rec["sssp_iters"] = svc.sssp_fused.last_iters
        rec["sssp_full"] = svc.sssp_fused.full_recomputes
        tile_parts(rec)
        if not np.array_equal(d_u, d_f):
            raise AssertionError(f"batch {st.batch_index}: fused SSSP "
                                 "differs from unfused (bitwise)")
        if svc._sssp[root].full_recomputes != rec["sssp_full"]:
            raise AssertionError("SSSP consumers recomputed apart")
        gap = pr_gap(f"batch {st.batch_index}")
        rec.update(pr_gap=gap, pr_gap_v=gap * v)
        log(f"    batch {st.batch_index} ({size} edges): ingest "
            f"{rec['ingest_s']:.3f} s (apply {rec['apply_s']:.3f}, folds "
            f"{rec['folds_s']:.3f}, regroup {rec['regroup_s']:.3f}, "
            f"{rec['moved']} moved"
            + (f", compaction {rec['compact_s']:.2f}" if st.compacted else "")
            + f"; the comparison consumers' folds {rec['extra_folds_s']:.3f} "
            f"apart); tiles {rec['tiles_s']:.3f} s (alive "
            f"{rec['alive_s']:.3f}, coo {rec['coo_s']:.4f}); "
            f"PageRank fused {rec['pr_fused_s']:.3f} s "
            f"({rec['pr_fused_iters']} pushes"
            + (" + the resync pull" if resync else "")
            + f", {rec['pr_fused_launches']} K5 launches), unfused "
            f"{rec['pr_flat_s']:.3f} s ({rec['pr_flat_iters']}), "
            f"max|d| {gap:.3g} (x V {gap * v:.3g}; band {pr_band:.3g}); SSSP "
            f"fused "
            f"{rec['sssp_fused_s']:.3f} s ({rec['sssp_iters']} "
            f"iterations, {rec['sssp_fused_launches']} launches), "
            f"unfused {rec['sssp_flat_s']:.3f} s, bitwise equal; "
            f"full SSSP recomputes so far {rec['sssp_full']}")
        return rec

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    svc, dg_s, rest_s = _stream_service(gw, root, device)
    out.update(delta_graph_s=dg_s, service_rest_s=rest_s)
    log(f"  service: DeltaGraph {dg_s:.1f} s, IncrementalDBG and consumers "
        f"{rest_s:.1f} s; StreamConfig {STREAM_CONFIG}")
    stream = ChurnStream(gw, insert_frac=STREAM_INSERT_FRAC, seed=3)
    for tm in timers:
        tm.__enter__()
    tr = obs_trace.enable()
    _reset_launches()
    try:
        # the cold solves (the fused PageRank's first refresh is the resync
        # pull, then the pushes)
        cold = {}
        (_, cold["pr_fused_s"], cold["pr_fused_launches"],
         cold["pr_fused_tiles_s"]) = refresh(
            svc.pagerank, lambda: svc.pr.last_iters + 1, True)
        cold["pr_fused_iters"] = svc.pr.last_iters
        _, cold["pr_flat_s"], _, _ = refresh(svc.pr_flat.query, None, False)
        cold["pr_flat_iters"] = svc.pr_flat.last_iters
        d_u, cold["sssp_flat_s"], _, _ = refresh(lambda: svc.sssp(root),
                                                 None, False)
        d_f, cold["sssp_fused_s"], _, _ = refresh(
            svc.sssp_fused.query, lambda: svc.sssp_fused.last_iters, True)
        cold["sssp_iters"] = svc.sssp_fused.last_iters
        tile_parts(cold)
        if not np.array_equal(d_u, d_f):
            raise AssertionError("cold SSSP: fused differs from unfused")
        gap = pr_gap("cold PageRank")
        cold["pr_fused_vs_flat"] = gap
        out["cold"] = cold
        log(f"  cold solves: PageRank fused {cold['pr_fused_s']:.3f} s "
            f"({cold['pr_fused_iters']} pushes + the resync pull, "
            f"{cold['pr_fused_launches']} K5 launches), unfused "
            f"{cold['pr_flat_s']:.3f} s ({cold['pr_flat_iters']} pushes), "
            f"max|d| {gap:.3g} (band {pr_band:.3g}); SSSP unfused "
            f"{cold['sssp_flat_s']:.3f} s, "
            f"fused {cold['sssp_fused_s']:.3f} s ({cold['sssp_iters']} "
            f"iterations), bitwise equal; the tiles built in "
            f"{cold['pr_fused_tiles_s']:.2f} s")

        records, checks, push_device = [], [], None
        for size in STREAM_SIZES:
            for i in range(STREAM_BATCHES):
                t = time.perf_counter()
                a_s, a_d, d_s, d_d = stream.next_batch(svc.dg, size)
                a_w = stream.weights(a_s.shape[0])
                records.append(batch(size, time.perf_counter() - t,
                                     a_s, a_d, a_w, d_s, d_d))
                if size == STREAM_SIZES[-1] and i == STREAM_BATCHES - 2:
                    # before the compacting batch, while the delta is full;
                    # its launches and tiles are not the drive's
                    counts = _read_launches()
                    push_device = _stream_push_device(svc.dg, device)
                    for name, (fn, _, _) in _wrappers().items():
                        fn.launches = counts[name]
                    for tm in timers:
                        tm.take()
            if size != STREAM_SIZES[-1]:
                checks.append(full_check(f"after the {size}-edge series"))
        compacted = [r["batch"] for r in records if r["compacted"]]
        if compacted != [records[-1]["batch"]] or svc.compactions != 1:
            raise AssertionError(f"compactions at batches {compacted}: only "
                                 "the final batch must compact")
        # every churn batch deletes a tight edge, so each SSSP refresh above
        # is a full recompute; with no deletion both consumers relax from
        # the new edges alone
        t = time.perf_counter()
        a_s, a_d = stream.inserts(STREAM_INSERT_ONLY)
        a_w = stream.weights(a_s.shape[0])
        full0 = svc.sssp_fused.full_recomputes
        ins = batch(STREAM_INSERT_ONLY, time.perf_counter() - t, a_s, a_d,
                    a_w)
        if ins["sssp_full"] != full0 or not ins["sssp_iters"]:
            raise AssertionError(
                f"insert-only batch: {ins['sssp_full'] - full0} full SSSP "
                f"recomputes, {ins['sssp_iters']} relaxation iterations "
                "(want 0 and at least 1)")
        checks.append(full_check(f"after the {STREAM_SIZES[-1]}-edge series "
                                 "and the insert-only batch", last=True))
        stream_launches = _read_launches()
    finally:
        obs_trace.disable()
        for tm in timers:
            tm.__exit__(sys.exc_info()[0])
    t = time.perf_counter()
    loc = svc.locality()
    loc_s = time.perf_counter() - t
    out.update(records=records, insert_only_batch=ins, checks=checks,
               push_device=push_device, locality=loc, locality_s=loc_s,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=stream_launches)
    out["series"] = {}
    for size in STREAM_SIZES:
        rs = [r for r in records if r["size"] == size]
        out["series"][size] = ser = {k: _median_span([r[k] for r in rs])
                                     for k in STREAM_KEYS}
        log(f"  {size}-edge series, median [min-max] of {len(rs)} batches: "
            + "; ".join(f"{k} {ser[k]['median']:.4g} [{ser[k]['min']:.4g}-"
                        f"{ser[k]['max']:.4g}]" for k in STREAM_KEYS))
    last = records[-1]
    log(f"  compaction (batch {last['batch']}): {last['compact_s']:.2f} s; "
        f"the resync refresh {last['pr_fused_s']:.2f} s (tiles rebuilt in "
        f"{last['tiles_s']:.2f} s); insert-only batch: SSSP relaxed in "
        f"{ins['sssp_iters']} iterations, fused {ins['sssp_fused_s']:.3f} s, "
        f"unfused {ins['sssp_flat_s']:.3f} s, no full recompute; locality() "
        f"{loc_s:.1f} s: MPKA "
        + "; ".join(f"{k} " + ", ".join(f"{lv} {x:.2f}" for lv, x in m.items())
                    for k, m in loc.items()))
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _stream_push_device(dg, device):
    """One fused push (base + delta, sum, ``init``) and one unfused push of
    the same function on the device alone, each checked twice bitwise and
    against each other in the sum band, beside the fused push's bound (the
    real lanes' bytes at ``HBM_BYTES_PER_S``, or its operations if more;
    ``padded_bound_ms`` prices ``fused_edge_map_bytes``' padded planes).
    ``x`` is a PageRank contribution (``rand / out-degree``), ``init`` of
    the same order, so every row's value stands above the band."""
    import torch

    from repro_torch.kernels.edge_map import fused_edge_map_bytes
    from repro_torch.stream import incremental

    base, delta = incremental.stream_push_tiles(dg, device=device)
    sa = incremental.stream_arrays(dg, device)
    v = dg.num_vertices
    gen = torch.Generator(device=device).manual_seed(4)
    out_deg = torch.from_numpy(dg.out_deg).to(device).clamp(min=1)
    x = torch.rand(v, generator=gen, device=device) / out_deg
    init = torch.rand(v, generator=gen, device=device)

    def fused():
        return incremental.edge_map_push_stream_fused(base, delta, x, v,
                                                      init=init)

    def flat():
        return incremental.edge_map_push_stream(sa, x, init=init)

    n0 = _ell_launches()
    a = fused()
    launches = _ell_launches() - n0
    b, c, d = fused(), flat(), flat()
    if not (torch.equal(a, b) and torch.equal(c, d)):
        raise AssertionError("a stream push differs between two calls")
    err = _assert_close(a, c, "sum", "fused vs unfused stream push")
    band = 2e-6 * (1.0 + float(c.abs().max()))
    padded = fused_edge_map_bytes(base, v, push_init=True, extra_tiles=delta)
    edges = sum(int(t.deg.sum()) for t in base + delta)
    # what K5 must move at the least: the real lanes' ids and alive bytes,
    # deg, init and y per row, x once
    real = v * 4 + sum(int(t.deg.sum()) * (t.idx.element_size() + 1)
                       + t.idx.shape[0] * 12 for t in base + delta)
    bound_bytes_ms = real / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = edges / FP32_OPS_PER_S * 1e3
    rec = dict(
        launches=launches, delta_rows=int(delta[0].num_rows) if delta else 0,
        delta_shape=tuple(delta[0].idx.shape) if delta else None,
        delta_edges=int(delta[0].deg.sum()) if delta else 0,
        base_classes=len(base), max_abs_err=err, band=band,
        min_abs_y=float(c.abs().min()), max_abs_y=float(c.abs().max()),
        fused_device_ms=_events_ms(fused, REPS, device_only=True),
        flat_device_ms=_events_ms(flat, REPS, device_only=True),
        fused_ms=_events_ms(fused, REPS), flat_ms=_events_ms(flat, REPS),
        bound_ms=max(bound_bytes_ms, bound_ops_ms),
        bound_by="bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        bound_bytes=real, padded_bound_ms=padded / HBM_BYTES_PER_S * 1e3,
        padded_bytes=padded)
    log(f"  one push on the device alone (base {len(base)} classes with "
        f"alive planes + a delta tile {rec['delta_shape']}, "
        f"{rec['delta_edges']} lanes; {launches} K5 launches): fused "
        f"{rec['fused_device_ms']:.4f} ms (idle device "
        f"{rec['fused_ms']:.4f}), unfused {rec['flat_device_ms']:.4f} ms "
        f"(idle {rec['flat_ms']:.4f}), bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}: {real} B over the real lanes, {edges} edges; "
        f"{rec['padded_bound_ms']:.4f} ms over the padded planes, {padded} "
        f"B); both twice bitwise, max |err| {err:.3g} against a band of "
        f"{band:.3g} (|y| {rec['min_abs_y']:.3g} to {rec['max_abs_y']:.3g})")
    return rec


# ---------------------------------------------------------------- phase 11
def measure_hw(device):
    """The card's memory rate and float32 rate, as the port's ``"h100"``
    roofline profile holds them: a timed device-to-device copy of
    ``HW_COPY_BYTES`` (bytes read + written over its time) and a timed
    float32 ``torch.matmul`` of ``HW_MATMUL_N``^3 with TF32 off (2 n^3
    operations over its time), each the median of ``REPS`` event-timed
    calls."""
    import torch

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls must not run in TF32")
    n = HW_COPY_BYTES // 4
    a = torch.ones(n, dtype=torch.float32, device=device)
    b = torch.empty_like(a)
    copy_ms = _events_ms(lambda: b.copy_(a), REPS)
    if not torch.equal(a[:1024], b[:1024]):
        raise AssertionError("the timed copy did not copy")
    del a, b
    m = HW_MATMUL_N
    gen = torch.Generator(device=device).manual_seed(5)
    x = torch.rand(m, m, generator=gen, device=device)
    y = torch.rand(m, m, generator=gen, device=device)
    mm_ms = _events_ms(lambda: torch.matmul(x, y), 5)
    del x, y
    torch.cuda.empty_cache()
    return dict(copy_bytes=HW_COPY_BYTES, copy_ms=copy_ms,
                hbm_bw=2 * HW_COPY_BYTES / (copy_ms * 1e-3),
                matmul_n=m, matmul_ms=mm_ms,
                peak_flops=2 * m ** 3 / (mm_ms * 1e-3))


def _sweep_family(g, gw, device, top_k, extras, reps_schedule):
    """``tune.search.sweep`` of PageRank on ``g`` and SSSP on ``gw`` (the
    ``"h100"`` profile), SSSP's switch point refined: the chosen configs by
    app and the audit."""
    from repro_torch.roofline import HW
    from repro_torch.tune import search

    hw = HW.profile("h100")
    configs, audit = {}, {}
    for app, graph in (("pr", g), ("sssp", gw)):
        t = time.perf_counter()
        res = search.sweep(graph, app=app, top_k=top_k, extras=extras,
                           reps_schedule=reps_schedule, hw=hw, device=device)
        sweep_s = time.perf_counter() - t
        chosen, timings = dict(res.chosen), None
        if app == "sssp":
            t = time.perf_counter()
            chosen, timings = search.refine_density_threshold(
                gw, chosen, app="sssp", device=device)
            refine_s = time.perf_counter() - t
        errors = [t.error for t in res.trials if t.error]
        if errors:
            raise AssertionError(f"tune {app}: trials failed: {errors}")
        configs[app] = chosen
        audit[app] = dict(
            chosen=chosen, winner=res.winner, chosen_ms=res.chosen_s * 1e3,
            winner_ms=res.winner_s * 1e3, default_ms=res.default_s * 1e3,
            speedup_vs_default=res.speedup_vs_default, honest=res.honest,
            honest_strict=res.honest_strict,
            num_candidates=res.num_candidates, num_measured=res.num_measured,
            sweep_s=sweep_s,
            trials=[dict(config=t.config, source=t.source,
                         model_bytes=t.model_bytes, feasible=t.feasible,
                         best_ms=t.best_s * 1e3,
                         eliminated_round=t.eliminated_round)
                    for t in res.trials])
        if timings is not None:
            audit[app].update(density_ms={str(k): s * 1e3
                                          for k, s in timings.items()},
                              refine_s=refine_s)
        log(f"  tune {app}: {res.num_measured} of {res.num_candidates} "
            f"candidates measured in {sweep_s:.1f} s; winner {res.winner} "
            f"{res.winner_s * 1e3:.3f} ms; chosen {chosen} "
            f"{res.chosen_s * 1e3:.3f} ms (default "
            f"{res.default_s * 1e3:.3f} ms, x{res.speedup_vs_default:.3f}); "
            f"honest {res.honest}, honest_strict {res.honest_strict}"
            + ("" if timings is None else
               "; switch points " + ", ".join(
                   f"{k} {s * 1e3:.3f} ms" for k, s in sorted(timings.items()))
               + f" ({refine_s:.1f} s)"))
        for tr in audit[app]["trials"]:
            log(f"    {tr['source']:9s} {tr['config']}: {tr['model_bytes']} "
                f"B{'' if tr['feasible'] else ' (over budget)'}, best "
                f"{tr['best_ms']:.3f} ms, eliminated "
                f"{tr['eliminated_round']}")
    return configs, audit


def tune_on_card(gw_serve, device):
    """The reference's tuning workflow on the card, for two families.

    ``kr`` at ``TUNE_SCALE`` (the registry graph, as the reference tunes):
    ``sweep`` with ``top_k=3``, ``extras=1``, ``reps_schedule=(1, 3)``, the
    other apps by least modeled bytes, every distinct chosen backend held
    to ``flat`` (SSSP bitwise, PageRank in phase 4's band).  Then the
    served graph ``gw_serve`` itself (``top_k=2``, ``extras=1``, one round:
    a candidate's build at 2^21 costs seconds), PageRank and SSSP only:
    the card's sweep at ``TUNE_SCALE`` picks ``flat`` (its launches per
    iteration outweigh the pull there), which phase 4 measures 4x slower
    than ``ell`` at 2^21, so the served graph's nearest family must be its
    own.  Its backends are held to ``flat`` by ``serving_plane``.  The plan
    of both families is set active.  Returns the audit record."""
    from repro_torch import apps
    from repro_torch.graph import datasets
    from repro_torch.roofline import HW
    from repro_torch.tune import cost, plan, space

    t_all = time.perf_counter()
    g = datasets.load("kr", TUNE_SCALE)
    gw = datasets.load_weighted("kr", TUNE_SCALE)
    hw = HW.profile("h100")
    log(f"  tune: kr at {TUNE_SCALE} scale, V={g.num_vertices} "
        f"E={g.num_edges} (generated in {time.perf_counter() - t_all:.1f} "
        f"s); profile {hw}")
    configs, audit = _sweep_family(g, gw, device, 3, 1, (1, 3))
    grid = space.engine_space().grid()
    for app in ("prd", "bc", "radii"):  # priced only, least modeled bytes
        ranked = cost.rank(cost.GraphCost.from_graph(g), grid, app=app, hw=hw)
        configs[app] = dict(min(ranked, key=lambda s: (
            s.model_bytes, cost.config_key(s.config))).config)
    configs["default"] = dict(configs["pr"])
    # every distinct backend the registry family serves, held to flat
    t = time.perf_counter()
    flat, flat_w = (apps.to_arrays(x, device=device) for x in (g, gw))
    pr_want, _ = apps.pagerank(flat)
    d_want, _ = apps.sssp(flat_w, 0)
    verified = {}
    for cfg in configs.values():
        eng = space.split_config(cfg)[0]
        key = cost.config_key(eng)
        if key in verified:
            continue
        kw = dict(eng)
        name = kw.pop("backend")
        ga = apps.to_arrays(g, backend=name, device=device, **kw)
        gaw = apps.to_arrays(gw, backend=name, device=device, **kw)
        pr, _ = apps.pagerank(ga)
        d, _ = apps.sssp(gaw, 0)
        if not _same(d, d_want):
            raise AssertionError(f"tune: {eng} SSSP differs from flat")
        verified[key] = _rank_gap(pr, pr_want, f"tune {eng} PageRank")
        del ga, gaw
    del flat, flat_w
    audit["verified"] = verified
    audit["verify_s"] = time.perf_counter() - t
    log(f"  tune: kr at {TUNE_SCALE}: {configs}; {len(verified)} backends "
        f"held to flat (SSSP bitwise, worst PageRank gap "
        f"{max(verified.values()):.3g} of the band) in "
        f"{audit['verify_s']:.1f} s")
    t = time.perf_counter()
    log(f"  tune: the served graph, V={gw_serve.num_vertices} "
        f"E={gw_serve.num_edges}")
    served, audit["served"] = _sweep_family(gw_serve, gw_serve, device, 2, 1,
                                            (1,))
    served["default"] = dict(served["pr"])
    audit["served_s"] = time.perf_counter() - t
    cells = [{"family": f"kr-{TUNE_SCALE}", "features": plan.graph_features(g),
              "configs": configs},
             {"family": "kr-served", "configs": served,
              "features": plan.graph_features(gw_serve)}]
    p = plan.build_plan(cells, meta={"scale": TUNE_SCALE, "profile": hw.name})
    plan.set_active_plan(p)
    audit.update(configs=configs, served_configs=served,
                 features=plan.graph_features(g),
                 served_features=plan.graph_features(gw_serve),
                 seconds=time.perf_counter() - t_all)
    log(f"  tune: the served graph's family {served} "
        f"({audit['served_s']:.1f} s); the tune took "
        f"{audit['seconds']:.1f} s")
    return audit


def _serve_roots(v, kind, n):
    """The seeded roots of ``n`` queries of ``kind``: the same for every
    width, so each lane has its K = 1 twin."""
    import numpy as np

    seed = {"sssp": 17, "pagerank": 18}[kind]
    return [int(r) for r in np.random.default_rng(seed).integers(0, v, n)]


def _rewidth(svc, k):
    """``svc`` admitting batches of width ``k`` (``max_depth`` 4k), with
    fresh admission counters and serving metrics; its stream plane, store
    and snapshots stay."""
    import dataclasses

    from repro_torch.serve import QueryQueue, ServeMetrics

    svc.config = dataclasses.replace(svc.config, max_width=k,
                                     max_depth=4 * k)
    svc.queue = QueryQueue(max_width=k, max_depth=4 * k,
                           deadline=svc.config.deadline, clock=svc._clock)
    svc.metrics = ServeMetrics(k)


def _serve_workload(svc, k, roots, qroot):
    """``SERVE_QUERIES`` queries in bursts that alternate ``k`` SSSP roots
    with ``k`` one-hot PageRank roots, each burst drained; the results in
    order and the seconds.  ``qroot`` maps each qid to its root."""
    from repro_torch.serve import Query

    taken = {"sssp": 0, "pagerank": 0}
    out, burst = [], 0
    t = time.perf_counter()
    while len(out) < SERVE_QUERIES:
        kind = "sssp" if burst % 2 == 0 else "pagerank"
        for _ in range(min(k, SERVE_QUERIES - len(out))):
            root = roots[kind][taken[kind]]
            taken[kind] += 1
            qroot[svc.submit(Query(kind, root=root))] = root
        out.extend(svc.drain())
        burst += 1
    _sync()
    return out, time.perf_counter() - t


def serving_plane(gw, device):
    """Phase 11, the serving plane at the main path's size: a tuned plan
    from the card, ``GraphServeService(backend="auto")`` on phase 4's
    weighted DBG graph answering ``SERVE_QUERIES`` queries at each width of
    ``SERVE_WIDTHS`` on version 0 (one K5 pass per iteration over the
    (V, K) plane), then ``SERVE_CHURN_BURSTS`` bursts of churn on O(delta)
    versions, snapshot isolation checked; then K5 over a (V, 8) plane
    timed.  Returns the ``serve`` JSON record; its ``launches`` are those of
    the service's own calls (the workloads, the uniform lane's batch, the
    churn's ingests and drains), not of the tune or the checks between
    them, which launch the same kernels."""
    import gc

    import numpy as np
    import torch

    from repro_torch import apps
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve import GraphServeService, Query, ServeConfig

    t_phase = time.perf_counter()
    out = {}
    out["hw"] = hw = measure_hw(device)
    from repro_torch.roofline import HW

    prof = HW.profile("h100")
    log(f"  the card's rates: copy of {hw['copy_bytes'] / 2**30:.0f} GiB "
        f"{hw['copy_ms']:.3f} ms = {hw['hbm_bw'] / 1e12:.4f} TB/s (profile "
        f"{prof.hbm_bw / 1e12:.4f}); float32 matmul {hw['matmul_n']}^3 "
        f"{hw['matmul_ms']:.3f} ms = {hw['peak_flops'] / 1e12:.3f} TFLOP/s "
        f"(profile {prof.peak_flops / 1e12:.3f}; TF32 off)")
    out["tune"] = tune_on_card(gw, device)
    gc.collect()
    torch.cuda.empty_cache()

    v = gw.num_vertices
    cfg = ServeConfig(backend="auto", max_width=max(SERVE_WIDTHS),
                      max_depth=4 * max(SERVE_WIDTHS), pr_max_iters=15,
                      publish_every=1, incremental_publish=True)
    t = time.perf_counter()
    svc = GraphServeService(gw, cfg, device=device)
    out["service_s"] = time.perf_counter() - t
    log(f"  service: built in {out['service_s']:.1f} s (the stream plane's "
        f"DeltaGraph and consumers, version 0 materialized); {cfg}")
    roots = {kind: _serve_roots(v, kind, SERVE_QUERIES)
             for kind in ("sssp", "pagerank")}
    tr = obs_trace.enable()
    _reset_launches()
    launches = {}  # the service's own calls only
    snap0 = svc.store.acquire()
    widths, single, k1_lanes = [], {}, {}
    try:
        for k in SERVE_WIDTHS:
            _rewidth(svc, k)
            qroot = {}
            n0 = len(tr.events)
            (warm, warm_s), _ = _launched(launches, _serve_workload, svc, k,
                                          roots, qroot)
            builds = [e for e in tr.events[n0:] if e["ph"] == "X"
                      and e["name"] == "engine.build_backend"]
            _rewidth(svc, k)
            qroot = {}
            n0 = len(tr.events)
            (res, secs), made = _launched(launches, _serve_workload, svc, k,
                                          roots, qroot)
            spans = [e for e in tr.events[n0:] if e["ph"] == "X"]
            solve = [e["dur"] / 1e6 for e in spans
                     if e["name"].startswith("engine.solve.")]
            summ = svc.metrics.summary()
            rec = dict(
                width=k, queries=len(res), seconds=secs, qps=len(res) / secs,
                warm_seconds=warm_s, build_s=sum(e["dur"] for e in builds)
                / 1e6, latency_p50_ms=summ["latency_p50_ms"],
                latency_p99_ms=summ["latency_p99_ms"],
                occupancy=summ["occupancy"], batches=summ["batches"],
                batch_ms_mean=summ["batch_ms_mean"],
                solve_ms_mean=1e3 * sum(solve) / len(solve),
                iters_sssp=float(np.mean([r.iters for r in res
                                          if r.kind == "sssp"])),
                iters_pagerank=float(np.mean([r.iters for r in res
                                              if r.kind == "pagerank"])),
                launches=made)
            if rec["launches"]["ell_edge_map"] == 0:
                raise AssertionError(f"serve K={k}: K5 was never launched")
            if any(r.snapshot_version != 0 for r in res):
                raise AssertionError("serve: a version-0 query saw another")
            # every SSSP lane bitwise against apps.sssp on the same resolved
            # backend, with the same iteration count; every PageRank lane
            # against its K = 1 twin
            ga_s = svc._backend(snap0, "sssp")
            thr = svc._sssp_threshold(snap0)
            gaps = []
            for r in res:
                root = qroot[r.qid]
                if r.kind == "sssp":
                    if root not in single:
                        d, it = apps.sssp(ga_s, root, density_threshold=thr)
                        single[root] = (d.cpu().numpy(), it)
                    d, it = single[root]
                    if not np.array_equal(r.value, d) or r.iters != it:
                        raise AssertionError(
                            f"serve K={k}: SSSP lane from {root} differs "
                            f"from apps.sssp ({r.iters} vs {it} iterations)")
                elif k == 1:
                    k1_lanes[root] = r
                else:
                    twin = k1_lanes[root]
                    gaps.append(_rank_gap(torch.from_numpy(r.value),
                                          torch.from_numpy(twin.value),
                                          f"serve K={k} PageRank lane"))
                    if abs(r.iters - twin.iters) > 1:
                        raise AssertionError(
                            f"serve K={k}: PageRank lane iterations "
                            f"{r.iters} vs {twin.iters} at K = 1")
            rec["pagerank_gap"] = max(gaps, default=0.0)
            widths.append(rec)
            log(f"  serve K={k}: {rec['queries']} queries in "
                f"{secs:.3f} s = {rec['qps']:.2f} QPS (warm run "
                f"{warm_s:.2f} s" + (f", backend builds {rec['build_s']:.1f}"
                                     " s" if builds else "")
                + f"); latency p50 {rec['latency_p50_ms']:.1f} ms, p99 "
                f"{rec['latency_p99_ms']:.1f} ms; occupancy "
                f"{rec['occupancy']:.3f}; {rec['batches']} batches, "
                f"{rec['batch_ms_mean']:.2f} ms each (engine.solve "
                f"{rec['solve_ms_mean']:.2f} ms); iterations SSSP "
                f"{rec['iters_sssp']:.1f}, PageRank "
                f"{rec['iters_pagerank']:.1f}; K5 launches "
                f"{rec['launches']['ell_edge_map']}; SSSP lanes bitwise "
                f"equal to apps.sssp"
                + ("" if k == 1 else f", PageRank lanes within "
                   f"{rec['pagerank_gap']:.3g} of the band of their K = 1 "
                   "twins"))
        # one uniform lane against apps.pagerank, in a batch of one-hot ones
        k = max(SERVE_WIDTHS)
        qids = [svc.submit(Query("pagerank"))] + [
            svc.submit(Query("pagerank", root=r))
            for r in roots["pagerank"][:k - 1]]
        res = {r.qid: r for r in _launched(launches, svc.drain)[0]}
        ga_p = svc._backend(snap0, "pagerank")
        want, it = apps.pagerank(ga_p, max_iters=cfg.pr_max_iters,
                                 tol=cfg.pr_tol)
        uni = res[qids[0]]
        out["uniform_gap"] = _rank_gap(torch.from_numpy(uni.value),
                                       want.cpu(), "serve uniform lane")
        if abs(uni.iters - it) > 1:
            raise AssertionError(f"serve uniform lane: {uni.iters} "
                                 f"iterations vs {it}")
        out["backends"] = {kind: type(svc._backend(snap0, kind)).__name__
                           for kind in ("pagerank", "sssp")}
        log(f"  a uniform lane among {k - 1} one-hot ones: within "
            f"{out['uniform_gap']:.3g} of the band of apps.pagerank "
            f"({uni.iters} vs {it} iterations); backends {out['backends']}")
        out["widths"] = widths
        out["churn"] = _serve_churn(svc, gw, device, tr, launches)
        # the served family's backends held to flat, as the tune holds the
        # registry family's: SSSP bitwise, PageRank in phase 4's band
        flat = apps.to_arrays(gw, device=device)
        d_a, _ = apps.sssp(ga_s, 0, density_threshold=thr)
        d_f, _ = apps.sssp(flat, 0)
        if not torch.equal(d_a, d_f):
            raise AssertionError("serve: the served SSSP backend differs "
                                 "from flat (must be bitwise)")
        out["served_vs_flat_gap"] = _rank_gap(
            apps.pagerank(ga_p)[0], apps.pagerank(flat)[0],
            "serve: the served PageRank backend vs flat")
        log(f"  the served backends vs flat: SSSP bitwise, PageRank within "
            f"{out['served_vs_flat_gap']:.3g} of the band")
        out["plane"] = time_plane(ga_p, ga_s, flat, max(SERVE_WIDTHS),
                                  device)
        del flat
    finally:
        obs_trace.disable()
        svc.store.release(snap0)
    del svc, ga_s, ga_p, single, k1_lanes
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _serve_churn(svc, gw, device, tr, launches):
    """``SERVE_CHURN_BURSTS`` bursts on ``svc`` (width 8): each ingests one
    ``ChurnStream`` batch of ``SERVE_CHURN_EDGES`` (seed 3), which publishes
    an O(delta) version, submits 8 mixed queries and drains.  Every version
    is pinned; the first and the last churned versions are forced
    (``Snapshot.graph``, O(E)) and one SSSP answer re-solved on ``flat``
    (bitwise), one PageRank answer too (phase 4's band).

    The ingest's seconds run to the device's end (synchronized after the
    call).  The publish's are read from the trace ``tr`` without touching
    the path: the ``serve.ingest`` span less the ``stream.ingest`` span in
    it, the host time of ``_publish`` (``StreamBackend.from_delta``).  The
    ingests' and drains' launches are added into ``launches``."""
    import numpy as np
    import torch

    from repro_torch import apps
    from repro_torch.serve import Query, batched
    from repro_torch.stream import StreamBackend

    k = max(SERVE_WIDTHS)
    _rewidth(svc, k)
    stream = ChurnStream(gw, insert_frac=STREAM_INSERT_FRAC, seed=3)
    rng = np.random.default_rng(19)
    v = gw.num_vertices
    pins, results, qroot, ingest_s, publish_s = {}, [], {}, [], []
    t_all = time.perf_counter()
    for burst in range(SERVE_CHURN_BURSTS):
        a_s, a_d, d_s, d_d = stream.next_batch(svc.stream.dg,
                                               SERVE_CHURN_EDGES)
        a_w = stream.weights(a_s.shape[0])
        ver, n0 = svc.snapshot_version, len(tr.events)
        t = time.perf_counter()
        _launched(launches, svc.ingest, add_src=a_s, add_dst=a_d, add_w=a_w,
                  del_src=d_s, del_dst=d_d)
        _sync()
        ingest_s.append(time.perf_counter() - t)
        dur = {e["name"]: e["dur"] for e in tr.events[n0:] if e["ph"] == "X"
               and e["name"] in ("serve.ingest", "stream.ingest")}
        publish_s.append((dur["serve.ingest"] - dur["stream.ingest"]) / 1e6)
        snap = pins[svc.snapshot_version] = svc.store.acquire()
        if svc.snapshot_version != ver + 1 or not isinstance(
                snap._cache.get("backend:stream"), StreamBackend):
            raise AssertionError(f"churn: burst {burst} published no "
                                 "O(delta) version")
        for i in range(k):
            kind = "sssp" if i % 2 == 0 else "pagerank"
            root = int(rng.integers(0, v))
            qroot[svc.submit(Query(kind, root=root))] = root
        got, _ = _launched(launches, svc.drain)
        if {r.snapshot_version for r in got} != {svc.snapshot_version}:
            raise AssertionError("churn: a burst's answers span versions")
        results.extend(got)
    _sync()
    total_s = time.perf_counter() - t_all
    versions = sorted(pins)
    checks = []
    for ver in (versions[0], versions[-1]):
        t = time.perf_counter()
        snap = pins[ver]
        if snap.materialized:
            raise AssertionError(f"churn: version {ver} was materialized "
                                 "before a reader forced it")
        ga = apps.to_arrays(snap.graph, device=device)
        mine = [r for r in results if r.snapshot_version == ver]
        rs = next(r for r in mine if r.kind == "sssp")
        d, _ = apps.sssp(ga, qroot[rs.qid])
        if not np.array_equal(d.cpu().numpy(), rs.value):
            raise AssertionError(f"churn: version {ver}'s SSSP answer "
                                 "differs from a re-solve on flat")
        rp = next(r for r in mine if r.kind == "pagerank")
        p = torch.zeros((v, 1), dtype=torch.float32, device=device)
        p[qroot[rp.qid], 0] = 1.0
        want, _ = batched.batched_pagerank(ga, p, max_iters=15)
        gap = _rank_gap(torch.from_numpy(rp.value), want[:, 0].cpu(),
                        f"churn version {ver} PageRank")
        checks.append(dict(version=ver, pagerank_gap=gap,
                           seconds=time.perf_counter() - t))
        del ga
        log(f"  churn version {ver}: forced (O(E)); SSSP from "
            f"{qroot[rs.qid]} bitwise equal to a re-solve on flat, PageRank "
            f"from {qroot[rp.qid]} within {gap:.3g} of the band "
            f"({checks[-1]['seconds']:.1f} s)")
    for snap in pins.values():
        svc.store.release(snap)
    health = svc.health()
    summ = svc.metrics.summary()
    rec = dict(bursts=SERVE_CHURN_BURSTS, edges=SERVE_CHURN_EDGES,
               queries=len(results), seconds=total_s,
               qps=len(results) / total_s, ingest_s=ingest_s,
               publish_s=publish_s, latency_p50_ms=summ["latency_p50_ms"],
               latency_p99_ms=summ["latency_p99_ms"],
               batch_ms_mean=summ["batch_ms_mean"], checks=checks,
               versions=versions, health=health,
               live_versions=svc.store.live_versions)
    med = _median_span(ingest_s)
    pub = _median_span(publish_s)
    log(f"  churn: {SERVE_CHURN_BURSTS} bursts of {SERVE_CHURN_EDGES} edges "
        f"+ {k} queries: {rec['queries']} queries in {total_s:.2f} s = "
        f"{rec['qps']:.2f} QPS; ingest {med['median']:.3f} "
        f"[{med['min']:.3f}-{med['max']:.3f}] s per burst (to the device's "
        f"end), of which the O(delta) publish (the serve.ingest span less "
        f"its stream.ingest, host) {pub['median']:.4f} "
        f"[{pub['min']:.4f}-{pub['max']:.4f}] s; latency p50 "
        f"{rec['latency_p50_ms']:.1f} ms, p99 {rec['latency_p99_ms']:.1f} "
        f"ms; health {health['status']} {health['queue']} "
        f"{health['snapshots']}")
    return rec


def time_plane(ga, ga_w, flat, k, device):
    """K5 over a (V, ``k``) plane at the serving graph: one pull of
    ``batched_pagerank``'s shape (``x`` = rand / out-degree) on ``ga``'s
    tiles, from an idle device and on the device alone, beside ``k`` pulls
    of one column each, cuSPARSE SpMM of the in-CSR by the plane, and the
    bound (the real lanes' ids and ``deg`` once, the plane read once, ``y``
    written once); checked against the plain version in the sum band and
    twice bitwise.  Then one ``batched_sssp`` push step at width ``k`` on
    ``ga_w`` (the frontier of its third iteration), timed the same way,
    checked against ``flat`` (the serving graph's ``FlatBackend``, whose
    in-CSR the library call reads too) bitwise and twice bitwise; it has no
    library call."""
    import torch

    from repro_torch.serve import batched

    v = ga.num_vertices
    tiles = ga.in_tiles
    gen = torch.Generator(device=device).manual_seed(6)
    x = (torch.rand(v, k, generator=gen, device=device)
         / ga.out_deg.clamp(min=1)[:, None])
    cols = [x[:, j].contiguous() for j in range(k)]

    def pull(x):
        return ga.pull(x, reduce="sum")

    n0 = _ell_launches()
    got = pull(x)
    launches = _ell_launches() - n0
    if not torch.equal(got, pull(x)):
        raise AssertionError("the (V, K) pull differs between two calls")
    want = torch.zeros_like(got)
    for t in tiles:
        want[t.rows] = _plain(x, t.idx, t.deg)[: t.num_rows]
    err = _assert_close(got, want, "sum", f"(V, {k}) pull vs plain")
    band = 2e-6 * (1.0 + float(want.abs().max()))
    col_err = max(float((got[:, j] - pull(c)).abs().max())
                  for j, c in enumerate(cols))
    ms = _events_ms(lambda: pull(x), REPS)
    device_ms = _events_ms(lambda: pull(x), REPS, device_only=True)
    cols_ms = _events_ms(lambda: [pull(c) for c in cols], REPS)
    cols_device_ms = _events_ms(lambda: [pull(c) for c in cols], REPS,
                                device_only=True)
    g = flat.ga
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(g.in_ptr, g.in_src,
                                      torch.ones_like(g.in_w), size=(v, v),
                                      check_invariants=False)
        lib = csr @ x
        lib_err = float((lib - got).abs().max())
        library_ms = _events_ms(lambda: csr @ x, REPS)
        library_device_ms = _events_ms(lambda: csr @ x, REPS, True)
    edges = sum(int(t.deg.sum()) for t in tiles)
    need = v * 4 * k + sum(int(t.deg.sum()) * t.idx.element_size()
                           + t.num_rows * 4 * (1 + k) for t in tiles)
    bound_bytes_ms = need / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = edges * k / FP32_OPS_PER_S * 1e3
    rec = dict(k=k, backend=type(ga).__name__, launches=launches,
               ms=ms, device_ms=device_ms, k1x8_ms=cols_ms,
               k1x8_device_ms=cols_device_ms, library_ms=library_ms,
               library_device_ms=library_device_ms,
               library_max_abs_err=lib_err, column_max_abs_err=col_err,
               bound_ms=max(bound_bytes_ms, bound_ops_ms),
               bound_by=("bytes" if bound_bytes_ms >= bound_ops_ms
                         else "operations"),
               bound_bytes=need, max_abs_err=err, band=band,
               plane_bytes=v * 4 * k)
    log(f"  K5 over a (V, {k}) plane ({rec['backend']}, {len(tiles)} "
        f"classes, {launches} launches): {ms:.4f} ms (device alone "
        f"{device_ms:.4f}); {k} pulls of one column {cols_ms:.4f} ms "
        f"(device alone {cols_device_ms:.4f}); cuSPARSE SpMM "
        f"{library_ms:.4f} ms (device alone {library_device_ms:.4f}; max "
        f"|d| {lib_err:.3g}); bound {rec['bound_ms']:.4f} ms ({need} B, "
        f"the plane alone {v * 4 * k} B); max |err| vs plain {err:.3g} "
        f"(band {band:.3g}), twice bitwise; columns vs the plane max |d| "
        f"{col_err:.3g}")

    # one batched_sssp push step at width k, the frontier of iteration 3
    roots = torch.tensor(_serve_roots(v, "sssp", k), device=device)
    d1, _ = batched.batched_sssp(ga_w, roots, max_iters=1)
    d2, _ = batched.batched_sssp(ga_w, roots, max_iters=2)
    frontier = d2 < d1
    inf = float("inf")

    def push(b):
        return b.push(d2, reduce="min", src_frontier=frontier,
                      use_weights=True, neutral=inf, init=d2)

    n0 = _ell_launches()
    got = push(ga_w)
    push_launches = _ell_launches() - n0
    if not (torch.equal(got, push(ga_w)) and torch.equal(got, push(flat))):
        raise AssertionError("the (V, K) SSSP push differs between two calls "
                             "or from flat (must be bitwise)")
    tiles_w = ga_w.in_tiles
    edges_w = sum(int(t.deg.sum()) for t in tiles_w)
    need_w = v * k * 5 + sum(
        int(t.deg.sum()) * (t.idx.element_size() + 4)
        + t.num_rows * 4 * (1 + 2 * k) for t in tiles_w)
    b_bytes = need_w / HBM_BYTES_PER_S * 1e3
    b_ops = 2 * edges_w * k / FP32_OPS_PER_S * 1e3
    rec["sssp_push"] = dict(
        launches=push_launches, frontier_share=float(frontier.float().mean()),
        ms=_events_ms(lambda: push(ga_w), REPS),
        device_ms=_events_ms(lambda: push(ga_w), REPS, device_only=True),
        plain_ms=_events_ms(lambda: push(flat), REPS),
        bound_ms=max(b_bytes, b_ops),
        bound_by="bytes" if b_bytes >= b_ops else "operations",
        bound_bytes=need_w, library_ms=None)
    s = rec["sssp_push"]
    log(f"  one batched_sssp push step at K={k} (frontier "
        f"{s['frontier_share']:.4f} of the (V, K) slots, {push_launches} "
        f"launches): {s['ms']:.4f} ms (device alone {s['device_ms']:.4f}); "
        f"flat {s['plain_ms']:.4f} ms; bound {s['bound_ms']:.4f} ms "
        f"({need_w} B); bitwise equal to flat and twice; no library call "
        "computes it")
    return rec


# ---------------------------------------------------------------- phase 12
def _shard_sizes(sg):
    """Per shard of a layout, from its planes alone: edges held, halo
    entries it receives (the distinct halo slots its edges read), hot
    vertices it owns (its share of the hot panel's all-gather); and the
    layout's totals."""
    import numpy as np

    first_halo = sg.v_blk + sg.hot_cap
    hot_owner = sg.hot_ids[: sg.stats["n_hot"]].astype(np.int64) // sg.v_blk
    per = []
    for i in range(sg.n_shards):
        slots = sg.in_slot[i][sg.in_mask[i]]
        per.append(dict(
            edges=int(slots.shape[0]),
            halo=int(np.unique(slots[slots >= first_halo]).shape[0]),
            hot_owned=int((hot_owner == i).sum())))
    return dict(per_shard=per, n_hot=sg.stats["n_hot"],
                hot_frac=sg.stats["hot_frac"],
                halo_slots=sg.stats["halo_slots"],
                halo_max=sg.stats["halo_max"],
                halo_bytes_padded=sg.stats["halo_bytes_padded"])


def dist_layouts(gw):
    """Phase 12's host layouts of ``gw`` (phase 4's weighted DBG graph),
    built in a thread beside phases 3-11: for ``DIST_SHARDS`` x both
    policies, ``shard_graph``'s host seconds and the per-shard sizes; the
    ``DIST_K5_SHARDS`` replicate_hot layout on ``ell`` is kept for K5's
    check, the others (``flat``, no remap bookkeeping) only measured."""
    from repro_torch.apps import engine
    from repro_torch.dist import graph as dg

    ga = engine.to_arrays(gw, backend="arrays", device="cpu")
    out = {"seconds": {}, "sizes": {}}
    for d in DIST_SHARDS:
        for policy in ("replicate_hot", "partition"):
            keep = d == DIST_K5_SHARDS and policy == "replicate_hot"
            t = time.perf_counter()
            sg = dg.shard_graph(ga, d, policy=policy,
                                backend="ell" if keep else "flat",
                                track_remap=False)
            out["seconds"][f"{d}/{policy}"] = time.perf_counter() - t
            out["sizes"][f"{d}/{policy}"] = _shard_sizes(sg)
            if keep:
                out["sg"] = sg
    return out


def _k5_shard_grid(sg, x, device):
    """K5 against its plain version over every class of every shard's pull
    and push tiles of ``sg`` (unweighted and weighted, sum/min/max), each
    pull table built from the global ``x`` as the exchange delivers it;
    every sum on a class wider than 1,024 lanes twice, bitwise.  Returns
    (calls checked, max |err| of the sums, sums checked twice)."""
    import torch

    from repro_torch.dist.graph import exchange_table
    from repro_torch.kernels.edge_map import ell_edge_map
    from repro_torch.kernels.edge_map.ops import _tile_of

    n, max_err, twice = 0, 0.0, 0
    for i in range(sg.n_shards):
        table = exchange_table(sg, x, i)
        for side, tiles, xs in (("pull", sg.pull_tiles, table),
                                ("push", sg.push_tiles, table[: sg.v_blk])):
            for c, st in enumerate(tiles):
                t = st.shard(i, device)
                r, w = t.idx.shape
                geo = dict(row_tile=_tile_of(r, sg.row_tile),
                           width_tile=_tile_of(w, sg.width_tile))
                for red, weighted in itertools.product(
                        ("sum", "min", "max"), (False, True)):
                    kw = dict(reduce=red, w=t.w if weighted else None,
                              unit_weights=weighted,
                              neutral={"sum": 0.0, "min": float("inf"),
                                       "max": float("-inf")}[red])
                    got = ell_edge_map(xs, t.idx, t.deg, segments=t.segments,
                                       **geo, **kw)
                    what = f"shard {i} {side} class {c} ({r}, {w}) {red}"
                    if red == "sum" and t.segments is not None:
                        again = ell_edge_map(xs, t.idx, t.deg,
                                             segments=t.segments, **geo, **kw)
                        if not torch.equal(got, again):
                            raise AssertionError(f"{what}: two calls differ")
                        twice += 1
                    max_err = max(max_err, _assert_close(
                        got, _plain(xs, t.idx, t.deg, **kw), red, what))
                    n += 1
                del t
    _sync()
    return n, max_err, twice


def _dist_stream(mesh, device, acc):
    """The sharded stream on one rank: a ``ShardedStreamService`` and the
    single-device ``StreamService`` on the registry's ``kr`` at
    ``DIST_STREAM_SCALE`` (weighted), the same ``ChurnStream`` batches (seed
    3) into both; after each, SSSP from three roots bitwise, PageRank
    within ``STREAM_PR_ATOL`` of a full single-device solve of the
    service's snapshot (``apps.pagerank`` on ``flat``, L1 tol 1e-9) and
    within ``STREAM_SERVICE_ATOL`` of the service's incremental PageRank.
    The sharded service's calls add their launches into ``acc``."""
    import numpy as np

    from repro_torch import apps
    from repro_torch.graph import datasets
    from repro_torch.stream import StreamConfig, StreamService
    from repro_torch.stream.sharded import ShardedStreamService

    t0 = time.perf_counter()
    g = datasets.load_weighted("kr", DIST_STREAM_SCALE)
    # no hysteresis: the regroups move vertices, so apply_remaps_to patches
    cfg = StreamConfig(regroup_every=1, hysteresis=0.0)
    single = StreamService(g, cfg, device=device)
    sh, _ = _launched(acc, ShardedStreamService, g, cfg, mesh=mesh,
                      backend="ell")
    rec = dict(vertices=g.num_vertices, edges=g.num_edges,
               batches=DIST_STREAM_BATCHES, edges_per_batch=DIST_STREAM_EDGES,
               build_s=time.perf_counter() - t0, ingest_s=[], pr_gap=[],
               pr_service_gap=[], sssp_roots=0)
    churn = ChurnStream(g, seed=3)
    roots = np.random.default_rng(3).integers(0, g.num_vertices,
                                              3 * DIST_STREAM_BATCHES)
    for b in range(DIST_STREAM_BATCHES):
        a_s, a_d, d_s, d_d = churn.next_batch(single.dg, DIST_STREAM_EDGES)
        kw = dict(add_src=a_s, add_dst=a_d, add_w=churn.weights(len(a_s)),
                  del_src=d_s, del_dst=d_d)
        single.ingest(**kw)
        _sync()
        t = time.perf_counter()
        _launched(acc, sh.ingest, **kw)
        _sync()
        rec["ingest_s"].append(time.perf_counter() - t)
        for root in roots[3 * b: 3 * b + 3].tolist():
            got, _ = _launched(acc, sh.sssp, root)
            if not np.array_equal(got, single.sssp(root)):
                raise AssertionError(f"sharded stream batch {b}: SSSP from "
                                     f"{root} differs (must be bitwise)")
            rec["sssp_roots"] += 1
        pr, _ = _launched(acc, sh.pagerank)
        full, _ = apps.pagerank(apps.to_arrays(single.snapshot(),
                                               backend="flat", device=device),
                                tol=1e-9, max_iters=4096)
        gap = float(np.abs(pr - full.cpu().numpy()).max())
        to_service = float(np.abs(pr - single.pagerank()).max())
        if not (gap <= STREAM_PR_ATOL and to_service <= STREAM_SERVICE_ATOL):
            raise AssertionError(
                f"sharded stream batch {b}: PageRank {gap} from a full solve "
                f"(band {STREAM_PR_ATOL}), {to_service} from the service "
                f"(band {STREAM_SERVICE_ATOL})")
        rec["pr_gap"].append(gap)
        rec["pr_service_gap"].append(to_service)
    h = sh.health()["shard_ingest"]
    rec.update(full_rebuilds=sh.full_rebuilds,
               moved=int(sum(d.num_moved for d in sh.remap_deltas)),
               remap_deltas=len(sh.remap_deltas),
               folds=sum(len(x["compacted"]) for x in sh.shard_history),
               halo_slots=h["halo_slots"],
               delta_capacity=h["delta_capacity"])
    return rec


def dist_plane(gw, ell_w, prep, device):
    """Phase 12: the sharded engine on a one-rank NCCL group over phase 4's
    weighted DBG graph (``gw``; ``ell_w`` is phase 4's single-device ``ell``
    backend of it): ``pagerank_dist`` on ``ell`` / ``replicate_hot`` and
    its layout's pull and push against the single-device engine, sharded
    SSSP, the sharded stream, with K5's launches on the path counted from
    zero; then K5 over every shard's tiles of the ``DIST_K5_SHARDS`` layout
    (``prep``, built in a thread) against its plain version, and the
    sharded pull and PageRank timed beside the single-device ones."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as tdist

    from repro_torch import apps
    from repro_torch.apps.pagerank_dist import pagerank_dist
    from repro_torch.dist import graph as dg
    from repro_torch.dist import stream as ds

    t_phase = time.perf_counter()
    out = {"shards": 1, "policy": "replicate_hot", "backend": "ell"}
    (ROOT / "build").mkdir(exist_ok=True)
    rendezvous = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    tdist.init_process_group("nccl", init_method=f"file://{rendezvous}/pg",
                             rank=0, world_size=1)
    try:
        mesh = dg.make_graph_mesh(1)
        v = gw.num_vertices
        x = torch.rand(v, generator=torch.Generator(device=device)
                       .manual_seed(12), device=device)
        acc = {}
        t0 = time.perf_counter()
        (ranks, iters, sg), _ = _launched(
            acc, pagerank_dist, apps.to_arrays(gw, backend="arrays",
                                               device="cpu"),
            mesh=mesh, backend="ell", policy="replicate_hot")
        _sync()
        out["pagerank_dist_s"] = time.perf_counter() - t0
        pr_ref, pr_iters = apps.pagerank(ell_w)
        gap = float((ranks - pr_ref).abs().max())
        used = _rank_gap(ranks, pr_ref, "pagerank_dist")
        if not gap <= DIST_PR_ATOL or abs(iters - pr_iters) > 1:
            raise AssertionError(f"pagerank_dist: max gap {gap} (band "
                                 f"{DIST_PR_ATOL}), iterations {iters} vs "
                                 f"{pr_iters}")
        out.update(pagerank_iters=iters, pagerank_ref_iters=pr_iters,
                   pagerank_gap=gap, pagerank_band_used=used,
                   layout_stats=sg.stats)
        checks = []
        for mode, red, uw in itertools.product(
                ("pull", "push"), ("sum", "min", "max"), (False, True)):
            fn = (dg.edge_map_pull_sharded if mode == "pull"
                  else dg.edge_map_push_sharded)
            got, _ = _launched(acc, fn, sg, x, mesh, reduce=red,
                               use_weights=uw)
            want = (apps.edge_map_pull if mode == "pull"
                    else apps.edge_map_push)(ell_w, x, reduce=red,
                                             use_weights=uw)
            checks.append(_assert_close(got, want, red,
                                        f"sharded {mode} {red} w={uw}"))
        out["map_max_abs_err"] = max(checks)
        (dist, s_iters), _ = _launched(acc, ds.sssp_sharded_stream, sg, 0,
                                       mesh)
        want, w_iters = apps.sssp(ell_w, 0)
        if not np.array_equal(dist, want.cpu().numpy()):
            raise AssertionError("sharded SSSP differs from phase 4's "
                                 "(must be bitwise)")
        out.update(sssp_iters=s_iters, sssp_ref_iters=w_iters)
        t0 = time.perf_counter()
        out["stream"] = _dist_stream(mesh, device, acc)
        out["stream"]["seconds"] = time.perf_counter() - t0
        out["launches"] = dict(acc)
        if acc.get("ell_edge_map", 0) == 0:
            raise AssertionError("dist: K5 was never launched")

        # K5 over every shard's tiles of the 4-shard layout (not counted)
        t0 = time.perf_counter()
        n, err, twice = _k5_shard_grid(prep["sg"], x, device)
        if twice == 0:
            raise AssertionError(f"the {DIST_K5_SHARDS}-shard layout has no "
                                 "class wider than 1,024 lanes to check twice")
        out["k5_shards"] = dict(shards=DIST_K5_SHARDS, calls=n,
                                max_abs_err=err, hub_sums_twice=twice,
                                seconds=time.perf_counter() - t0)
        out["host_layout_s"] = prep["seconds"]
        out["sizes"] = prep["sizes"]

        # times: the sharded pull and PageRank beside the single-device ones
        pull = lambda: dg.edge_map_pull_sharded(sg, x, mesh)  # noqa: E731
        single = lambda: apps.edge_map_pull(ell_w, x)  # noqa: E731
        out["pull"] = dict(
            ms=_events_ms(pull, REPS), device_ms=_events_ms(pull, REPS, True),
            single_ms=_events_ms(single, REPS),
            single_device_ms=_events_ms(single, REPS, True))
        rec, _ = warm_median(lambda: dg.pagerank_sharded(sg, mesh))
        ref, _ = warm_median(lambda: apps.pagerank(ell_w))
        out["pagerank"] = dict(sharded=rec, single=ref)
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(rendezvous, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------- phase 13
def _zipf_tokens(vocab_size, batch, seq_len):
    """(batch, seq_len) int32 ids of the port's ``ZipfPipeline`` (seed 0),
    remapped through DBG over the pipeline's own token frequencies, and the
    reordering."""
    from repro_torch.core.vocab import reorder_vocab
    from repro_torch.data import DataConfig, ZipfPipeline

    base = ZipfPipeline(DataConfig(vocab_size=vocab_size, seq_len=seq_len,
                                   batch_size=batch, seed=0))
    vm = reorder_vocab(base.frequencies())
    return ZipfPipeline(base.cfg, vocab_map=vm).batch(0)["tokens"], vm


def _bitwise(got, want, what):
    """Raise unless equal bit for bit; return the measured max |err| (0)."""
    import torch

    if not torch.equal(got, want):
        bad = int((got != want).any(dim=-1).sum())
        raise AssertionError(f"{what}: {bad} rows differ (must be bitwise)")
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def k2_grid(device):
    """K2 against its plain version, both entry points, float32 and
    bfloat16, at reduced and at Yi-9B widths, int32 and int64 ids,
    contiguous and strided.  Returns (cases, max |err|)."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.gather_embed import (hot_gather, hot_gather_ref,
                                                  split_gather_ref)
    from repro_torch.lm.embed import EmbedDims

    full = get_config(LM_ARCH)
    zipf, _ = _zipf_tokens(full.vocab_size, 1, K2_ZIPF_T)
    zipf = torch.from_numpy(zipf.reshape(-1)).to(device)
    gen = torch.Generator(device=device).manual_seed(6)
    cases, err = 0, 0.0
    for cfg in (reduced(full), full):
        dims = EmbedDims(cfg.vocab_size, cfg.d_model, cfg.hot_vocab_rows)
        h, c, d = dims.hot_rows, dims.cold_rows, dims.d_model
        table = torch.randn((h + c, d), generator=gen, device=device)
        uniform = torch.randint(-2, h + c + 64, (K2_ZIPF_T,), generator=gen,
                                device=device, dtype=torch.int32)
        pair = torch.stack([uniform, zipf], dim=1)  # columns of stride 2
        ids = {"zipf": zipf.clamp(max=h + c - 1), "uniform": uniform,
               "ragged": zipf[:1000], "all_hot": zipf.clamp(0, h - 1),
               "all_cold": zipf.clamp(h, h + c - 1),
               "int64": uniform.long(), "strided": pair[:, 0],
               "int64_strided": pair.long()[:, 1]}
        for dtype, kind in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            t = table.to(dtype)
            hot, cold = t[:h], t[h:]
            for what, b in ids.items():
                label = (f"K2 {what} T={b.shape[0]} H={h} C={c} D={d} "
                         f"{dtype}")
                err = max(err, _bitwise(hot_gather(b, hot, cold),
                                        split_gather_ref(hot, cold, b),
                                        label + " split"),
                          _bitwise(hot_gather(b, hot), hot_gather_ref(b, hot),
                                   label + " hot-only"))
                cases += 2
            del t, hot, cold
        del table
    _sync()
    return cases, err


# ---------------------------------------------------------------- phase 14
@contextlib.contextmanager
def _spy(module, name, pick):
    """``module.name`` swapped for a wrapper that records ``pick(out)`` of
    every call while the block is open; yields the list of records."""
    real, seen = getattr(module, name), []

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(pick(out))
        return out

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def _stub_inputs(cfg, b, gen):
    """A family's stub inputs on the CPU: VLM patch embeddings, enc-dec
    frames (24 positions)."""
    import torch

    out = {}
    if cfg.prefix_len:
        out["prefix"] = torch.randn((b, cfg.prefix_len, cfg.d_model),
                                    generator=gen)
    if cfg.n_enc_layers:
        out["frames"] = torch.randn((b, 24, cfg.d_model), generator=gen)
    return out


def lm_parity(device):
    """Every block kind at reduced size, the same weights on the CPU and the
    card (``LM_PARITY``): greedy tokens equal, every step's logits within
    rtol 1e-4, atol 1e-5, the MoE's expert choices equal at every call;
    then ``forward`` over 16 tokens (with the family's ``prefix`` or
    ``frames``) in the same band, its aux loss too.  Returns the worst
    share of that band used, per family."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.lm import moe
    from repro_torch.lm.model import forward, init_params
    from repro_torch.lm.serve import generate

    def used(a, b):
        return _band_used(a.cpu(), b, 1e-4, 1e-5)

    worst = {}
    for arch, kw in LM_PARITY:
        cfg = reduced(get_config(arch), **kw)
        model = init_params(cfg, seed=0, device="cpu")
        gen = torch.Generator().manual_seed(1)
        prompt = torch.randint(0, cfg.vocab_size, (2, 8), dtype=torch.int32,
                               generator=gen)
        toks = torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32,
                             generator=gen)
        stub = _stub_inputs(cfg, 2, gen)
        runs = {}
        for where, dev in (("cpu", torch.device("cpu")), ("card", device)):
            model = model.to(dev)
            with _spy(moe, "route", lambda out: out[1].cpu()) as routes, \
                    torch.no_grad():
                tokens, step_lg = generate(model, prompt.to(dev), max_new=8,
                                           return_logits=True)
                lg, aux = forward(model, toks.to(dev),
                                  **{k: v.to(dev) for k, v in stub.items()})
            runs[where] = (tokens, step_lg, lg, aux, routes)
        (want, want_lg, want_f, want_aux, want_r), (got, got_lg, got_f,
                                                     got_aux, got_r) = (
            runs["cpu"], runs["card"])
        if len(got_r) != len(want_r) or not all(
                torch.equal(a, b) for a, b in zip(got_r, want_r)):
            raise AssertionError(f"{arch}: the card's MoE expert choices "
                                 "differ from the CPU's")
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"{arch}: card and CPU tokens differ")
        shares = [used(a, b) for a, b in zip(got_lg, want_lg)]
        shares += [used(got_f, want_f), used(got_aux, want_aux)]
        if not max(shares) <= 1.0:
            raise AssertionError(f"{arch}: logits off by {max(shares):.3g}x "
                                 "the band (rtol 1e-4, atol 1e-5); per "
                                 f"step {[round(x, 3) for x in shares]}")
        worst[arch] = max(shares)
        kinds = sorted({k for pair in cfg.layer_pattern() for k in pair})
        extra = (f", window {cfg.window}" if "local" in kinds else "") + (
            f", stub {'/'.join(stub)}" if stub else "")
        log(f"  {cfg.arch_id} reduced ({cfg.n_layers} layers, {kinds}, "
            f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
            f"norm {cfg.norm}{extra}): "
            f"{len(got_lg)} steps and the forward agree "
            f"({worst[arch]:.3g} of the band), tokens equal"
            + (f", {len(got_r)} MoE routings equal" if got_r else ""))
    return worst


# ---------------------------------------------------------------- phase 15
def lm_serve(device):
    """Yi-9B at full width serves LM_BATCH requests through ``generate``.
    Returns the model and what phase 16 and the ``kernels`` line need."""
    import torch

    import repro_torch.lm.model as model_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels.gather_embed import split_gather, split_gather_ref
    from repro_torch.lm.serve import generate

    cfg = get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = model_mod.init_params(cfg, seed=0, device=device)
    _sync()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    tokens, vm = _zipf_tokens(cfg.vocab_size, LM_BATCH, LM_PROMPT)
    prompt = torch.from_numpy(tokens).to(device)
    hot_share = float((prompt < cfg.hot_vocab_rows).float().mean())
    if not 0.0 < hot_share < 1.0:
        raise AssertionError(f"prompt hot share {hot_share}: hot and cold "
                             "ids must both occur")
    log(f"  {cfg.arch_id}: {n_params} parameters (float32) on the card in "
        f"{init_s:.1f} s; prompt ({LM_BATCH}, {LM_PROMPT}) from the "
        f"DBG-remapped Zipf pipeline, {hot_share:.4f} of its ids below "
        f"hot_vocab_rows {cfg.hot_vocab_rows} (DBG's own hot set: "
        f"{vm.hot_rows} rows, {vm.coverage:.4f} of the mass)")

    t0 = time.perf_counter()
    generate(model, prompt, max_new=LM_NEW)  # first call: cuBLAS set-up
    _sync()
    first_s = time.perf_counter() - t0

    sv = _served(model, prompt)
    out, logits, launches, steps = (sv["out"], sv["logits"], sv["launches"],
                                    sv["steps"])
    gen_s, decode_ms = sv["gen_s"], sv["decode_ms"]
    prefill_ms = sv["prefill_ms"]
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        ids = out.reshape(-1)
        hot, cold = model.embed["hot"], model.embed["cold"]
        err = _bitwise(split_gather(hot, cold, ids),
                       split_gather_ref(hot, cold, ids),
                       "K2 on the served ids")
    served = LM_BATCH * (LM_PROMPT + LM_NEW)
    log(f"  generate: {gen_s:.3f} s per call (first call {first_s:.3f} s), "
        f"{steps} decode_step calls, decode step {decode_ms:.3f} ms "
        f"(median of {LM_NEW}; prefill steps {prefill_ms:.3f} ms), "
        f"{LM_BATCH / decode_ms * 1e3:.1f} decode tokens/s, {served / gen_s:.1f}"
        f" tokens/s over the call; peak device memory {peak / 2**30:.2f} GiB; "
        f"K2 launches {launches['hot_gather']}; K2 on the served ids bitwise "
        "equal to the plain version")
    return model, out, dict(
        launches=launches, gen_s=gen_s, first_s=first_s, decode_ms=decode_ms,
        prefill_ms=prefill_ms, peak_gib=peak / 2**30, hot_share=hot_share,
        max_abs_err=err, n_params=n_params, step_logits=logits)


def _served(model, prompt):
    """``generate`` of ``prompt`` (LM_BATCH, LM_PROMPT) + LM_NEW tokens with
    every ``decode_step`` timed by CUDA events and the launch counts read
    from zero.  Checks: K2 launched once per step (LM_PROMPT + LM_NEW), no
    graph kernel, every token in the vocabulary, the last logits finite."""
    import statistics

    import torch

    import repro_torch.lm.model as model_mod
    from repro_torch.lm.serve import generate

    cfg = model.cfg
    events = []
    plain_step = model_mod.decode_step

    def timed_step(*args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = plain_step(*args)
        b.record()
        events.append((a, b))
        return out

    _reset_launches()
    model_mod.decode_step = timed_step
    try:
        t0 = time.perf_counter()
        out, logits = generate(model, prompt, max_new=LM_NEW,
                               return_logits=True)
        _sync()
        gen_s = time.perf_counter() - t0
    finally:
        model_mod.decode_step = plain_step
    launches = _read_launches()
    steps = len(events)
    if launches["hot_gather"] != steps or steps != LM_PROMPT + LM_NEW:
        raise AssertionError(f"{cfg.arch_id}: K2 launched "
                             f"{launches['hot_gather']} times over {steps} "
                             "decode steps")
    others = {k: n for k, n in launches.items() if k not in LM_KERNELS and n}
    if others:
        raise AssertionError(f"graph kernels launched on the LM path: {others}")
    if not (int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size):
        raise AssertionError(f"{cfg.arch_id}: generated ids outside the "
                             "vocabulary")
    if not bool(torch.isfinite(logits[-1]).all()):
        raise AssertionError(f"{cfg.arch_id}: last logits not finite")
    ms = [a.elapsed_time(b) for a, b in events]
    return dict(out=out, logits=logits, launches=launches, steps=steps,
                gen_s=gen_s, decode_ms=statistics.median(ms[LM_PROMPT:]),
                prefill_ms=statistics.median(ms[:LM_PROMPT]))


def profile_decode_step(model, tokens):
    """One full-width decode step under ``torch.profiler``: its wall time
    (CUDA events), the device time of every kernel, summed by name (one
    stream, so the sum is the device's busy time), and the launch count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.lm.model as model_mod

    cache = model_mod.init_cache(model.cfg, tokens.shape[0], 2,
                                 device=tokens.device, dtype=torch.float32)
    model_mod.decode_step(model, cache, tokens[:, :1])  # warm
    _sync()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with warnings.catch_warnings():  # "Profiler clears events at the end..."
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            a.record()
            model_mod.decode_step(model, cache, tokens[:, 1:2])
            b.record()
            _sync()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return dict(step_ms=a.elapsed_time(b),
                busy_ms=sum(ms for _, ms in by_name.values()),
                launches=sum(n for n, _ in by_name.values()),
                top=[(name[:90], n, ms) for name, (n, ms) in top[:8]])


# ---------------------------------------------------------------- phase 16
def _host_us(fn, n=1000):
    """Host microseconds per ``fn()`` over ``n`` calls issued with no sync
    between them: what the caller's thread spends to issue one call."""
    fn()
    _sync()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    _sync()
    return dt / n * 1e6


def _device_ops(calls, tries=3):
    """The device activities (kernels, copies, fills) of one call of each
    function in ``calls`` (name → fn), after a warm call of each, under
    ``torch.profiler``.  The profiler on the card's machine can drop device
    events from a session, and its device timestamps can drift from the
    host's.  So each call runs in its own ``record_function`` range; a
    device event belongs to the range that holds, on the host's clock, the
    CUDA runtime call that launched it (the two share a correlation id);
    and the session runs again, up to ``tries`` times, until two sessions
    agree, keeping each call's longest list."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in calls.values():
        fn()
    _sync()
    tag = "chip_smoke:"
    best = {name: [] for name in calls}
    for _ in range(tries):
        with warnings.catch_warnings():  # "Profiler clears events at..."
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for name, fn in calls.items():
                    with record_function(tag + name):
                        fn()
                        _sync()
        events = prof.events()
        device = {e.id: e.name[:60] for e in events
                  if e.device_type == DeviceType.CUDA}
        ranges = [(e.time_range, e.name[len(tag):]) for e in events
                  if e.device_type == DeviceType.CPU
                  and e.name.startswith(tag)]
        got = {name: [] for name in calls}
        for e in sorted(events, key=lambda e: e.time_range.start):
            if (e.device_type == DeviceType.CPU and e.name.startswith("cu")
                    and e.id in device):
                for r, name in ranges:
                    if r.start <= e.time_range.start <= r.end:
                        got[name].append(device[e.id])
        stable = got == best
        for name, ops in got.items():
            if len(ops) > len(best[name]):
                best[name] = ops
        if stable:
            break
    return best


def time_k2(model, served, reps):
    """K2 at the decode call (the last step's LM_BATCH ids) and at K2_ZIPF_T
    Zipf ids, against its plain version and ``F.embedding`` over the
    joined table (built once, outside the timed region), each from an idle
    device (``ms``) and on the device alone (``device_ms``); and the host
    time of one call at the decode call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.gather_embed import hot_gather, split_gather_ref

    cfg = model.cfg
    with torch.no_grad():
        hot, cold = model.embed["hot"].detach(), model.embed["cold"].detach()
        table = torch.cat([hot, cold])
        zipf, _ = _zipf_tokens(cfg.vocab_size, 1, K2_ZIPF_T)
        calls = {"decode": served[:, -1].contiguous(),
                 "zipf": torch.from_numpy(zipf.reshape(-1)).to(hot.device)}
        out = {}
        for label, ids in calls.items():
            n0 = hot_gather.launches
            got = hot_gather(ids, hot, cold)
            per_call = hot_gather.launches - n0
            err = max(_bitwise(got, split_gather_ref(hot, cold, ids),
                               f"timed K2 ({label}) vs plain"),
                      _bitwise(got, F.embedding(ids, table),
                               f"timed K2 ({label}) vs F.embedding"))
            # The least traffic: each distinct row read once, each output
            # row written once, the ids read once.
            t, d = ids.shape[0], hot.shape[1]
            rows = int(torch.unique(ids).numel())
            row_bytes = d * hot.element_size()
            bound_ms, bound_by = _bound((rows + t) * row_bytes + t * 4, 0)

            def kernel(ids=ids):
                return hot_gather(ids, hot, cold)

            def library(ids=ids):
                return F.embedding(ids, table)

            out[label] = dict(
                distinct_rows=rows,
                bound_ms_t_rows=_bound(2 * t * row_bytes + t * 4, 0)[0],
                t=t, ms=_events_ms(kernel, reps),
                device_ms=_events_ms(kernel, reps, True),
                plain_ms=_events_ms(lambda: split_gather_ref(hot, cold, ids),
                                    reps),
                library_ms=_events_ms(library, reps),
                library_device_ms=_events_ms(library, reps, True),
                bound_ms=bound_ms, bound_by=bound_by,
                launches_per_call=per_call, max_abs_err=err)
        ids = calls["decode"]
        out["decode"]["host_us"] = _host_us(lambda: hot_gather(ids, hot, cold))
        out["decode"]["library_host_us"] = _host_us(
            lambda: F.embedding(ids, table))
        del table
    return out


# ---------------------------------------------------------------- phase 17
def _band_used(got, want, rtol, atol):
    """The largest |got - want| / (atol + rtol |want|): at most 1 inside
    the band."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _matmul_params(model):
    """Parameters that enter a matrix product: all but the embedding
    tables, which are gathered."""
    return sum(p.numel() for n, p in model.named_parameters()
               if n not in ("embed.hot", "embed.cold", "embed.table"))


def lm_forward(model, served, step_logits, reps):
    """A12.1 at full width: ``forward`` over the served tokens (B, S) against
    ``generate``'s step logits (position t against the step that read token
    t) in the reference's decode band, rtol 2e-2, atol 2e-4; ``last_only``
    against the full call's last position in phase 14's band, rtol 1e-4,
    atol 1e-5 (cuBLAS may choose another algorithm for M = B); one K2 launch
    per call; the forward's time from an idle device."""
    import torch

    import repro_torch.lm.model as model_mod
    from repro_torch.kernels.gather_embed import hot_gather

    with torch.no_grad():
        _reset_launches()
        full, _ = model_mod.forward(model, served)
        _sync()
        launches = _read_launches()
        n0 = hot_gather.launches
        last, _ = model_mod.forward(model, served, last_only=True)
        last_launches = hot_gather.launches - n0
    if launches["hot_gather"] != 1 or last_launches != 1:
        raise AssertionError(f"forward launched K2 {launches['hot_gather']} "
                             f"and {last_launches} times, not once a call")
    others = {k: n for k, n in launches.items() if k != "hot_gather" and n}
    if others:
        raise AssertionError(f"graph kernels launched by forward: {others}")
    want = torch.cat(step_logits, dim=1)
    if want.shape != full.shape:
        raise AssertionError(f"forward gave {tuple(full.shape)}, generate "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(full).all()):
        raise AssertionError("forward logits not finite")
    used = _band_used(full, want, 2e-2, 2e-4)
    used_last = _band_used(last, full[:, -1:], 1e-4, 1e-5)
    if not (used <= 1.0 and used_last <= 1.0):
        raise AssertionError(f"forward off generate by {used:.3g}x the decode"
                             f" band, last_only off by {used_last:.3g}x")
    cfg = model.cfg
    b, s = served.shape

    def fwd():
        with torch.no_grad():
            model_mod.forward(model, served)

    ms = _events_ms(fwd, reps)
    flops = (2 * _matmul_params(model) * b * s
             + 4 * cfg.n_layers * cfg.n_heads * cfg.head_dim * s * b * s)
    return dict(launches=launches, ms=ms, band_used=used,
                last_only_band_used=used_last, tokens=b * s,
                tflops_per_s=flops / ms / 1e9,
                flops_formula="2*N_matmul*T + 4*L*H*Dh*S*T (full S x S "
                              "scores), T = B*S")


# ---------------------------------------------------------------- phase 18
def lm_train(device):
    """OLMo-1B at its published config (remat on) trained from seeded
    weights for one warm-up step and TRAIN_TIMED timed steps on the DBG-
    reordered Zipf stream, bf16 compute on float32 masters.  Checks: loss
    and grad norm finite, grad norm > 0; after step 1 every parameter has
    changed and the master gradients of ``embed.hot`` / ``embed.cold`` are
    nonzero on exactly the rows the batch's ids read; K2 launches = forward
    passes; the embedding backward twice bitwise on the step's ids and
    gradient, and within 1e-6 relative of it on CPU copies."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.gather_embed import ops as k2_ops
    from repro_torch.launch.train import dbg_stream
    from repro_torch.lm.model import init_params
    from repro_torch.train.step import OptConfig, init_opt, make_train_step

    cfg, pipe, vr = dbg_stream(get_config(TRAIN_ARCH), TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=device)
    opt = init_opt(model)
    _sync()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.arch_id}: {n_params} parameters ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff "
        f"{cfg.d_ff}, vocabulary {cfg.vocab_size} padded to "
        f"{model.embed['unembed'].shape[1]}, hot rows {cfg.hot_vocab_rows} "
        f"(DBG coverage {vr.coverage:.4f}), norm {cfg.norm}, remat "
        f"{cfg.remat}), float32 masters and Adam moments on the card in "
        f"{init_s:.1f} s")
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in pipe.batch(i).items()}
               for i in range(1 + TRAIN_TIMED)]
    train_step = make_train_step(cfg, OptConfig(**TRAIN_OPT))
    events, last = [], {}
    real_bw = k2_ops.gather_backward

    def timed_bw(ids, grad, h, c, dtype):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real_bw(ids, grad, h, c, dtype)
        b.record()
        events.append((a, b))
        last.update(ids=ids, grad=grad, rows=(h, c))
        return out

    # on the host, so that the peak memory is the training's alone
    before = {n: p.detach().to("cpu", copy=True)
              for n, p in model.named_parameters()}
    step_ms, metrics = [], []
    k2_ops.gather_backward = timed_bw
    _reset_launches()
    try:
        for i, batch in enumerate(batches):
            _sync()
            t0 = time.perf_counter()
            m = train_step(model, opt, batch)
            _sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                same = [n for n, p in model.named_parameters()
                        if torch.equal(p.detach().cpu(), before[n])]
                if same:
                    raise AssertionError(f"step 1 left {same} unchanged")
                del before
                h = model.embed["hot"].shape[0]
                read = torch.zeros(h + model.embed["cold"].shape[0],
                                   dtype=torch.bool)
                read[batch["tokens"].reshape(-1).long().cpu()] = True
                g = torch.cat([model.embed["hot"].grad.cpu(),
                               model.embed["cold"].grad.cpu()])
                hit = (g != 0).any(dim=1)
                if not (bool(hit[read].all()) and not bool(hit[~read].any())):
                    raise AssertionError(
                        f"embedding gradients on {int(hit.sum())} rows, "
                        f"{int(read.sum())} read ({int((hit & read).sum())} "
                        "of them)")
                rows_read, rows_hot = int(read.sum()), int(read[:h].sum())
                del g, read, hit
    finally:
        k2_ops.gather_backward = real_bw
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    for i, m in enumerate(metrics):
        if not (all(map(lambda x: x == x and abs(x) != float("inf"),
                        m.values())) and m["grad_norm"] > 0):
            raise AssertionError(f"step {i}: {m}")
    if launches["hot_gather"] != len(batches):
        raise AssertionError(f"K2 launched {launches['hot_gather']} times over"
                             f" {len(batches)} forward passes")
    others = {k: n for k, n in launches.items() if k != "hot_gather" and n}
    if others:
        raise AssertionError(f"graph kernels launched on the LM path: {others}")
    bw_ms = [a.elapsed_time(b) for a, b in events]
    # the embedding backward on the last step's ids and gradient
    ids, grad, (h, c) = last["ids"], last["grad"], last["rows"]
    a = real_bw(ids, grad, h, c, grad.dtype)
    b = real_bw(ids, grad, h, c, grad.dtype)
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        raise AssertionError("two embedding backward calls differ")
    card32 = torch.cat(real_bw(ids, grad, h, c, torch.float32)).cpu()
    cpu32 = torch.cat(real_bw(ids.cpu(), grad.cpu(), h, c, torch.float32))
    bw_used = _band_used(card32, cpu32, 1e-6, 1e-30)
    if not bw_used <= 1.0:
        raise AssertionError(f"embedding backward off the CPU's by "
                             f"{bw_used:.3g}x of 1e-6 relative")
    del a, b, card32, cpu32, last
    # the step split: the gradients (forward and backward) and the update,
    # on CUDA events over two more steps; then one step's device kernels
    # by class under torch.profiler, with the device's busy and idle share
    split = []
    for batch in batches[1:3]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        train_step.grads_of(model, batch)
        ev[1].record()
        train_step.apply(model, opt)
        ev[2].record()
        ev[2].synchronize()
        split.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
    profiled = _kernel_classes(lambda: train_step(model, opt, batches[1]))
    timed = step_ms[1:]
    ms = statistics.median(timed)
    t = TRAIN_BATCH * TRAIN_SEQ
    n_mm = _matmul_params(model)
    attn = 12 * cfg.n_layers * cfg.n_heads * cfg.head_dim * TRAIN_SEQ * t
    flops = 6 * n_mm * t + attn
    out = dict(
        arch=cfg.arch_id, n_params=n_params, n_matmul_params=n_mm,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, tokens_per_step=t,
        hot_vocab_rows=cfg.hot_vocab_rows, rows_read_step1=rows_read,
        hot_rows_read_step1=rows_hot, opt=TRAIN_OPT, init_s=init_s,
        first_step_ms=step_ms[0], step_ms=ms, step_ms_min=min(timed),
        step_ms_max=max(timed), tokens_per_s=t / ms * 1e3,
        flops_per_step=flops,
        flops_formula="6*N_matmul*T + 12*L*H*Dh*S*T (model FLOPs: no remat "
                      "recompute, full S x S scores), T = B*S",
        tflops_per_s=flops / ms / 1e9,
        bf16_peak_share=flops / ms / 1e-3 / BF16_OPS_PER_S,
        peak_gib=peak / 2**30, embed_backward_ms=statistics.median(bw_ms[1:]),
        embed_backward_ms_all=bw_ms, embed_backward_cpu_band_used=bw_used,
        losses=[m["loss"] for m in metrics],
        grad_norms=[m["grad_norm"] for m in metrics],
        lrs=[m["lr"] for m in metrics], launches=launches,
        grads_ms=[a for a, _ in split], update_ms=[b for _, b in split],
        profiled_step=profiled)
    del model, opt, batches
    return out


def _kernel_class(name):
    n = name.lower()
    for cls, keys in (("matmul", ("gemm", "cutlass", "nvjet", "xmma",
                                  "sm90_", "cublas")),
                      ("sort and segment sum", ("segment", "sort", "radix",
                                                "searchsorted")),
                      ("copies and casts", ("memcpy", "memset", "copy",
                                            "fill")),
                      ("reductions", ("reduce", "softmax", "logsumexp"))):
        if any(k in n for k in keys):
            return cls
    return "elementwise"


def _kernel_classes(fn):
    """One call of ``fn`` under ``torch.profiler``: its wall time (synced),
    the device time of its kernels by class (one stream, so their sum is
    the device's busy time), the idle share and the heaviest kernels."""
    import torch  # noqa: F401
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync()
    with warnings.catch_warnings():  # "Profiler clears events at the end..."
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            _sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
    classes, by_name = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            cls = _kernel_class(e.name)
            n, t = classes.get(cls, (0, 0.0))
            classes[cls] = (n + 1, t + ms)
            n, t = by_name.get(e.name[:80], (0, 0.0))
            by_name[e.name[:80]] = (n + 1, t + ms)
    busy = sum(t for _, t in classes.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return dict(wall_ms=wall_ms, busy_ms=busy,
                idle_share=1.0 - busy / wall_ms if wall_ms else None,
                launches=sum(n for n, _ in classes.values()),
                classes={k: {"launches": n, "ms": t}
                         for k, (n, t) in sorted(classes.items(),
                                                 key=lambda kv: -kv[1][1])},
                top=[(name, n, t) for name, (n, t) in top])


def train_parity(device):
    """Reduced Yi-9B (GQA) and OLMo-1B, remat on, from the same weights on
    the CPU and the card: TRAIN_PARITY_STEPS float32 steps with loss and
    grad norm within 1e-5 relative and every parameter within
    PARITY_PARAM_ATOL; the forward logits at S = 1,024 within phase 14's
    band.  Returns the worst shares of those bands."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.lm import model as model_mod
    from repro_torch.train.step import OptConfig, init_opt, make_train_step

    worst = dict(loss=0.0, grad_norm=0.0, params=0.0, forward=0.0)
    for arch, kw in (("yi_9b", dict(n_kv_heads=2)), ("olmo_1b", {})):
        cfg = reduced(get_config(arch), remat=True, **kw)
        cpu = model_mod.init_params(cfg, seed=0, device="cpu")
        card = model_mod.init_params(cfg, seed=0, device="cpu").to(device)
        toks = torch.randint(0, cfg.vocab_size, (2, 1024), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            want, _ = model_mod.forward(cpu, toks)
            got, _ = model_mod.forward(card, toks.to(device))
        worst["forward"] = max(worst["forward"],
                               _band_used(got.cpu(), want, 1e-4, 1e-5))
        ts = make_train_step(cfg, OptConfig(lr=1e-3, warmup=2, total_steps=10,
                                            compute_dtype="float32"))
        o_cpu, o_card = init_opt(cpu), init_opt(card)
        gen = torch.Generator().manual_seed(2)
        for _ in range(TRAIN_PARITY_STEPS):
            t = torch.randint(0, cfg.vocab_size, (4, 65), dtype=torch.int32,
                              generator=gen)
            batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
            w = ts(cpu, o_cpu, batch)
            g = ts(card, o_card, {k: v.to(device) for k, v in batch.items()})
            for key in ("loss", "grad_norm"):
                worst[key] = max(worst[key], abs(float(g[key]) - float(w[key]))
                                 / (1e-5 * abs(float(w[key]))))
        for a, b in zip(card.parameters(), cpu.parameters()):
            diff = float((a.detach().cpu() - b.detach()).abs().max())
            worst["params"] = max(worst["params"], diff / PARITY_PARAM_ATOL)
        log(f"  {cfg.arch_id} reduced ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}): {TRAIN_PARITY_STEPS} float32 steps and the "
            f"forward at S = 1,024, card against CPU")
    if not all(v <= 1.0 for v in worst.values()):
        raise AssertionError(f"card vs CPU training off its bands: {worst}")
    return worst


def train_driver(steps):
    """``repro_torch.launch.train.main`` on the card: ``steps`` straight,
    then preempted by a SIGTERM in step ``steps / 2`` (the driver's
    checkpoint-and-exit path) and resumed to ``steps`` in another
    directory; final parameters and optimizer state bitwise equal; the
    straight run's return code 0 (loss decreased)."""
    import io
    import re
    import signal

    import torch

    from repro_torch.launch import ckpt
    from repro_torch.launch import train as train_mod

    root = ROOT / "build" / "train_driver"
    shutil.rmtree(root, ignore_errors=True)
    half = steps // 2
    args = DRIVER_ARGS + ["--steps", str(steps), "--ckpt-every", str(half)]
    real = train_mod.step_mod.make_train_step

    def preempted(cfg, oc):
        fn, calls = real(cfg, oc), []

        def ts(*a):
            calls.append(1)
            if len(calls) == half:
                signal.raise_signal(signal.SIGTERM)
            return fn(*a)
        return ts

    runs = {}
    for name, d, make in (("straight", "a", real), ("preempted", "b", preempted),
                          ("resumed", "b", real)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        train_mod.step_mod.make_train_step = make
        try:
            with contextlib.redirect_stdout(buf):
                rc = train_mod.main(args + ["--ckpt-dir", str(root / d)])
        finally:
            train_mod.step_mod.make_train_step = real
        runs[name] = dict(rc=rc, seconds=time.perf_counter() - t0,
                          out=buf.getvalue())
        tail = [ln for ln in buf.getvalue().splitlines()
                if "done" in ln or "resumed" in ln or "signal" in ln
                or "arch=" in ln]
        log(f"  driver {name} ({' '.join(args)}): return code {rc} in "
            f"{runs[name]['seconds']:.1f} s; " + " | ".join(tail))
        if name == "preempted" and (
                "checkpoint + exit" not in buf.getvalue()
                or ckpt.list_checkpoints(str(root / d))[-1]
                != f"ckpt_{half:08d}"):
            raise AssertionError(f"the driver did not stop with a checkpoint "
                                 f"at step {half} on SIGTERM")
    finals = []
    for d in ("a", "b"):
        path = root / d / ckpt.list_checkpoints(str(root / d))[-1]
        finals.append([torch.load(path / f, weights_only=True)
                       for f in ("params.pt", "opt.pt")])
    (pa, oa), (pb, ob) = finals
    same = (set(pa) == set(pb) and set(oa) == set(ob)
            and all(torch.equal(pa[k], pb[k]) for k in pa)
            and all(torch.equal(oa[k], ob[k]) for k in oa))
    if not same or int(oa["step"]) != steps:
        raise AssertionError("resumed run's final state differs from the "
                             "straight run's")
    if runs["straight"]["rc"] != 0 or runs["preempted"]["rc"] != 0:
        raise AssertionError(f"driver return codes "
                             f"{[r['rc'] for r in runs.values()]}")
    found = re.search(r"loss ([0-9.]+) -> ([0-9.]+)", runs["straight"]["out"])
    losses = re.findall(r"step (\d+) loss ([0-9.]+)", runs["straight"]["out"])
    shutil.rmtree(root, ignore_errors=True)
    return dict(steps=steps, args=args,
                first_fifth_loss=float(found.group(1)),
                last_fifth_loss=float(found.group(2)),
                first_loss=float(losses[0][1]), last_loss=float(losses[-1][1]),
                return_codes={k: r["rc"] for k, r in runs.items()},
                seconds={k: r["seconds"] for k, r in runs.items()},
                bitwise_resume=same)


# ---------------------------------------------------------------- phase 19
def _counted(counts, what, k2, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with every launch count set to 0 just before
    and read just after, added into ``counts``.  Raises unless K2 launched
    ``k2`` times and no graph kernel launched."""
    _reset_launches()
    out = fn(*args, **kwargs)
    made = _read_launches()
    for n, c in made.items():
        counts[n] = counts.get(n, 0) + c
    others = {k: n for k, n in made.items() if k not in LM_KERNELS and n}
    if made["hot_gather"] != k2 or others:
        raise AssertionError(f"{what}: K2 launched {made['hot_gather']} "
                             f"times, not {k2}; graph kernels {others}")
    return out


def _dropped(keeps):
    """(slots, dropped per call) of ``stable_bin_dispatch``'s keep masks."""
    return (sum(k.numel() for k in keeps), [int((~k).sum()) for k in keeps])


def _float64_last(model, tokens):
    """``forward(last_only=True)`` logits of ``model`` over ``tokens`` in
    float64 on the card: the weights widened (exact), the embedding rows
    read from float32 copies of the tables (K2 takes float32 and bfloat16)
    and widened, every later operation in float64."""
    import copy

    import torch

    import repro_torch.lm.model as model_mod
    from repro_torch.lm import embed as embed_mod

    m64 = copy.deepcopy(model).double()
    real = embed_mod.embed_lookup

    def widened(params, ids):
        return real({k: v.float() for k, v in params.items()}, ids).double()

    embed_mod.embed_lookup = widened
    try:
        with torch.no_grad():
            out, _ = model_mod.forward(m64, tokens, last_only=True)
    finally:
        embed_mod.embed_lookup = real
    del m64
    return out


def _full_width(arch, device):
    """One config of BLOCK_ARCHS at its published widths and depth, float32,
    seeded weights drawn on the card: the bytes predicted before anything
    is allocated, served as phase 15 serves Yi-9B (K2 once per decode
    step), ``forward(last_only=True)`` over the served tokens against the
    last decode step in the reference's decode band (an MoE at capacity
    factor BLOCK_CF_CHECK, where neither drops a slot; then the slots the
    published factor drops in the same forward), one decode step under
    ``torch.profiler``, the peak memory.  Every call through the model's
    entry points runs with the launch counts set to 0 just before and read
    just after, and adds into the model's ``launches``.  A family in
    FORWARD_REL_L2 holds its forward, its last decode step and the gap
    between them to a float64 forward of the same weights instead."""
    import dataclasses

    import torch

    import repro_torch.lm.model as model_mod
    from repro_torch.configs import get_config
    from repro_torch.lm import moe
    from repro_torch.lm.serve import generate

    cfg = get_config(arch)
    n_params = sum(p.numel() for p in
                   model_mod.LM(cfg, device="meta").parameters())
    free, total = torch.cuda.mem_get_info()
    log(f"  {cfg.arch_id}: {n_params} parameters, {n_params * 4 / 1e9:.2f} "
        f"GB in float32 predicted ({n_params * 4 / 2**30:.2f} GiB); "
        f"{free / 2**30:.2f} GiB of {total / 2**30:.2f} free on the card")
    if n_params * 4 > free - (2 << 30):
        raise AssertionError(f"{cfg.arch_id} does not fit in float32 beside "
                             "2 GiB of working memory")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = model_mod.init_params(cfg, seed=0, device=device)
    _sync()
    init_s = time.perf_counter() - t0
    tokens, vm = _zipf_tokens(cfg.vocab_size, LM_BATCH, LM_PROMPT)
    prompt = torch.from_numpy(tokens).to(device)
    counts = {}
    t0 = time.perf_counter()
    # cuBLAS set-up: 8 steps
    _counted(counts, f"{cfg.arch_id} warm-up", 8, generate, model,
             prompt[:, :4], max_new=4)
    _sync()
    warm_s = time.perf_counter() - t0
    sv = _served(model, prompt)  # counts read from zero, checked there
    for n, c in sv.pop("launches").items():
        counts[n] = counts.get(n, 0) + c
    served = sv.pop("out")
    last_step = sv.pop("logits")[-1]

    check = (dataclasses.replace(cfg, capacity_factor=BLOCK_CF_CHECK)
             if cfg.n_experts else cfg)
    model.cfg = check
    with _spy(moe, "stable_bin_dispatch", lambda out: out[1]) as keeps, \
            torch.no_grad():
        last, _ = _counted(counts, f"{cfg.arch_id} forward", 1,
                           model_mod.forward, model, served, last_only=True)
    used = _band_used(last, last_step, 2e-2, 2e-4)
    rel = float((last - last_step).norm() / last_step.norm())
    dropped = sum(_dropped(keeps)[1])
    if dropped:
        raise AssertionError(f"{cfg.arch_id}: the forward at capacity factor "
                             f"{BLOCK_CF_CHECK} dropped {dropped} slots")
    if arch not in FORWARD_REL_L2 and not used <= 1.0:
        raise AssertionError(f"{cfg.arch_id}: forward(last_only) off the last"
                             f" decode step by {used:.3g}x the decode band, "
                             f"{rel:.3g} relative L2")
    drops = None
    if cfg.n_experts:
        model.cfg = cfg
        with _spy(moe, "stable_bin_dispatch", lambda out: out[1]) as keeps, \
                torch.no_grad():
            _counted(counts, f"{cfg.arch_id} forward at capacity factor "
                     f"{cfg.capacity_factor}", 1, model_mod.forward, model,
                     served, last_only=True)
        slots, per_call = _dropped(keeps)
        drops = dict(capacity_factor=cfg.capacity_factor, slots=slots,
                     dropped=sum(per_call), dropped_per_layer=per_call)
    model.cfg = cfg
    # a warm step, then the profiled one
    prof = _counted(counts, f"{cfg.arch_id} profiled step", 2,
                    profile_decode_step, model, served)
    peak = torch.cuda.max_memory_allocated()
    exact = None
    if arch in FORWARD_REL_L2:
        want = _float64_last(model, served)

        def off(x):
            return float((x.double() - want).norm() / want.norm())

        exact = dict(forward=off(last), decode=off(last_step))
        band = FORWARD_REL_L2[arch]
        if not max(rel, exact["forward"], exact["decode"]) <= band:
            raise AssertionError(
                f"{cfg.arch_id}: forward(last_only) and the last decode step "
                f"{rel:.3g} apart, {exact['forward']:.3g} and "
                f"{exact['decode']:.3g} from a float64 forward (relative L2; "
                f"band {band:g})")
        del want
    step_bytes = _matmul_params(model) * 4
    out = dict(arch=cfg.arch_id, n_params=n_params, dtype="float32",
               predicted_bytes=n_params * 4, init_s=init_s, warm_s=warm_s,
               layers=cfg.n_layers, d_model=cfg.d_model,
               pattern=[list(p) for p in cfg.layer_pattern()],
               launches=counts, k2_launches=counts["hot_gather"],
               forward_band_used=used, forward_rel_l2=rel,
               forward_rel_l2_band=FORWARD_REL_L2.get(arch),
               float64_rel_l2=exact, drops=drops,
               hot_share=float((prompt < cfg.hot_vocab_rows).float().mean()),
               dbg_hot_rows=vm.hot_rows, peak_gib=peak / 2**30,
               step_bytes=step_bytes,
               bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
               profile=prof, **sv)
    log(f"  {cfg.arch_id} ({cfg.n_layers} layers of {cfg.layer_pattern()}, "
        f"d_model {cfg.d_model}): on the card in {init_s:.1f} s; "
        f"generate {sv['gen_s']:.3f} s (warm-up {warm_s:.1f} s), decode "
        f"step {sv['decode_ms']:.3f} ms (median of {LM_NEW}; prefill steps "
        f"{sv['prefill_ms']:.3f} ms), bound {out['bound_ms']:.3f} ms "
        f"({step_bytes} B of weights per step); one profiled step "
        f"{prof['step_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms, "
        f"{prof['launches']} device launches; K2 launches "
        f"{counts['hot_gather']} ({sv['steps']} served steps, 8 warm-up, "
        f"{2 if drops else 1} forward, 2 profiled); "
        f"forward(last_only) at {used:.3g} of the decode band, {rel:.3g} "
        f"relative L2"
        + ("" if exact is None else
           f" (held to {FORWARD_REL_L2[arch]:g} relative L2, as are its "
           f"{exact['forward']:.3g} and the decode's {exact['decode']:.3g} "
           "from a float64 forward)")
        + ("" if drops is None else
           f" (capacity factor {BLOCK_CF_CHECK}, no slot dropped); at the "
           f"published {cfg.capacity_factor} the same forward drops "
           f"{drops['dropped']} of {drops['slots']} slots")
        + f"; peak device memory {peak / 2**30:.2f} GiB")
    for kname, n, ms in prof["top"][:4]:
        log(f"    {ms:9.3f} ms  {n:4d} x  {kname}")
    return out


def lm_blocks(device):
    """Phase 19: BLOCK_ARCHS at full width, one after another, each freed
    before the next."""
    import gc

    import torch

    out = {}
    for arch in BLOCK_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out[arch] = _full_width(arch, device)
        gc.collect()
        torch.cuda.empty_cache()
        out[arch]["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------- phase 20
def _steps(ts, model, opt, batches, counts, what, ctx=contextlib.nullcontext):
    """``ts`` over ``batches``, each step counted from zero (K2 once, no
    graph kernel) and timed on the host clock, synced: (metrics, ms)."""
    out, ms = [], []
    for i, batch in enumerate(batches):
        _sync()
        t0 = time.perf_counter()
        with ctx():
            m = _counted(counts, f"{what} step {i}", 1, ts, model, opt, batch)
        _sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append({k: float(v) for k, v in m.items()})
    return out, ms


def lm_sharded(device):
    """Phase 20: phase 18's model (OLMo-1B, remat on), weights and batches
    trained 1 + SHARDED_STEPS steps through ``dist.sharding.shard_model`` on
    a one-rank NCCL ``DeviceMesh`` (1, 1), beside an unsharded copy from the
    same start (run first, its end state kept on the host): loss, grad norm
    and every parameter within PARITY_PARAM_ATOL of it; K2 once per step,
    no graph kernel.  One card holds every axis at size 1, so this checks
    DTensor, NCCL and K2 inside the step, not the exchange between cards;
    the steps' wall time beside the unsharded one is DTensor's host cost."""
    import statistics
    import tempfile

    import torch
    import torch.distributed as tdist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.constrain import activation_sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import dbg_stream
    from repro_torch.lm.model import init_params
    from repro_torch.train.step import OptConfig, init_opt, make_train_step

    t_phase = time.perf_counter()
    cfg, pipe, _ = dbg_stream(get_config(TRAIN_ARCH), TRAIN_BATCH, TRAIN_SEQ)
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in pipe.batch(i).items()}
               for i in range(1 + SHARDED_STEPS)]
    ts = make_train_step(cfg, OptConfig(**TRAIN_OPT))
    counts = {}
    model = init_params(cfg, seed=0, device=device)
    opt = init_opt(model)
    plain, plain_ms = _steps(ts, model, opt, batches, counts, "unsharded")
    want = {n: p.detach().to("cpu", copy=True)
            for n, p in model.named_parameters()}
    del model, opt
    torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    rendezvous = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    tdist.init_process_group("nccl", init_method=f"file://{rendezvous}/pg",
                             rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1)
        model = init_params(cfg, seed=0, device=device)
        rules = shd.param_specs(model)  # before the size-1 axes drop
        shd.shard_model(model, mesh)
        opt = init_opt(model)
        spec = (shd.batch_spec(mesh)[0], None)
        placed = [{k: distribute_tensor(v, mesh, shd.placements(spec, mesh))
                   for k, v in b.items()} for b in batches]
        counts = {}
        torch.cuda.reset_peak_memory_stats()
        got, ms = _steps(ts, model, opt, placed, counts, "sharded",
                         lambda: activation_sharding(mesh))
        peak = torch.cuda.max_memory_allocated()
        worst = dict(loss=0.0, grad_norm=0.0, params=0.0)
        for g, w in zip(got, plain):
            for key in ("loss", "grad_norm"):
                worst[key] = max(worst[key], abs(g[key] - w[key])
                                 / (PARITY_PARAM_ATOL * abs(w[key])))
        not_dt = [n for n, p in model.named_parameters()
                  if not isinstance(p, DTensor)]
        for n, p in model.named_parameters():
            diff = float((p.full_tensor().detach().cpu() - want[n]).abs().max())
            worst["params"] = max(worst["params"], diff / PARITY_PARAM_ATOL)
        del model, opt, placed, want
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(rendezvous, ignore_errors=True)
    if not_dt or not all(v <= 1.0 for v in worst.values()):
        raise AssertionError(f"sharded step off the unsharded one: worst "
                             f"shares of PARITY_PARAM_ATOL {worst}; plain "
                             f"tensors {not_dt[:4]}")
    if counts["hot_gather"] != len(batches):
        raise AssertionError(f"K2 launched {counts['hot_gather']} times over "
                             f"{len(batches)} sharded steps")
    t = TRAIN_BATCH * TRAIN_SEQ
    return dict(arch=cfg.arch_id, mesh="1x1", steps=len(batches),
                params_with_axes=sum(any(e is not None for e in sp)
                                     for sp in rules.values()),
                n_tensors=len(rules),
                step_ms=statistics.median(ms[1:]), step_ms_all=ms,
                plain_step_ms=statistics.median(plain_ms[1:]),
                plain_step_ms_all=plain_ms,
                tokens_per_s=t / statistics.median(ms[1:]) * 1e3,
                losses=[m["loss"] for m in got],
                plain_losses=[m["loss"] for m in plain],
                worst_share=worst, peak_gib=peak / 2**30, launches=counts,
                seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------- phase 21
def _train_depth(cfg, tokens):
    """The depth (whole pattern periods, at most the published one) whose
    float32 masters, gradients and two Adam moments (16 bytes a parameter)
    fit in TRAIN_BLOCKS_GIB beside an activation allowance: the chunked
    loss's logits (``tokens`` / TRAIN_BATCH x TRAIN_BLOCKS_LOSS_CHUNK rows
    of the padded vocabulary, 16 bytes each: bf16 and float32 copies and
    their gradients) and TRAIN_BLOCKS_SLACK_GIB.  Counted on ``meta``."""
    import dataclasses

    import repro_torch.lm.model as model_mod

    plen = len(cfg.layer_pattern())

    def n_params(n_layers):
        c = dataclasses.replace(cfg, n_layers=n_layers)
        return sum(p.numel() for p in
                   model_mod.LM(c, device="meta").parameters())

    one, two = n_params(plen), n_params(2 * plen)
    per, base = two - one, one - (two - one)
    vocab = model_mod.LM(cfg, device="meta").embed["unembed"].shape[1]
    act = (TRAIN_BATCH * TRAIN_BLOCKS_LOSS_CHUNK * vocab * 16
           + TRAIN_BLOCKS_SLACK_GIB * 2**30)
    room = TRAIN_BLOCKS_GIB * 2**30 - act
    periods = min(cfg.n_layers // plen, int((room / 16 - base) // per))
    if periods < 1:
        raise AssertionError(f"{cfg.arch_id}: not one period fits")
    return periods * plen, base + periods * per, act


def _moments(model, chunk=1 << 26):
    """Each parameter's (sum, sum of squares) in float64, over chunks of
    ``chunk`` elements (a float64 copy of a whole 256,000-row table would
    not fit beside the training state): a change of any element moves
    them."""
    import torch

    out = {}
    with torch.no_grad():
        for n, p in model.named_parameters():
            a = b = 0.0
            for c in p.detach().reshape(-1).split(chunk):
                c = c.double()
                a += float(c.sum())
                b += float(c.square().sum())
            out[n] = (a, b)
    return out


def lm_train_blocks(device):
    """Phase 21: TRAIN_BLOCK_ARCHS trained at their published widths, one
    at a time, 1 + TRAIN_BLOCK_STEPS steps each on phase 18's stream
    settings (the DBG-remapped Zipf stream, TRAIN_BATCH x TRAIN_SEQ), bf16
    compute on float32 masters, the loss over chunks of
    TRAIN_BLOCKS_LOSS_CHUNK positions; each cut to the depth
    ``_train_depth`` allows (Mamba2 keeps its 48 layers).  Checks, as
    phase 18 makes them: loss and grad norm finite, grad norm > 0, the
    loss falling; after step 1 every parameter changed; K2 once per step
    (counted from zero around each), no graph kernel."""
    import dataclasses
    import gc
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import dbg_stream
    from repro_torch.lm.model import init_params
    from repro_torch.train.step import OptConfig, init_opt, make_train_step

    out = {}
    t_tok = TRAIN_BATCH * TRAIN_SEQ
    for arch in TRAIN_BLOCK_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        published = get_config(arch)
        depth, n_params, act = _train_depth(published, t_tok)
        cfg, pipe, _ = dbg_stream(
            dataclasses.replace(published, n_layers=depth), TRAIN_BATCH,
            TRAIN_SEQ)
        log(f"  {cfg.arch_id}: depth {depth} of {published.n_layers} "
            f"layers, {n_params} parameters, {16 * n_params / 2**30:.2f} GiB"
            f" of masters, gradients and moments predicted beside "
            f"{act / 2**30:.2f} GiB of activation allowance")
        torch.cuda.reset_peak_memory_stats()
        model = init_params(cfg, seed=0, device=device)
        opt = init_opt(model)
        batches = [{k: torch.from_numpy(v).to(device)
                    for k, v in pipe.batch(i).items()}
                   for i in range(1 + TRAIN_BLOCK_STEPS)]
        ts = make_train_step(cfg, OptConfig(**dict(
            TRAIN_OPT, lr=TRAIN_BLOCKS_LR,
            loss_chunk=TRAIN_BLOCKS_LOSS_CHUNK)))
        counts = {}
        before = _moments(model)
        metrics, ms = _steps(ts, model, opt, batches[:1], counts, cfg.arch_id)
        after = _moments(model)
        same = [n for n in before if before[n] == after[n]]
        if same:
            raise AssertionError(f"{cfg.arch_id}: step 1 left {same[:4]} "
                                 f"({len(same)}) unchanged")
        more, more_ms = _steps(ts, model, opt, batches[1:], counts,
                               cfg.arch_id)
        metrics += more
        ms += more_ms
        # the first batch's loss again after the steps (a forward and
        # backward, no update): training on the stream must have lowered it
        again = float(_counted(counts, f"{cfg.arch_id} first batch again", 1,
                               ts.grads_of, model, batches[0]))
        peak = torch.cuda.max_memory_allocated()
        losses = [m["loss"] for m in metrics]
        for i, m in enumerate(metrics):
            if not (all(x == x and abs(x) != float("inf")
                        for x in m.values()) and m["grad_norm"] > 0):
                raise AssertionError(f"{cfg.arch_id} step {i}: {m}")
        if not again < losses[0]:
            raise AssertionError(f"{cfg.arch_id}: the first batch's loss "
                                 f"{losses[0]} -> {again} after the steps "
                                 f"({losses})")
        if counts["hot_gather"] != len(batches) + 1:
            raise AssertionError(f"{cfg.arch_id}: K2 launched "
                                 f"{counts['hot_gather']} times over "
                                 f"{len(batches) + 1} forward passes")
        del model, opt, batches
        step_ms = statistics.median(ms[1:])
        out[arch] = dict(
            arch=cfg.arch_id, layers=depth, published_layers=published.n_layers,
            n_params=n_params, state_gib=16 * n_params / 2**30,
            activation_allowance_gib=act / 2**30, steps=len(ms),
            first_step_ms=ms[0], step_ms=step_ms, step_ms_all=ms,
            tokens_per_step=t_tok, tokens_per_s=t_tok / step_ms * 1e3,
            peak_gib=peak / 2**30, losses=losses, lr=TRAIN_BLOCKS_LR,
            first_batch_again=again,
            grad_norms=[m["grad_norm"] for m in metrics], launches=counts,
            seconds=time.perf_counter() - t0)
        log(f"  {cfg.arch_id} ({depth} layers): {step_ms:.1f} ms per step "
            f"(median of {len(ms) - 1} after the first, "
            f"{ms[0]:.1f} ms), {t_tok / step_ms * 1e3:.0f} tokens/s, peak "
            f"{peak / 2**30:.2f} GiB; losses {[round(x, 4) for x in losses]}"
            f", the first batch's {losses[0]:.4f} -> {again:.4f} "
            f"({out[arch]['seconds']:.1f} s)")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- main
# ---------------------------------------------------------------- phase 22
def _rel_l2(got, want):
    """(over the whole output, worst per (sequence, head)) relative L2."""
    got, want = got.float(), want.float()
    whole = float((got - want).norm() / want.norm())
    rows = float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())
    return whole, rows


def mla_decode_plane(device):
    """Phase 22: the MLA decode kernel at the deepseek-v2-lite.decode
    cell's shapes (``MLA_BATCH`` sequences, lengths drawn on the card
    log-uniformly in ``MLA_HISTORY``, a room of ``MLA_ROOM`` rows, 16
    heads, DeepSeek-V2-Lite's softmax scale).  Checks: the kernel over the
    bf16 cache against the plain path (``latent_attention_ref``, float32)
    within ``MLA_REL_L2`` relative L2 (and 1e-2 per head, the card tests'
    band), the float32 variant within ``MLA_F32_REL_L2``, the library call
    within the bf16 band too; ``lm.layers.mla_decode`` of one
    DeepSeek-V2-Lite layer over the cache launching it once, counted from
    zero just before (``lm.mla_decode.launches`` and the wrapper's count),
    its rows (``lm.mla_decode.cache_rows``) the lengths' sum.  Times: the
    kernel from an idle device and on the device alone, the plain path,
    the float32 variant, and one library call computing the same function
    (``F.scaled_dot_product_attention``: the 16 heads as 16 queries of one
    key head ``[latent | krope]`` of 576, values the latent, a length
    mask, over the longest sequence's rows), beside the bound: the rows
    read once, 1,152 B each, at ``HBM_BYTES_PER_S``."""
    import math

    import numpy as np
    import torch
    import torch.nn.functional as F

    import repro_torch.lm.model as model_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels.mla_decode import (latent_attention,
                                                latent_attention_ref)
    from repro_torch.lm import layers
    from repro_torch.obs import metrics

    cfg = get_config("deepseek_v2_lite")
    dims = model_mod._mla_dims(cfg)
    b, h, c, r = MLA_BATCH, cfg.n_heads, cfg.kv_lora, cfg.mla_d_rope
    g = torch.Generator(device=device)
    g.manual_seed(0)
    lo, hi = MLA_HISTORY
    lens = torch.empty(b, device=device).uniform_(
        math.log(lo), math.log(hi), generator=g).exp().round().long().clamp(
        lo, hi)
    rows = lens + 1  # the history and the new token's row
    max_rows, total = int(rows.max()), int(rows.sum())
    bf = torch.bfloat16
    lat = torch.randn((b, MLA_ROOM, c), generator=g, device=device, dtype=bf)
    kr = torch.randn((b, MLA_ROOM, r), generator=g, device=device, dtype=bf)
    q = torch.randn((b, h, c + r), generator=g, device=device, dtype=bf)
    ql, qr = q[..., :c], q[..., c:]
    scale = dims.scale

    got = latent_attention(ql, qr, lat, kr, rows, scale, max_rows, total)
    want = latent_attention_ref(ql, qr, lat, kr, rows, scale, max_rows)
    err, err_rows = _rel_l2(got, want)
    max_abs = float((got.float() - want).abs().max())
    if not (err <= MLA_REL_L2 and err_rows <= 1e-2):
        raise AssertionError(f"mla_decode kernel: relative L2 {err:.3g} "
                             f"(worst head {err_rows:.3g}) against the plain "
                             f"path; band {MLA_REL_L2:g} (1e-2 per head)")
    lat32, kr32 = lat.float(), kr.float()
    ql32, qr32 = ql.float(), qr.float()
    got32 = latent_attention(ql32, qr32, lat32, kr32, rows, scale, max_rows,
                             total)
    err32, err32_rows = _rel_l2(got32, want)
    if not err32_rows <= MLA_F32_REL_L2:
        raise AssertionError(f"mla_decode float32 variant: relative L2 "
                             f"{err32:.3g} (worst head {err32_rows:.3g}); "
                             f"band {MLA_F32_REL_L2:g}")

    # the library's call: one key head of [latent | krope], values the
    # latent, a length mask, over the longest sequence's rows
    key = torch.cat([lat[:, :max_rows], kr[:, :max_rows]], dim=-1)[:, None]
    value = lat[:, None, :max_rows]
    mask = (torch.arange(max_rows, device=device)[None, :]
            < rows[:, None])[:, None, None, :]
    qs = q[:, None]

    def library():
        return F.scaled_dot_product_attention(qs, key, value, attn_mask=mask,
                                              scale=scale)

    lib_err, lib_rows = _rel_l2(library()[:, 0], want)
    if not lib_rows <= 1e-2:
        raise AssertionError(f"the library call is off the plain path by "
                             f"{lib_rows:.3g} per head")

    def kernel():
        return latent_attention(ql, qr, lat, kr, rows, scale, max_rows, total)

    def kernel32():
        return latent_attention(ql32, qr32, lat32, kr32, rows, scale,
                                max_rows, total)

    t = dict(
        ms=_events_ms(kernel, REPS),
        device_ms=_events_ms(kernel, REPS, device_only=True),
        plain_ms=_events_ms(lambda: latent_attention_ref(
            ql, qr, lat, kr, rows, scale, max_rows), 3),
        f32_ms=_events_ms(kernel32, REPS),
        f32_device_ms=_events_ms(kernel32, REPS, device_only=True),
        library_ms=_events_ms(library, REPS),
        library_device_ms=_events_ms(library, REPS, device_only=True))
    del key, value, mask, lat32, kr32, got32, want
    torch.cuda.empty_cache()
    bound_ms = total * (c + r) * 2 / HBM_BYTES_PER_S * 1e3
    f32_bound_ms = 2 * bound_ms

    # one DeepSeek-V2-Lite layer's decode over the cache, counted from zero
    params = layers.mla_init(cfg.d_model, dims, generator=g, device=device,
                             dtype=bf)
    x = torch.randn((b, 1, cfg.d_model), generator=g, device=device,
                    dtype=bf)
    at = layers.DecodeAt(lens.cpu().numpy().astype(np.int64), lens)
    metrics.reset_registry()
    _reset_launches()
    with torch.no_grad():
        out, made = _launched({}, layers.mla_decode, params, x, dims, lat,
                              kr, at)
    _sync()
    reg = metrics.get_registry()
    counted = reg.get("lm.mla_decode.launches").value
    cache_rows = reg.get("lm.mla_decode.cache_rows").value
    metrics.reset_registry()
    if made["latent_attention"] != 1 or counted != 1 or any(
            n for k, n in made.items() if k != "latent_attention"):
        raise AssertionError(f"mla_decode launched {made} (counted "
                             f"{counted}), not the kernel once")
    if cache_rows != total or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"mla_decode read {cache_rows} rows, not "
                             f"{total}, or its output is not finite")
    return dict(t, max_abs_err=max_abs, rel_l2=err, rel_l2_per_head=err_rows,
                f32_rel_l2=err32, f32_rel_l2_per_head=err32_rows,
                library_rel_l2=lib_err, bound_ms=bound_ms, bound_by="HBM",
                f32_bound_ms=f32_bound_ms, launches_per_call=2,
                launches=made, batch=b, rows=total, max_rows=max_rows,
                mean_rows=total / b)


def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on the card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: {ROOT} holds no src/repro_torch; run "
                         "it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.reorder import dbg_spec
    from repro_torch.graph import datasets
    from repro_torch.kernels import _build, load_all
    from repro_torch.kernels.edge_map import ell_tiles
    from repro_torch.kernels.edge_map.edge_map import _SOURCE as K5_SOURCE
    from repro_torch.kernels.hist_bin import dbg_bin, hist_bin
    from repro_torch.kernels.hist_bin.hist_bin import (
        _SOURCE as HIST_BIN_SOURCE)
    from repro_torch.lm.embed import embed_lookup

    t_start = time.perf_counter()
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = torch.cuda.get_device_name(0)
    log(f"device: {card} ({smi}); torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        extra = pool.submit(_build.load_many,
                            [(K5_SOURCE, NARROW_BUILDS),
                             (HIST_BIN_SOURCE, HIST_BIN_BUILDS)])
        load_all()
        narrow_builds, hist_builds = extra.result()
    log(f"build: K5, K4, K1, hist_bin (with the stable rank) and K2 "
        f"libraries, K5's sum {' and '.join(NARROW_BUILDS)} and hist_bin "
        f"{' and '.join(HIST_BIN_BUILDS)}, ready in "
        f"{time.perf_counter() - t0:.1f} s (every nvcc started together)")

    # 3. K5 vs plain, every static variant
    dev = torch.device("cuda")
    small = datasets.load("kr", "small")
    spec = dbg_spec(max(1.0, float(small.in_csr.degrees().mean())))
    small_tiles = ell_tiles(small.in_csr, spec.boundaries, device=dev)
    g, g_dbg, gw_dbg, res = build_graphs()
    # phase 12's host layouts, built beside phases 3-11
    dist_pool = ThreadPoolExecutor(1)
    dist_prep = dist_pool.submit(dist_layouts, gw_dbg)
    in_deg = g_dbg.in_csr.degrees()
    big_tiles = ell_tiles(g_dbg.in_csr, dbg_spec(float(in_deg.mean())).boundaries,
                          device=dev)
    t0 = time.perf_counter()
    n1, e1, _ = variant_grid(small_tiles, small.num_vertices, dev, seed=0)
    n2, e2, twice = variant_grid(big_tiles, g_dbg.num_vertices, dev, seed=1)
    if twice == 0:
        raise AssertionError("the main-path graph has no class wider than "
                             "1,024 lanes to check twice")
    log(f"kernel vs plain: {n1} variants on kr/small "
        f"({[tuple(t.idx.shape) for t in small_tiles]}, "
        f"{small_tiles[0].idx.dtype}) and {n2} on the main-path graph's "
        f"classes ({[tuple(t.idx.shape) for t in big_tiles]}, int32 ids), "
        f"all rows, all agree; max |err| of sums {max(e1, e2):.3g}; "
        f"{twice} sums on the hub class bitwise equal over two calls "
        f"({time.perf_counter() - t0:.1f} s)")
    del big_tiles
    torch.cuda.empty_cache()

    # 4. the main path; the launch counts are read from zero
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    backends, runs, records = main_path(g, g_dbg, gw_dbg, dev)
    ell_path = _read_launches()
    log(f"main path: launches {ell_path}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    time_apps(runs, backends, records, {"ell": 1, "flat": 0})
    log(f"main path: warm medians of {EVAL_REPS} runs each, ell and flat "
        f"({time.perf_counter() - t0:.1f} s)")

    # 5. K5 times
    flat, ell = backends["dbg"]
    t = time_pull(flat, ell, REPS, narrow_builds)
    for c in t["per_class"]:
        hub = " (the hub class)" if c["segments"] is not None else ""
        line = (f"  class {c['shape']} {c['dtype']}{hub}: {c['edges']} edges, "
                f"longest row {c['max_deg']}, {c['group']} lanes per row, "
                f"{c['launches']} launch(es)")
        if c["segments"] is not None:
            line += (f", split into {c['segments']} segments: kernel "
                     f"{c['ms']:.4f} ms; a block per whole row "
                     f"{c['block_per_row_ms']:.4f} ms")
        else:
            line += (f", {c['lanes_per_thread']} lanes per thread: kernel "
                     f"{c['ms']:.4f} ms; " + ", ".join(
                         f"{n} {c[n + '_ms']:.4f}" for n in NARROW_BUILDS)
                     + " ms")
        log(line + f"; its share of the bound {c['bound_share_ms']:.4f} ms")
    log(f"timed pull: fused_edge_map {t['ms']:.4f} ms "
        f"({t['launches_per_call']} K5 launches; the device's time alone "
        f"{t['device_ms']:.4f} ms), plain "
        f"{t['plain_ms']:.4f} ms, cuSPARSE {t['library_ms']:.4f} ms (max |err| "
        f"vs flat {t['library_max_abs_err']:.3g}), bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_bytes']} B), padded-plane bound "
        f"{t['padded_bound_ms']:.4f} ms ({t['padded_bytes']} B)")
    log(json.dumps({"apps": records, "edges": g.num_edges,
                    "vertices": g.num_vertices, "k5_per_class": t["per_class"]}))
    ells = {key: b[1] for key, b in backends.items()}  # phase 9's
    del backends, flat, ell
    gc.collect()
    torch.cuda.empty_cache()

    # 6. the packed path; the launch counts are read from zero
    t0 = time.perf_counter()
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    pk = packed_path(g, g_dbg, gw_dbg, res, dev)
    packed = _read_launches()
    idle = [k for k, n in packed.items() if n == 0 and k not in LM_KERNELS]
    if idle:
        raise AssertionError(f"packed path: {idle} never launched ({packed})")
    log(f"packed path: launches {packed}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    time_apps(pk["runs"], {key: (pk["packs"][key],) for key in pk["packs"]},
              pk["records"], {"packed": 0})
    log(f"packed path: warm medians of {EVAL_REPS} runs each "
        f"({time.perf_counter() - t0:.1f} s)")
    log(json.dumps({"packed_apps": pk["records"]}))
    for app, rec in records.items():
        p = pk["records"].get(app)
        log(f"app {app}, seconds per run (median [min-max] of {EVAL_REPS} "
            f"warm runs): ell {_span(rec, 'ell_')}, packed "
            + ("-" if p is None else _span(p, "packed_"))
            + f", flat {_span(rec, 'flat_')}")

    # 7. K4, K1 and hist_bin vs their plain versions
    t0 = time.perf_counter()
    err4, err1, widths, split = new_kernel_grid(pk, small, dev)
    if widths != {1, 2, 4}:
        raise AssertionError(f"K4 was checked on id widths {widths} bytes, "
                             "not on uint8, uint16 and uint32")
    if split == 0:
        raise AssertionError("no K4 table wider than 1,024 slots was checked")
    log(f"new kernels vs plain: all agree ({time.perf_counter() - t0:.1f} s)")

    # 8. their times
    t0 = time.perf_counter()
    k4, k1, hb = (time_hot_spmv(pk, REPS), time_ell_spmv(pk, REPS),
                  time_hist_bin(pk, REPS, hist_builds))
    for c in k4["per_table"]:
        split = ("" if c["segments"] is None
                 else f", split into {c['segments']} pieces")
        log(f"  K4 table {c['shape']} {c['dtype']}: {c['edges']} edges, "
            f"longest row {c['max_deg']}, {c['group']} lanes per row"
            f"{split}, {c['launches']} launch(es): {c['ms']:.4f} ms "
            f"(device alone {c['device_ms']:.4f})")
    log(f"timed K4 (pack_spmv's hot groups, {k4['rows']} rows, {k4['edges']} "
        f"edges): kernel {k4['ms']:.4f} ms (device alone "
        f"{k4['device_ms']:.4f}; {k4['launches_per_call']} launches per "
        f"call), plain {k4['plain_ms']:.4f} ms, cuSPARSE "
        f"{k4['library_ms']:.4f} ms (device alone "
        f"{k4['library_device_ms']:.4f}; max |err| vs K4 "
        f"{k4['library_max_abs_err']:.3g}), bound {k4['bound_ms']:.4f} ms")
    for shape, edges, lanes, ms, pms in k1["per_group"]:
        log(f"  K1 group {shape}: {edges} edges, degree walk {ms:.4f} ms "
            f"({lanes} lanes per row{', split' if lanes == 256 else ''}), "
            f"every lane {pms:.4f} ms")
    log(f"timed K1 (dbg_spmv, {k1['edges']} edges in {k1['lanes']} lanes): "
        f"degree walk {k1['ms']:.4f} ms (device alone "
        f"{k1['device_ms']:.4f}; {k1['launches_per_call']} launches), "
        f"every lane {k1['padded_ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms, "
        f"cuSPARSE {k1['library_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms "
        f"(real lanes), {k1['padded_bound_ms']:.4f} ms (padded planes)")
    sr = hb["stable_rank"]
    log(f"timed hist_bin: kernel {hb['ms']:.4f} ms (device alone "
        f"{hb['device_ms']:.4f}), plain "
        f"{hb['plain_ms']:.4f} ms, searchsorted + bincount "
        f"{hb['library_ms']:.4f} ms (device alone "
        f"{hb['library_device_ms']:.4f}), bound {hb['bound_ms']:.4f} ms; "
        f"two-op build (memset + atomics, bitwise equal) "
        f"{hb['two_ops_ms']:.4f} ms (device alone "
        f"{hb['two_ops_device_ms']:.4f})")
    log(f"timed stable_rank: kernel {sr['ms']:.4f} ms (device alone "
        f"{sr['device_ms']:.4f}), plain {sr['plain_ms']:.4f} ms, argsort + "
        f"scatter_ {sr['library_ms']:.4f} ms (device alone "
        f"{sr['library_device_ms']:.4f}), bound {sr['bound_ms']:.4f} ms")
    log(f"timed device DBG (dbg_bin: hist_bin, then stable_rank): "
        f"{hb['dbg_bin_ms']:.4f} ms (device alone "
        f"{hb['dbg_bin_device_ms']:.4f}), plain "
        f"{hb['dbg_bin_plain_ms']:.4f} ms, searchsorted + argsort + scatter_ "
        f"{hb['dbg_bin_library_ms']:.4f} ms (device alone "
        f"{hb['dbg_bin_library_device_ms']:.4f}), bound "
        f"{hb['dbg_bin_bound_ms']:.4f} ms; host mapping (group_reorder) "
        f"{hb['host_mapping_ms']:.2f} ms ({time.perf_counter() - t0:.1f} s)")

    pk_err = pk["max_err"]
    deg_t, b_t = pk["deg_t"], pk["b_t"]  # phase 15 profiles dbg_bin on them
    del pk
    gc.collect()
    torch.cuda.empty_cache()

    # 9. the paper's evaluation: every ordering x app on ell
    t0 = time.perf_counter()
    evals, tables = paper_eval(g, g_dbg, gw_dbg, res, ells, dev)
    log(f"paper evaluation: {len(EVAL_ORDERINGS)} orderings x "
        f"{len(evals) // len(EVAL_ORDERINGS)} apps, all checks hold "
        f"({time.perf_counter() - t0:.1f} s)")
    log(json.dumps({"paper_eval": evals, "tables": tables, "card": smi}))

    # 10. the streaming plane on phase 4's weighted DBG graph; the launch
    # counts are read from zero inside
    ell_w = ells["dbg_w"]  # phase 12's single-device engine
    del ells
    gc.collect()
    torch.cuda.empty_cache()
    st = stream_plane(gw_dbg, 0, dev)  # the main path's SSSP root
    stream_path = st.pop("launches")
    if stream_path["ell_edge_map"] == 0:
        raise AssertionError("stream: K5 was never launched")
    log(f"streaming plane: launches {stream_path}; peak device memory "
        f"{st['peak_gib']:.2f} GiB ({st['seconds']:.1f} s)")
    log(json.dumps({"stream": st, "card": smi}))

    # 11. the serving plane on phase 4's weighted DBG graph: tune on the
    # card, serve version 0 through backend="auto" at every width, churn;
    # the launch counts are read from zero inside (the serving drive)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sv = serving_plane(gw_dbg, dev)
    serve_path = sv.pop("launches")
    if serve_path["ell_edge_map"] == 0:
        raise AssertionError("serve: K5 was never launched")
    log(f"serving plane: launches {serve_path} "
        f"({time.perf_counter() - t0:.1f} s)")
    log(json.dumps({"serve": sv, "card": smi}))

    # 12. the sharded engine on one NCCL rank over phase 4's weighted DBG
    # graph; the launch counts are read from zero inside
    gc.collect()
    torch.cuda.empty_cache()
    prep = dist_prep.result()
    dist_pool.shutdown()
    dp = dist_plane(gw_dbg, ell_w, prep, dev)
    dist_path = {name: dp["launches"].get(name, 0) for name in _wrappers()}
    del dp["launches"], prep, ell_w
    for key, sz in dp["sizes"].items():
        log(f"  layout D={key}: shard_graph {dp['host_layout_s'][key]:.1f} s "
            f"on the host; hot panel {sz['n_hot']} vertices "
            f"({sz['hot_frac']:.4f} of V), halo {sz['halo_slots']} slots "
            f"(pad {sz['halo_max']} per pair, {sz['halo_bytes_padded']} B "
            f"per pull); per shard (edges, halo received, hot owned): "
            + ", ".join(f"({p['edges']}, {p['halo']}, {p['hot_owned']})"
                        for p in sz["per_shard"]))
    k5s, stm = dp["k5_shards"], dp["stream"]
    log(f"  K5 over every shard's tiles of the {k5s['shards']}-shard layout: "
        f"{k5s['calls']} calls agree with the plain version (max |err| of "
        f"sums {k5s['max_abs_err']:.3g}), {k5s['hub_sums_twice']} hub-class "
        f"sums bitwise over two calls ({k5s['seconds']:.1f} s)")
    log(f"  sharded stream on kr/{DIST_STREAM_SCALE} ({stm['vertices']} "
        f"vertices): {stm['batches']} batches of {stm['edges_per_batch']} "
        f"edges, SSSP bitwise from {stm['sssp_roots']} roots, PageRank gaps "
        f"to a full solve {[f'{x:.3g}' for x in stm['pr_gap']]} and to the "
        f"service {[f'{x:.3g}' for x in stm['pr_service_gap']]}, "
        f"{stm['remap_deltas']} remap "
        f"deltas routed ({stm['moved']} moves), {stm['folds']} folds, "
        f"full_rebuilds {stm['full_rebuilds']} ({stm['seconds']:.1f} s)")
    pl, pr = dp["pull"], dp["pagerank"]
    log(f"dist: pagerank_dist {dp['pagerank_dist_s']:.1f} s cold (layout, "
        f"upload, {dp['pagerank_iters']} iterations; gap "
        f"{dp['pagerank_gap']:.3g}); sharded pull {pl['ms']:.4f} ms (device "
        f"alone {pl['device_ms']:.4f}) vs single-device "
        f"{pl['single_ms']:.4f} ms ({pl['single_device_ms']:.4f}); PageRank "
        f"{_span(pr['sharded'])} s vs {_span(pr['single'])} s; launches "
        f"{dist_path} ({dp['seconds']:.1f} s)")
    log(json.dumps({"dist": dp, "card": smi}))

    # 13. K2 vs plain, once the graph state has left the card
    del small_tiles, small, g, g_dbg, gw_dbg, res
    gc.collect()
    torch.cuda.empty_cache()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls must not run in TF32")
    log("float32 matmuls: full float32 (torch.backends.cuda.matmul."
        "allow_tf32 = False)")
    t0 = time.perf_counter()
    n9, e9 = k2_grid(dev)
    log(f"K2 vs plain: {n9} cases "
        f"bitwise equal, max |err| {e9} "
        f"({time.perf_counter() - t0:.1f} s)")

    # 14. the LM serving path at reduced size, every block kind, card
    # against CPU
    t0 = time.perf_counter()
    used = lm_parity(dev)
    log(f"LM parity, card vs CPU: worst logit gap {max(used.values()):.3g} "
        f"of the band ({time.perf_counter() - t0:.1f} s)")

    # 15. the LM serving path at full width; counts read from zero inside
    t0 = time.perf_counter()
    model, served, lm = lm_serve(dev)
    prof = profile_decode_step(model, served)
    lm["profile"] = prof
    log(f"LM serving path: launches {lm['launches']} "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"  one decode step under torch.profiler: {prof['step_ms']:.3f} ms "
        f"(CUDA events), device busy {prof['busy_ms']:.3f} ms "
        f"({prof['launches']} device launches)")
    for kname, n, ms in prof["top"]:
        log(f"    {ms:9.3f} ms  {n:4d} x  {kname}")

    # 16. K2's times
    t0 = time.perf_counter()
    k2 = time_k2(model, served, REPS)
    for label, m in k2.items():
        log(f"timed K2 ({label}, T={m['t']}, D={model.cfg.d_model} float32): "
            f"kernel {m['ms']:.4f} ms (device alone {m['device_ms']:.4f}), "
            f"plain {m['plain_ms']:.4f} ms, F.embedding "
            f"{m['library_ms']:.4f} ms (device alone "
            f"{m['library_device_ms']:.4f}), bound {m['bound_ms']:.5f}"
            f" ms ({m['bound_by']}; {m['distinct_rows']} distinct rows; "
            f"{m['bound_ms_t_rows']:.5f} ms if every row were read)")
    m = k2["decode"]
    log(f"  host time per call at the decode call (1,000 calls, no sync): "
        f"hot_gather {m['host_us']:.2f} us, F.embedding "
        f"{m['library_host_us']:.2f} us")
    # the device operations of what the serving loop passes to embed_lookup
    # (a prefill step's strided column of the prompt, a decode step's (B, 1)
    # greedy pick) and of hist_bin and dbg_bin at phase 8's call: all here,
    # after phase 15's session, as this process's profiler reads reliably
    prefill, decode = served[:, 1:2], served[:, -1:].contiguous()
    with torch.no_grad():
        ops = _device_ops({
            "prefill": lambda: embed_lookup(model.embed, prefill),
            "decode": lambda: embed_lookup(model.embed, decode),
            "hist_bin": lambda: hist_bin(deg_t, b_t),
            "dbg_bin": lambda: dbg_bin(deg_t, b_t)})
    want = {"prefill": 1, "decode": 1, "hist_bin": 1, "dbg_bin": 2}
    for what, names in ops.items():
        log(f"  one {what} call: {len(names)} device operation(s) {names}")
        if len(names) != want[what]:
            raise AssertionError(f"one {what} call made {len(names)} device "
                                 f"operations, not {want[what]}")
    lookups = {k: ops[k] for k in ("prefill", "decode")}
    hb["device_ops_per_call"] = len(ops["hist_bin"])
    hb["dbg_bin_device_ops_per_call"] = len(ops["dbg_bin"])
    log(f"K2 timings done ({time.perf_counter() - t0:.1f} s)")

    # 17. the full-sequence forward (A12.1) at full width; the launch counts
    # are read from zero inside
    t0 = time.perf_counter()
    fw = lm_forward(model, served, lm.pop("step_logits"), FORWARD_REPS)
    c = model.cfg
    log(f"LM forward: {c.arch_id} ({c.n_layers} layers, d_model {c.d_model},"
        f" {c.n_heads}/{c.n_kv_heads} heads) over the served tokens "
        f"{tuple(served.shape)}: logits at {fw['band_used']:.3g} of the "
        f"decode band (rtol 2e-2, atol 2e-4) against generate's steps, "
        f"last_only at {fw['last_only_band_used']:.3g} of rtol 1e-4, atol "
        f"1e-5; launches {fw['launches']}; {fw['ms']:.3f} ms per forward "
        f"from an idle device (median of {FORWARD_REPS}), "
        f"{fw['tflops_per_s']:.2f} TFLOP/s float32 "
        f"({time.perf_counter() - t0:.1f} s)")
    del model, deg_t, b_t
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps({"lm_serve": {k: v for k, v in lm.items()
                                 if k != "launches"},
                    "k2": k2, "embed_lookup_launches": lookups,
                    "lm_forward": fw, "card": smi}))

    # 18. training (A12.2): OLMo-1B at full width, the reduced card-vs-CPU
    # steps, the driver's resume; the launch counts are read from zero
    # inside, over the full-width steps
    t0 = time.perf_counter()
    tr = lm_train(dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"LM training: {tr['arch']} ({tr['n_params']} parameters), "
        f"{tr['tokens_per_step']} tokens per step, bf16 compute: "
        f"{tr['step_ms']:.1f} ms per step (median [{tr['step_ms_min']:.1f}-"
        f"{tr['step_ms_max']:.1f}] of {TRAIN_TIMED}, synced; first step "
        f"{tr['first_step_ms']:.1f} ms), {tr['tokens_per_s']:.0f} tokens/s, "
        f"{tr['tflops_per_s']:.1f} TFLOP/s ({tr['flops_formula']}; "
        f"{tr['bf16_peak_share']:.3f} of the bf16 peak), peak device memory "
        f"{tr['peak_gib']:.2f} GiB, embedding backward "
        f"{tr['embed_backward_ms']:.3f} ms per step; losses "
        f"{[round(x, 4) for x in tr['losses']]}; launches {tr['launches']}")
    pf = tr["profiled_step"]
    log(f"  step split (CUDA events, 2 steps): gradients "
        f"{[round(x, 1) for x in tr['grads_ms']]} ms, update "
        f"{[round(x, 1) for x in tr['update_ms']]} ms; one profiled step: "
        f"wall {pf['wall_ms']:.1f} ms, device busy {pf['busy_ms']:.1f} ms "
        f"(idle share {pf['idle_share']:.3f}), {pf['launches']} kernels")
    for cls, c in pf["classes"].items():
        log(f"    {c['ms']:9.2f} ms  {c['launches']:6d} x  {cls}")
    for name, n, ms in pf["top"]:
        log(f"    {ms:9.2f} ms  {n:6d} x  {name}")
    parity = train_parity(dev)
    log(f"  reduced card vs CPU: worst shares of the bands {parity}")
    drv = train_driver(DRIVER_STEPS)
    log(f"  driver m100: loss {drv['first_loss']:.4f} -> "
        f"{drv['last_loss']:.4f} (first/last fifth {drv['first_fifth_loss']:.4f}"
        f" -> {drv['last_fifth_loss']:.4f}), resume bitwise "
        f"({time.perf_counter() - t0:.1f} s)")
    log(json.dumps({"train": dict(tr, parity=parity, driver=drv),
                    "card": smi}))

    # 19. (OLMo-1B freed) the remaining block kinds at full width: MLA +
    # MoE, RG-LRU + local attention, SSD, each served and freed in turn
    t0 = time.perf_counter()
    blocks = lm_blocks(dev)
    blocks_launches = {k: sum(b["launches"][k] for b in blocks.values())
                       for k in _wrappers()}
    if any(n for k, n in blocks_launches.items() if k not in LM_KERNELS):
        raise AssertionError(f"graph kernels launched on the LM path: "
                             f"{blocks_launches}")
    log(f"LM block kinds at full width: {list(blocks)}, launches "
        f"{blocks_launches} ({time.perf_counter() - t0:.1f} s)")
    log(json.dumps({"lm_blocks": blocks, "card": smi}))

    # 20. the sharded LM (A12.7): phase 18's step through shard_model on a
    # one-rank NCCL mesh beside the unsharded step; counts read from zero
    # around each step inside
    t0 = time.perf_counter()
    sh = lm_sharded(dev)
    ws = sh["worst_share"]
    log(f"LM sharded step: {sh['arch']} on a (1, 1) NCCL DeviceMesh, "
        f"{sh['params_with_axes']} of {sh['n_tensors']} parameters with "
        f"mesh axes in their rules (every axis of size 1: DTensor, NCCL and "
        f"K2 in the step, no exchange); "
        f"{sh['step_ms']:.1f} ms per step (median of {SHARDED_STEPS} after "
        f"the first) against {sh['plain_step_ms']:.1f} ms unsharded "
        f"(phase 18: {tr['step_ms']:.1f}); worst shares of "
        f"PARITY_PARAM_ATOL: loss {ws['loss']:.3g}, grad norm "
        f"{ws['grad_norm']:.3g}, parameters {ws['params']:.3g}; peak "
        f"{sh['peak_gib']:.2f} GiB; launches {sh['launches']} "
        f"({time.perf_counter() - t0:.1f} s)")
    log(json.dumps({"lm_sharded": sh, "card": smi}))

    # 21. the new block kinds trained at published widths (A12.8)
    t0 = time.perf_counter()
    tb = lm_train_blocks(dev)
    train_blocks_launches = {k: sum(b["launches"].get(k, 0)
                                    for b in tb.values())
                             for k in _wrappers()}
    log(f"LM block kinds trained: {list(tb)}, launches "
        f"{train_blocks_launches} ({time.perf_counter() - t0:.1f} s)")
    log(json.dumps({"lm_train_blocks": tb, "card": smi}))

    # 22. the MLA decode kernel at the LM benchmark cell's shapes; its
    # launches through the model's layer counted from zero inside
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mla = mla_decode_plane(dev)
    log(f"MLA decode at the deepseek-v2-lite.decode shapes ({mla['batch']} "
        f"sequences, {mla['rows']} rows, longest {mla['max_rows']}): kernel "
        f"{mla['ms']:.4f} ms (device alone {mla['device_ms']:.4f}) against "
        f"a bound of {mla['bound_ms']:.4f} ms ({mla['bound_ms'] / mla['device_ms']:.3f}"
        f" of it); library (scaled_dot_product_attention) "
        f"{mla['library_ms']:.4f} ms ({mla['library_device_ms']:.4f}); plain "
        f"{mla['plain_ms']:.3f} ms; float32 variant {mla['f32_ms']:.4f} ms "
        f"({mla['f32_device_ms']:.4f}; bound {mla['f32_bound_ms']:.4f}); "
        f"relative L2 {mla['rel_l2']:.3g} (worst head "
        f"{mla['rel_l2_per_head']:.3g}), float32 {mla['f32_rel_l2']:.3g}, "
        f"library {mla['library_rel_l2']:.3g}; mla_decode launches "
        f"{mla['launches']} ({time.perf_counter() - t0:.1f} s)")
    log(json.dumps({"mla_decode": mla, "card": smi}))

    timed = {
        "ell_edge_map": dict(t, max_abs_err=max(
            e1, e2, t["max_abs_err"], sv["plane"]["max_abs_err"],
            dp["k5_shards"]["max_abs_err"])),
        "hot_spmv": dict(k4, max_abs_err=max(err4, k4["max_abs_err"],
                                             pk_err["hot_spmv"])),
        "ell_spmv": dict(k1, max_abs_err=max(err1, k1["max_abs_err"],
                                             pk_err["ell_spmv"])),
        "hist_bin": hb,
        "stable_rank": hb["stable_rank"],
        "hot_gather": dict(k2["decode"], max_abs_err=max(
            e9, lm["max_abs_err"], k2["decode"]["max_abs_err"],
            k2["zipf"]["max_abs_err"]), at_zipf_8192=k2["zipf"]),
        "latent_attention": mla,
    }
    # K5 carries the main (ell) path, K2 the LM path, the others the packed one
    home = {"ell_edge_map": "ell", "hot_gather": "lm_serve",
            "latent_attention": "lm_mla"}
    kernels = []
    for kname, (_, source, replaces) in _wrappers().items():
        m = timed[kname]
        by_path = {"ell": ell_path[kname], "packed": packed[kname],
                   "stream": stream_path[kname], "serve": serve_path[kname],
                   "dist": dist_path[kname],
                   "lm_serve": lm["launches"][kname],
                   "lm_forward": fw["launches"][kname],
                   "lm_train": tr["launches"][kname],
                   "lm_blocks": blocks_launches[kname],
                   "lm_sharded": sh["launches"].get(kname, 0),
                   "lm_train_blocks": train_blocks_launches[kname],
                   "lm_mla": mla["launches"][kname]}
        entry = {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": by_path[home.get(kname, "packed")],
            "launches_by_path": by_path,
            "launches_per_call": m["launches_per_call"],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "device_ms": m["device_ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "library_device_ms": m["library_device_ms"],
        }
        if "dbg_bin_ms" in m:  # hist_bin: its caller, the device DBG
            for key in ("device_ops_per_call", "two_ops_ms",
                        "two_ops_device_ms", "dbg_bin_ms",
                        "dbg_bin_device_ms", "dbg_bin_bound_ms",
                        "dbg_bin_plain_ms", "dbg_bin_library_ms",
                        "dbg_bin_library_device_ms",
                        "dbg_bin_device_ops_per_call"):
                entry[key] = m[key]
        if kname == "ell_edge_map":  # one stream push, base + delta
            entry["stream_push"] = {k: st["push_device"][k] for k in (
                "fused_ms", "fused_device_ms", "flat_ms", "flat_device_ms",
                "bound_ms", "bound_by", "padded_bound_ms", "launches",
                "max_abs_err", "band")}
            entry["serve_plane"] = {k: sv["plane"][k] for k in (
                "k", "backend", "ms", "device_ms", "k1x8_ms",
                "k1x8_device_ms", "library_ms", "library_device_ms",
                "bound_ms", "bound_by", "launches", "max_abs_err", "band",
                "sssp_push")}
            entry["serve_plane"]["launches_on_path"] = serve_path[kname]
            entry["dist"] = dict(dp["pull"], shards=1,
                                 k5_shard_calls=dp["k5_shards"]["calls"],
                                 launches_on_path=dist_path[kname])
        if "padded_ms" in m:  # K1 without the degrees: every lane
            entry["padded_ms"] = m["padded_ms"]
            entry["padded_bound_ms"] = m["padded_bound_ms"]
        if kname == "hot_gather":  # the LM's forward and training
            entry["lm_train"] = {
                "launches": tr["launches"][kname],
                "forward_passes": 1 + TRAIN_TIMED,
                "backward": "plain (gather_backward)",
                "backward_ms_per_step": tr["embed_backward_ms"],
                "tokens_per_step": tr["tokens_per_step"],
                "step_ms": tr["step_ms"]}
        if "at_zipf_8192" in m:
            entry["at_zipf_8192"] = {k: m["at_zipf_8192"][k] for k in (
                "ms", "device_ms", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms", "bound_by",
                "distinct_rows")}
        kernels.append(entry)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
