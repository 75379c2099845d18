"""LM decode: a chat server keeps resident conversations in one model's
latent cache on one card and decodes one token for each of them a step.

Set-up builds the two kernels the path runs (``kernels``), draws the
weights on the device from the seed and loads them into the program's
``LM`` by name, strictly (``weights``), allocates the cache with a row of
room per position and fills each slot's resident history into it from the
seed (``cache``), records the program's decode step over that cache as a
CUDA graph (``graph``: ``serve.DecodeGraph``, the step a server replays),
and builds the first-token stream (``vocab``).  A job is one batched decode
step of the program, one replay of that graph: every slot's next token,
each the program's own greedy pick of the last step, in a closed loop.  A
slot's turn answers a drawn number of tokens; then the slot takes the next
turn of its resident session: the cache rows of the history stay, the
answer's rows are written again from the history's end, and the turn's
first token comes from the program's ``ZipfPipeline`` through DBG's
vocabulary mapping (``core.vocab.reorder_vocab``).

The check: each slot keeps one step of its turn, drawn uniformly from the
seed as the turn goes (its logits and input token, on the device; no host
read in a window), so the steps kept at the end come from the slots' final
turns, whose cache rows are still in place.  After the windows, the plain
float32 reference (``bench.reference.deepseek_v2``) recomputes a seeded
choice of them (``sample_per_app``, as many as there are slots) layer by
layer from the same weights, the histories drawn again from the seed and
the turn's rows the program wrote, and compares the full logits row and,
in every layer, the cache row the step wrote.

Its limits: the whole-depth numbers (``logits_rel_l2``,
``cache_row_rel_l2``) are loose, for a bf16 program's expert choices flip
where the reference's router has a near-tie, and a flip moves every later
layer.  The tight one, ``cache_row_rel_l2_untied``, reads each layer's row
from layer 0 down to the first MoE layer whose router is near a tie, that
layer's own row included (it is written before the layer routes): there
the program computed what the reference did, and its error is bf16's
rounding alone, which adds up layer by layer as a random walk, so layer
``l``'s error is read over ``sqrt(l + 1)``.  A router is near a tie where
the margin of its k-th choice over the first expert left out is under
``ROUTER_TIE_SIGMAS`` times the program's error at that layer's row times
the spread of the router's logits: a perturbation of the router's input of
that relative size moves a logit by about that error times the spread.

A configuration file names this system (``"system": "lm_decode"``), the
program's preset that is the published model (``program_arch``), the
published ``config.json``'s keys (``program_config`` maps them onto the
preset and raises on a value the program has no option for),
``hot_vocab_rows``, and the ``dtype`` of the weights and the
``cache_dtype``.  A mix gives the ``batch`` of resident slots, the
``history`` lengths (``min``, ``max``, drawn log-uniformly per slot), the
``answer`` lengths (``min``, ``max``, drawn uniformly per turn) and the
first tokens' ``zipf_alpha``; a slot's room is the longest history plus
the longest answer.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import sys
from typing import Dict, List

import numpy as np
import torch

from ..lib import inputs, lm_inputs, lm_work, program, traffic
from ..reference import deepseek_v2 as reference

__all__ = ["FIXED", "ROUTER_TIE_SIGMAS", "program_config", "FirstTokens",
           "Cell", "untied_depth"]

#: Published values the program computes with no option to change them.
FIXED = {"q_lora_rank": None, "topk_method": "greedy", "scoring_func":
         "softmax", "n_group": 1, "topk_group": 1, "routed_scaling_factor": 1,
         "hidden_act": "silu", "tie_word_embeddings": False,
         "moe_layer_freq": 1, "attention_bias": False, "rms_norm_eps": 1e-6}

#: A router is near a tie where its top-k margin is under this many times
#: the program's row error at its layer times its logits' spread: about
#: that many standard deviations of the logits' perturbation.
ROUTER_TIE_SIGMAS = 8.0

#: The program's counters a window reads.
COUNTERS = ("lm.mla_decode.cache_rows", "lm.mla_decode.launches")


def program_config(config: dict):
    """The program's preset ``config["program_arch"]`` with the published
    keys of ``config`` on it (the preset itself where they are its own)."""
    from repro_torch import configs

    wrong = {k: config.get(k) for k, v in FIXED.items()
             if config.get(k) != v}
    rs = config["rope_scaling"]
    if wrong or rs.get("type") != "yarn":
        raise ValueError(f"the program computes {FIXED} with YaRN rope; "
                         f"the configuration has {wrong} and {rs}")
    return dataclasses.replace(
        configs.get_config(config["program_arch"]),
        n_layers=config["num_hidden_layers"], d_model=config["hidden_size"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        d_ff=config["intermediate_size"], vocab_size=config["vocab_size"],
        rope_theta=float(config["rope_theta"]),
        n_experts=config["n_routed_experts"],
        top_k=config["num_experts_per_tok"],
        n_shared_experts=config["n_shared_experts"],
        moe_d_ff=config["moe_intermediate_size"],
        kv_lora=config["kv_lora_rank"], mla_d_nope=config["qk_nope_head_dim"],
        mla_d_rope=config["qk_rope_head_dim"], mla_d_v=config["v_head_dim"],
        first_dense_layers=config["first_k_dense_replace"],
        moe_norm_topk=bool(config["norm_topk_prob"]),
        hot_vocab_rows=config["hot_vocab_rows"],
        yarn_factor=float(rs["factor"]), yarn_mscale=float(rs["mscale"]),
        yarn_mscale_all_dim=float(rs["mscale_all_dim"]),
        yarn_original_max_pos=rs["original_max_position_embeddings"],
        yarn_beta_fast=float(rs["beta_fast"]),
        yarn_beta_slow=float(rs["beta_slow"]))


class FirstTokens:
    """Each new turn's first token: the program's Zipf stream over the
    vocabulary, remapped by DBG's vocabulary reordering of its own
    frequencies, read one token at a time."""

    def __init__(self, vocab: int, alpha: float, seed: int):
        from repro_torch.core.vocab import reorder_vocab
        from repro_torch.data.pipeline import DataConfig, ZipfPipeline

        cfg = DataConfig(vocab_size=vocab, seq_len=255, batch_size=1,
                         alpha=alpha, seed=seed)
        self.mapping = reorder_vocab(ZipfPipeline(cfg).frequencies())
        self._pipe = ZipfPipeline(cfg, vocab_map=self.mapping)
        self._step = 0
        self._left: List[int] = []

    def __call__(self) -> int:
        if not self._left:
            self._left = self._pipe.batch(self._step)["tokens"][0].tolist()
            self._step += 1
        return int(self._left.pop())


class Cell:
    """The program serving the slots: set-up, steps, and the check."""

    def __init__(self, config: dict, mix: dict, check: dict, seed: int,
                 device: torch.device, spans):
        from repro_torch import kernels
        from repro_torch.lm import model as model_mod
        from repro_torch.lm import serve

        if device.type == "cuda":  # the peak counts the program's state
            torch.cuda.reset_peak_memory_stats(device)
        self.config, self.mix, self.seed, self.device = (config, mix, seed,
                                                         device)
        self.model_mod = model_mod
        self.cfg = cfg = program_config(config)
        self.cache_dtype = getattr(torch, config["cache_dtype"])
        self.samples_wanted = int(check["sample_per_app"])
        b = self.batch = int(mix["batch"])
        hist, ans = mix["history"], mix["answer"]
        self.answer = (int(ans["min"]), int(ans["max"]))
        room = int(hist["max"]) + self.answer[1]
        rng = np.random.default_rng(inputs.derive_seed(seed, "histories"))
        drawn = np.exp(rng.uniform(math.log(hist["min"]),
                                   math.log(hist["max"]), b))
        self.history = np.clip(np.rint(drawn), hist["min"],
                               hist["max"]).astype(np.int64)
        self._turn_rng = np.random.default_rng(inputs.derive_seed(seed,
                                                                  "turns"))
        self._sample_rng = np.random.default_rng(inputs.derive_seed(seed,
                                                                    "sample"))
        if device.type == "cuda":
            with spans("kernels"):
                kernels.load_all(("gather_embed.gather_embed",
                                  "mla_decode.mla_decode"))
        with spans("weights", sync=True):
            model = model_mod.LM(cfg, device="meta",
                                 dtype=getattr(torch, config["dtype"]))
            shapes = {k: (tuple(v.shape), v.dtype)
                      for k, v in model.state_dict().items()}
            self.tensors = lm_inputs.draw_weights(shapes, cfg.d_model, seed,
                                                  device)
            model.load_state_dict(self.tensors, strict=True, assign=True)
            self.model = model.eval()
        with spans("cache", sync=True):
            self.cache = model_mod.init_cache(cfg, b, room, device=device,
                                              dtype=self.cache_dtype)
            for i, layer in enumerate(self.cache["layers"]):
                for s, n in enumerate(self.history.tolist()):
                    latent, krope = self._history(i, s)
                    layer["latent"][s, :n] = latent
                    layer["krope"][s, :n] = krope
            model_mod.set_lengths(self.cache, self.history)
        with spans("graph", sync=True):
            self.decode = serve.DecodeGraph(self.model, self.cache)
        with spans("vocab"):
            self.first_tokens = FirstTokens(
                cfg.vocab_size, float(mix["zipf_alpha"]),
                inputs.derive_seed(seed, "tokens") % (1 << 32))
        self.sizes = {"cache_row_bytes": lm_work.cache_row_bytes(config),
                      "step_tokens": b}
        self.counters: Dict[str, float] = {}
        self.per_app: Dict[str, List[float]] = {}
        self.token = self.decode.token  # the graph's input
        self.kept_logits = torch.zeros((b, cfg.vocab_size),
                                       dtype=self.model.embed["unembed"].dtype,
                                       device=device)
        self.kept_tokens = torch.zeros(b, dtype=torch.int32, device=device)
        self.left = np.zeros(b, dtype=np.int64)  # tokens each turn owes
        self.steps = np.zeros(b, dtype=np.int64)  # steps of each turn
        self.kept: Dict[int, int] = {}  # slot -> position of its kept step
        self._chosen: List[tuple] = []
        self._begin_turns(np.arange(b))

    # -- inputs ------------------------------------------------------------
    def _history(self, layer: int, slot: int):
        """Slot ``slot``'s history rows in ``layer``, as the cache holds
        them."""
        latent, krope = lm_inputs.history_rows(
            self.seed, layer, slot, int(self.history[slot]),
            self.tensors[f"layers.{layer}.mix.kv_norm.scale"],
            self.cfg.mla_d_rope, self.device)
        return latent.to(self.cache_dtype), krope.to(self.cache_dtype)

    def _begin_turns(self, slots: np.ndarray) -> None:
        """A new turn in each of ``slots``: its answer length drawn, its
        length back at the history's end, its first token from the Zipf
        stream; no step of it kept yet."""
        lens = np.array(self.cache["len"])
        for s in slots.tolist():
            self.left[s] = self._turn_rng.integers(self.answer[0],
                                                   self.answer[1] + 1)
            self.steps[s] = 0
            self.kept.pop(s, None)
            lens[s] = self.history[s]
        self.model_mod.set_lengths(self.cache, lens)
        first = torch.tensor([self.first_tokens() for _ in slots.tolist()],
                             dtype=torch.int32)
        self.token[torch.from_numpy(slots).to(self.device), 0] = first.to(
            self.device)

    # -- jobs ---------------------------------------------------------------
    def jobs(self):
        return traffic.jobs(self.mix, np.random.default_rng(
            inputs.derive_seed(self.seed, "jobs")), lambda spec, rng: spec)

    def run(self, app: str, p: dict):
        """One decode step of every slot; returns its logits."""
        logits, _ = self.decode()
        logits = logits[:, 0, :self.cfg.vocab_size]
        self.steps += 1
        # keep one step per turn, each with chance 1/steps (a reservoir)
        swap = np.flatnonzero(self._sample_rng.random(self.batch)
                              * self.steps < 1)
        if swap.size:
            ix = torch.from_numpy(swap).to(self.device)
            self.kept_logits[ix] = logits[ix]
            self.kept_tokens[ix] = self.token[ix, 0]
            for s in swap.tolist():
                self.kept[s] = int(self.cache["len"][s]) - 1
        self.token.copy_(logits.argmax(dim=-1, keepdim=True))
        self.left -= 1
        ended = np.flatnonzero(self.left <= 0)
        if ended.size:
            self._begin_turns(ended)
        return logits

    def warm_up(self, steps: int = 3):
        """A few steps on every slot (every shape the window takes), then
        fresh turns."""
        for _ in range(steps):
            self.run("decode", {})
        self._begin_turns(np.arange(self.batch))
        self._count()

    def done(self, app: str, p: dict, out, seconds: float):
        self.per_app.setdefault(app, []).append(seconds)
        self._count()

    def _count(self):
        """The program's counts so far: a window reads their change."""
        for name in COUNTERS:
            self.counters[name] = program.value(name) or 0

    def release(self):
        """Keep what the check reads (the chosen steps' logits, tokens and
        their turns' cache rows), free the cache and the model."""
        slots = sorted(self.kept)
        rng = np.random.default_rng(inputs.derive_seed(self.seed, "check"))
        chosen = rng.choice(slots, min(self.samples_wanted, len(slots)),
                            replace=False) if slots else []
        for s in sorted(int(x) for x in chosen):
            pos = self.kept[s]
            h = int(self.history[s])
            rows = [(layer["latent"][s, h:pos + 1].clone(),
                     layer["krope"][s, h:pos + 1].clone())
                    for layer in self.cache["layers"]]
            self._chosen.append((s, pos, int(self.kept_tokens[s]),
                                 self.kept_logits[s].clone(), rows))
        self.cache = self.model = self.decode = None
        self.kept_logits = self.token = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------
    def samples(self):
        return [("decode", {"slot": s, "position": pos}, logits)
                for s, pos, _, logits, _ in self._chosen]

    def check(self) -> Dict[str, float]:
        """The worst relative L2 error of the chosen steps' logits rows and
        of the cache rows they wrote in any layer, and the worst of the
        rows down to each step's first near-tie, each over the square root
        of its depth (``untied``); NaN (which fails every limit) where
        nothing was kept."""
        found = {"logits_rel_l2": math.nan, "cache_row_rel_l2": math.nan,
                 "cache_row_rel_l2_untied": math.nan}
        w = reference.Weights(self.tensors)
        pub = reference.Published.of(self.config)
        worst: Dict[str, float] = {}
        with reference.full_float32(), torch.no_grad():
            for s, pos, tok, got, rows in self._chosen:
                def history(i, s=s, rows=rows):
                    latent, krope = self._history(i, s)
                    return (torch.cat([latent, rows[i][0][:-1]]),
                            torch.cat([krope, rows[i][1][:-1]]))

                routers: List[tuple] = []
                want, want_rows = reference.decode(w, pub, tok, pos, history,
                                                   self.device, routers)
                errs = [_rel_l2(torch.cat([lat[-1], kr[-1]]), row)
                        for (lat, kr), row in zip(rows, want_rows)]
                depth = untied_depth(errs, routers, ROUTER_TIE_SIGMAS)
                print(f"check: slot {s} position {pos}: logits "
                      f"{_rel_l2(got, want):.3e}, cache rows by layer "
                      f"{' '.join(f'{e:.1e}' for e in errs)}; router "
                      "margins over spread "
                      f"{' '.join(f'{m / sd:.3f}' for _, m, sd in routers)};"
                      f" untied through layer {depth}",
                      file=sys.stderr, flush=True)
                untied = [e / math.sqrt(i + 1)
                          for i, e in enumerate(errs[:depth + 1])]
                for key, x in (("logits_rel_l2", _rel_l2(got, want)),
                               ("cache_row_rel_l2", _worst(errs)),
                               ("cache_row_rel_l2_untied", _worst(untied))):
                    worst[key] = _worst([worst.get(key, x), x])
        found.update(worst)
        return found


def untied_depth(errs: List[float], routers: List[tuple],
                 tie_sigmas: float) -> int:
    """The first MoE layer whose router is near a tie (its margin under
    ``tie_sigmas`` x the row error ``errs`` of that layer x its logits'
    spread), or the last layer where none is."""
    for i, margin, spread in routers:
        if margin < tie_sigmas * errs[i] * spread:
            return i
    return len(errs) - 1


def _worst(values) -> float:
    """The largest of ``values``, NaN if any is NaN."""
    return float(np.max(np.asarray(values, dtype=np.float64)))


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """``|got - want| / |want|`` in float32 (NaN stays NaN)."""
    got, want = got.float(), want.float()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))
