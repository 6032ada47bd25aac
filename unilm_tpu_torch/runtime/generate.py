"""Generation engine: greedy, sampling, beam, diverse-siblings,
length-constrained and diverse beam search, ensembling, lexically
constrained beam search and aggressive (draft-and-verify) decoding (port
of unilm_tpu/runtime/generate.py: `GenerationConfig` :37, `_tile_cache`
:73, `_topk_over_beams` :85, `_gather_beams` :107, `_ngram_ban_mask`
:135, `_adjust_logprobs` :163, `_apply_len_constraints` :180,
`length_constraints` :202, `greedy_generate` :216, `beam_generate` :285,
`generate` :444, `make_ensemble` :467, `diverse_beam_generate` :511,
`pack_constraints` :673, `_advance_progress` :700,
`constrained_beam_generate` :723, `_rewind_cache` :923,
`aggressive_generate` :936).

Model adapter: two closures
    prefill(tokens [B, P], aux) -> (logits [B, P|1, V], cache)
    step(token [B, 1], cache, aux) -> (logits [B, 1, V], cache)
(models/kosmos.py make_unigpt_generate_fns). The JAX `params` argument
has no counterpart: the torch modules own their weights. A cache is a tree
of dicts, lists, tuples and dataclasses whose tensor leaves lead with the
batch; Python numbers and 0-d tensors are shared counters.

The decode loops are Python loops with the JAX while_loops' conditions
(greedy stops once every row has emitted eos; beam search once every
sentence's finished set cannot be beaten). Every top-k is `_top_k`: a
stable sort, so that ties go to the lower index as in `jax.lax.top_k`,
and the token streams equal JAX's.

Beams are folded into the batch, and a reorder gathers every batch-leading
cache leaf (`_gather_beams`). The port's decode writes pool rows in place,
so the gather returns fresh tensors (`index_select`), never views: two
beams that share a parent must not share storage. The exception is an
encoder-decoder's cross-attention K/V (`cross_key` / `cross_value`, 5-D,
`_is_shared_cross_leaf`): every beam of a sentence reads the same source,
so beam search neither tiles them nor, while the beam count holds,
reorders them; the decoder folds the beams into the query length.

Sampling draws from an explicit `torch.Generator` (Gumbel-max over the
kept candidates, as `jax.random.categorical`); JAX's key stream cannot be
reproduced, so its tokens differ, but its kept support (top-k, top-p) is
the same.

`constrained_beam_generate` is fairseq's LexicallyConstrainedBeamSearch
as the JAX package redesigned it for static shapes (ordered constraints,
dynamic beam allocation by banks of constraint progress); every top-k in
it is the stable `_top_k`, so ties break as JAX's and the beams equal
JAX's. `aggressive_generate` (GAD) verifies a drafted block in one
decoder call of T = D + 1 tokens (the generic T > 1 decode path, over
`kv_len = start + T`) and rewinds the cache's counters to the accepted
length (`_rewind_cache`): stale pool rows past it are hidden by kv_len on
the next verify and by the decode kernel's `lengths` on a one-token step,
and overwritten by later writes. There is no `jax.jit` to port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1.0e7


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    beam_size: int = 5
    max_new_tokens: int = 200
    min_new_tokens: int = 1
    len_penalty: float = 1.0
    unk_penalty: float = 0.0
    temperature: float = 1.0
    no_repeat_ngram_size: int = 0
    sampling: bool = False
    sampling_topk: int = 0
    sampling_topp: float = 0.0
    pad: int = 1
    eos: int = 2
    unk: int = 3
    vocab_size: int = 0
    # diverse beam (fairseq search.DiverseBeamSearch)
    num_groups: int = 1
    diversity_strength: float = 0.5
    # diverse siblings (fairseq search.DiverseSiblingsSearch): the k-th
    # best continuation of a beam pays rate * k; 0 = plain beam
    diversity_rate: float = 0.0


def _map_tree(fn, tree, path: tuple = ()):
    """fn(path, leaf) over the tensor leaves of dicts / lists / tuples /
    dataclasses, `path` the dict keys and field names from the root; None,
    numbers and other leaves pass through."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v, path) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_tree(fn, getattr(tree, f.name), path + (f.name,))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    return tree


_CROSS_LEAVES = ("cross_key", "cross_value")


def _is_shared_cross_leaf(path: tuple, x: torch.Tensor) -> bool:
    """A decoder's cross-attention K/V ([B, L, S, H, D], JAX :62-70): 5-D,
    under a `cross_key` / `cross_value` key. Shared by every beam of a
    sentence, so `_tile_cache` passes it through."""
    return x.ndim == 5 and any(k in _CROSS_LEAVES for k in path)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: the k largest, best first, ties
    to the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _tile_cache(tree: Any, K: int) -> Any:
    """Tile batch-leading leaves to beams ([B, ...] -> [B*K, ...], each row
    K times in a row); 0-d leaves and shared cross-attention leaves pass
    through."""
    return _map_tree(
        lambda path, x: x if x.ndim == 0 or _is_shared_cross_leaf(path, x)
        else x.repeat_interleave(K, dim=0), tree)


def _topk_over_beams(cand: torch.Tensor, n: int, sibling_rate: float = 0.0):
    """Exact top-n over the [B, K, V] candidate cube in two stages: each
    beam's top-n, then the top-n of the K*n survivors (any global top-n
    element is in its own beam's top-n). sibling_rate > 0 is fairseq's
    DiverseSiblingsSearch: each beam keeps its top min(n, V - 1), the k-th
    of them penalized by rate * k, and the second stage runs on (and
    returns) the penalized scores. Returns (scores [B, n], beam_idx [B, n],
    tok_idx [B, n])."""
    B, K, V = cand.shape
    kloc = min(n, V - 1) if sibling_rate > 0.0 else min(n, V)
    vals, toks = _top_k(cand.reshape(B * K, V), kloc)
    if sibling_rate > 0.0:
        vals = vals - sibling_rate * torch.arange(
            1, kloc + 1, dtype=torch.float32, device=cand.device)
    scores, pos = _top_k(vals.reshape(B, K * kloc), min(n, K * kloc))
    beam_idx = torch.div(pos, kloc, rounding_mode="floor")
    tok_idx = torch.gather(toks.reshape(B, K * kloc), 1, pos)
    return scores, beam_idx, tok_idx


def _gather_beams(tree: Any, idx: torch.Tensor, batch: int,
                  old_k: int) -> Any:
    """Gather beam-major leaves [B*old_k, ...] by idx [B, new_k] into fresh
    tensors (index_select copies: the decode writes pool rows in place, so
    siblings must not share storage). 0-d leaves pass through, and so do
    the cross-attention K/V when new_k == old_k (JAX :107-132): a
    reorder within a sentence's beams leaves a source shared by all of
    them unchanged. Gathered otherwise, like any other leaf."""
    flat = (idx + torch.arange(batch, device=idx.device)[:, None] * old_k
            ).reshape(-1)
    same_k = idx.shape[1] == old_k

    def gather(path, x):
        if x.ndim == 0:
            return x
        if same_k and any(k in _CROSS_LEAVES for k in path):
            return x
        return x.index_select(0, flat.to(x.device))

    return _map_tree(gather, tree)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis(x [B, N, ...], idx [B, M], axis=1) -> [B, M, ...]."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.ndim - 2)))
                        .expand(*idx.shape, *x.shape[2:]))


def _ngram_ban_mask(tokens: torch.Tensor, cur_len: int, n: int,
                    vocab: int) -> torch.Tensor:
    """[B, V] bool: tokens that would complete an n-gram already in
    tokens[:, :cur_len]. For every past position i whose window
    tokens[i:i+n-1] equals the current suffix, ban tokens[i+n-1]."""
    B, L = tokens.shape
    if n <= 0:
        return torch.zeros((B, vocab), dtype=torch.bool, device=tokens.device)
    pos = torch.arange(L, device=tokens.device)
    match = torch.ones((B, L), dtype=torch.bool, device=tokens.device)
    for d in range(n - 1):
        suf_tok = tokens[:, max(cur_len - (n - 1) + d, 0)]
        win_tok = torch.roll(tokens, -d, dims=1)
        match = match & (win_tok == suf_tok[:, None])
    match = match & ((pos[None, :] + n - 1) < cur_len)
    banned_tok = torch.roll(tokens, -(n - 1), dims=1)
    counts = torch.zeros((B, vocab), dtype=torch.float32, device=tokens.device)
    counts.scatter_add_(1, banned_tok.long(), match.float())
    return counts > 0


def _adjust_logprobs(logprobs: torch.Tensor, tokens: torch.Tensor,
                     gen_len: int, cur_len: int,
                     cfg: GenerationConfig) -> torch.Tensor:
    """pad ban, unk penalty, eos ban before min_new_tokens, n-gram
    blocking (fairseq sequence_generator.py:303-330)."""
    V = logprobs.shape[-1]
    logprobs = logprobs.clone()
    logprobs[:, cfg.pad] = NEG_INF
    if cfg.unk_penalty:
        logprobs[:, cfg.unk] -= cfg.unk_penalty
    # min_new_tokens counts the eos itself: picking eos now gives gen_len+1
    if gen_len + 1 < cfg.min_new_tokens:
        logprobs[:, cfg.eos] = NEG_INF
    if cfg.no_repeat_ngram_size > 0:
        banned = _ngram_ban_mask(tokens, cur_len, cfg.no_repeat_ngram_size, V)
        logprobs = logprobs.masked_fill(banned, NEG_INF)
    return logprobs


def _apply_len_constraints(lp: torch.Tensor, gen: int, min_lens, max_lens,
                           eos: int) -> torch.Tensor:
    """Per-sentence length bounds (fairseq LengthConstrainedBeamSearch):
    while gen < min_lens[n] the eos is banned; once gen >= max_lens[n] the
    eos is forced (its logprob 0, every other token banned). lp [N, V];
    min_lens / max_lens [N] or None."""
    eos_lp = lp[:, eos]
    if min_lens is not None:
        eos_lp = torch.where(gen < min_lens, NEG_INF, eos_lp)
    if max_lens is not None:
        force = gen >= max_lens
        lp = torch.where(force[:, None], NEG_INF, lp)
        eos_lp = torch.where(force, 0.0, eos_lp)
    lp = lp.clone()
    lp[:, eos] = eos_lp
    return lp


def length_constraints(src_lengths: torch.Tensor, min_len_a: float,
                       min_len_b: float, max_len_a: float, max_len_b: float):
    """fairseq's per-sentence bounds from source lengths: min/max generated
    length = a * src_len + b (int32, truncated)."""
    sl = src_lengths.float()
    return ((min_len_a * sl + min_len_b).to(torch.int32),
            (max_len_a * sl + max_len_b).to(torch.int32))


# ------------------------------------------------------------------------ #
# Greedy / sampling
# ------------------------------------------------------------------------ #


def sampling_candidates(lp: torch.Tensor, cfg: GenerationConfig):
    """The candidates a sampling step draws among: (logprobs [N, C], ids
    [N, C] or None for the whole vocabulary). sampling_topk > 0 keeps the
    k best; else sampling_topp > 0 keeps, best first, every token whose
    preceding mass is below p (the rest at NEG_INF)."""
    if cfg.sampling_topk > 0:
        return _top_k(lp, cfg.sampling_topk)
    if cfg.sampling_topp > 0.0:
        sorted_lp, sort_idx = _top_k(lp, lp.shape[-1])
        probs = torch.exp(sorted_lp)
        keep = torch.cumsum(probs, dim=-1) - probs < cfg.sampling_topp
        return torch.where(keep, sorted_lp, NEG_INF), sort_idx
    return lp, None


def _categorical(logits: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """One draw per row of softmax(logits): Gumbel-max, as
    jax.random.categorical."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def greedy_generate(cfg: GenerationConfig, prefill: Callable, step: Callable,
                    prompt: torch.Tensor, aux: Any = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy or sampled decode. Returns (tokens [B, P + max_new_tokens],
    lengths [B]). Sampling draws from `generator` (on the prompt's device;
    default: seeded 0, as JAX's PRNGKey(0))."""
    B, P = prompt.shape
    total = P + cfg.max_new_tokens
    logits, cache = prefill(prompt, aux)
    tokens = torch.full((B, total), cfg.pad, dtype=torch.int64,
                        device=prompt.device)
    tokens[:, :P] = prompt
    if cfg.sampling and generator is None:
        generator = torch.Generator(device=prompt.device).manual_seed(0)

    def pick(logits_row, cur_len):
        lp = torch.log_softmax(logits_row.float() / cfg.temperature, dim=-1)
        lp = _adjust_logprobs(lp, tokens, cur_len - P, cur_len, cfg)
        if not cfg.sampling:
            return torch.argmax(lp, dim=-1)
        vals, ids = sampling_candidates(lp, cfg)
        choice = _categorical(vals, generator)
        return choice if ids is None else ids.gather(1, choice[:, None])[:, 0]

    nxt = pick(logits[:, -1], P)
    tokens[:, P] = nxt
    finished = nxt == cfg.eos
    i = P + 1
    while i < total and not bool(finished.all()):
        logits, cache = step(tokens[:, i - 1:i], cache, aux)
        nxt = pick(logits[:, -1], i)
        nxt = torch.where(finished, torch.full_like(nxt, cfg.pad), nxt)
        tokens[:, i] = nxt
        finished = finished | (nxt == cfg.eos)
        i += 1
    lengths = (tokens != cfg.pad).sum(dim=1)
    return tokens, lengths


# ------------------------------------------------------------------------ #
# Beam search
# ------------------------------------------------------------------------ #


class _Finished:
    """The K best finished hypotheses of each sentence and the closing
    rule both beam searches share."""

    def __init__(self, B: int, K: int, total: int, cfg: GenerationConfig,
                 dev):
        self.K, self.cfg = K, cfg
        self.tokens = torch.full((B, K, total), cfg.pad, dtype=torch.int64,
                                 device=dev)
        self.scores = torch.full((B, K), NEG_INF, device=dev)
        self.exists = torch.zeros((B, K), dtype=torch.bool, device=dev)

    def lp_den(self, gen_len: float) -> float:
        return max(gen_len, 1.0) ** self.cfg.len_penalty

    def add(self, scores, tokens, exists):
        """Keep the K best of the finished set and these candidates
        (scores [B, N], tokens [B, N, total], exists [B, N])."""
        all_scores = torch.cat([self.scores, scores], dim=1)
        all_tokens = torch.cat([self.tokens, tokens], dim=1)
        all_exists = torch.cat([self.exists, exists], dim=1)
        self.scores, keep = _top_k(
            torch.where(all_exists, all_scores, NEG_INF), self.K)
        self.tokens = _take(all_tokens, keep)
        self.exists = torch.gather(all_exists, 1, keep)

    def open(self, i: int, total: int, P: int,
             alive_scores: torch.Tensor) -> bool:
        """The loop condition: a sentence is closed when all K are finished
        and the best alive score over the longest length cannot beat the
        worst finished one."""
        if i >= total:
            return False
        best_alive = alive_scores.max(dim=1).values / self.lp_den(total - P)
        worst_fin = torch.where(self.exists, self.scores, NEG_INF).min(
            dim=1).values
        done = self.exists.all(dim=1) & (worst_fin >= best_alive)
        return not bool(done.all())

    def result(self, alive_tokens, alive_scores, total: int, P: int):
        """(tokens [B, K, total], scores [B, K]) best first: the finished
        set and the alive beams finalized at the longest length."""
        all_scores = torch.cat([
            torch.where(self.exists, self.scores, NEG_INF),
            alive_scores / self.lp_den(total - P)], dim=1)
        all_tokens = torch.cat([self.tokens, alive_tokens], dim=1)
        out_scores, idx = _top_k(all_scores, self.K)
        return _take(all_tokens, idx), out_scores


def _beam_prefill(cfg: GenerationConfig, prefill: Callable,
                  prompt: torch.Tensor, aux: Any):
    """The prefill both beam searches open with, on the un-tiled batch:
    (the first new token's adjusted log-probs [B, V], the cache, tokens
    [B, P + max_new_tokens] holding the prompt, pad after it)."""
    B, P = prompt.shape
    logits, cache = prefill(prompt, aux)
    lp0 = torch.log_softmax(logits[:, -1].float() / cfg.temperature, dim=-1)
    tokens_flat = torch.full((B, P + cfg.max_new_tokens), cfg.pad,
                             dtype=torch.int64, device=prompt.device)
    tokens_flat[:, :P] = prompt
    return _adjust_logprobs(lp0, tokens_flat, 0, P, cfg), cache, tokens_flat


def _beam_start(cfg: GenerationConfig, cache: Any, aux: Any,
                tokens_flat: torch.Tensor, first_tokens: torch.Tensor,
                first_scores: torch.Tensor, P: int):
    """Tile the cache and aux to beams and open the search on the first
    tokens [B, K]: (cache, aux_t, alive_tokens [B, K, total], alive_scores
    [B, K], the finished set). A first token that is eos finishes its beam
    at length 1."""
    B, total = tokens_flat.shape
    K = first_tokens.shape[1]
    alive_tokens = tokens_flat.repeat_interleave(K, dim=0).reshape(B, K, total)
    alive_tokens[:, :, P] = first_tokens
    fin = _Finished(B, K, total, cfg, tokens_flat.device)
    is_eos0 = first_tokens == cfg.eos
    fin.scores = torch.where(is_eos0, first_scores / fin.lp_den(1.0),
                             fin.scores)
    fin.tokens = torch.where(is_eos0[..., None], alive_tokens, fin.tokens)
    fin.exists = is_eos0
    return (_tile_cache(cache, K), _tile_cache(aux, K), alive_tokens,
            torch.where(is_eos0, NEG_INF, first_scores), fin)


def beam_generate(cfg: GenerationConfig, prefill: Callable, step: Callable,
                  prompt: torch.Tensor, aux: Any = None,
                  min_lens: Optional[torch.Tensor] = None,
                  max_lens: Optional[torch.Tensor] = None):
    """Beam search. Returns (tokens [B, K, total], scores [B, K]) best
    first; scores are length-penalized as fairseq's (cum / len^lenpen).
    cfg.diversity_rate > 0 selects candidates as fairseq's
    DiverseSiblingsSearch; min_lens / max_lens [B] apply the per-sentence
    LengthConstrainedBeamSearch bounds."""
    B, P = prompt.shape
    K, V = cfg.beam_size, cfg.vocab_size
    total = P + cfg.max_new_tokens
    if V <= 0:
        raise ValueError("GenerationConfig.vocab_size is required for beam "
                         "search")
    dev = prompt.device

    lp0, cache, tokens_flat = _beam_prefill(cfg, prefill, prompt, aux)
    lp0 = _apply_len_constraints(lp0, 0, min_lens, max_lens, cfg.eos)
    k0 = min(K, V)
    first_scores, first_tokens = _top_k(lp0, k0)
    if k0 < K:  # beam wider than the vocabulary: dead beams
        first_scores = torch.cat([first_scores, torch.full(
            (B, K - k0), NEG_INF, device=dev)], dim=1)
        first_tokens = torch.cat([first_tokens, torch.full(
            (B, K - k0), cfg.pad, dtype=torch.int64, device=dev)], dim=1)
    cache, aux_t, alive_tokens, alive_scores, fin = _beam_start(
        cfg, cache, aux, tokens_flat, first_tokens, first_scores, P)
    rep = lambda x: None if x is None else x.repeat_interleave(K, dim=0)
    min_k, max_k = rep(min_lens), rep(max_lens)

    i = P + 1
    while fin.open(i, total, P, alive_scores):
        flat_tokens = alive_tokens.reshape(B * K, total)
        logits, cache = step(flat_tokens[:, i - 1:i], cache, aux_t)
        lp = torch.log_softmax(logits[:, -1].float() / cfg.temperature,
                               dim=-1)
        lp = _adjust_logprobs(lp, flat_tokens, i - P, i, cfg)
        if min_lens is not None or max_lens is not None:
            lp = _apply_len_constraints(lp, i - P, min_k, max_k, cfg.eos)
        cand = alive_scores[:, :, None] + lp.reshape(B, K, V)
        top_scores, beam_idx, tok_idx = _topk_over_beams(
            cand, 2 * K, cfg.diversity_rate)

        cand_tokens = _take(alive_tokens, beam_idx)  # [B, 2K, total]
        cand_tokens[:, :, i] = tok_idx
        is_eos = tok_idx == cfg.eos
        fin.add(torch.where(is_eos, top_scores / fin.lp_den(i + 1 - P),
                            NEG_INF), cand_tokens, is_eos)

        alive_scores, sel = _top_k(torch.where(is_eos, NEG_INF, top_scores),
                                   K)
        alive_tokens = _take(cand_tokens, sel)
        cache = _gather_beams(cache, torch.gather(beam_idx, 1, sel), B, K)
        i += 1
    return fin.result(alive_tokens, alive_scores, total, P)


def diverse_beam_generate(cfg: GenerationConfig, prefill: Callable,
                          step: Callable, prompt: torch.Tensor,
                          aux: Any = None):
    """Diverse beam search (fairseq search.DiverseBeamSearch): the beams
    split into `num_groups` groups that pick in turn within each step;
    group g's logprobs pay diversity_strength times the count of each token
    already picked this step by groups 0..g-1. Scores stay the model's own.
    Returns (tokens [B, K, total], scores [B, K]) best first; beam j is in
    group j % num_groups."""
    B, P = prompt.shape
    K, G, V = cfg.beam_size, cfg.num_groups, cfg.vocab_size
    if K % G:
        raise ValueError(f"beam_size {K} is not a multiple of num_groups {G}")
    Kg = K // G
    total = P + cfg.max_new_tokens
    if V <= 0 or Kg > V:
        raise ValueError(f"vocab_size {V} with {Kg} beams a group")
    dev = prompt.device
    strength = cfg.diversity_strength

    lp_all, cache, tokens_flat = _beam_prefill(cfg, prefill, prompt, aux)

    # ---- first step: the groups pick in turn under the penalty -----------
    div = torch.zeros((B, V), device=dev)
    first_tokens, first_scores = [], []
    for _ in range(G):
        _, t = _top_k(lp_all - strength * div, Kg)
        first_tokens.append(t)
        first_scores.append(torch.gather(lp_all, 1, t))
        div = div + F.one_hot(t, V).float().sum(dim=1)
    first_tokens = torch.stack(first_tokens, dim=2).reshape(B, K)
    first_scores = torch.stack(first_scores, dim=2).reshape(B, K)

    cache, aux_t, alive_tokens, alive_scores, fin = _beam_start(
        cfg, cache, aux, tokens_flat, first_tokens, first_scores, P)

    i = P + 1
    while fin.open(i, total, P, alive_scores):
        flat_tokens = alive_tokens.reshape(B * K, total)
        logits, cache = step(flat_tokens[:, i - 1:i], cache, aux_t)
        lp = torch.log_softmax(logits[:, -1].float() / cfg.temperature,
                               dim=-1)
        lp = _adjust_logprobs(lp, flat_tokens, i - P, i, cfg).reshape(B, K, V)
        den = fin.lp_den(i + 1 - P)

        div = torch.zeros((B, V), device=dev)
        sel_tokens, sel_scores, sel_src = [], [], []
        eos_scores, eos_src, eos_tok = [], [], []
        for g in range(G):
            idx_g = torch.arange(g, K, G, device=dev)  # the group's beams
            lp_g = lp[:, idx_g] - strength * div[:, None, :]
            cand = alive_scores[:, idx_g, None] + lp_g
            cand_true = alive_scores[:, idx_g, None] + lp[:, idx_g]
            top_pen, beam_g, tok_g = _topk_over_beams(cand, 2 * Kg)
            true_scores = torch.gather(cand_true.reshape(B, Kg * V), 1,
                                       beam_g * V + tok_g)
            src = idx_g[beam_g]  # global beam rows
            is_eos = tok_g == cfg.eos
            eos_scores.append(torch.where(is_eos, true_scores / den, NEG_INF))
            eos_src.append(src)
            eos_tok.append(tok_g)
            # alive: the group's top Kg non-eos by the PENALIZED score
            _, sel = _top_k(torch.where(is_eos, NEG_INF, top_pen), Kg)
            sel_tok = torch.gather(tok_g, 1, sel)
            sel_tokens.append(sel_tok)
            sel_scores.append(torch.gather(true_scores, 1, sel))
            sel_src.append(torch.gather(src, 1, sel))
            div = div + F.one_hot(sel_tok, V).float().sum(dim=1)

        # ---- the finished set, shared across groups -----------------------
        cat_scores = torch.cat(eos_scores, dim=1)  # [B, 2K]
        cand_rows = _take(alive_tokens, torch.cat(eos_src, dim=1))
        cand_rows[:, :, i] = torch.cat(eos_tok, dim=1)
        fin.add(cat_scores, cand_rows, cat_scores > NEG_INF / 2)

        # ---- the groups back into the interleaved beam layout -------------
        new_tok = torch.stack(sel_tokens, dim=2).reshape(B, K)
        alive_scores = torch.stack(sel_scores, dim=2).reshape(B, K)
        src_beam = torch.stack(sel_src, dim=2).reshape(B, K)
        alive_tokens = _take(alive_tokens, src_beam)
        alive_tokens[:, :, i] = new_tok
        cache = _gather_beams(cache, src_beam, B, K)
        i += 1
    return fin.result(alive_tokens, alive_scores, total, P)


def generate(cfg: GenerationConfig, prefill: Callable, step: Callable,
             prompt: torch.Tensor, aux: Any = None,
             generator: Optional[torch.Generator] = None,
             min_lens: Optional[torch.Tensor] = None,
             max_lens: Optional[torch.Tensor] = None):
    """The fairseq search switchboard: num_groups > 1 -> diverse beam;
    beam_size > 1 or diversity_rate > 0 -> beam (diverse siblings,
    length-constrained per sentence); else greedy or sampling."""
    if cfg.num_groups > 1 and not cfg.sampling:
        return diverse_beam_generate(cfg, prefill, step, prompt, aux)
    if (cfg.beam_size > 1 or cfg.diversity_rate > 0) and not cfg.sampling:
        return beam_generate(cfg, prefill, step, prompt, aux,
                             min_lens=min_lens, max_lens=max_lens)
    return greedy_generate(cfg, prefill, step, prompt, aux, generator)


def make_ensemble(model_fns, temperature: float = 1.0):
    """Multi-model ensemble (fairseq EnsembleModel): each step averages the
    models' probabilities, avg = logsumexp(stack(log_softmax(logits_m /
    T))) - log(M), and the cache is the tuple of the models' caches (beam
    reorders map over it). model_fns: a list of (prefill, step) pairs; the
    returned pair takes `aux` as an M-tuple (or None). Its "logits" are
    avg * T, so the engine's log_softmax(x / T) leaves them unchanged."""
    M = len(model_fns)

    def split_aux(aux):
        return (None,) * M if aux is None else tuple(aux)

    def combine(logits_list):
        lps = torch.stack([torch.log_softmax(lg.float() / temperature,
                                             dim=-1) for lg in logits_list])
        return (torch.logsumexp(lps, dim=0) - math.log(M)) * temperature

    def prefill(tokens, aux):
        outs = [pf(tokens, a) for (pf, _), a in zip(model_fns,
                                                     split_aux(aux))]
        return combine([o[0] for o in outs]), tuple(o[1] for o in outs)

    def step(token, cache, aux):
        outs = [st(token, c, a) for (_, st), c, a in zip(model_fns, cache,
                                                         split_aux(aux))]
        return combine([o[0] for o in outs]), tuple(o[1] for o in outs)

    return prefill, step


# ------------------------------------------------------------------------ #
# Lexically constrained beam search (ordered constraints; Post & Vilar 2018)
# ------------------------------------------------------------------------ #


def pack_constraints(batch_phrases, pad: int = 1, device=None):
    """Per-sentence ordered constraint phrases -> (constraints [B, C],
    phrase_start [B, C], counts [B]) int64 tensors: the flat ordered tokens
    padded with `pad`; for each token the flat index where its phrase
    begins (the automaton's reset target); the number of real tokens."""
    B = len(batch_phrases)
    C = max((sum(len(p) for p in ph) for ph in batch_phrases), default=1) or 1
    out = torch.full((B, C), pad, dtype=torch.int64)
    starts = torch.zeros((B, C), dtype=torch.int64)
    counts = torch.zeros((B,), dtype=torch.int64)
    for b, phrases in enumerate(batch_phrases):
        j = 0
        for ph in phrases:
            s = j
            for t in ph:
                out[b, j] = int(t)
                starts[b, j] = s
                j += 1
        counts[b] = j
    return out.to(device), starts.to(device), counts.to(device)


def _advance_progress(progress, tok, constraints, phrase_start, counts):
    """The ordered-constraint automaton's step (fairseq
    LexicallyConstrainedBeamSearch's ordered state). progress, tok [B, N]:
    a token that matches the next constraint token advances; otherwise a
    partly matched phrase resets to its start and the token is retried
    against the phrase's first token (greedy matching, no KMP backtrack,
    as the reference)."""
    C = constraints.shape[1]
    pj = progress.clamp(0, C - 1)
    nxt = torch.gather(constraints, 1, pj)
    done = progress >= counts[:, None]
    adv = ~done & (tok == nxt)
    reset = torch.gather(phrase_start, 1, pj)
    first = torch.gather(constraints, 1, reset.clamp(0, C - 1))
    retry = ~done & ~adv & (tok == first)
    return torch.where(adv, progress + 1, torch.where(
        done, progress, torch.where(retry, reset + 1, reset)))


def constrained_beam_generate(cfg: GenerationConfig, prefill: Callable,
                              step: Callable, prompt: torch.Tensor,
                              constraints: torch.Tensor,
                              phrase_start: torch.Tensor,
                              counts: torch.Tensor, aux: Any = None):
    """Lexically constrained beam search with ordered constraints (fairseq
    search.LexicallyConstrainedBeamSearch, Post & Vilar 2018's dynamic beam
    allocation, as upstream TrOCR uses it; JAX :723-920). `constraints`,
    `phrase_start`, `counts`: `pack_constraints`' tensors.

    Each beam tracks `progress` (constraint tokens met, in order), and a
    candidate's bank is its new progress. Candidates are the top 2K of the
    K x V cube plus each beam's forced advance token (its next unmet
    constraint token), de-duplicated; the K survivors are taken round-robin
    over the banks (each bank's best before any bank's second), by the
    float32 key valid * 1e12 + rank_in_bank * 1e6 - clip(score) * 1e-3.
    eos is blocked until a beam has met every constraint, so a finished
    hypothesis always meets them; alive leftovers that do not rank after
    the met ones at NEG_INF / 2.

    Returns (tokens [B, K, total], scores [B, K], met [B, K] bool)."""
    B, P = prompt.shape
    K, V = cfg.beam_size, cfg.vocab_size
    total = P + cfg.max_new_tokens
    if V <= 0:
        raise ValueError("GenerationConfig.vocab_size is required for beam "
                         "search")
    dev = prompt.device
    constraints, phrase_start, counts = (
        t.to(device=dev, dtype=torch.int64)
        for t in (constraints, phrase_start, counts))
    C = constraints.shape[1]

    lp0, cache, tokens_flat = _beam_prefill(cfg, prefill, prompt, aux)
    # eos before the constraints are met: only with no constraints
    lp0[:, cfg.eos] = torch.where(counts > 0, NEG_INF, lp0[:, cfg.eos])
    k0 = min(K, V)
    first_scores, first_tokens = (t.clone() for t in _top_k(lp0, k0))
    if k0 < K:
        first_scores = torch.cat([first_scores, torch.full(
            (B, K - k0), NEG_INF, device=dev)], dim=1)
        first_tokens = torch.cat([first_tokens, torch.full(
            (B, K - k0), cfg.pad, dtype=torch.int64, device=dev)], dim=1)
    # the first constraint token among the first beams (the DBA seed)
    adv0 = constraints[:, 0]
    have = (first_tokens == adv0[:, None]).any(dim=1) | (counts == 0)
    forced = torch.gather(lp0, 1, adv0[:, None])[:, 0]
    first_tokens[:, K - 1] = torch.where(have, first_tokens[:, K - 1], adv0)
    first_scores[:, K - 1] = torch.where(have, first_scores[:, K - 1], forced)
    progress = _advance_progress(torch.zeros_like(first_tokens), first_tokens,
                                 constraints, phrase_start, counts)

    cache, aux_t = _tile_cache(cache, K), _tile_cache(aux, K)
    alive_tokens = tokens_flat.repeat_interleave(K, dim=0).reshape(B, K, total)
    alive_tokens[:, :, P] = first_tokens
    fin = _Finished(B, K, total, cfg, dev)
    is_eos0 = (first_tokens == cfg.eos) & (counts == 0)[:, None]
    fin.scores = torch.where(is_eos0, first_scores, fin.scores)
    fin.tokens = torch.where(is_eos0[..., None], alive_tokens, fin.tokens)
    fin.exists = is_eos0
    alive_scores = torch.where(is_eos0, NEG_INF, first_scores)
    beams = torch.arange(K, device=dev)

    i = P + 1
    while fin.open(i, total, P, alive_scores):
        flat_tokens = alive_tokens.reshape(B * K, total)
        logits, cache = step(flat_tokens[:, i - 1:i], cache, aux_t)
        lp = torch.log_softmax(logits[:, -1].float() / cfg.temperature,
                               dim=-1)
        lp = _adjust_logprobs(lp, flat_tokens, i - P, i, cfg).reshape(B, K, V)
        met = progress >= counts[:, None]
        lp[:, :, cfg.eos] = torch.where(met, lp[:, :, cfg.eos], NEG_INF)
        cand = alive_scores[:, :, None] + lp
        top_scores, beam_idx, tok_idx = _topk_over_beams(cand, 2 * K)

        # each beam's forced advance: its next unmet constraint token,
        # dropped if met, dead or already among the top 2K from that beam
        adv_tok = torch.gather(constraints, 1, progress.clamp(0, C - 1))
        adv_scores = alive_scores + torch.gather(lp, 2,
                                                 adv_tok[..., None])[..., 0]
        dup = ((beam_idx[:, None, :] == beams[None, :, None])
               & (tok_idx[:, None, :] == adv_tok[..., None])).any(dim=2)
        adv_valid = ~met & ~dup & (alive_scores > NEG_INF / 2)
        adv_scores = torch.where(adv_valid, adv_scores, NEG_INF)

        all_scores = torch.cat([top_scores, adv_scores], dim=1)  # [B, 3K]
        all_beam = torch.cat([beam_idx, beams.expand(B, K)], dim=1)
        all_tok = torch.cat([tok_idx, adv_tok], dim=1)
        cand_prog = _advance_progress(torch.gather(progress, 1, all_beam),
                                      all_tok, constraints, phrase_start,
                                      counts)
        is_eos = (all_tok == cfg.eos) & (all_scores > NEG_INF / 2)
        cand_rows = _take(alive_tokens, all_beam)
        cand_rows[:, :, i] = all_tok
        fin.add(torch.where(is_eos, all_scores / fin.lp_den(i + 1 - P),
                            NEG_INF), cand_rows, is_eos)

        # ---- survivors by bank: every bank's best outranks any second ---
        M = all_scores.shape[1]
        alive_cand = torch.where(is_eos, NEG_INF, all_scores)
        valid = alive_cand > NEG_INF / 2
        same_bank = cand_prog[:, :, None] == cand_prog[:, None, :]
        order = torch.arange(M, device=dev)
        better = (alive_cand[:, None, :] > alive_cand[:, :, None]) | (
            (alive_cand[:, None, :] == alive_cand[:, :, None])
            & (order[None, None, :] < order[None, :, None]))
        rank = (same_bank & better & valid[:, None, :]).sum(dim=2)
        key = (torch.where(valid, 0.0, 1e12) + rank.float() * 1e6
               - alive_cand.clamp(NEG_INF, 0.0) * 1e-3)
        _, sel = _top_k(-key, K)  # the K smallest keys
        alive_scores = torch.gather(alive_cand, 1, sel)
        alive_tokens = _take(cand_rows, sel)
        progress = torch.gather(cand_prog, 1, sel)
        cache = _gather_beams(cache, torch.gather(all_beam, 1, sel), B, K)
        i += 1

    # finished hypotheses met every constraint; alive leftovers rank after
    # them, unmet ones last (fairseq sorts them below the met ones)
    met_alive = progress >= counts[:, None]
    alive_fin = (alive_scores / fin.lp_den(total - P)
                 + torch.where(met_alive, 0.0, NEG_INF / 2))
    all_scores = torch.cat([torch.where(fin.exists, fin.scores, NEG_INF),
                            alive_fin], dim=1)
    out_scores, idx = _top_k(all_scores, K)
    out_tokens = _take(torch.cat([fin.tokens, alive_tokens], dim=1), idx)
    out_met = torch.gather(torch.cat([fin.exists, met_alive], dim=1), 1, idx)
    return out_tokens, out_scores, out_met


# ------------------------------------------------------------------------ #
# (Generalized) aggressive decoding: draft and verify
# ------------------------------------------------------------------------ #


def _rewind_cache(tree: Any, new_len: int) -> Any:
    """Every counter of the cache (the Python ints `cache_index` and
    `pos`) set to new_len; the pools pass through. Rows past new_len are
    stale: kv_len (a T > 1 verify) or the decode kernel's lengths (a
    one-token step) hide them, and later writes overwrite them. A dataclass
    cache (YOCO's) raises: its retention state has already taken in the
    rejected draft tokens, and no counter can undo that."""
    if isinstance(tree, dict):
        return {k: _rewind_cache(v, new_len) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rewind_cache(v, new_len) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        raise TypeError(f"aggressive decoding cannot rewind a "
                        f"{type(tree).__name__}: it may hold recurrent state")
    if isinstance(tree, int):
        return int(new_len)
    return tree


def aggressive_generate(cfg: GenerationConfig, prefill: Callable,
                        step: Callable, prompt: torch.Tensor,
                        draft_fn: Callable, aux: Any = None,
                        block_size: int = 16):
    """(Generalized) aggressive decoding (reference decoding/GAD): verify a
    drafted block in ONE decoder call, accept the longest prefix that
    matches greedy, take the model's correction token, rewind the cache
    and repeat: exactly the greedy (argmax) output in fewer sequential
    calls. Batch 1.

    draft_fn(accepted, need) gets the accepted sequence so far (a numpy
    array, prompt included) and the number of tokens to draft, and returns
    up to `need` tokens. Each verify feeds [last accepted, draft...]
    (T = D + 1) to `step`; its output j predicts position len(accepted) +
    j. Returns (tokens [1, P + max_new_tokens], model calls)."""
    import numpy as np

    B, P = prompt.shape
    if B != 1:
        raise ValueError("aggressive decoding runs batch 1 (accept lengths "
                         "are per sample)")
    total = P + cfg.max_new_tokens
    dev = prompt.device

    def finish(accepted):
        out = torch.full((1, total), cfg.pad, dtype=torch.int64)
        n = min(len(accepted), total)
        out[0, :n] = torch.tensor(accepted[:n], dtype=torch.int64)
        return out.to(dev)

    logits, cache = prefill(prompt, aux)
    first = int(torch.argmax(logits[0, -1]))
    accepted = [int(t) for t in prompt[0].tolist()] + [first]
    calls = 1
    if first == cfg.eos:
        return finish(accepted), calls
    while len(accepted) < total:
        need = min(block_size, total - len(accepted))
        draft = np.asarray(draft_fn(np.asarray(accepted), need)).reshape(
            -1)[:need].tolist()
        D = len(draft)
        x = torch.tensor([[accepted[-1]] + [int(t) for t in draft]],
                         dtype=torch.int64, device=dev)
        logits, cache = step(x, cache, aux)
        g = torch.argmax(logits[0], dim=-1).tolist()  # [D + 1]
        calls += 1
        k = 0
        while k < D and g[k] == draft[k] and draft[k] != cfg.eos:
            k += 1
        new_tokens = [int(t) for t in draft[:k]] + [int(g[k])]
        accepted.extend(new_tokens)
        # the cache holds [last, draft...]: its valid prefix is what was
        # accepted before this block's last token
        cache = _rewind_cache(cache, len(accepted) - 1)
        if cfg.eos in new_tokens:
            break
    return finish(accepted), calls
