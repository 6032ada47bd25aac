"""Generation engine, greedy path (port of unilm_tpu/runtime/generate.py:
`GenerationConfig` :37, `_ngram_ban_mask` :135, `_adjust_logprobs` :163,
`greedy_generate` :216, `generate` :444).

Model adapter: two closures
    prefill(tokens [B, P], aux) -> (logits [B, P|1, V], cache)
    step(token [B, 1], cache, aux) -> (logits [B, 1, V], cache)
(models/kosmos.py make_unigpt_generate_fns). The JAX `params` argument
has no counterpart: the torch modules own their weights.

The decode loop is a Python loop that stops early once every row has
emitted eos, as the JAX while_loop does. Beam, diverse-beam and sampling
generation are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

NEG_INF = -1.0e7

_NOT_PORTED = ("{} generation is not ported yet: ROADMAP Queue 1, remainder "
               "of slices 0-2 (beam, sampling and diverse generation)")


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
    num_groups: int = 1
    diversity_strength: float = 0.5
    diversity_rate: float = 0.0


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


def greedy_generate(cfg: GenerationConfig, prefill: Callable, step: Callable,
                    prompt: torch.Tensor,
                    aux: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode. Returns (tokens [B, P + max_new_tokens], lengths [B])."""
    if cfg.sampling:
        raise NotImplementedError(_NOT_PORTED.format("sampling"))
    B, P = prompt.shape
    total = P + cfg.max_new_tokens
    logits, cache = prefill(prompt, aux)
    tokens = torch.full((B, total), cfg.pad, dtype=torch.int64,
                        device=prompt.device)
    tokens[:, :P] = prompt

    def pick(logits_row, cur_len):
        lp = torch.log_softmax(logits_row.float() / cfg.temperature, dim=-1)
        lp = _adjust_logprobs(lp, tokens, cur_len - P, cur_len, cfg)
        return torch.argmax(lp, dim=-1)

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


def generate(cfg: GenerationConfig, prefill: Callable, step: Callable,
             prompt: torch.Tensor, aux: Any = None):
    """The fairseq search switchboard: num_groups > 1 -> diverse beam;
    beam_size > 1 or diversity_rate > 0 -> beam; else greedy. Only greedy
    is ported."""
    if cfg.num_groups > 1 and not cfg.sampling:
        raise NotImplementedError(_NOT_PORTED.format("diverse beam"))
    if (cfg.beam_size > 1 or cfg.diversity_rate > 0) and not cfg.sampling:
        raise NotImplementedError(_NOT_PORTED.format("beam"))
    return greedy_generate(cfg, prefill, step, prompt, aux)
