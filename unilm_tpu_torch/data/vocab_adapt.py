"""AdaLM: incremental domain vocabulary extension + embedding growth.

Capability-equivalent of the reference's adalm/incr_bpe pipeline
(adalm/incr_bpe/vocab_extend.py: build_target_size_vocab /
compute_language_model / vocab_extend / merge_output_file_with_bert_vocab,
backed by a tensor2tensor-style SubwordTextEncoder in text_encoder.py):

1. build candidate wordpiece vocabularies of growing target sizes from a
   domain corpus (binary search on a min-count like
   SubwordTextEncoder.build_to_target_size);
2. score each merged vocab by the corpus mean per-document log-probability
   under a unigram LM over its own tokenization (compute_language_model);
3. stop growing when the marginal gain per interval falls below a threshold
   and merge the new tokens after the base (BERT-style) vocab, preserving
   base ids (merge_output_file_with_bert_vocab);
4. initialize embeddings of new tokens as the mean of their old-vocab
   wordpiece sub-token embeddings (the AdaLM embedding-init recipe), so the
   adapted model can warm-start from the general-domain checkpoint.

Host-side, pure Python/numpy: vocabulary work is offline preprocessing.
Uses the BERT "##" continuation convention so outputs merge directly into a
BERT vocab file.

The port's copy of unilm_tpu/data/vocab_adapt.py
(pure Python: the port imports nothing of the JAX package), held
against it by the CPU tests.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

RESERVED = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def corpus_word_counts(
    lines: Iterable[str], lower: bool = True, max_lines: Optional[int] = None
) -> Dict[str, int]:
    """Whitespace word counts (tokenizer.corpus_token_counts equivalent)."""
    counts: Dict[str, int] = collections.Counter()
    for i, line in enumerate(lines):
        if max_lines is not None and i >= max_lines:
            break
        if lower:
            line = line.lower()
        counts.update(line.split())
    return dict(counts)


class WordPieceTokenizer:
    """Greedy longest-match wordpiece with '##' continuations."""

    def __init__(self, vocab: Sequence[str], unk: str = "[UNK]", lower: bool = True):
        self.vocab = list(vocab)
        self.index = {t: i for i, t in enumerate(self.vocab)}
        self.unk = unk
        self.lower = lower

    def tokenize_word(self, word: str) -> List[str]:
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while end > start:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.index:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk]
            pieces.append(piece)
            start = end
        return pieces or [self.unk]

    def tokenize(self, text: str) -> List[str]:
        if self.lower:
            text = text.lower()
        out: List[str] = []
        for w in text.split():
            out.extend(self.tokenize_word(w))
        return out

    def encode(self, text: str) -> List[int]:
        unk_id = self.index.get(self.unk, 0)
        return [self.index.get(t, unk_id) for t in self.tokenize(text)]


def _alphabet(word_counts: Dict[str, int]) -> List[str]:
    chars = set()
    for w in word_counts:
        for i, c in enumerate(w):
            chars.add(c if i == 0 else "##" + c)
    return sorted(chars)


def _candidate_counts(
    word_counts: Dict[str, int], tok: WordPieceTokenizer, max_len: int = 16
) -> Dict[str, int]:
    """For each word, greedy-tokenize with the current vocab and count every
    substring extending from each piece start (the t2t candidate-collection
    step, text_encoder.py build_from_token_counts)."""
    counts: Dict[str, int] = collections.defaultdict(int)
    for word, c in word_counts.items():
        pieces = tok.tokenize_word(word)
        if pieces == [tok.unk]:
            starts = range(len(word))  # untokenizable: count everything
        else:
            starts, pos = [], 0
            for p in pieces:
                starts.append(pos)
                pos += len(p) - 2 if p.startswith("##") else len(p)
        for s in starts:
            for e in range(s + 1, min(len(word), s + max_len) + 1):
                sub = word[s:e] if s == 0 else "##" + word[s:e]
                counts[sub] += c
    return counts


def _build_vocab_min_count(
    word_counts: Dict[str, int],
    min_count: int,
    num_iterations: int = 4,
    reserved: Sequence[str] = RESERVED,
    max_len: int = 16,
) -> List[str]:
    alphabet = _alphabet(word_counts)
    vocab = list(reserved) + alphabet
    for _ in range(num_iterations):
        tok = WordPieceTokenizer(vocab)
        cand = _candidate_counts(word_counts, tok, max_len)
        # length-bucketed longest-first selection with prefix-count subtraction
        by_len: Dict[int, List[Tuple[str, int]]] = collections.defaultdict(list)
        counts = dict(cand)
        for sub, c in cand.items():
            by_len[len(sub)].append((sub, c))
        chosen = []
        for L in sorted(by_len, reverse=True):
            for sub, _ in by_len[L]:
                c = counts[sub]
                if c < min_count or len(sub.lstrip("#")) < 2:
                    continue
                chosen.append((c, sub))
                # subtract from all prefixes so shorter pieces only keep
                # occurrences not already covered by this longer piece
                core = sub[2:] if sub.startswith("##") else sub
                pre = "##" if sub.startswith("##") else ""
                for e in range(1, len(core)):
                    p = pre + core[:e]
                    if p in counts:
                        counts[p] -= c
        vocab = list(reserved) + alphabet + [s for _, s in sorted(chosen, reverse=True)]
    return vocab


def build_wordpiece_vocab(
    word_counts: Dict[str, int],
    target_size: int,
    num_iterations: int = 4,
    reserved: Sequence[str] = RESERVED,
    tolerance_pct: float = 3.0,
) -> List[str]:
    """Binary search min_count to land within ~tolerance_pct of target_size
    (SubwordTextEncoder.build_to_target_size)."""
    lo, hi = 1, max(2, sum(word_counts.values()))
    best = _build_vocab_min_count(word_counts, lo, num_iterations, reserved)
    while lo <= hi:
        mid = (lo + hi) // 2
        vocab = _build_vocab_min_count(word_counts, mid, num_iterations, reserved)
        if abs(len(vocab) - target_size) <= target_size * tolerance_pct / 100:
            return vocab
        if len(vocab) > target_size:
            lo = mid + 1
        else:
            hi = mid - 1
        if abs(len(vocab) - target_size) < abs(len(best) - target_size):
            best = vocab
    return best


def corpus_log_prob(documents: Sequence[str], vocab: Sequence[str]) -> float:
    """Mean per-document log-probability under the unigram LM of the vocab's
    own tokenization (adalm compute_language_model)."""
    tok = WordPieceTokenizer(vocab)
    tokenized = [tok.tokenize(d) for d in documents]
    freq: Dict[str, int] = collections.Counter()
    total = 0
    for toks in tokenized:
        freq.update(toks)
        total += len(toks)
    if total == 0:
        return float("-inf")
    probs = []
    for toks in tokenized:
        p = sum(math.log(freq[t] / total) for t in toks)
        probs.append(p)
    return float(np.mean(probs))


def merge_vocabs(base: Sequence[str], extra: Sequence[str]) -> List[str]:
    """Base vocab first (ids preserved), novel tokens appended
    (merge_output_file_with_bert_vocab)."""
    seen = set(base)
    out = list(base)
    for t in extra:
        if t not in seen:
            out.append(t)
            seen.add(t)
    return out


def vocab_extend(
    documents: Sequence[str],
    base_vocab: Sequence[str],
    interval: int = 10000,
    threshold: float = 0.01,
    max_rounds: int = 10,
    num_iterations: int = 4,
) -> List[str]:
    """Grow the domain vocab by `interval` until the marginal mean-log-prob
    gain per interval drops below `threshold` (vocab_extend.py:62)."""
    counts = corpus_word_counts(documents)
    merged = list(base_vocab)
    best_lp = corpus_log_prob(documents, merged)
    for r in range(1, max_rounds + 1):
        domain = build_wordpiece_vocab(counts, r * interval,
                                       num_iterations=num_iterations)
        cand = merge_vocabs(base_vocab, domain)
        lp = corpus_log_prob(documents, cand)
        gain = (lp - best_lp) / max(abs(best_lp), 1e-9)
        if gain < threshold:
            return merged
        merged, best_lp = cand, lp
    return merged


def extend_embeddings(
    embeddings: np.ndarray,  # [V_base, E]
    base_vocab: Sequence[str],
    merged_vocab: Sequence[str],
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Rows for new tokens = mean of their base-vocab wordpiece sub-token
    embeddings (AdaLM warm-start); tokens the base tokenizer cannot cover
    get a small random row."""
    assert embeddings.shape[0] == len(base_vocab)
    base_tok = WordPieceTokenizer(base_vocab)
    rng = rng or np.random.default_rng(0)
    new_rows = []
    for t in merged_vocab[len(base_vocab):]:
        core = t[2:] if t.startswith("##") else t
        pieces = base_tok.tokenize_word(core)
        ids = [base_tok.index[p] for p in pieces if p in base_tok.index]
        if ids and pieces != [base_tok.unk]:
            new_rows.append(embeddings[ids].mean(axis=0))
        else:
            new_rows.append(
                rng.normal(0, 0.02, embeddings.shape[1]).astype(embeddings.dtype)
            )
    if not new_rows:
        return embeddings.copy()
    return np.concatenate([embeddings, np.stack(new_rows)], axis=0)
