"""The host ops of unilm_tpu/native/__init__.py, as numpy: the port's
copies of the JAX package's pure-numpy fallbacks, `edit_distance` (and
`edit_distance_batch`), `bleu_counts`, `batch_by_size` (data/
iterators.py's), `balanced_assignment`, `token_block_slices` and
`block_to_dataset_index`.

The JAX package builds native/unilm_native.cpp with g++ into a host
library and falls back to numpy without it. That library is a host
accelerator, not a TPU kernel: the port neither builds nor loads it and
computes every op with the numpy version (tests/test_native_scoring.py
holds the library against those fallbacks).
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional

import numpy as np

from unilm_tpu_torch.data.iterators import batch_by_size  # noqa: F401


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def edit_distance(a, b) -> int:
    """Levenshtein distance between two int sequences (libnat equivalent)."""
    a, b = _i32(a), _i32(b)
    la, lb = len(a), len(b)
    prev = np.arange(lb + 1, dtype=np.int64)
    for i in range(1, la + 1):
        cur = np.empty(lb + 1, np.int64)
        cur[0] = i
        sub = prev[:-1] + (a[i - 1] != b)
        for j in range(1, lb + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub[j - 1])
        prev = cur
    return int(prev[lb])


def edit_distance_batch(seqs_a: List, seqs_b: List) -> np.ndarray:
    return np.asarray([edit_distance(a, b) for a, b in zip(seqs_a, seqs_b)])


def bleu_counts(ref, hyp, counts: Optional[np.ndarray] = None) -> np.ndarray:
    """Accumulate 1-4gram (match, total) counts (libbleu equivalent)."""
    if counts is None:
        counts = np.zeros(8, np.int64)
    ref, hyp = _i32(ref), _i32(hyp)
    for n in range(1, 5):
        if len(hyp) < n:
            continue
        rg = Counter(tuple(ref[i: i + n]) for i in range(len(ref) - n + 1))
        hg = Counter(tuple(hyp[i: i + n]) for i in range(len(hyp) - n + 1))
        match = sum(min(c, rg[g]) for g, c in hg.items())
        counts[2 * (n - 1)] += match
        counts[2 * (n - 1) + 1] += len(hyp) - n + 1
    return counts


def balanced_assignment(scores: np.ndarray) -> np.ndarray:
    """Balanced token->expert assignment (libbase equivalent, BASE-layer
    MoE routing), greedy: all (token, expert) scores in descending order
    fill each expert to n/k tokens. scores [n, k] -> expert id [n]."""
    scores = np.ascontiguousarray(scores, np.float32)
    n, k = scores.shape
    cap = n // k
    order = np.argsort(-scores, axis=None)
    fill = np.zeros(k, np.int64)
    out = np.full(n, -1, np.int64)
    for flat in order:
        i, j = divmod(int(flat), k)
        if out[i] == -1 and fill[j] < cap:
            out[i] = j
            fill[j] += 1
    return out


_BREAK_MODES = {None: 0, "none": 0, "complete": 1, "complete_doc": 2, "eos": 3}


def token_block_slices(
    sizes: np.ndarray,
    break_mode: Optional[str] = None,
    block_size: int = 512,
    document_sep_len: int = 1,
) -> np.ndarray:
    """[n] sentence sizes -> [m, 2] (start, end) token-stream slices
    (token_block_utils_fast._get_slice_indices_fast equivalent;
    modes: none / complete / complete_doc / eos)."""
    sizes = np.ascontiguousarray(sizes, np.int64)
    mode = _BREAK_MODES[break_mode]
    rows = []
    if mode == 0:
        total = int(sizes.sum())
        for s in range(0, total, block_size):
            rows.append((s, min(s + block_size, total)))
    elif mode == 1:
        tok = cur = i = 0
        while i < len(sizes):
            if cur + sizes[i] <= block_size or cur == 0:
                cur += int(sizes[i])
                i += 1
            else:
                rows.append((tok, tok + cur))
                tok += cur
                cur = 0
        if cur:
            rows.append((tok, tok + cur))
    elif mode == 2:
        tok = cur = i = 0
        while i < len(sizes):
            if ((cur + sizes[i] <= block_size or cur == 0)
                    and sizes[i] != document_sep_len):
                cur += int(sizes[i])
                i += 1
            else:
                if cur > 1:
                    rows.append((tok, tok + cur))
                tok += cur
                cur = 0
                if sizes[i] == document_sep_len:
                    tok += int(sizes[i])
                    i += 1
        if cur > 1:
            rows.append((tok, tok + cur))
    else:
        start = 0
        for sz in sizes:
            rows.append((start, start + int(sz)))
            start += int(sz)
    return np.asarray(rows, np.int64).reshape(-1, 2)


def block_to_dataset_index(sizes: np.ndarray,
                           slices: np.ndarray) -> np.ndarray:
    """[m, 2] slices -> [m, 3] (start_ds_idx, start_offset, end_ds_idx)
    (_get_block_to_dataset_index_fast equivalent)."""
    sizes = np.ascontiguousarray(sizes, np.int64)
    slices = np.ascontiguousarray(slices, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    out = np.zeros((len(slices), 3), np.int64)
    for i, (s, e) in enumerate(slices):
        ds = int(np.searchsorted(starts, s, side="right") - 1)
        out[i, 0] = ds
        out[i, 1] = s - starts[ds]
        out[i, 2] = int(np.searchsorted(starts, max(e - 1, s),
                                        side="right") - 1)
    return out
