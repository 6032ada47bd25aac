"""Kernel #1's tile classification, `flash_tile_plan` (the rule that
csrc/flash_fwd.cu's `walk` and `interior` compute), held against the keep
mask of the plain version, `_keep_mask`, on the CPU:
- a skipped key tile holds no visible (row, key) pair, so the walk covers
  every visible pair;
- an interior tile has every pair visible (before the padding mask);
- the walk of a 128-row block, which the producer loads, is the union of
  its two 64-row halves' walks, which the consumers classify by.
"""

import pytest
import torch

from unilm_tpu_torch.ops import flash_attention as tfa

# name: (T, S, q_offset, kv_len, causal, window)
CASES = {
    "tiny_causal": (45, 45, 0, None, True, 0),
    "tiny_full": (45, 45, 0, None, False, 0),
    "one_row": (1, 300, 299, None, True, 0),
    "aligned_causal": (256, 256, 0, None, True, 0),
    "ragged_causal": (200, 200, 0, None, True, 0),
    "slice_prefill": (2052, 2052, 0, None, True, 0),
    "slice_noncausal": (2052, 2052, 0, None, False, 0),
    "q_offset_mid_tile": (70, 263, 193, None, True, 0),
    "q_offset_aligned": (128, 384, 256, None, True, 0),
    "q_offset_noncausal": (70, 263, 193, None, False, 0),
    "kv_len_mid_tile": (131, 300, 0, 217, True, 0),
    "kv_len_noncausal": (131, 300, 0, 217, False, 0),
    "kv_len_zero": (64, 128, 0, 0, True, 0),
    "window_mid_tile": (300, 300, 0, None, True, 50),
    "window_one": (300, 300, 0, None, True, 1),
    "window_noncausal": (300, 300, 0, None, False, 50),
    "window_offset": (70, 263, 193, None, True, 100),
    "yoco_long": (4096, 4128, 0, 4096, True, 1024),
    "tower": (4096, 4096, 0, None, False, 0),
    "resampler": (2048, 6144, 0, None, False, 0),
    "train": (2048, 2048, 0, None, True, 0),
    "decode_step": (1, 256, 140, 141, True, 1024),
    "rows_before_keys": (64, 128, -80, None, True, 0),
}


def _limit(S, kv_len):
    return S if kv_len is None else min(kv_len, S)


@pytest.mark.parametrize("BQ,BK", [(64, 128), (128, 128), (64, 64)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_matches_keep_mask(name, BQ, BK):
    T, S, qoff, kvl, causal, window = CASES[name]
    limit = _limit(S, kvl)
    keep = tfa._keep_mask(T, S, qoff, limit, causal, window, None, "cpu")[0, 0]
    plan = tfa.flash_tile_plan(T, S, qoff, limit, causal, window, BQ, BK)
    nk = -(-S // BK)
    assert len(plan) == -(-T // BQ)
    for i, (jb, je, interior) in enumerate(plan):
        assert 0 <= jb <= je <= nk and len(interior) == je - jb
        rows = keep[i * BQ:(i + 1) * BQ]
        for j in range(nk):
            tile = rows[:, j * BK:(j + 1) * BK]
            if not jb <= j < je:
                assert not tile.any(), (i, j, "skipped tile with a visible pair")
            elif interior[j - jb]:
                assert tile.shape[1] == BK and tile.all(), (
                    i, j, "interior tile with a masked pair")
        walked = torch.zeros_like(rows)
        walked[:, jb * BK:je * BK] = True
        assert not (rows & ~walked).any(), (i, "visible pair outside the walk")


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_walk_is_union_of_consumer_walks(name):
    T, S, qoff, kvl, causal, window = CASES[name]
    limit = _limit(S, kvl)
    block = tfa.flash_tile_plan(T, S, qoff, limit, causal, window, 128, 128)
    half = tfa.flash_tile_plan(T, S, qoff, limit, causal, window, 64, 128)
    for i, (jb, je, _) in enumerate(block):
        parts = [(b, e) for b, e, _ in half[2 * i:2 * i + 2] if e > b]
        if not parts:
            assert je == jb
            continue
        assert jb == min(b for b, _ in parts) and je == max(e for _, e in parts)
        covered = set()
        for b, e in parts:
            covered.update(range(b, e))
        assert covered == set(range(jb, je))


def test_interior_is_exact_without_causal_or_window():
    """Non-causal, no window: every key tile inside the valid prefix is
    interior, and only the tile that `limit` cuts is a boundary one."""
    plan = tfa.flash_tile_plan(300, 700, 0, 650, False, 0, 64, 128)
    for jb, je, interior in plan:
        assert (jb, je) == (0, 6)
        assert interior == [True] * 5 + [False]


def test_causal_diagonal_tiles():
    """Causal with T = S and BQ = BK: the tiles below the diagonal are
    interior, the diagonal tile is a boundary tile, the rest are skipped;
    a q_offset of 64 moves the diagonal to the middle of a tile."""
    plan = tfa.flash_tile_plan(512, 512, 0, 512, True, 0, 128, 128)
    for i, (jb, je, interior) in enumerate(plan):
        assert (jb, je) == (0, i + 1)
        assert interior == [True] * i + [False]
    plan = tfa.flash_tile_plan(128, 512, 64, 512, True, 0, 64, 128)
    assert [(jb, je) for jb, je, _ in plan] == [(0, 1), (0, 2)]
    assert plan[0][2] == [False] and plan[1][2] == [True, False]
