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
    # TrOCR-Small's fine-tune self-attention (8 heads of 32) and its
    # beam-5 cross-attention, folded
    "trocr_small_finetune": (64, 64, 0, None, True, 0),
    "trocr_small_folded": (5, 578, 0, None, False, 0),
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


# ---- the backward's walks: #6 takes flash_tile_plan at BK = 64 (a block
# of 128 rows, two consumers of 64), #7 its transpose, flash_bwd_tile_plan
# (a block of 64 keys per consumer, two consumers at D = 64) ------------


@pytest.mark.parametrize("BQ,BK", [(64, 64), (64, 128)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_plan_matches_keep_mask(name, BQ, BK):
    """For each key tile: the q tiles outside its walk hold no visible
    pair, and an interior tile has every pair of its rows < T visible
    (rows past T read as zeros and add nothing, as in #1's plan)."""
    T, S, qoff, kvl, causal, window = CASES[name]
    limit = _limit(S, kvl)
    keep = tfa._keep_mask(T, S, qoff, limit, causal, window, None, "cpu")[0, 0]
    plan = tfa.flash_bwd_tile_plan(T, S, qoff, limit, causal, window, BQ, BK)
    nq = -(-T // BQ)
    assert len(plan) == -(-S // BK)
    for j, (ib, ie, interior) in enumerate(plan):
        assert 0 <= ib <= ie <= nq and len(interior) == ie - ib
        cols = keep[:, j * BK:(j + 1) * BK]
        for i in range(nq):
            tile = cols[i * BQ:(i + 1) * BQ]
            if not ib <= i < ie:
                assert not tile.any(), (i, j, "skipped tile with a visible pair")
            elif interior[i - ib]:
                assert tile.shape[1] == BK and tile.all(), (
                    i, j, "interior tile with a masked pair")


@pytest.mark.parametrize("BQ,BK", [(64, 64), (64, 128)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_plan_is_transpose_of_fwd_plan(name, BQ, BK):
    """#7 visits exactly the (q tile, key tile) pairs #1 and #6 visit,
    with the same interior flags."""
    T, S, qoff, kvl, causal, window = CASES[name]
    limit = _limit(S, kvl)
    fwd = tfa.flash_tile_plan(T, S, qoff, limit, causal, window, BQ, BK)
    bwd = tfa.flash_bwd_tile_plan(T, S, qoff, limit, causal, window, BQ, BK)
    nk = -(-S // BK)
    by_fwd = {(i, j): flag for i, (jb, je, flags) in enumerate(fwd)
              for j, flag in zip(range(jb, je), flags) if j < nk}
    by_bwd = {(i, j): flag for j, (ib, ie, flags) in enumerate(bwd)
              for i, flag in zip(range(ib, ie), flags)}
    assert by_fwd == by_bwd


@pytest.mark.parametrize("name", sorted(CASES))
def test_dkv_block_walk_is_union_of_consumer_walks(name):
    """#7's producer walks the q tiles of a 128-key block, its two
    consumers those of their 64 keys: the block walk is their union."""
    T, S, qoff, kvl, causal, window = CASES[name]
    limit = _limit(S, kvl)
    block = tfa.flash_bwd_tile_plan(T, S, qoff, limit, causal, window, 64, 128)
    half = tfa.flash_bwd_tile_plan(T, S, qoff, limit, causal, window, 64, 64)
    for j, (ib, ie, _) in enumerate(block):
        parts = [(b, e) for b, e, _ in half[2 * j:2 * j + 2] if e > b]
        if not parts:
            assert ie == ib
            continue
        covered = set()
        for b, e in parts:
            covered.update(range(b, e))
        assert covered == set(range(ib, ie))


@pytest.mark.parametrize("name", sorted(CASES))
def test_dq_block_walk_is_union_of_consumer_walks(name):
    """#6 walks 64-key tiles for a block of 128 q rows; its consumers
    classify by their 64 rows: the block walk is their union."""
    T, S, qoff, kvl, causal, window = CASES[name]
    limit = _limit(S, kvl)
    block = tfa.flash_tile_plan(T, S, qoff, limit, causal, window, 128, 64)
    half = tfa.flash_tile_plan(T, S, qoff, limit, causal, window, 64, 64)
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


def test_bwd_causal_walk():
    """Causal with T = S and BQ = BK: key tile j is seen by q tiles j ..
    end, the diagonal one a boundary tile; kv_len 100 skips the key tiles
    past it and cuts the second."""
    plan = tfa.flash_bwd_tile_plan(256, 256, 0, 256, True, 0, 64, 64)
    for j, (ib, ie, interior) in enumerate(plan):
        assert (ib, ie) == (j, 4)
        assert interior == [False] + [True] * (3 - j)
    plan = tfa.flash_bwd_tile_plan(256, 256, 0, 100, True, 0, 64, 64)
    assert [(ib, ie) for ib, ie, _ in plan] == [(0, 4), (1, 4), (0, 0), (0, 0)]
    assert plan[1][2] == [False] * 3
