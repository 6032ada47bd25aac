"""The tile plans of the Hopper kernels #2 and #3, on the CPU:
- `tri_fold_plan`, the folded walk of csrc/flash_tri.cu: every visible
  (q tile, k tile <= q tile) pair once, balanced blocks, the causal
  predicate only on the diagonal, and the same tiles and interior flags as
  #1's `flash_tile_plan` at 128 x 128;
- `encoder_tile_plan`, the row and key plan of csrc/encoder_attention.cu:
  every (row, key) once, whole rows in one 128-key tile up to S = 128 and
  streamed beyond, keys padded only to the product's width.
- `doc_bwd_tile_plan`, the three launches of csrc/doc_attention_bwd.cu
  (#10): every (q tile, k tile) pair once in each, the FUNSD edge of 709 =
  5 * 128 + 69 rows.
Then, marked `cuda` (they skip without a card), the kernels against their
plain twins at the new tiles' boundaries.
"""

import pytest
import torch

from unilm_tpu_torch.ops import doc_attention as tda
from unilm_tpu_torch.ops import flash_attention as tfa

TRI_TS = (1, 63, 64, 65, 127, 128, 129, 160, 1000, 2048)
ENC_SS = (1, 128, 129, 197, 208, 256, 257, 577, 2048)


@pytest.mark.parametrize("T", TRI_TS)
def test_tri_fold_plan_visits_each_visible_tile_once(T):
    nq = -(-T // tfa.TRI_TILE)
    plan = tfa.tri_fold_plan(T)
    assert len(plan) == -(-nq // 2)
    seen = [(i, j) for steps in plan for i, j, _ in steps]
    assert sorted(seen) == [(i, j) for i in range(nq) for j in range(i + 1)]
    for steps in plan:
        # a block's walks in ring order: the longer q tile first, each from
        # k tile 0 up to its diagonal
        tiles = [i for i, j, _ in steps if j == 0]
        assert tiles == sorted(tiles, reverse=True) and len(tiles) in (1, 2)
        assert [j for _, j, _ in steps] == [
            j for i in tiles for j in range(i + 1)]


@pytest.mark.parametrize("T", TRI_TS)
def test_tri_fold_plan_balances_blocks(T):
    """Every block walks nq + 1 k tiles but the middle block of an odd nq,
    which takes its one q tile alone: (nq + 1) / 2."""
    nq = -(-T // tfa.TRI_TILE)
    work = [len(steps) for steps in tfa.tri_fold_plan(T)]
    if nq % 2:
        assert work[-1] == (nq + 1) // 2
        work = work[:-1]
    assert all(w == nq + 1 for w in work)


@pytest.mark.parametrize("T", TRI_TS)
def test_tri_fold_plan_flags_only_the_diagonal(T):
    """The flagged steps are the diagonal tiles, and they are #1's boundary
    tiles of the same causal call at 128 x 128 (T == S, no offset); every
    other step is an interior tile, whose pairs are all visible."""
    tile = tfa.TRI_TILE
    fwd = tfa.flash_tile_plan(T, T, 0, T, True, 0, tile, tile)
    interior = {(i, j): flag for i, (jb, je, flags) in enumerate(fwd)
                for j, flag in zip(range(jb, je), flags)}
    keep = tfa._keep_mask(T, T, 0, T, True, 0, None, "cpu")[0, 0]
    steps = [s for block in tfa.tri_fold_plan(T) for s in block]
    assert {(i, j) for i, j, _ in steps} == set(interior)
    for i, j, diagonal in steps:
        assert diagonal == (i == j) == (not interior[(i, j)])
        pairs = keep[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile]
        assert bool(pairs.all()) == (not diagonal or pairs.numel() == 1)


@pytest.mark.parametrize("T", (1, 64, 197, 300))
@pytest.mark.parametrize("S", ENC_SS)
def test_encoder_tile_plan_covers_each_pair_once(T, S):
    mode, steps = tfa.encoder_tile_plan(T, S)
    assert mode == ("whole" if S <= 128 else "streamed")
    seen = torch.zeros(T, S, dtype=torch.int32)
    for r0, r1, c0, c1, _ in steps:
        assert 0 <= r0 < r1 <= T and r1 - r0 <= tfa.ENCODER_ROWS
        assert 0 <= c0 < c1 <= S and c1 - c0 <= tfa.ENCODER_TILE
        seen[r0:r1, c0:c1] += 1
    assert bool((seen == 1).all())
    # every 64-row tile walks every key tile, in order
    rows = sorted({r0 for r0, *_ in steps})
    assert rows == list(range(0, T, tfa.ENCODER_ROWS))
    for r in rows:
        assert [c0 for r0, _, c0, _, _ in steps if r0 == r] == list(
            range(0, S, tfa.ENCODER_TILE))


@pytest.mark.parametrize("S", ENC_SS)
def test_encoder_tile_plan_pads_keys_only_to_the_product_width(S):
    """The products run over whole 128-key tiles (the S = Q K^T product's
    wgmma N): only the last tile holds keys past S, fewer than 128."""
    _, steps = tfa.encoder_tile_plan(64, S)
    last = max(c0 for _, _, c0, _, _ in steps)
    for _, _, c0, c1, computed in steps:
        assert computed == 128
        assert c1 - c0 == (128 if c0 < last else S - last)
    assert 0 <= len(steps) * 128 - S < 128


def test_encoder_tile_plan_beit_b():
    """BEiT-B/224: 197 rows in four 64-row tiles (two per consumer), each
    over two key tiles, 128 keys and 69."""
    mode, steps = tfa.encoder_tile_plan(197, 197)
    assert mode == "streamed"
    assert sorted({(r0, r1) for r0, r1, *_ in steps}) == [
        (0, 64), (64, 128), (128, 192), (192, 197)]
    assert {(c0, c1) for _, _, c0, c1, _ in steps} == {(0, 128), (128, 197)}


DOC_TS = [(709, 709), (37, 40), (197, 197), (100, 77), (64, 200), (129, 131),
          (301, 37), (50, 2048), (1024, 1024), (2048, 2048)]


@pytest.mark.parametrize("D", (32, 64, 96, 128))
@pytest.mark.parametrize("T,S", DOC_TS)
def test_doc_bwd_tile_plan_visits_each_pair_once(T, S, D):
    plan = tda.doc_bwd_tile_plan(T, S, D)
    for launch, blocks in plan.items():
        seen = torch.zeros(T, S, dtype=torch.int32)
        for steps in blocks:
            for r0, r1, c0, c1 in steps:
                assert 0 <= r0 < r1 <= T and 0 <= c0 < c1 <= S
                seen[r0:r1, c0:c1] += 1
        assert bool((seen == 1).all()), launch
    # stats and dq: 128-row blocks over 64-key tiles; dk/dv: key blocks
    # (128 keys at D = 32 and 64, else 64) over 64-row tiles
    kb = 128 if D <= 64 else 64
    assert len(plan["stats"]) == len(plan["dq"]) == -(-T // 128)
    assert len(plan["dkv"]) == -(-S // kb)
    assert all(len(steps) == -(-S // 64) for steps in plan["stats"])
    assert all(len(steps) == -(-T // 64) for steps in plan["dkv"])
    assert plan["dq"] == plan["stats"]


def test_doc_bwd_tile_plan_funsd_edges():
    """FUNSD, T = S = 709: the last 128-row block holds 69 rows, the last
    64-key tile 5 keys, the last 128-key block 69 keys."""
    plan = tda.doc_bwd_tile_plan(709, 709, 64)
    assert {(r0, r1) for r0, r1, _, _ in plan["stats"][-1]} == {(640, 709)}
    assert plan["stats"][0][-1][2:] == (704, 709)
    assert {(c0, c1) for _, _, c0, c1 in plan["dkv"][-1]} == {(640, 709)}
    assert plan["dkv"][-1][-1][:2] == (704, 709)


# --------------------------------------------------------------------------- #
# on the card: the kernels against their twins at the tiles' boundaries
# --------------------------------------------------------------------------- #

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels build with nvcc "
                    "at first use); chip_smoke.py runs them on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(x, ref):
    x, ref = x.float(), ref.float()
    return float((x - ref).norm() / ref.norm().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("kpm", [False, True])
@pytest.mark.parametrize("T,D", [(127, 64), (128, 96), (129, 128), (255, 64),
                                 (257, 96)])
def test_tri_kernel_at_tile_boundaries(card, T, D, kpm):
    """#2 (bf16, the wgmma kernel) against flash_forward_tri_plain at T one
    short of, at and one past a 128-row tile, and one or two tiles on:
    relative L2 <= 1e-2; with the mask, the row with no key is 0."""
    rn = lambda *s: torch.randn(*s, generator=card, device="cuda").to(
        torch.bfloat16)
    q, k, v = rn(2, T, 4, D) * D ** -0.5, rn(2, T, 4, D), rn(2, T, 4, D)
    mask = None
    if kpm:
        mask = torch.rand(2, T, generator=card, device="cuda") > 0.3
        mask[0, 0], mask[1, 0] = True, False
    bias = rn(1, 4, T, T)
    out, lse = tfa.flash_forward_tri(q, k, v, bias, mask)
    ref, ref_lse = tfa.flash_forward_tri_plain(q, k, v, bias, mask)
    assert _rel(out, ref) <= 1e-2 and _rel(lse, ref_lse) <= 1e-2
    if kpm:
        assert float(out[1, 0].abs().max()) == 0.0
        assert float(lse[1, :, 0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("T,S,D", [(64, 128, 96), (33, 129, 64), (197, 208, 64),
                                   (64, 256, 96), (129, 257, 128), (300, 577, 64)])
def test_encoder_kernel_at_tile_boundaries(card, T, S, D, bias):
    """#3 (bf16, the wgmma kernel) against fused_encoder_attention_plain at
    S = 128 (one full key tile, whole rows), 129 (a second tile of one
    key), 208, 256, 257 and 577 (two to five tiles, the last ragged or
    full): relative L2 <= 1e-2."""
    rn = lambda *s: torch.randn(*s, generator=card, device="cuda").to(
        torch.bfloat16)
    q, k, v = rn(2, T, 3, D), rn(2, S, 3, D), rn(2, S, 3, D)
    b = 2 * rn(1, 3, T, S) if bias else None
    out = tfa.fused_encoder_attention(q, k, v, b)
    assert _rel(out, tfa.fused_encoder_attention_plain(q, k, v, b)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T,S,D", [(127, 64, 64), (128, 129, 96), (129, 127, 128),
                                   (709, 709, 64), (65, 300, 64)])
def test_doc_bwd_kernel_at_tile_boundaries(card, T, S, D, masked):
    """#10 (bf16, the wgmma kernels) against doc_backward_plain at T and S
    one short of, at and one past the 128-row and 64/128-key tiles, and
    FUNSD's 709, head-major bias, with and without a mask: dq, dk, dv and
    dbias within relative L2 1e-2, as chip_smoke.py's doc_bwd phase."""
    rn = lambda *s: torch.randn(*s, generator=card, device="cuda").to(
        torch.bfloat16)
    B, H = 2, 3
    q, k, v, do = rn(B, T, H, D), rn(B, S, H, D), rn(B, S, H, D), rn(B, T, H, D)
    bias = tda.HeadMajorBias(2 * rn(H, B, T, S))
    mask = None
    if masked:
        mask = torch.rand(B, S, generator=card, device="cuda") > 0.2
        mask[0, 0], mask[1] = True, False  # an example with every key masked
    got = tda.doc_backward(q, k, v, bias, mask, do)
    ref = tda.doc_backward_plain(q, k, v, bias, mask, do)
    for x, r in zip(got, ref):
        assert _rel(x, r) <= 1e-2
