"""The bf16 walk of #11 (csrc/paged_attention.cu `paged_split_sm90`), on the
CPU:
- `paged_split_plan`: every token of every sequence in exactly one split
  and one tile, the tiles dealt to the token groups in turn, no table entry
  read past ceil(L / page), no split for L = 0 (its heads' zeros go to the
  first blocks), the blocks numbered as the kernel numbers them and within
  its grid; at the serving shape's ragged lengths no block walks more than
  the span and the blocks number about two an SM;
- the walk's arithmetic emulated in torch from the plan (per-tile online
  softmax in each token group, every p rounded to the pool type for P V
  and l summing the unrounded p, the groups merged in group order, the
  splits in split order, out = acc / (l > 0 ? l : 1)) against the JAX
  Pallas kernel `_paged_kernel` in interpret mode, at
  tests/test_torch_fused_paged.py's tolerances (2e-5 in float32, 2e-2 in
  bfloat16);
- the wrapper's raise for a bf16 CUDA pool whose page is no multiple of 16.
Then, marked `cuda` (they skip without a card), the kernel against the
plain version at the plan's edges, pages of 16 and 64, bit-equal twice.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)

N_SM = 132  # the H100 SXM's SMs
RAGGED = [2047, 1800, 1536, 1024, 777, 300, 1, 0]  # chip_smoke.py's


# --------------------------------------------------------------------------- #
# the plan
# --------------------------------------------------------------------------- #

PLAN_CASES = [
    # lengths, H, D, page, max_pages
    (RAGGED, 16, 96, 64, 32),
    (RAGGED, 16, 96, 16, 128),
    ([2047] * 8, 16, 96, 64, 32),
    ([0, 1, 77, 128], 3, 96, 16, 8),
    ([3200, 0, 257], 4, 64, 32, 100),
    ([(i * 97) % 960 for i in range(40)], 2, 64, 48, 20),
    ([2559], 16, 96, 64, 40),
    ([0, 0], 16, 128, 64, 40),
    ([5000, 31, 32, 33, 255, 256, 257, -3], 2, 128, 16, 300),
    # 16 heads of 32, the d32_kernels phase's geometry, and pages of 16
    (RAGGED, 16, 32, 64, 32),
    ([0, 1, 77, 128], 8, 32, 16, 8),
]


@pytest.mark.parametrize("lengths,H,D,page,MP", PLAN_CASES)
def test_paged_plan_covers_each_token_once(lengths, H, D, page, MP):
    plan = tpa.paged_split_plan(lengths, H, D, page, MP, N_SM)
    span, ngrp, box = plan["span"], plan["ngrp"], plan["box"]
    assert span % tpa.SPLIT_TILE == 0 and span >= tpa.PAGED_SPAN_FLOOR
    assert plan["nst"] % ngrp == 0 and 1 <= ngrp <= tpa.SPLIT_WARPS
    assert box == (tpa.SPLIT_TILE if page % tpa.SPLIT_TILE == 0 else 16)
    blocks = []
    for b, L in enumerate(lengths):
        n = min(max(L, 0), MP * page)
        splits, tiles = plan["splits"][b], plan["tiles"][b]
        assert len(splits) == len(tiles) == -(-n // span)  # none for n = 0
        assert len(splits) <= plan["xs"]
        seen = np.zeros(n, np.int32)
        for s, ((t0, t1), tl) in enumerate(zip(splits, tiles)):
            assert t0 == s * span and t1 - t0 <= span
            seen[t0:t1] += 1
            assert [a for _, a, _, _ in tl] == list(range(t0, t1,
                                                          tpa.SPLIT_TILE))
            assert [g for g, _, _, _ in tl] == [i % ngrp
                                                for i in range(len(tl))]
            for _, a, c, boxes in tl:
                assert c == min(t1, a + tpa.SPLIT_TILE)
                # each box inside one page, no entry past ceil(n / page),
                # a box wholly past the split left out
                assert boxes == [(x // page, x % page)
                                 for x in range(a, a + tpa.SPLIT_TILE, box)
                                 if x < t1]
                assert all(e < -(-n // page) and off + box <= page
                           for e, off in boxes)
        assert bool((seen == 1).all())
        blocks += [(b, h, s) for s in range(len(splits)) for h in range(H)]
    assert plan["blocks"] == blocks
    assert plan["zeros"] == [(b, h) for b, L in enumerate(lengths)
                             if min(max(L, 0), MP * page) == 0
                             for h in range(H)]
    # the grid holds the work and the zero writers
    assert max(len(blocks), len(plan["zeros"])) <= plan["grid"]
    assert plan["grid"] == min(plan["xs"] * len(lengths) * H,
                               plan["target"] + len(lengths) * H)


def test_paged_plan_at_the_ragged_lengths():
    """B8 H16 D96 page 64 (chip_smoke.py's phase_paged): the span is
    ceil(16 * 7485 / 264) = 454 rounded up to 480; no block walks more;
    the 2047-token sequence takes five splits, L = 0 none; the blocks with
    work number 320 (about two an SM: at most target + B * H)."""
    plan = tpa.paged_split_plan(RAGGED, 16, 96, 64, 32, N_SM)
    assert plan["span"] == 480
    walks = [t1 - t0 for sp in plan["splits"] for t0, t1 in sp]
    assert max(walks) == 480 and min(walks) >= 1
    assert [len(sp) for sp in plan["splits"]] == [5, 4, 4, 3, 2, 1, 1, 0]
    assert len(plan["blocks"]) == 320 <= plan["target"] + 8 * 16
    assert plan["grid"] == 392 and plan["zeros"] == [(7, h) for h in range(16)]
    # 8 x 2047: two splits of 1024 each, 256 blocks in one wave
    full = tpa.paged_split_plan([2047] * 8, 16, 96, 64, 32, N_SM)
    assert full["span"] == 1024 and len(full["blocks"]) == 256


def test_paged_plan_short_sequences_do_not_split():
    """Below the floor (256 tokens) a sequence is one split; the floor is
    what sizes the grid for the longest possible sequence."""
    plan = tpa.paged_split_plan([255, 256, 257], 2, 64, 16, 64, N_SM)
    assert plan["span"] == tpa.PAGED_SPAN_FLOOR
    assert [len(sp) for sp in plan["splits"]] == [1, 1, 2]
    assert plan["xs"] == 64 * 16 // tpa.PAGED_SPAN_FLOOR


# --------------------------------------------------------------------------- #
# the walk, emulated, against the JAX kernel
# --------------------------------------------------------------------------- #

def split_walk(qs, kf, vf, table, L, plan, b, pool_dtype, page):
    """csrc/paged_attention.cu's bf16 arithmetic for sequence b, all heads,
    in fp32: qs [H, D] pre-scaled in q's dtype; kf/vf [rows, H, D] the
    flat pools; token t at row table[t // page] * page + t % page."""
    H, D = qs.shape
    qf = qs.float()
    ngrp = plan["ngrp"]
    parts = []
    for (t0, t1), tiles in zip(plan["splits"][b], plan["tiles"][b]):
        m = torch.full((ngrp, H), -1e30)
        l = torch.zeros(ngrp, H)
        acc = torch.zeros(ngrp, H, D)
        for grp, a, c, _ in tiles:
            rows = torch.tensor([int(table[t // page]) * page + t % page
                                 for t in range(a, c)])
            k, v = kf[rows].float(), vf[rows].float()  # [cnt, H, D]
            s = torch.einsum("hd,thd->ht", qf, k)
            m_new = torch.maximum(m[grp], s.amax(-1))
            p = torch.exp(s - m_new[:, None])
            alpha = torch.exp(m[grp] - m_new)
            l[grp] = l[grp] * alpha + p.sum(-1)
            m[grp] = m_new
            pr = p.to(pool_dtype).float()
            acc[grp] = acc[grp] * alpha[:, None] + torch.einsum(
                "ht,thd->hd", pr, v)
        M = m.amax(0)
        e = torch.exp(m - M)
        parts.append((M, (l * e).sum(0), (acc * e[..., None]).sum(0)))
    if not parts:  # L = 0: the zeros a first block writes
        return torch.zeros(H, D, dtype=qs.dtype)
    M = torch.stack([p[0] for p in parts]).amax(0)
    l = sum(pl * torch.exp(pm - M) for pm, pl, _ in parts)
    o = sum(pa * torch.exp(pm - M)[:, None] for pm, _, pa in parts)
    return (o / torch.where(l > 0, l, 1.0)[:, None]).to(qs.dtype)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("H,D,page", [(2, 64, 16), (4, 96, 32), (4, 32, 16)])
def test_paged_split_walk_matches_jax(dtype, atol, H, D, page):
    """Lengths that split (700: three splits at the floor's span, 300: two),
    one that does not (40), one empty; scattered tables with garbage past
    each sequence's pages (never read)."""
    from unilm_tpu.ops.paged_attention import paged_decode_attention as jpda

    rng = np.random.RandomState(H + D + page)
    lengths = np.asarray([700, 0, 300, 40], np.int32)
    B, MP = len(lengths), -(-800 // page)
    P = B * MP + 2
    q = rng.randn(B, 1, H, D).astype(np.float32)
    kp = rng.randn(P, page, H * D).astype(np.float32)
    vp = rng.randn(P, page, H * D).astype(np.float32)
    tables = rng.permutation(P)[: B * MP].reshape(B, MP).astype(np.int32)
    junk = tables.copy()
    for b, L in enumerate(lengths):
        junk[b, -(-L // page):] = 10 ** 6
    want = np.asarray(jpda(
        jnp.asarray(q).astype(dtype), jnp.asarray(kp).astype(dtype),
        jnp.asarray(vp).astype(dtype), jnp.asarray(tables),
        jnp.asarray(lengths), interpret=True).astype(jnp.float32))
    plan = tpa.paged_split_plan(lengths.tolist(), H, D, page, MP, N_SM)
    assert [len(sp) for sp in plan["splits"]] == [3, 0, 2, 1]
    tdt = getattr(torch, dtype)
    t = lambda a: torch.from_numpy(a).to(tdt)
    qs = t(q)[:, 0] * D ** -0.5  # the wrapper scales q in its own dtype
    kf, vf = t(kp).reshape(P * page, H, D), t(vp).reshape(P * page, H, D)
    for b in range(B):
        got = split_walk(qs[b], kf, vf, junk[b], int(lengths[b]), plan, b,
                         tdt, page)
        np.testing.assert_allclose(got.float().numpy(), want[b, 0],
                                   atol=atol, rtol=0, err_msg=f"b={b}")
    assert float(np.abs(want[1]).max()) == 0.0


# --------------------------------------------------------------------------- #
# the wrapper's page rule for bf16 pools
# --------------------------------------------------------------------------- #

class _FakeCudaDevice(torch.Tensor):
    """A CPU tensor that names a CUDA device, so the wrapper takes its
    kernel branch and its checks run (it raises before any launch)."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(*shape, dtype=torch.bfloat16):
    return torch.zeros(*shape, dtype=dtype).as_subclass(_FakeCudaDevice)


@pytest.mark.parametrize("page", [8, 24, 40])
def test_bf16_pool_page_must_be_a_multiple_of_16(page):
    """JAX's kernel_supported asks a 16-row sublane tile of bf16 pages;
    the bf16 walk loads boxes of 16 or 32 rows inside a page."""
    tables = torch.zeros(2, 3, dtype=torch.int32)
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 16"):
        tpa.paged_decode_attention(_fake(2, 1, 2, 64), _fake(6, page, 128),
                                   _fake(6, page, 128), tables, lengths)


# --------------------------------------------------------------------------- #
# on the card: the kernel against the plain version at the plan's edges
# --------------------------------------------------------------------------- #

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels build with nvcc "
                    "at first use); chip_smoke.py runs them on the H100")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("lengths", [
    RAGGED, [2047] * 8, [0, 0], [255, 256, 257, 31, 32, 33, 1, 2560]])
def test_paged_kernel_at_plan_edges(card, page, lengths):
    """bf16: within chip_smoke.py's OUT_ATOL / OUT_RTOL (2e-2 each), the
    L = 0 rows exactly 0, two runs bit-equal (the splits merge in split
    order whichever arrives last)."""
    B, H, D, MP = len(lengths), 16, 96, 2560 // page
    P = B * MP
    rn = lambda *s: torch.randn(*s, generator=card, device="cuda").to(
        torch.bfloat16)
    q, kp, vp = rn(B, 1, H, D), rn(P, page, H * D), rn(P, page, H * D)
    tables = torch.randperm(P, generator=card, device="cuda").reshape(
        B, MP).to(torch.int32)
    L = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out = tpa.paged_decode_attention(q, kp, vp, tables, L)
    ref = tpa.paged_decode_attention_plain(q, kp, vp, tables, L)
    err = (out.float() - ref.float()).abs()
    assert bool((err <= 2e-2 + 2e-2 * ref.float().abs()).all())
    for b, n in enumerate(lengths):
        if n == 0:
            assert float(out[b].abs().max()) == 0.0
    assert torch.equal(out, tpa.paged_decode_attention(q, kp, vp, tables, L))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_kernel_at_head_dim_32(card, dtype):
    """#11 at 16 heads of 32 (chip_smoke.py's d32_kernels shape: pages of
    64, RAGGED, scattered tables), bf16 and fp32, within OUT_ATOL /
    OUT_RTOL (2e-2 each), the L = 0 row exactly 0."""
    B, H, D, page, MP = len(RAGGED), 16, 32, 64, 32
    P = B * MP
    rn = lambda *s: torch.randn(*s, generator=card, device="cuda").to(dtype)
    q, kp, vp = rn(B, 1, H, D), rn(P, page, H * D), rn(P, page, H * D)
    tables = torch.randperm(P, generator=card, device="cuda").reshape(
        B, MP).to(torch.int32)
    L = torch.tensor(RAGGED, dtype=torch.int32, device="cuda")
    out = tpa.paged_decode_attention(q, kp, vp, tables, L)
    ref = tpa.paged_decode_attention_plain(q, kp, vp, tables, L)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    assert float(out[-1].float().abs().max()) == 0.0
