"""Kernel #9's bf16 plan on the CPU (`doc_fwd_tile_plan`, the rule of
csrc/doc_attention.cu's `FwdGeo` and of its two sweeps):

- each sweep computes every (row, key) pair exactly once, each consumer
  warpgroup its own 64 rows; the producer stages K and the bias tile in
  both sweeps and V in the second only, and every staged tile is read by
  a step;
- the ring fits the card's shared memory at every head dim;
- an emulation of the schedule in torch, built from the plan with the
  kernel's arithmetic (exp2 domain; sweep 0 the exact row max over the
  tiles; sweep 1 p = exp2(s - max) rounded to v's type, l the sum of the
  rounded p, O += P V tile by tile), against JAX's `_doc_fwd_impl` in
  interpret mode at tests/test_torch_doc_attention.py's float32 bound
  (2e-5 abs);
- marked `cuda` (they skip without a card), the kernel against its twin at
  the tiles' edges, and two runs bit-equal.
"""

import numpy as np
import pytest
import torch

from unilm_tpu_torch.ops import doc_attention as da

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
EDGES = (1, 63, 64, 65, 127, 128, 129, 709, 2048)


@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("T,S", [(t, s) for t in EDGES for s in EDGES
                                 if t * s <= 709 * 2048])
def test_each_sweep_computes_each_pair_once(T, S, D):
    plan = da.doc_fwd_tile_plan(T, S, D)
    assert plan["rows"] == 128 and plan["tile"] == 64
    assert len(plan["blocks"]) == -(-T // 128)
    for sweep in (0, 1):
        seen = torch.zeros(T, S, dtype=torch.int32)
        for blk in plan["blocks"]:
            q0, q1 = blk["rows"]
            for sw, r0, r1, c0, c1 in blk["steps"]:
                assert q0 <= r0 < r1 <= q1 and 0 <= c0 < c1 <= S
                assert (r0, r1) in blk["consumers"]
                if sw == sweep:
                    seen[r0:r1, c0:c1] += 1
        assert bool((seen == 1).all())


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("T,S", [(1, 1), (65, 129), (129, 64), (709, 709),
                                 (2048, 2048)])
def test_block_stages_only_what_it_reads(T, S, bias):
    plan = da.doc_fwd_tile_plan(T, S, 64, bias)
    tiles = [(c0, min(c0 + 64, S)) for c0 in range(0, S, 64)]
    for blk in plan["blocks"]:
        q0, q1 = blk["rows"]
        # consumers: 64-row halves from q0, none past T
        assert blk["consumers"] == [(r, min(r + 64, T))
                                    for r in (q0, q0 + 64) if r < T]
        loads = blk["loads"]
        assert [x[1:] for x in loads if x[0] == "k"] == tiles * 2
        assert [x[1:] for x in loads if x[0] == "v"] == tiles
        assert [x[1:] for x in loads if x[0] == "bias"] == (
            [(q0, q1, *t) for t in tiles * 2] if bias else [])
        # in ring order: each step reads the ring step's K (and V in the
        # second sweep) and bias tile, and every staged tile is read
        ring = [x[1:] for x in loads if x[0] == "k"]
        per = len(blk["consumers"])
        steps = blk["steps"]
        assert len(steps) == per * len(ring)
        for n, (c0, c1) in enumerate(ring):
            for sw, r0, r1, s0, s1 in steps[per * n:per * (n + 1)]:
                assert (s0, s1) == (c0, c1) and sw == n // len(tiles)


@pytest.mark.parametrize("D,stages", [(64, 4), (96, 4), (128, 3)])
def test_ring_fits_shared_memory(D, stages):
    plan = da.doc_fwd_tile_plan(709, 709, D)
    assert plan["stages"] == stages
    assert plan["smem"] <= da._SMEM_MAX


# --------------------------------------------------------------------------- #
# the schedule, emulated in torch from the plan
# --------------------------------------------------------------------------- #

def doc_fwd_emulate(q, k, v, bias4, mask, scale):
    """#9's bf16 schedule on the plan, in torch: out [B, T, H, D]. bias4 is
    [B|1, H|1, T, S] or None, mask bool [B, S] or None."""
    B, T, H, D = q.shape
    S = k.shape[1]
    plan = da.doc_fwd_tile_plan(T, S, D)
    qs = (q.float() * (scale * LOG2E)).to(q.dtype).float()
    out = torch.zeros(B, T, H, D)
    for blk in plan["blocks"]:
        for r0, r1 in blk["consumers"]:
            m = torch.full((B, H, r1 - r0, 1), da.NEG_INF)
            l = torch.zeros(B, H, r1 - r0, 1)
            o = torch.zeros(B, H, r1 - r0, D)
            for sw, a0, _, c0, c1 in blk["steps"]:
                if a0 != r0:
                    continue
                s = torch.einsum("bthd,bshd->bhts", qs[:, r0:r1],
                                 k[:, c0:c1].float())
                if bias4 is not None:
                    s = s + LOG2E * bias4[:, :, r0:r1, c0:c1].float()
                if mask is not None:
                    s = s.masked_fill(~mask[:, None, None, c0:c1], da.NEG_INF)
                if sw == 0:
                    m = torch.maximum(m, s.amax(-1, keepdim=True))
                else:
                    p = torch.exp2(s - m).to(v.dtype).float()
                    l = l + p.sum(-1, keepdim=True)
                    o = o + torch.einsum("bhts,bshd->bhtd", p,
                                         v[:, c0:c1].float())
            out[:, r0:r1] = (o / l).permute(0, 2, 1, 3)
    return out.to(q.dtype)


# name: (B, T, S, H, bias, mask); D = 64. The emulation covers two 128-row
# blocks with a consumer past T and three key tiles with a ragged last one.
EMU_CASES = {
    "mask": (2, 37, 40, 2, None, True),
    "bias_11": (2, 197, 150, 2, (1, 1), False),
    "bias_BH_mask": (2, 70, 45, 2, (2, 2), True),
    "bias_1H_ragged": (1, 200, 131, 2, (1, 2), False),
    "head_major_mask": (2, 130, 131, 2, "hm", True),
    "all_masked_row": (2, 37, 40, 2, (2, 2), "allfalse"),
}


def _inputs(B, T, S, H, bias, kpm, D=64, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, T, H, D) * 0.4).astype(np.float32)
    k = (rng.randn(B, S, H, D) * 0.4).astype(np.float32)
    v = rng.randn(B, S, H, D).astype(np.float32)
    shape = (H, B, T, S) if bias == "hm" else (
        None if bias is None else (*bias, T, S))
    b = None if shape is None else (rng.randn(*shape) * 0.5).astype(np.float32)
    mask = None
    if kpm:
        mask = rng.rand(B, S) > 0.2
        mask[:, 0] = True
        if kpm == "allfalse":  # S is a multiple of 8: JAX pads no key
            mask[1] = False
    return q, k, v, b, mask


@pytest.mark.parametrize("name", sorted(EMU_CASES))
def test_emulated_schedule_matches_the_tpu_kernel(name):
    jnp = pytest.importorskip("jax.numpy")
    from unilm_tpu.ops import doc_attention as jda

    B, T, S, H, bias, kpm = EMU_CASES[name]
    q, k, v, b, mask = _inputs(B, T, S, H, bias, kpm)
    D = q.shape[-1]
    hm = bias == "hm"
    want = jda._doc_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if b is None else jnp.asarray(b),
        None if mask is None else jnp.asarray(mask), D ** -0.5, 16, True,
        hmajor=hm)
    t = lambda a: None if a is None else torch.from_numpy(a)
    b4 = t(b)
    if hm:
        b4 = b4.permute(1, 0, 2, 3)
    got = doc_fwd_emulate(t(q), t(k), t(v), b4, t(mask), D ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    # and the twin the CPU path runs gives the same function
    twin = da.doc_attention_plain(
        t(q), t(k), t(v), da.HeadMajorBias(t(b)) if hm else t(b), t(mask),
        D ** -0.5)
    np.testing.assert_allclose(got.numpy(), twin.numpy(), atol=2e-5, rtol=0)


# --------------------------------------------------------------------------- #
# on the card: the kernel against its twin at the tiles' edges
# --------------------------------------------------------------------------- #

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel builds with nvcc "
                    "at first use); chip_smoke.py runs it on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [63, 64, 65, 127, 128, 129])
@pytest.mark.parametrize("T", [63, 64, 65, 127, 128, 129])
def test_kernel_at_tile_edges(card, T, S):
    """#9 bf16 against doc_attention_plain at the 64-row consumer, 128-row
    block and 64-key tile edges, D cycling over 64, 96 and 128, a
    head-major bias and a mask with one example wholly masked: relative L2
    <= 1e-2 (chip_smoke.py's doc_attn bound); two runs bit-equal."""
    D = (64, 96, 128)[(T + S) % 3]
    B, H = 2, 3
    rn = lambda *s: torch.randn(*s, generator=card, device="cuda").to(
        torch.bfloat16)
    q, k, v = rn(B, T, H, D), rn(B, S, H, D), rn(B, S, H, D)
    bias = da.HeadMajorBias(2 * rn(H, B, T, S))
    mask = torch.rand(B, S, generator=card, device="cuda") > 0.2
    mask[:, 0] = True
    mask[1] = False
    got = da.doc_attention(q, k, v, bias, mask)
    again = da.doc_attention(q, k, v, bias, mask)
    ref = da.doc_attention_plain(q, k, v, bias, mask)
    err = float((got.float() - ref.float()).norm() / ref.float().norm())
    assert bool(torch.isfinite(got.float()).all()) and err <= 1e-2
    assert torch.equal(got, again)
