"""Kernel #5's bf16 plan on the CPU (`onepass_tile_plan`, the rule of
csrc/onepass_attention.cu's `launch_bf16`, the walk's key tiles and the
wgmma blocks' `key_walk` ranges):

- every visible (row, key) pair of the keep mask is computed by exactly one
  step, every key a block reads is staged once, and the staged keys are
  the visible ones (the walk: exactly; the wgmma rows: their 128-key
  chunks); a decode step reads only the `limit` keys it can see;
- T <= 16 takes the walk, T >= 17 the wgmma rows;
- an emulation of both schedules in torch, built from the plan with the
  kernel's arithmetic (exp2 domain, the online factor per chunk, the
  walk's per-warp state merged in warp order, p rounded to v's type, l of
  the unrounded p), against JAX's `_onepass_kernel` in interpret mode at
  tests/test_torch_onepass.py's float32 bound (2e-5 abs + 1e-5 rel; fully
  masked rows exactly 0);
- marked `cuda` (they skip without a card), the kernel against its twin at
  the plan's edges.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.ops import flash_attention as jfa
from unilm_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

LOG2E = 1.4426950408889634

# (T, S, q_offset, limit, causal, window, D)
PLAN_CASES = [
    (128, 256, 0, 128, True, 1024, 64),    # yoco_chat prefill
    (1, 256, 140, 141, True, 1024, 64),    # yoco_chat decode
    (1, 256, 140, 141, True, 0, 64),       # its cross layer
    (16, 256, 240, 256, True, 0, 128),
    (17, 257, 240, 257, True, 0, 96),
    (64, 2048, 1984, 2048, True, 256, 64),
    (65, 256, 191, 256, True, 100, 128),
    (197, 197, 0, 197, False, 0, 64),
    (197, 69, 0, 69, True, 0, 96),
    (16, 69, 0, 40, False, 0, 64),
    (300, 2048, 0, 2048, True, 0, 128),
    (5, 100, 0, 0, True, 0, 64),           # kv_len 0: nothing visible
    # D = 32 (TrOCR-Small's decoder): the prompt's walk, the fine-tune's
    # causal 64 rows, chunks of 128 keys as at D = 64
    (1, 1, 0, 1, True, 0, 32),
    (64, 64, 0, 64, True, 0, 32),
    (200, 300, 100, 300, True, 0, 32),
]


def _visible(T, S, q_offset, limit, causal, window, D=64):
    return tfa._keep_mask(T, S, q_offset, min(limit, S), causal, window,
                          None, "cpu")[0, 0].expand(T, S)


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_plan_computes_each_visible_pair_once(case):
    T, S, qoff, limit, causal, window, D = case
    plan = tfa.onepass_tile_plan(*case)
    chunk = tfa.onepass_chunk(D)
    keep = _visible(*case)
    seen = torch.zeros(T, S, dtype=torch.int32)
    for blk in plan["blocks"]:
        staged = torch.zeros(S, dtype=torch.int32)
        for c0, c1 in blk["staged"]:
            assert 0 <= c0 < c1 <= S
            if plan["route"] == "wgmma":  # whole chunks, the last cut at S
                assert c0 % chunk == 0 and c1 == min(c0 + chunk, S)
            staged[c0:c1] += 1
        assert int(staged.max()) <= 1  # each key read once
        for r0, r1, c0, c1, _ in blk["steps"]:
            assert bool((staged[c0:c1] == 1).all())  # only staged keys
            seen[r0:r1, c0:c1] += 1
        # the block's rows see no key it did not stage
        rows = sorted({r for r0, r1, *_ in blk["steps"] for r in range(r0, r1)})
        if rows:
            assert not bool((keep[rows] & (staged == 0)[None]).any())
    assert bool((seen[keep] == 1).all())
    assert int(seen.max()) <= 1


@pytest.mark.parametrize("T", [1, 2, 15, 16, 17, 64, 65, 128, 197, 2048])
def test_walk_and_wgmma_split_at_16(T):
    plan = tfa.onepass_tile_plan(T, 256, 0, 256, True, 0)
    assert plan["route"] == ("walk" if T <= 16 else "wgmma")
    if plan["route"] == "wgmma":
        assert len(plan["blocks"]) == -(-T // tfa.ONEPASS_ROWS)
        # each consumer's rows: 64 of the block's 128
        for i, blk in enumerate(plan["blocks"]):
            for r0, r1, _, _, cw in blk["steps"]:
                assert r0 == i * 128 + 64 * cw and r1 - r0 <= 64


@pytest.mark.parametrize("qoff,limit,window", [(140, 141, 1024), (140, 141, 0),
                                               (255, 256, 0), (0, 1, 0),
                                               (200, 201, 64)])
def test_decode_step_reads_only_its_keys(qoff, limit, window):
    """A decode step (T = 1) at position q_offset reads exactly the keys it
    can see: [q_offset - window + 1, limit), not the cache's slots."""
    plan = tfa.onepass_tile_plan(1, 256, qoff, limit, True, window)
    assert plan["route"] == "walk"
    (blk,) = plan["blocks"]
    lo = max(0, qoff - window + 1) if window else 0
    assert blk["staged"] == [(lo, limit)]
    keys = sorted(c for _, _, c0, c1, _ in blk["steps"] for c in range(c0, c1))
    assert keys == list(range(lo, limit))
    # warps take 32-key tiles in turn
    for _, _, c0, _, w in blk["steps"]:
        assert w == (c0 - lo) // 32 % 8


def test_yoco_chat_rows_fit_one_chunk():
    """yoco_chat's prefill: one block per (batch, head) stages keys 0..127
    once; each consumer's rows see one chunk, so its max and l are exact
    in one step (no online rescaling)."""
    plan = tfa.onepass_tile_plan(128, 256, 0, 128, True, 1024)
    (blk,) = plan["blocks"]
    assert blk["staged"] == [(0, 128)]
    assert [s[4] for s in blk["steps"]] == [0, 1]


# --------------------------------------------------------------------------- #
# the schedules, emulated in torch from the plan
# --------------------------------------------------------------------------- #

def _scores2(q, k, bias, mask, b_rows, keys, T, S, qoff, limit, causal, window):
    """exp2-domain scores [B, H, rows, keys] with the keep predicate."""
    r0, r1 = b_rows
    c0, c1 = keys
    s = torch.einsum("bthd,bshd->bhts", q[:, r0:r1].float(), k[:, c0:c1].float())
    if bias is not None:
        s = s + bias[:, :, r0:r1, c0:c1].float()
    keep = tfa._keep_mask(T, S, qoff, limit, causal, window,
                          mask, "cpu")[:, :, r0:r1, c0:c1]
    return torch.where(keep, s * LOG2E, torch.tensor(-math.inf))


def _online(state, s, v_tile, vdtype):
    m, l, o = state
    mx = s.amax(-1, keepdim=True)
    m_new = torch.maximum(m, mx)
    m_use = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
    alpha = torch.exp2(m - m_use)
    p = torch.exp2(s - m_use)
    l = l * alpha + p.sum(-1, keepdim=True)
    o = o * alpha + torch.einsum("bhts,bshd->bhtd", p.to(vdtype).float(),
                                 v_tile.float())
    return m_new, l, o


def _finish(m, l, o):
    out = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    lse = torch.where(l > 0, (m + torch.log2(torch.clamp(l, min=1e-37)))
                      * math.log(2), 0.0)
    return out, lse[..., 0]


def onepass_emulate(q, k, v, bias, mask, qoff, kv_len, causal, window):
    """#5's bf16 schedule on the plan, in torch: (out [B,T,H,D], lse)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    limit = S if kv_len is None else min(kv_len, S)
    plan = tfa.onepass_tile_plan(T, S, qoff, limit, causal, window, D)
    out = torch.zeros(B, H, T, D)
    lse = torch.zeros(B, H, T)
    args = (T, S, qoff, limit, causal, window)

    def fresh(rows):
        return (torch.full((B, H, rows, 1), -math.inf),
                torch.zeros(B, H, rows, 1), torch.zeros(B, H, rows, D))

    for blk in plan["blocks"]:
        if plan["route"] == "wgmma":
            # each consumer over its chunks in order
            for cw in sorted({st[4] for st in blk["steps"]}):
                steps = [st for st in blk["steps"] if st[4] == cw]
                r0, r1 = steps[0][:2]
                state = fresh(r1 - r0)
                for _, _, c0, c1, _ in steps:
                    s = _scores2(q, k, bias, mask, (r0, r1), (c0, c1), *args)
                    state = _online(state, s, v[:, c0:c1], v.dtype)
                out[:, :, r0:r1], lse[:, :, r0:r1] = _finish(*state)
        else:
            # each warp over its tiles, then the warps merged in warp order
            warps = []
            for w in range(tfa.ONEPASS_WALK_WARPS):
                state = fresh(T)
                for _, _, c0, c1, _ in [st for st in blk["steps"] if st[4] == w]:
                    s = _scores2(q, k, bias, mask, (0, T), (c0, c1), *args)
                    state = _online(state, s, v[:, c0:c1], v.dtype)
                warps.append(state)
            M = torch.stack([m for m, _, _ in warps]).amax(0)
            L = torch.zeros(B, H, T, 1)
            O = torch.zeros(B, H, T, D)
            for m, l, o in warps:
                f = torch.where(M > -math.inf, torch.exp2(m - M), 0.0)
                L, O = L + l * f, O + o * f
            out[:], lse[:] = _finish(M, L, O)
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


# name: (B, T, S, H, causal, q_offset, kv_len, window, kpm, bias, D)
EMU_CASES = {
    "walk_decode": (2, 1, 64, 2, True, 20, 21, 16, False, None, 64),
    "walk_T16_kpm_dead_row": (2, 16, 70, 2, False, 0, None, 0, True, None, 64),
    "walk_T5_bias_1H": (2, 5, 40, 2, True, 30, None, 0, False, "1H", 96),
    "wgmma_T17_S257": (1, 17, 257, 2, True, 240, None, 0, False, None, 64),
    "wgmma_T65_window": (2, 65, 200, 2, True, 100, None, 40, False, "B1", 128),
    "wgmma_kpm_dead_row": (2, 24, 40, 2, False, 0, None, 0, True, None, 64),
    "wgmma_limit_D96": (2, 20, 300, 2, True, 0, 150, 0, False, None, 96),
    "walk_prompt_D32": (3, 1, 1, 4, True, 0, None, 0, False, None, 32),
    "wgmma_finetune_D32": (2, 64, 64, 4, True, 0, None, 0, False, None, 32),
    "wgmma_D32_kpm_dead_row": (2, 40, 200, 4, False, 0, None, 0, True, "1H",
                               32),
}


def _inputs(B, T, S, H, kpm, bias, D=64, seed=0):
    rng = np.random.RandomState(seed)
    r = lambda *s: rng.randn(*s).astype(np.float32)
    q = r(B, T, H, D) * np.float32(D ** -0.5)
    k, v = r(B, S, H, D), r(B, S, H, D)
    mask = None
    if kpm:
        mask = rng.rand(B, S) > 0.3
        mask[1] = False  # example 1 sees no key: out 0, lse 0
    b = None
    if bias == "1H":
        b = r(1, H, T, S)
    elif bias == "B1":
        b = r(B, 1, T, S)
    return q, k, v, mask, b


@pytest.mark.parametrize("name", sorted(EMU_CASES))
def test_emulated_schedule_matches_the_tpu_kernel(name):
    B, T, S, H, causal, qoff, kvl, window, kpm, bias, D = EMU_CASES[name]
    q, k, v, mask, b = _inputs(B, T, S, H, kpm, bias, D)
    route = tfa.onepass_tile_plan(T, S, qoff, S if kvl is None else kvl,
                                  causal, window, D)["route"]
    assert route == name.split("_")[0]
    sw = lambda a: jnp.asarray(a).swapaxes(1, 2)
    jo, jl = jfa._flash_forward_onepass(
        sw(q), sw(k), sw(v), None if b is None else jnp.asarray(b),
        None if mask is None else jnp.asarray(mask, jnp.int32),
        jnp.asarray([qoff], jnp.int32),
        jnp.asarray([S if kvl is None else kvl], jnp.int32),
        causal=causal, window=window, full_kv=kvl is None and not qoff,
        interpret=True)
    t = lambda a: None if a is None else torch.from_numpy(a)
    to, tl = onepass_emulate(t(q), t(k), t(v), t(b), t(mask), qoff, kvl,
                             causal, window)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo).swapaxes(1, 2),
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=1e-5)
    if kpm:  # the dead row: exactly 0 on both sides
        assert float(to[1].abs().max()) == 0.0
        assert float(tl[1].abs().max()) == 0.0


# --------------------------------------------------------------------------- #
# on the card: the kernel against its twin at the plan's edges
# --------------------------------------------------------------------------- #

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel builds with nvcc "
                    "at first use); chip_smoke.py runs it on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [69, 197, 256, 257, 2048])
@pytest.mark.parametrize("T", [1, 16, 17, 64, 65, 197])
def test_kernel_at_plan_edges(card, T, S):
    """#5 bf16 against its twin at the walk / wgmma split (T 16 / 17), the
    consumer split (64 / 65), BEiT's 197, and S around the 128-key chunks,
    causal at the cache's end with a mask (one dead example) and a
    [B, 1, T, S] bias: #1's tolerances (2e-2 abs + 2e-2 rel on out, 1e-3
    on lse); the dead example exactly 0."""
    rn = lambda *s: torch.randn(*s, generator=card, device="cuda").to(
        torch.bfloat16)
    B, H, D = 2, 4, 64 if T % 2 else 128
    q = rn(B, T, H, D) * D ** -0.5
    k, v = rn(B, S, H, D), rn(B, S, H, D)
    mask = torch.rand(B, S, generator=card, device="cuda") > 0.2
    mask[1] = False
    bias = rn(B, 1, T, S)
    qoff = max(0, S - T)
    got = tfa.flash_forward_onepass(q, k, v, bias, mask, qoff, None,
                                    causal=True, window=0)
    want = tfa.flash_forward_onepass_plain(q, k, v, bias, mask, qoff, None,
                                           causal=True, window=0)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=0)
    assert float(got[0][1].abs().max()) == 0.0
    assert float(got[1][1].abs().max()) == 0.0


def test_chunks_at_head_dim_32():
    """D = 32 takes the D = 64 chunk of 128 keys (`Geo<D>::BK`)."""
    assert tfa.onepass_chunk(32) == tfa.onepass_chunk(64) == 128
    assert tfa.onepass_chunk(96) == tfa.onepass_chunk(128) == 64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,S", [(1, 1), (5, 34), (64, 64), (200, 300)])
def test_kernel_at_head_dim_32(card, T, S, dtype):
    """#5 at D = 32 (TrOCR-Small's 8 heads of 32: the prompt's walk, the
    fine-tune's causal 64 rows) against its twin, causal at the cache's
    end: #1's tolerances (2e-2 abs + 2e-2 rel, 1e-3 on lse)."""
    rn = lambda *s: torch.randn(*s, generator=card, device="cuda").to(dtype)
    B, H, D = 3, 8, 32
    q = rn(B, T, H, D) * D ** -0.5
    k, v = rn(B, S, H, D), rn(B, S, H, D)
    qoff = S - T
    got = tfa.flash_forward_onepass(q, k, v, None, None, qoff, None,
                                    causal=True, window=0)
    want = tfa.flash_forward_onepass_plain(q, k, v, None, None, qoff, None,
                                           causal=True, window=0)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=0)
