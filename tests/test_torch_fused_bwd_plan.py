"""Kernel #8's bf16 plan on the CPU (`fused_bwd_plan`, the rule of
csrc/flash_bwd_fused.cu's `block_of`, `block_walk` and its writers' turn
targets):

- the blocks' (q tile, key block) steps compute every visible (row, key)
  pair exactly once, and a block stages K/V of its keys once and the Q/dO
  tiles of its walk once each, every one holding a visible pair (skipped
  tiles are never loaded);
- each dq row tile's adders form one total order: their turn targets are
  0, 1, .. in descending key block, and no block waits on a block of
  higher linear index (the grid runs the key blocks reversed, so the
  blocks a turn waits on were dispatched before it);
- an emulation of the schedule in torch, built from the plan with the
  kernel's arithmetic (p = exp2(s log2 e - lse log2 e) under the keep
  mask, ds = p (dp - delta), p and ds rounded to the inputs' type before
  their products, dk and dv summed over the walk in order, dq as the
  blocks' parts added in turn order into a zeroed fp32 accumulator),
  against JAX's `_flash_backward_fused` in interpret mode at
  tests/test_torch_flash_schedules.py's float32 bound (1e-5 abs + 1e-5
  rel);
- marked `cuda` (they skip without a card), the kernel against its twin at
  the tiles' edges, two runs bit-equal, fully masked rows with zero
  gradients.
"""

import numpy as np
import pytest
import torch

from unilm_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
TOL = 1e-5

# (T, S, D, causal, window, q_offset, limit)
PLAN_CASES = [
    (2048, 2048, 64, True, 0, 0, 2048),     # the 1.3B train shape
    (200, 200, 64, True, 0, 0, 200),
    (70, 263, 96, True, 0, 193, 263),
    (131, 300, 96, True, 0, 40, 217),
    (300, 300, 128, True, 50, 0, 300),
    (97, 150, 128, False, 0, 0, 150),
    (160, 96, 64, False, 0, 0, 96),
    (1000, 1000, 64, True, 0, 0, 1000),
    (64, 2048, 64, True, 256, 1984, 2048),
    (129, 127, 64, True, 0, 0, 127),
    (65, 129, 96, False, 0, 0, 100),
    (5, 100, 64, True, 0, 0, 0),            # kv_len 0: nothing visible
]


def _visible(T, S, q_offset, limit, causal, window):
    return tfa._keep_mask(T, S, q_offset, min(limit, S), causal, window,
                          None, "cpu")[0, 0].expand(T, S)


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_plan_computes_each_visible_pair_once(case):
    T, S, D, causal, window, qoff, limit = case
    plan = tfa.fused_bwd_plan(T, S, D, causal, window, qoff, limit)
    rows, keys = plan["rows"], plan["keys"]
    assert rows == 64 and keys == (128 if D == 64 else 64)
    assert plan["consumers"] == keys // 64
    assert [b["key_block"] for b in plan["blocks"]] == list(
        range(-(-S // keys)))[::-1]
    keep = _visible(T, S, qoff, limit, causal, window)
    seen = torch.zeros(T, S, dtype=torch.int32)
    for blk in plan["blocks"]:
        c0, c1 = blk["keys"]
        assert c0 == blk["key_block"] * keys and c1 == min(S, c0 + keys)
        tiles = [i for i, _ in blk["steps"]]
        assert tiles == sorted(set(tiles))  # each Q/dO tile staged once, upward
        assert tiles == list(range(tiles[0], tiles[-1] + 1)) if tiles else True
        for i in tiles:
            r0, r1 = i * rows, min(T, (i + 1) * rows)
            assert 0 <= r0 < r1
            assert bool(keep[r0:r1, c0:c1].any())  # no tile without a pair
            seen[r0:r1, c0:c1] += 1
    assert bool((seen[keep] == 1).all())
    assert int(seen.max()) <= 1


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_turns_form_one_total_order(case):
    T, S, D, causal, window, qoff, limit = case
    plan = tfa.fused_bwd_plan(T, S, D, causal, window, qoff, limit)
    adders = {}
    for n, blk in enumerate(plan["blocks"]):
        for i, target in blk["steps"]:
            adders.setdefault(i, []).append((target, blk["key_block"], n))
    for i, a in adders.items():
        a.sort()
        assert [t for t, _, _ in a] == list(range(len(a))), (i, a)
        assert [j for _, j, _ in a] == sorted((j for _, j, _ in a),
                                              reverse=True)
        # a block waits on the adders before it, all of lower linear index
        assert [n for _, _, n in a] == sorted(n for _, _, n in a)


def test_causal_turns_rarely_stall():
    """At the train shape every causal key block j reaches row tile i at
    its step i - 2 j, the block before it in the turn (j + 1) at its step
    i - 2 j - 2: the turn is passed two steps ahead of need."""
    plan = tfa.fused_bwd_plan(2048, 2048, 64, True, 0, 0, 2048)
    step = {}
    for blk in plan["blocks"]:
        for n, (i, _) in enumerate(blk["steps"]):
            step[blk["key_block"], i] = n
    for (j, i), n in step.items():
        if (j + 1, i) in step:
            assert step[j + 1, i] == n - 2


# --------------------------------------------------------------------------- #
# the schedule, emulated in torch from the plan
# --------------------------------------------------------------------------- #

def fused_emulate(q, k, v, mask, qoff, limit, causal, window, lse, delta,
                  do):
    """#8's bf16 schedule on the plan, in torch, on pre-scaled q [B,T,H,D],
    k/v [B,S,H,D], lse/delta [B,H,T]: (dq, dk, dv) in the inputs' type."""
    B, T, H, D = q.shape
    S = k.shape[1]
    dt = q.dtype
    plan = tfa.fused_bwd_plan(T, S, D, causal, window, qoff, limit)
    rows = plan["rows"]
    keep = tfa._keep_mask(T, S, qoff, limit, causal, window, mask, "cpu")
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    dk = torch.zeros(B, S, H, D)
    dv = torch.zeros(B, S, H, D)
    parts = {}
    for blk in plan["blocks"]:
        c0, c1 = blk["keys"]
        for i, target in blk["steps"]:
            r0, r1 = i * rows, min(T, (i + 1) * rows)
            s = torch.einsum("bthd,bshd->bhts", qf[:, r0:r1], kf[:, c0:c1])
            p = torch.where(keep[..., r0:r1, c0:c1],
                            torch.exp2(s * LOG2E
                                       - lse[:, :, r0:r1, None] * LOG2E), 0.0)
            dp = torch.einsum("bthd,bshd->bhts", dof[:, r0:r1], vf[:, c0:c1])
            ds = p * (dp - delta[:, :, r0:r1, None])
            pr, dsr = p.to(dt).float(), ds.to(dt).float()
            dv[:, c0:c1] += torch.einsum("bhts,bthd->bshd", pr, dof[:, r0:r1])
            dk[:, c0:c1] += torch.einsum("bhts,bthd->bshd", dsr, qf[:, r0:r1])
            parts.setdefault(i, []).append(
                (target, torch.einsum("bhts,bshd->bthd", dsr, kf[:, c0:c1])))
    dq = torch.zeros(B, T, H, D)
    for i, lst in parts.items():
        for _, part in sorted(lst, key=lambda x: x[0]):
            dq[:, i * rows:(i + 1) * rows] += part
    return dq.to(dt), dk.to(dt), dv.to(dt)


# name: (B, T, S, H, D, causal, q_offset, kv_len, window, kpm)
EMU_CASES = {
    "causal_T256_D64": (2, 256, 256, 2, 64, True, 0, None, 0, False),
    "noncausal_kpm_dead_row": (2, 64, 200, 2, 64, False, 0, None, 0, True),
    "window_offset_D128": (2, 100, 160, 2, 128, True, 60, 150, 40, False),
    "ragged_kpm_D96": (1, 130, 200, 2, 96, True, 70, None, 0, True),
}


@pytest.mark.parametrize("name", sorted(EMU_CASES))
def test_emulated_schedule_matches_the_tpu_kernel(name):
    jnp = pytest.importorskip("jax.numpy")
    from unilm_tpu.ops import flash_attention as jfa

    B, T, S, H, D, causal, qoff, kvl, window, kpm = EMU_CASES[name]
    rng = np.random.RandomState(5)
    r = lambda *s: rng.randn(*s).astype(np.float32)
    q = r(B, T, H, D) * np.float32(D ** -0.5)
    k, v, do = r(B, S, H, D), r(B, S, H, D), r(B, T, H, D)
    mask = None
    if kpm:
        mask = rng.rand(B, S) > 0.3
        mask[-1] = False  # the last example sees no key: zero gradients
    limit = S if kvl is None else kvl
    t = lambda a: None if a is None else torch.from_numpy(a)
    kw = dict(causal=causal, window=window)
    out, lse = tfa.flash_forward_plain(t(q), t(k), t(v), None, t(mask), qoff,
                                       kvl, **kw)
    delta = tfa._delta(out, t(do))
    got = fused_emulate(t(q), t(k), t(v), t(mask), qoff, limit, causal,
                        window, lse, delta, t(do))
    sw = lambda a: jnp.asarray(a).swapaxes(1, 2)
    want = jfa._flash_backward_fused(
        sw(q), sw(k), sw(v),
        None if mask is None else jnp.asarray(mask, jnp.int32),
        jnp.asarray([qoff], jnp.int32), jnp.asarray([limit], jnp.int32),
        jnp.asarray(lse.numpy()), jnp.asarray(delta.numpy()), sw(do),
        causal=causal, window=window, block_q=64, block_k=64,
        interpret=True)
    for gname, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w).swapaxes(1, 2),
                                   atol=TOL, rtol=TOL, err_msg=gname)
    if kpm:
        assert float(got[0][-1].abs().max()) == 0.0
        assert float(got[1][-1].abs().max()) == 0.0


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


def _rel(x, ref):
    x, ref = x.float(), ref.float()
    return float((x - ref).norm() / ref.norm().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("T,S", [(63, 63), (64, 64), (65, 65), (127, 129),
                                 (128, 128), (129, 127)])
def test_kernel_at_tile_edges(card, T, S, D, causal):
    """#8 bf16 against flash_backward_fused_plain on the forward kernel's
    out and lse at the 64-row tile and 64/128-key block edges: relative L2
    <= 1e-2 (chip_smoke.py's flash_bwd_fused bound); two runs bit-equal;
    the fully masked example's dq and dk exactly 0."""
    rn = lambda *s: torch.randn(*s, generator=card, device="cuda").to(
        torch.bfloat16)
    B, H = 2, 3
    q, k, v, do = rn(B, T, H, D) * D ** -0.5, rn(B, S, H, D), rn(B, S, H, D), \
        rn(B, T, H, D)
    mask = torch.rand(B, S, generator=card, device="cuda") > 0.2
    mask[1] = False
    kw = dict(causal=causal, window=0)
    out, lse = tfa.flash_forward(q, k, v, None, mask, 0, None, **kw)
    got = tfa.flash_backward_fused(q, k, v, mask, 0, None, out, lse, do, **kw)
    again = tfa.flash_backward_fused(q, k, v, mask, 0, None, out, lse, do, **kw)
    ref = tfa.flash_backward_fused_plain(q, k, v, mask, 0, None, out, lse, do,
                                         **kw)
    for a, b2, r in zip(got, again, ref):
        assert _rel(a[0], r[0]) <= 1e-2 and torch.equal(a, b2)
    assert float(got[0][1].abs().max()) == 0.0
    assert float(got[1][1].abs().max()) == 0.0
