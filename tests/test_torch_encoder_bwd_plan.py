"""Kernel #4's bf16 plan on the CPU (`enc_bwd_plan` / `enc_bwd_steps`, the
rule of csrc/encoder_attention_bwd.cu's `launch`, `item_bh` and
`acc_stride`):

- each of the three launches visits every (batch, head, q row, key) once;
  the dk/dv blocks take their items batch-major in order, the batch groups
  partition the batch in order, and the last launch adds the groups in
  group order;
- at BEiT-B (B=256, T=S=197, H=12, a [1, 12, 197, 197] bias) the partial
  planes are at most 32 MB (the first design's 477 MB), and the dbias tile
  fits in shared memory;
- an emulation of the schedule in torch, built from the plan with the
  kernel's arithmetic (online statistics over the key tiles in the exp2
  domain, ds from them, the dbias tile summed over a block's items in
  order, the groups' planes added in order, dq over the ds plane),
  against `jax.vjp` of the JAX package's `fused_encoder_attention` in
  interpret mode, whose custom VJP runs `_vit_bwd_kernel`, at
  tests/test_torch_encoder_backward.py's bound (2e-5 abs + 1e-5 rel);
- marked `cuda` (they skip without a card), the kernel against its twin at
  the plan's edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.ops import flash_attention as jfa
from unilm_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
BIAS = {None: None, "11": lambda B, H, T, S: (1, 1, T, S),
        "1H": lambda B, H, T, S: (1, H, T, S),
        "BH": lambda B, H, T, S: (B, H, T, S),
        "B1": lambda B, H, T, S: (B, 1, T, S)}

# (B, T, S, H, D, bias, sms)
PLAN_CASES = [
    (3, 17, 17, 3, 64, "1H", 132), (3, 17, 17, 3, 64, "1H", 1),
    (2, 13, 21, 3, 64, "B1", 132), (4, 24, 24, 2, 96, "11", 2),
    (2, 16, 24, 2, 128, "BH", 132), (2, 29, 11, 2, 128, None, 132),
    (5, 70, 130, 2, 64, "1H", 3), (2, 300, 40, 2, 64, "1H", 132),
    (3, 240, 65, 2, 64, "11", 132),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_plan_visits_each_pair_once(case):
    B, T, S, H, D, bias, sms = case
    shape = None if bias is None else BIAS[bias](B, H, T, S)
    plan = tfa.enc_bwd_plan(B, T, S, H, D, shape, sms=sms)
    steps = tfa.enc_bwd_steps(B, T, S, H, D, plan)
    for launch in ("stats", "dkv", "dq"):
        seen = torch.zeros(B, H, T, S, dtype=torch.int32)
        for blk in steps[launch]:
            for b, h, r0, r1, c0, c1 in blk:
                assert 0 <= r0 < r1 <= T and 0 <= c0 < c1 <= S
                seen[b, h, r0:r1, c0:c1] += 1
        assert bool((seen == 1).all()), launch
    assert len(steps["dkv"]) == plan["blocks"]


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_groups_and_items_in_fixed_order(case):
    """A dk/dv block's items are batch-major and ascending; its items all
    write one dbias plane (its group's, its head's or every head's); the
    groups cut the batch into consecutive runs of `group` items."""
    B, T, S, H, D, bias, sms = case
    shape = None if bias is None else BIAS[bias](B, H, T, S)
    plan = tfa.enc_bwd_plan(B, T, S, H, D, shape, sms=sms)
    steps = tfa.enc_bwd_steps(B, T, S, H, D, plan)
    g = plan["group"]
    assert plan["groups"] == -(-B // g)
    for blk, (z, hh) in zip(steps["dkv"], steps["dbias_plane"]):
        items = list(dict.fromkeys((b, h) for b, h, *_ in blk))
        assert items == sorted(items)
        assert {b for b, _ in items} == set(range(z * g, min(B, (z + 1) * g)))
        heads = {h for _, h in items}
        assert heads == (set(range(H)) if plan["head_sum"] else {hh})
    if plan["partial_bytes"]:
        Hb = shape[1]
        assert plan["partial_bytes"] == plan["groups"] * Hb * T * S * 4
    # a block sums on chip exactly when it has more than one item
    if plan["group"] > 1 or plan["head_sum"]:
        assert plan["tp"] == 0 or (plan["tp"] % 32 == 8
                                   and plan["tp"] >= -(-T // 2) * 2)
    else:
        assert plan["tp"] == 0


def test_beit_b_partial_planes():
    """BEiT-B fine-tuning: 11 groups of 24 batch items, 264 dk/dv blocks
    (two an SM), 20.5 MB of partial planes against the 477 MB of one group
    per batch item, and the [128 keys, 200] fp32 dbias tile on chip."""
    plan = tfa.enc_bwd_plan(256, 197, 197, 12, 64, (1, 12, 197, 197))
    assert (plan["group"], plan["groups"], plan["blocks"]) == (24, 11, 264)
    assert plan["partial_bytes"] <= 32 * 2 ** 20
    assert plan["partial_bytes"] == 11 * 12 * 197 * 197 * 4
    assert round(256 * 12 * 197 * 197 * 4 / 1e6) == 477  # the first design's
    assert plan["tp"] == 200
    assert (tfa._enc_bwd_dkv_smem(64) + 128 * plan["tp"] * 4
            <= tfa._SMEM_MAX)


def test_beit_b_tiles_visited_once():
    """The same at BEiT-B's full size, at tile granularity."""
    B, T, H = 256, 197, 12
    plan = tfa.enc_bwd_plan(B, T, T, H, 64, (1, H, T, T))
    steps = tfa.enc_bwd_steps(B, T, T, H, 64, plan)
    for launch, (rt, kt) in (("stats", (128, 128)), ("dkv", (64, 128)),
                             ("dq", (128, 64))):
        tiles = [(b, h, r0, c0) for blk in steps[launch]
                 for b, h, r0, _, c0, _ in blk]
        assert len(tiles) == len(set(tiles)) == B * H * -(-T // rt) * -(-T // kt)


@pytest.mark.parametrize("T,D,want", [(197, 64, 200), (232, 64, 232),
                                      (233, 64, 0), (197, 128, 200),
                                      (264, 96, 264), (2048, 64, 0)])
def test_dbias_tile_stride(T, D, want):
    """tp: the least stride >= T rounded up to even with tp = 8 mod 32
    (conflict-free float2 accesses), 0 where the tile does not fit."""
    plan = tfa.enc_bwd_plan(256, T, 197, 12, D, (1, 12, T, 197))
    assert plan["group"] > 1
    assert plan["tp"] == want


# --------------------------------------------------------------------------- #
# the schedule, emulated in torch from the plan
# --------------------------------------------------------------------------- #

def enc_bwd_emulate(q, k, v, bias, do, scale, sms):
    """#4's bf16 launches on the plan, in torch (fp32 math; ds and p
    rounded to k's / dO's type): (dq, dk, dv, dbias)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    shape = None if bias is None else tuple(bias.shape)
    plan = tfa.enc_bwd_plan(B, T, S, H, D, shape, sms=sms)
    steps = tfa.enc_bwd_steps(B, T, S, H, D, plan)
    qs = scale * LOG2E
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))

    def s2(b, h, r0, r1, c0, c1):
        s = qf[b, r0:r1, h] @ kf[b, c0:c1, h].T * qs
        if bias is not None:
            s = s + LOG2E * bias[b % bias.shape[0], h % bias.shape[1],
                                 r0:r1, c0:c1].float()
        return s

    # 1. statistics: online over the key tiles
    m = torch.full((B, H, T), -1e30)
    l = torch.zeros(B, H, T)
    u = torch.zeros(B, H, T)
    for blk in steps["stats"]:
        for b, h, r0, r1, c0, c1 in blk:
            s = s2(b, h, r0, r1, c0, c1)
            dp = dof[b, r0:r1, h] @ vf[b, c0:c1, h].T
            mt = torch.maximum(m[b, h, r0:r1], s.amax(-1))
            a = torch.exp2(m[b, h, r0:r1] - mt)
            e = torch.exp2(s - mt[:, None])
            l[b, h, r0:r1] = l[b, h, r0:r1] * a + e.sum(-1)
            u[b, h, r0:r1] = u[b, h, r0:r1] * a + (e * dp).sum(-1)
            m[b, h, r0:r1] = mt
    rl, delta = 1.0 / l, u / l

    # 2. dk, dv, the ds plane and each block's dbias tile over its items
    ds_plane = torch.zeros(B, H, T, S, dtype=k.dtype)
    dk, dv = torch.zeros(B, S, H, D), torch.zeros(B, S, H, D)
    Hb = 1 if bias is None else bias.shape[1]
    part = torch.zeros(plan["groups"], Hb, T, S)
    for blk, (z, hh) in zip(steps["dkv"], steps["dbias_plane"]):
        c0, c1 = blk[0][4:]
        tile = torch.zeros(T, c1 - c0)
        for b, h, r0, r1, _, _ in blk:
            s = s2(b, h, r0, r1, c0, c1)
            dp = dof[b, r0:r1, h] @ vf[b, c0:c1, h].T
            p = torch.exp2(s - m[b, h, r0:r1, None]) * rl[b, h, r0:r1, None]
            ds = p * (dp - delta[b, h, r0:r1, None])
            dsr = ds.to(k.dtype)
            ds_plane[b, h, r0:r1, c0:c1] = dsr
            dv[b, c0:c1, h] += p.to(do.dtype).float().T @ dof[b, r0:r1, h]
            dk[b, c0:c1, h] += dsr.float().T @ qf[b, r0:r1, h]
            tile[r0:r1] += ds
        if bias is not None:  # the block's plane: [group or batch item, head]
            part[z, hh if Hb > 1 else 0, :, c0:c1] = tile
    dk = dk * scale

    # 3. dq over the ds plane, key tiles in order
    dq = torch.zeros(B, T, H, D)
    for blk in steps["dq"]:
        for b, h, r0, r1, c0, c1 in blk:
            dq[b, r0:r1, h] += ds_plane[b, h, r0:r1, c0:c1].float() @ kf[b, c0:c1, h]
    dq = dq * scale

    # 4. the groups' planes in group order
    dbias = part if bias is not None else None
    if plan["partial_bytes"]:
        dbias = part[0].clone()
        for z in range(1, plan["groups"]):
            dbias += part[z]
        dbias = dbias[None]
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias)


# name: (B, T, S, H, D, bias, sms)
EMU_CASES = {
    "no_bias": (2, 24, 24, 2, 64, None, 132),
    "bias_11_groups": (3, 24, 24, 2, 64, "11", 1),
    "bias_1H_groups_of_one": (3, 17, 17, 3, 64, "1H", 132),
    "bias_1H_one_group": (3, 17, 17, 3, 64, "1H", 1),
    "bias_1H_two_groups": (5, 70, 130, 2, 64, "1H", 3),
    "bias_BH": (2, 16, 24, 2, 96, "BH", 132),
    "bias_B1_head_sum": (2, 13, 21, 3, 128, "B1", 132),
    "ragged_1H": (2, 13, 21, 2, 64, "1H", 132),
}


@pytest.mark.parametrize("name", sorted(EMU_CASES))
def test_emulated_schedule_matches_the_tpu_kernel(name):
    B, T, S, H, D, bias, sms = EMU_CASES[name]
    rng = np.random.RandomState(0)
    r = lambda *s: rng.randn(*s).astype(np.float32)
    q, k, v, do = r(B, T, H, D), r(B, S, H, D), r(B, S, H, D), r(B, T, H, D)
    b = None if bias is None else 2 * r(*BIAS[bias](B, H, T, S))
    scale = D ** -0.5
    args = [jnp.asarray(a) for a in (q, k, v)]
    if b is None:
        _, vjp = jax.vjp(lambda q_, k_, v_: jfa.fused_encoder_attention(
            q_, k_, v_, None, scale, True), *args)
    else:
        _, vjp = jax.vjp(lambda q_, k_, v_, b_: jfa.fused_encoder_attention(
            q_, k_, v_, b_, scale, True), *args, jnp.asarray(b))
    want = vjp(jnp.asarray(do))
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = enc_bwd_emulate(t(q), t(k), t(v), t(b), t(do), scale, sms)
    for n, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert g is None, n
            continue
        assert tuple(g.shape) == w.shape, n
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=1e-5, err_msg=n)


# --------------------------------------------------------------------------- #
# on the card: the kernel against its twin at the plan's edges
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
@pytest.mark.parametrize("S", [69, 197, 256, 257, 2048])
@pytest.mark.parametrize("T", [1, 16, 17, 64, 65, 197])
def test_kernel_at_plan_edges(card, T, S):
    """#4 bf16 against fused_encoder_backward_plain at the q tiles' edges
    (64 / 65 rows, 128-row blocks), the key blocks' (S around 128 and 256)
    and S = 2048, with a batch-summed [1, H, T, S] bias in batch groups:
    dq, dk, dv and dbias within relative L2 1e-2 (chip_smoke.py's
    encoder_bwd bound); two runs bit-equal."""
    rn = lambda *s: torch.randn(*s, generator=card, device="cuda").to(
        torch.bfloat16)
    B, H, D = 6, 3, 64 if S % 2 else 96
    q, k, v, do = rn(B, T, H, D), rn(B, S, H, D), rn(B, S, H, D), rn(B, T, H, D)
    bias = 2 * rn(1, H, T, S)
    got = tfa.fused_encoder_backward(q, k, v, bias, do)
    ref = tfa.fused_encoder_backward_plain(q, k, v, bias, do)
    for x, w in zip(got, ref):
        assert _rel(x, w) <= 1e-2
    again = tfa.fused_encoder_backward(q, k, v, bias, do)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
