"""The split walk of kernel #13 (csrc/decode_attention.cu
`decode_run_split_sm90`), on the CPU:
- `decode_split_plan`: every token of a sequence in exactly one split and
  one tile, the tiles dealt to the token groups in turn, splits with no
  tokens where L is short, and enough blocks to fill the card at the
  slice's B * H = 16 and the serving step's B * H = 128;
- the walk's arithmetic emulated in torch from the plan (per-tile online
  softmax in each token group, the groups merged per block, the splits
  merged in order, the new token's term added once for int8 pools, the
  rounding contract of csrc/decode_common.cuh) against the JAX Pallas
  kernel `_run_decode_kernel` in interpret mode, at lengths 0, 1, a split
  boundary +- 1 and 2052, at tests/test_torch_paged_attention.py's
  tolerances (2e-5 in float32, 2e-2 in bfloat16).
Then, marked `cuda` (they skip without a card), both launchers against
their plain versions at the plan's edges.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)

N_SM = 132  # the H100 SXM's SMs
H, D, PAGE, CHUNK, PP = 16, 96, 64, 8, 40  # the slice's cache geometry


def _force_interpret(monkeypatch):
    import unilm_tpu.ops.paged_attention as pa
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pa.pl, "pallas_call", patched)
    return pa


# --------------------------------------------------------------------------- #
# the plan
# --------------------------------------------------------------------------- #

PLAN_CASES = [(1, 16, 96, 2), (8, 16, 96, 1), (8, 16, 96, 2), (1, 16, 128, 2),
              (8, 16, 128, 2), (1, 4, 64, 1), (3, 5, 64, 2), (2, 12, 64, 2),
              (64, 32, 128, 2),
              # TrOCR-Small's beam step (B = 32 x 5, 8 heads of 32), bf16
              # and int8, and the distill student's 12 heads of 32
              (160, 8, 32, 2), (160, 8, 32, 1), (5, 8, 32, 2), (1, 12, 32, 1)]
PLAN_LENGTHS = (0, 1, 31, 32, 33, 127, 128, 129, 1055, 1056, 1057, 2053)


@pytest.mark.parametrize("B,Hn,D,itemsize", PLAN_CASES)
@pytest.mark.parametrize("n", PLAN_LENGTHS)
def test_decode_split_plan_covers_each_token_once(B, Hn, D, itemsize, n):
    plan = tpa.decode_split_plan(B, Hn, n, N_SM, D, itemsize)
    nsplit, ngrp, nst = (plan[k] for k in ("nsplit", "ngrp", "nst"))
    assert 1 <= nsplit <= (6 if itemsize == 1 else 8)  # one portable cluster
    assert 1 <= ngrp <= tpa.SPLIT_WARPS and nst % ngrp == 0
    stage = 2 * tpa.SPLIT_TILE * D * itemsize
    assert nst * stage <= max(tpa.SPLIT_RING, ngrp * stage)
    assert len(plan["ranges"]) == nsplit == len(plan["tiles"])
    seen = np.zeros(n, np.int32)
    for (t0, t1), tiles in zip(plan["ranges"], plan["tiles"]):
        assert 0 <= t0 <= t1 <= n
        seen[t0:t1] += 1
        # the range's tiles in order, SPLIT_TILE tokens but the last, dealt
        # to the token groups in turn
        assert [a for _, a, _ in tiles] == list(range(t0, t1, tpa.SPLIT_TILE))
        assert all(b - a == min(tpa.SPLIT_TILE, t1 - a) for _, a, b in tiles)
        assert [grp for grp, _, _ in tiles] == [i % ngrp
                                              for i in range(len(tiles))]
    assert bool((seen == 1).all())
    # ranges of whole tiles, equal but the last (and empty ones past n)
    sizes = [t1 - t0 for t0, t1 in plan["ranges"] if t1 > t0]
    assert all(x % tpa.SPLIT_TILE == 0 and x == sizes[0] for x in sizes[:-1])
    assert sizes == sorted(sizes, reverse=True)


@pytest.mark.parametrize("B,itemsize,blocks,ngrp", [(1, 2, 128, 8),
                                                    (8, 1, 128, 15),
                                                    (8, 2, 256, 8)])
def test_decode_split_plan_fills_the_card(B, itemsize, blocks, ngrp):
    """B * H = 16 (the slice, bf16) and 128 (the serving step, int8; and
    bf16): a block for all but at most 1/16 of the 132 SMs, two an SM for
    bf16 pools, one for int8 (its tensor-core consumers' registers), each
    with a 96 KB ring; the slice's eight splits of 288 tokens take their
    nine tiles on eight token groups, the serving step's one split of
    2047 int8 tokens its 64 tiles on fifteen."""
    plan = tpa.decode_split_plan(B, H, 2048, N_SM, D, itemsize)
    got = B * H * plan["nsplit"]
    assert got == blocks and N_SM - N_SM // 16 <= got <= 2 * N_SM
    assert plan["ngrp"] == ngrp
    assert plan["nst"] * 2 * tpa.SPLIT_TILE * D * itemsize <= tpa.SPLIT_RING


def test_decode_split_plan_empty_splits():
    """Shorter than a tile per split: the first split takes every token,
    the rest none (the kernel gives them m = -1e30, l = 0); L = 0 has no
    tile at all."""
    plan = tpa.decode_split_plan(1, 16, 5, N_SM)
    assert plan["ranges"] == [(0, 5)] + [(5, 5)] * (plan["nsplit"] - 1)
    assert plan["tiles"][0] == [(0, 0, 5)]
    assert all(tiles == [] for tiles in plan["tiles"][1:])
    assert all(tiles == [] for tiles in tpa.decode_split_plan(
        8, 16, 0, N_SM)["tiles"])


# --------------------------------------------------------------------------- #
# the walk, emulated, against the JAX kernel
# --------------------------------------------------------------------------- #

def split_walk(qs, kf, vf, base, L, plan, *, pool_dtype, q_dtype,
               max_tokens, kscale=None, vscale=None, k_new=None,
               v_new=None):
    """csrc/decode_attention.cu's arithmetic for one sequence, in fp32:
    qs [H, D] (pre-scaled, in q's dtype) over the run from page `base` of
    the flat pools kf/vf [rows, H, D]. RUN (bf16/fp32 pools): tokens
    0..L, token L's p unrounded, the others' rounded to the pool dtype.
    RUN_I8 (kscale given): tokens 0..L-1, scores times kscale, p times
    vscale rounded to q's dtype; the new token merged from k_new/v_new in
    the final merge, once."""
    quant = kscale is not None
    n = min(L + (0 if quant else 1), max_tokens)
    r0 = base * PAGE
    qf = qs.float()
    ngrp = plan["ngrp"]
    parts = []
    for (t0, t1), tiles in zip(plan["ranges"], plan["tiles"]):
        m = torch.full((ngrp, qf.shape[0]), -1e30)
        l = torch.zeros(ngrp, qf.shape[0])
        acc = torch.zeros(ngrp, *qf.shape)
        for grp, a, b in tiles:
            assert t0 <= a < b <= min(t1, n)
            k = kf[r0 + a:r0 + b].float()  # [cnt, H, D]
            v = vf[r0 + a:r0 + b].float()
            s = torch.einsum("hd,thd->ht", qf, k)
            if quant:
                s = s * kscale[r0 + a:r0 + b]
            m_new = torch.maximum(m[grp], s.amax(-1))
            p = torch.exp(s - m_new[:, None])
            alpha = torch.exp(m[grp] - m_new)
            l[grp] = l[grp] * alpha + p.sum(-1)
            m[grp] = m_new
            if quant:
                pr = (p * vscale[r0 + a:r0 + b]).to(q_dtype).float()
            else:
                pr = p.to(pool_dtype).float()
                last = torch.arange(a, b) == L
                pr[:, last] = p[:, last]
            acc[grp] = acc[grp] * alpha[:, None] + torch.einsum(
                "ht,thd->hd", pr, v)
        M = m.amax(0)
        e = torch.exp(m - M)
        parts.append((M, (l * e).sum(0), (acc * e[..., None]).sum(0)))
    M = torch.stack([p[0] for p in parts]).amax(0)
    if quant:
        s_new = (qf * k_new.float()).sum(-1)
        M = torch.maximum(M, s_new)
    l = sum(pl_ * torch.exp(pm - M) for pm, pl_, _ in parts)
    o = sum(pa_ * torch.exp(pm - M)[:, None] for pm, _, pa_ in parts)
    if quant:
        a_new = torch.exp(s_new - M)
        l = l + a_new
        o = o + a_new[:, None] * v_new.float()
    return (o / torch.where(l > 0, l, 1.0)[:, None]).to(q_dtype)


def _edges(nsplit):
    """n at the split walk's edges: 0, 1, and every split one tile +- 1
    (one token short: the last split one short; one over: every split two
    tiles, the last holding one token)."""
    t = tpa.SPLIT_TILE
    return [0, 1, nsplit * t - 1, nsplit * t, nsplit * t + 1]


def _jax_run(jpa, q, kn, vn, kp, vp, L, dtype, sp=None):
    jdt = getattr(jnp, dtype) if isinstance(dtype, str) else None
    cast = (lambda a: jnp.asarray(a).astype(jdt)) if jdt else jnp.asarray
    out = jpa.run_decode_append_attention(
        cast(q), cast(kn), cast(vn), jnp.asarray(kp), jnp.asarray(vp),
        jnp.zeros((1,), jnp.int32), jnp.asarray([L], jnp.int32),
        max_pages=PP, chunk=CHUNK,
        **({} if sp is None else {"scale_pool": jnp.asarray(sp)}))
    return out


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
def test_split_walk_matches_jax(monkeypatch, dtype, atol):
    """bf16/fp32 pools at the slice's plan (B = 1: 8 splits of one head):
    L = 0, 1, the split boundary (n = L + 1 = 8 tiles) +- 1 and the
    slice's 2052."""
    jpa = _force_interpret(monkeypatch)
    plan1 = tpa.decode_split_plan(1, H, 0, N_SM)
    assert plan1["nsplit"] == 8
    rng = np.random.RandomState(0)
    tdt = getattr(torch, dtype)
    P = PP + CHUNK
    kp = rng.randn(P, PAGE, H * D).astype(np.float32)
    vp = rng.randn(P, PAGE, H * D).astype(np.float32)
    for L in [n - 1 for n in _edges(8) if n >= 1] + [1, 2052]:
        q = rng.randn(1, 1, H, D).astype(np.float32)
        kn = rng.randn(1, 1, H, D).astype(np.float32)
        vn = rng.randn(1, 1, H, D).astype(np.float32)
        want = np.asarray(_jax_run(jpa, q, kn, vn,
                                   jnp.asarray(kp).astype(getattr(jnp, dtype)),
                                   jnp.asarray(vp).astype(getattr(jnp, dtype)),
                                   L, dtype)[0], np.float32)
        # the wrapper's own steps: the row appended, q scaled in its dtype
        t = lambda a: torch.from_numpy(a).to(tdt)
        tkp, tvp = t(kp), t(vp)
        tpa._append_rows(t(kn), t(vn), tkp, tvp, torch.zeros(1, dtype=torch.int32),
                         torch.tensor([L], dtype=torch.int32))
        qs = (t(q)[0, 0] * D ** -0.5)
        got = split_walk(qs, tkp.reshape(-1, H, D), tvp.reshape(-1, H, D), 0,
                         L, tpa.decode_split_plan(1, H, L + 1, N_SM),
                         pool_dtype=tdt, q_dtype=tdt,
                         max_tokens=PP * PAGE)
        np.testing.assert_allclose(got.float().numpy(), want[0, 0],
                                   atol=atol, rtol=0, err_msg=f"L={L}")


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
def test_split_walk_int8_matches_jax(monkeypatch, dtype, atol):
    """int8 pools with the slab scale sidecar at the serving step's plan
    (B = 8: one split, 15 token groups): L = 0 (only the new token, merged
    once), 1, a tile +- 1, every group's first tile +- 1 (n = 15 tiles)
    and 2047. An eight-way split of the same lengths (the plan at B = 1)
    is held to JAX too."""
    jpa = _force_interpret(monkeypatch)
    plan8 = tpa.decode_split_plan(8, H, 0, N_SM, D, 1)
    assert plan8["nsplit"] == 1 and plan8["ngrp"] == 15
    rng = np.random.RandomState(1)
    tdt = getattr(torch, dtype)
    P, S = PP + CHUNK, CHUNK * PAGE
    kp = rng.randint(-127, 128, size=(P, PAGE, H * D)).astype(np.int8)
    vp = rng.randint(-127, 128, size=(P, PAGE, H * D)).astype(np.int8)
    for L in _edges(1) + [479, 480, 481, 2047]:
        sp = (rng.rand(P // CHUNK, 8, S) * 0.02 + 1e-3).astype(np.float32)
        q = rng.randn(1, 1, H, D).astype(np.float32)
        kn = rng.randn(1, 1, H, D).astype(np.float32)
        vn = rng.randn(1, 1, H, D).astype(np.float32)
        want = np.asarray(_jax_run(jpa, q, kn, vn, kp, vp, L, dtype, sp)[0],
                          np.float32)
        t = lambda a: torch.from_numpy(a).to(tdt)
        tkp, tvp, tsp = (torch.from_numpy(a.copy()) for a in (kp, vp, sp))
        tpa._append_rows(t(kn), t(vn), tkp, tvp,
                         torch.zeros(1, dtype=torch.int32),
                         torch.tensor([L], dtype=torch.int32), tsp, CHUNK)
        qs = (t(q)[0, 0] * D ** -0.5)
        rows = P * PAGE
        for B in (8, 1):
            got = split_walk(
                qs, tkp.reshape(rows, H, D), tvp.reshape(rows, H, D), 0, L,
                tpa.decode_split_plan(B, H, L, N_SM, D, 1),
                pool_dtype=torch.int8, q_dtype=tdt, max_tokens=PP * PAGE,
                kscale=tsp[:, 0].reshape(rows), vscale=tsp[:, 1].reshape(rows),
                k_new=t(kn)[0, 0], v_new=t(vn)[0, 0])
            np.testing.assert_allclose(got.float().numpy(), want[0, 0],
                                       atol=atol, rtol=0,
                                       err_msg=f"L={L}, plan of B={B}")


# --------------------------------------------------------------------------- #
# on the card: both launchers against their plain versions at the edges
# --------------------------------------------------------------------------- #

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels build with nvcc "
                    "at first use); chip_smoke.py runs them on the H100")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
def test_decode_kernel_at_split_edges(card, B):
    """bf16 pools: the split walk against run_decode_append_attention_plain
    at the edges of the plan for B sequences, within chip_smoke.py's
    OUT_ATOL / OUT_RTOL (2e-2 each); the written rows bit-equal."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    ns = tpa.decode_split_plan(B, H, 0, n_sm, D, 2)["nsplit"]
    rn = lambda *s: torch.randn(*s, generator=card, device="cuda").to(
        torch.bfloat16)
    for n in [n for n in _edges(ns) if n >= 1] + [2053]:
        lengths = torch.full((B,), n - 1, dtype=torch.int32, device="cuda")
        bases = torch.arange(B, dtype=torch.int32, device="cuda") * PP
        kp, vp = rn(B * PP, PAGE, H * D), rn(B * PP, PAGE, H * D)
        q, kn, vn = rn(B, 1, H, D), rn(B, 1, H, D), rn(B, 1, H, D)
        kp2, vp2 = kp.clone(), vp.clone()
        out = tpa.run_decode_append_attention(q, kn, vn, kp, vp, bases,
                                              lengths, PP, None, CHUNK)[0]
        ref = tpa.run_decode_append_attention_plain(
            q, kn, vn, kp2, vp2, bases, lengths, PP, None, CHUNK)[0]
        err = (out.float() - ref.float()).abs()
        assert bool((err <= 2e-2 + 2e-2 * ref.float().abs()).all()), n
        assert torch.equal(kp, kp2) and torch.equal(vp, vp2)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
def test_decode_int8_kernel_at_split_edges(card, B):
    """int8 pools: the split walk against the plain version at the plan's
    edges, L = 0 included (the new token alone)."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    ns = tpa.decode_split_plan(B, H, 0, n_sm, D, 1)["nsplit"]
    P = B * PP + CHUNK
    for n in _edges(ns) + [2047]:
        kp = torch.randint(-127, 128, (P, PAGE, H * D), generator=card,
                           device="cuda", dtype=torch.int8)
        vp = torch.randint(-127, 128, (P, PAGE, H * D), generator=card,
                           device="cuda", dtype=torch.int8)
        sp = torch.rand(P // CHUNK, 8, CHUNK * PAGE, generator=card,
                        device="cuda") * 0.02 + 1e-3
        rn = lambda *s: torch.randn(*s, generator=card, device="cuda").to(
            torch.bfloat16)
        q, kn, vn = rn(B, 1, H, D), rn(B, 1, H, D), rn(B, 1, H, D)
        lengths = torch.full((B,), n, dtype=torch.int32, device="cuda")
        bases = torch.arange(B, dtype=torch.int32, device="cuda") * PP
        args = (lengths, PP, None, CHUNK)
        out = tpa.run_decode_append_attention(
            q, kn, vn, kp.clone(), vp.clone(), bases, *args,
            scale_pool=sp.clone())[0]
        ref = tpa.run_decode_append_attention_plain(
            q, kn, vn, kp, vp, bases, *args, scale_pool=sp)[0]
        err = (out.float() - ref.float()).abs()
        assert bool((err <= 2e-2 + 2e-2 * ref.float().abs()).all()), n


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2), ("int8", 2e-2)])
def test_split_walk_at_head_dim_32_matches_jax(monkeypatch, dtype, atol):
    """TrOCR-Small's decode (8 heads of 32) on the split walk's plan at its
    beam step (B = 160) and at B = 1: bf16 / fp32 pools (RUN) and int8
    pools under bf16 q (RUN_I8), each against JAX's kernel in interpret
    mode at the tolerances above, L at the plan's edges and a short
    cache's 33."""
    jpa = _force_interpret(monkeypatch)
    Hn, Dn = 8, 32
    quant = dtype == "int8"
    qdt = "bfloat16" if quant else dtype
    tdt = getattr(torch, qdt)
    itemsize = 1 if quant else 2
    rng = np.random.RandomState(3)
    P, S = PP + CHUNK, CHUNK * PAGE
    if quant:
        kp = rng.randint(-127, 128, size=(P, PAGE, Hn * Dn)).astype(np.int8)
        vp = rng.randint(-127, 128, size=(P, PAGE, Hn * Dn)).astype(np.int8)
    else:
        kp = rng.randn(P, PAGE, Hn * Dn).astype(np.float32)
        vp = rng.randn(P, PAGE, Hn * Dn).astype(np.float32)
    ns = tpa.decode_split_plan(1, Hn, 0, N_SM, Dn, itemsize)["nsplit"]
    for L in [n for n in _edges(ns) if n >= 1] + [33]:
        q = rng.randn(1, 1, Hn, Dn).astype(np.float32)
        kn = rng.randn(1, 1, Hn, Dn).astype(np.float32)
        vn = rng.randn(1, 1, Hn, Dn).astype(np.float32)
        sp = ((rng.rand(P // CHUNK, 8, S) * 0.02 + 1e-3).astype(np.float32)
              if quant else None)
        jk, jv = ((kp, vp) if quant else
                  (jnp.asarray(kp).astype(getattr(jnp, qdt)),
                   jnp.asarray(vp).astype(getattr(jnp, qdt))))
        want = np.asarray(_jax_run(jpa, q, kn, vn, jk, jv, L, qdt, sp)[0],
                          np.float32)
        t = lambda a: torch.from_numpy(a).to(tdt)
        if quant:
            tkp, tvp, tsp = (torch.from_numpy(a.copy()) for a in (kp, vp, sp))
            tpa._append_rows(t(kn), t(vn), tkp, tvp,
                             torch.zeros(1, dtype=torch.int32),
                             torch.tensor([L], dtype=torch.int32), tsp, CHUNK)
        else:
            tkp, tvp, tsp = t(kp), t(vp), None
            tpa._append_rows(t(kn), t(vn), tkp, tvp,
                             torch.zeros(1, dtype=torch.int32),
                             torch.tensor([L], dtype=torch.int32))
        qs = t(q)[0, 0] * Dn ** -0.5
        rows = P * PAGE
        extra = {} if not quant else dict(
            kscale=tsp[:, 0].reshape(rows), vscale=tsp[:, 1].reshape(rows),
            k_new=t(kn)[0, 0], v_new=t(vn)[0, 0])
        for B in (160, 1):
            plan = tpa.decode_split_plan(B, Hn, L if quant else L + 1, N_SM,
                                         Dn, itemsize)
            got = split_walk(qs, tkp.reshape(rows, Hn, Dn),
                             tvp.reshape(rows, Hn, Dn), 0, L, plan,
                             pool_dtype=torch.int8 if quant else tdt,
                             q_dtype=tdt, max_tokens=PP * PAGE, **extra)
            np.testing.assert_allclose(got.float().numpy(), want[0, 0],
                                       atol=atol, rtol=0,
                                       err_msg=f"L={L}, plan of B={B}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_decode_kernel_at_head_dim_32(card, dtype):
    """#13 at TrOCR-Small's beam step (B160, 8 heads of 32, page 16, chunk
    2, four pages a run), bf16 / fp32 / int8 pools, lengths at the page,
    slab and run edges: within chip_smoke.py's OUT_ATOL / OUT_RTOL (2e-2
    each), the pools (and the int8 sidecar) bit-equal."""
    Bc, Hn, Dn, page, chunk, pp = 160, 8, 32, 16, 2, 4
    quant = dtype == "int8"
    qdt = torch.bfloat16 if quant else getattr(torch, dtype)
    rn = lambda *s: torch.randn(*s, generator=card, device="cuda").to(qdt)
    if quant:
        ri = lambda: torch.randint(-127, 128, (Bc * pp, page, Hn * Dn),
                                   generator=card, device="cuda",
                                   dtype=torch.int8)
        kp, vp = ri(), ri()
        sp = torch.rand(Bc * pp // chunk, 8, chunk * page, generator=card,
                        device="cuda") * 0.02 + 1e-3
    else:
        kp, vp, sp = rn(Bc * pp, page, Hn * Dn), rn(Bc * pp, page, Hn * Dn), \
            None
    lens = ([1, 15, 16, 17, 31, 32, 33, 34] * 20)[:Bc]
    bases = torch.arange(Bc, dtype=torch.int32, device="cuda") * pp
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q, kn, vn = rn(Bc, 1, Hn, Dn), rn(Bc, 1, Hn, Dn), rn(Bc, 1, Hn, Dn)
    kp2, vp2 = kp.clone(), vp.clone()
    sp2 = None if sp is None else sp.clone()
    out = tpa.run_decode_append_attention(q, kn, vn, kp, vp, bases, lengths,
                                          pp, None, chunk, scale_pool=sp)[0]
    ref = tpa.run_decode_append_attention_plain(
        q, kn, vn, kp2, vp2, bases, lengths, pp, None, chunk,
        scale_pool=sp2)[0]
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
    assert sp is None or torch.equal(sp, sp2)
