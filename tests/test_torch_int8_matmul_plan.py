"""The bf16 kernel of #14 (csrc/int8_matmul.cu `hop::int8_mm_sm90`), on
the CPU:
- `int8_matmul_plan`: at the decoder's projection shapes (q/k/v/out
  K1536 N1536, fc1 K1536 N6144, fc2 K6144 N1536) and M 1/8/64/200, every
  (channel, k) pair in exactly one block, the splits of a channel tile
  covering K once, the ring's stages a multiple of the producer warps, and
  enough blocks to fill the card;
- `int8_k_order`: the order in which the products take K is a
  permutation inside each 128-K chunk, and its first k-step is the A
  fragment's columns of each thread's contiguous W bytes;
- the kernel's arithmetic emulated in torch from the plan (fp32 partial
  products over each split's chunks in the kernel's K order, the splits
  merged in split order, the scale once, one cast) against the JAX Pallas
  kernel `_int8_matmul_2d` in interpret mode, at tests/test_torch_quant.py's
  tolerance in float32 (2e-5) and 2e-2 in bfloat16.
Then, marked `cuda` (they skip without a card), the kernel against the
plain version at the plan's edges, bit-equal twice.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.ops import quant as jq
from unilm_tpu_torch.ops import _native
from unilm_tpu_torch.ops import quant as tq

torch.set_num_threads(1)

N_SM = 132  # the H100 SXM's SMs
SHAPES = [(1536, 1536), (1536, 6144), (6144, 1536)]  # (K, N)
MS = [1, 8, 64, 200]


# --------------------------------------------------------------------------- #
# the plan
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("K,N", SHAPES + [(992, 130), (80, 100), (4096, 64)])
@pytest.mark.parametrize("M", MS + [9, 17, 33])
def test_int8_plan_covers_each_channel_and_k_once(K, N, M):
    plan = tq.int8_matmul_plan(M, N, K, N_SM)
    mt, ks, chunks = plan["mt"], plan["ksplit"], plan["chunks"]
    assert mt == (8 if M <= 8 else 16 if M <= 16 else 32 if M <= 32 else 64)
    assert plan["m_tiles"] * mt >= M > (plan["m_tiles"] - 1) * mt
    assert 1 <= ks <= tq.INT8_MAX_SPLIT  # one portable cluster
    assert plan["channel_tile"] == tq.INT8_CHANNELS
    # the splits: whole chunks, equal but the last, none empty, K once
    seen = np.zeros(K, np.int32)
    for s, (k0, k1) in enumerate(plan["k_ranges"]):
        assert k0 == s * chunks * tq.INT8_CHUNK and k0 < k1 <= K
        seen[k0:k1] += 1
    assert bool((seen == 1).all())
    # every (channel, k) pair in exactly one block: channel tiles x splits
    tiles = -(-N // tq.INT8_CHANNELS)
    cover = np.zeros((tiles * tq.INT8_CHANNELS, K), np.int32)
    for tile in range(tiles):
        for k0, k1 in plan["k_ranges"]:
            c0 = tile * tq.INT8_CHANNELS
            cover[c0:c0 + tq.INT8_CHANNELS, k0:k1] += 1
    assert bool((cover[:N] == 1).all())
    assert plan["blocks"] == tiles * ks * plan["m_tiles"]
    # the ring: a multiple of the producer warps, a chunk a stage, within
    # its bytes unless only INT8_PRODUCERS stages fit, never more than a
    # split's chunks rounded up
    st = plan["stages"]
    stage = tq.INT8_CHANNELS * tq.INT8_CHUNK + mt * 2 * tq.INT8_CHUNK
    assert st % tq.INT8_PRODUCERS == 0 and st >= tq.INT8_PRODUCERS
    assert st * stage <= max(tq.INT8_RING, tq.INT8_PRODUCERS * stage)
    assert st <= max(tq.INT8_PRODUCERS,
                     -(-chunks // tq.INT8_PRODUCERS) * tq.INT8_PRODUCERS)


@pytest.mark.parametrize("K,N", SHAPES)
@pytest.mark.parametrize("M", MS)
def test_int8_plan_fills_the_card(K, N, M):
    """The projections' blocks number at least one an SM and at most
    three (about two: 2 n_sm over the channel tiles and M tiles, rounded to
    whole chunks a split), so the whole weight is requested at once."""
    plan = tq.int8_matmul_plan(M, N, K, N_SM)
    assert N_SM <= plan["blocks"] <= 3 * N_SM


@pytest.mark.parametrize("K", [128, 1536, 200, 992, 6144])
def test_int8_k_order_is_a_chunk_local_permutation(K):
    order = tq.int8_k_order(K).numpy()
    assert sorted(order.tolist()) == list(range(K))
    c = tq.INT8_CHUNK
    for j, k in enumerate(order[: (K // c) * c]):
        assert k // c == j // c  # stays in its chunk
    # k-step 0: thread t of a quad holds columns 2t, 2t+1 (a[0]) and
    # 2t+8, 2t+9 (a[2]) as its W bytes w t .. w t + 3 (w = c / 4)
    if K >= c:
        w = c // 4
        for t in range(4):
            assert order[[2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]].tolist() \
                == [w * t, w * t + 1, w * t + 2, w * t + 3]


def test_int8_plan_mirror_on_a_device(monkeypatch):
    """The wrapper's (mt, ksplit, stages) are the plan's for the device's
    SM count."""
    dev = torch.device("cuda", 0)
    monkeypatch.setitem(_native._SM_COUNT, dev, N_SM)
    monkeypatch.setattr(tq, "_PLANS", {})
    for K, N in SHAPES:
        for M in MS:
            plan = tq.int8_matmul_plan(M, N, K, N_SM)
            assert tq._plan(M, N, K, dev) == (plan["mt"], plan["ksplit"],
                                             plan["stages"])


# --------------------------------------------------------------------------- #
# the kernel's arithmetic, emulated, against the JAX kernel
# --------------------------------------------------------------------------- #

def emulate(x, w_i8, scale, plan):
    """csrc/int8_matmul.cu's bf16 path in fp32: per split, the chunks'
    products summed in chunk order with K in the kernel's order; the
    splits summed in split order; the scale once; one cast to x's type."""
    K = x.shape[1]
    order = tq.int8_k_order(K)
    xf, wf = x.float()[:, order], w_i8.float()[:, order]
    total = None
    for k0, k1 in plan["k_ranges"]:
        part = None
        for c0 in range(k0, k1, tq.INT8_CHUNK):
            c1 = min(k1, c0 + tq.INT8_CHUNK)
            prod = xf[:, c0:c1] @ wf[:, c0:c1].t()
            part = prod if part is None else part + prod
        total = part if total is None else total + part
    return (total * scale.float()).to(x.dtype)


@pytest.mark.parametrize("K,N", SHAPES)
@pytest.mark.parametrize("M", [1, 8])
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
def test_int8_emulation_matches_jax(K, N, M, dtype, atol):
    rng = np.random.RandomState(K + N + M)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) * 0.05).astype(np.float32)
    wi, sc = jq.quantize_int8(jnp.asarray(w), axis=0)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    Mp = max(8, -(-M // 8) * 8)  # int8_matmul's own row padding
    want = np.asarray(jq._int8_matmul_2d(
        jnp.pad(jx, ((0, Mp - M), (0, 0))), wi, sc, interpret=True),
        np.float32)[:M]
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tw = torch.from_numpy(np.asarray(wi).T.copy())
    ts = torch.from_numpy(np.array(sc))
    got = emulate(tx, tw, ts, tq.int8_matmul_plan(M, N, K, N_SM))
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)
    # and the plain version, which the card's kernel is held to
    plain = tq.int8_matmul_plain(tx, tw, ts)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               atol=atol, rtol=0)


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
@pytest.mark.parametrize("K,N", SHAPES + [(992, 130), (80, 100),
                                          (4096, 64), (1000, 96)])
def test_int8_kernel_at_plan_edges(card, K, N):
    """bf16 x: within 2 bf16 ulps of the plain result plus the fp32 order
    term K 2^-24 (|x| @ |W|) scale (chip_smoke.py's phase_int8_matmul),
    at M on both sides of each tile height, two runs bit-equal (the
    cluster merge sums in split order)."""
    w = torch.randint(-127, 128, (N, K), generator=card, device="cuda",
                      dtype=torch.int8)
    scale = (torch.rand(N, generator=card, device="cuda") + 0.5) * (
        2.0 / (127 * K ** 0.5))
    for M in (1, 8, 9, 16, 17, 33, 64, 65, 200):
        x = torch.randn(M, K, generator=card, device="cuda").to(
            torch.bfloat16)
        out = tq.int8_matmul(x, w, scale)
        ref = tq.int8_matmul_plain(x, w, scale)
        _, e = torch.frexp(ref.float())
        tol = (2 * torch.ldexp(torch.ones_like(ref, dtype=torch.float32),
                               e - 8)
               + K * 2.0 ** -24 * (x.float().abs() @ w.float().abs().t())
               * scale)
        assert bool(((out.float() - ref.float()).abs() <= tol).all()), M
        assert torch.equal(out, tq.int8_matmul(x, w, scale)), M
