"""Port parity: unilm_tpu_torch.ops.paged_attention
`run_decode_append_attention` (plain path, CPU) against the JAX Pallas
contiguous-run decode kernel, forced into interpret mode as
tests/test_fused_paged.py does.

H*D = 4*96 is a multiple of 128, as the TPU kernel needs; the lengths are
ragged and include 0 and both sides of a slab boundary (chunk*page = 64).
Pools are compared exactly (the same rows written); outputs within 2e-5
in float32, and within 2e-2 (~2 bf16 ulps at unit scale) in bfloat16,
where the two round the probabilities against different row maxima.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)


def _force_interpret(monkeypatch):
    import unilm_tpu.ops.paged_attention as pa
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pa.pl, "pallas_call", patched)
    return pa


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
def test_run_decode_append_matches_jax(monkeypatch, dtype, atol):
    jpa = _force_interpret(monkeypatch)
    rng = np.random.RandomState(0)
    B, H, D, page, chunk, MPg = 4, 4, 96, 16, 4, 8
    stride = -(-MPg // chunk) * chunk
    P = B * stride + chunk
    HD = H * D
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    q = rng.randn(B, 1, H, D).astype(np.float32)
    kn = rng.randn(B, 1, H, D).astype(np.float32)
    vn = rng.randn(B, 1, H, D).astype(np.float32)
    kp = rng.randn(P, page, HD).astype(np.float32)
    vp = rng.randn(P, page, HD).astype(np.float32)
    bases = np.asarray([b * stride for b in range(B)], np.int32)
    lengths = np.asarray([0, 63, 64, MPg * page - 1], np.int32)

    j = lambda a: jnp.asarray(a).astype(jdt)
    want, wk, wv = jpa.run_decode_append_attention(
        j(q), j(kn), j(vn), j(kp), j(vp), jnp.asarray(bases),
        jnp.asarray(lengths), max_pages=MPg, chunk=chunk)

    t = lambda a: torch.from_numpy(a).to(tdt)
    tkp, tvp = t(kp), t(vp)
    got, gk, gv = tpa.run_decode_append_attention(
        t(q), t(kn), t(vn), tkp, tvp, torch.from_numpy(bases),
        torch.from_numpy(lengths), max_pages=MPg, chunk=chunk)
    assert gk is tkp and gv is tvp  # updated in place
    assert got.shape == (B, 1, H, D) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)
    np.testing.assert_array_equal(gk.float().numpy(),
                                  np.asarray(wk, np.float32))
    np.testing.assert_array_equal(gv.float().numpy(),
                                  np.asarray(wv, np.float32))


def test_quantize_kv_rows_bit_equal():
    from unilm_tpu.ops.paged_attention import quantize_kv_rows as jquant

    rng = np.random.RandomState(3)
    k = (rng.randn(6, 384) * 3).astype(np.float32)
    v = (rng.randn(6, 384) * 0.1).astype(np.float32)
    k[2] = 0.0  # an all-zero row takes the 1e-6 floor
    want = jquant(jnp.asarray(k), jnp.asarray(v))
    got = tpa.quantize_kv_rows(torch.from_numpy(k), torch.from_numpy(v))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].dtype == torch.int8 and got[2].dtype == torch.float32


def test_run_decode_append_int8_matches_jax(monkeypatch):
    """int8 pools with the slab scale sidecar: the plain version against
    the JAX kernel (interpret), float32 q. The new token is merged from
    the unquantized k_new/v_new (a read-back of the int8 row would be off
    by ~1e-2). Out within 2e-5; pools and sidecar bit-equal."""
    jpa = _force_interpret(monkeypatch)
    rng = np.random.RandomState(1)
    B, H, D, page, chunk, MPg = 4, 4, 96, 16, 4, 8
    stride = -(-MPg // chunk) * chunk
    P = B * stride + chunk
    HD, S = H * D, chunk * page
    q = rng.randn(B, 1, H, D).astype(np.float32)
    kn = rng.randn(B, 1, H, D).astype(np.float32)
    vn = rng.randn(B, 1, H, D).astype(np.float32)
    kp = rng.randint(-127, 128, size=(P, page, HD)).astype(np.int8)
    vp = rng.randint(-127, 128, size=(P, page, HD)).astype(np.int8)
    sp = (rng.rand(P // chunk, 8, S) * 0.02 + 1e-3).astype(np.float32)
    bases = np.asarray([b * stride for b in range(B)], np.int32)
    lengths = np.asarray([0, 63, 64, MPg * page - 1], np.int32)

    want, wk, wv, ws = jpa.run_decode_append_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(bases), jnp.asarray(lengths),
        max_pages=MPg, chunk=chunk, scale_pool=jnp.asarray(sp))
    t = torch.from_numpy
    tkp, tvp, tsp = t(kp.copy()), t(vp.copy()), t(sp.copy())
    got, gk, gv, gs = tpa.run_decode_append_attention(
        t(q), t(kn), t(vn), tkp, tvp, t(bases), t(lengths), max_pages=MPg,
        chunk=chunk, scale_pool=tsp)
    assert gk is tkp and gv is tvp and gs is tsp  # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    # the merge really uses k_new/v_new, not the int8 row just written
    assert not np.array_equal(gk.numpy(), kp)


def test_paged_decode_append_matches_jax(monkeypatch):
    """Block tables: the plain version against the JAX append kernel
    (interpret), lengths {0, 17, MP*page - 1}. Out within 2e-5 (the same
    fp32 sums in another order); pools bit-equal."""
    jpa = _force_interpret(monkeypatch)
    rng = np.random.RandomState(2)
    B, H, D, page, P, MP = 3, 4, 64, 16, 20, 6
    HD = H * D
    q = rng.randn(B, 1, H, D).astype(np.float32)
    kn = rng.randn(B, 1, H, D).astype(np.float32)
    vn = rng.randn(B, 1, H, D).astype(np.float32)
    kp = rng.randn(P, page, HD).astype(np.float32)
    vp = rng.randn(P, page, HD).astype(np.float32)
    perm = rng.permutation(P)[: B * MP]
    tables = perm.reshape(B, MP).astype(np.int32)
    lengths = np.asarray([0, 17, MP * page - 1], np.int32)

    want, wk, wv = jpa.paged_decode_append_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(tables), jnp.asarray(lengths))
    t = torch.from_numpy
    tkp, tvp = t(kp.copy()), t(vp.copy())
    got, gk, gv = tpa.paged_decode_append_attention(
        t(q), t(kn), t(vn), tkp, tvp, t(tables), t(lengths))
    assert gk is tkp and gv is tvp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_paged_attention_gather_matches_jax():
    """runtime.paged_kv.paged_attention, plain gather path, and its kernel
    branch, which takes CUDA tensors only: on CPU tensors it raises."""
    from unilm_tpu.runtime.paged_kv import paged_attention as jpaged
    from unilm_tpu_torch.runtime.paged_kv import paged_attention

    rng = np.random.RandomState(4)
    B, H, D, page, P, MP = 3, 2, 16, 8, 12, 4
    q = rng.randn(B, 1, H, D).astype(np.float32)
    kp = rng.randn(P, page, H * D).astype(np.float32)
    vp = rng.randn(P, page, H * D).astype(np.float32)
    tables = rng.permutation(P)[: B * MP].reshape(B, MP).astype(np.int32)
    lengths = np.asarray([1, 19, 32], np.int32)
    want = jpaged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                  jnp.asarray(tables), jnp.asarray(lengths), use_kernel=False)
    t = torch.from_numpy
    got = paged_attention(t(q), t(kp), t(vp), t(tables), t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_attention(t(q), t(kp), t(vp), t(tables), t(lengths),
                        use_kernel=True)
