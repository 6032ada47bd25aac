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
