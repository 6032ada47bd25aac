"""Port parity: unilm_tpu_torch.ops.fused (`swiglu`, `rotary_apply`),
unilm_tpu_torch.ops.paged_attention `paged_decode_attention` and
unilm_tpu_torch.runtime.paged_kv (`PagePool`, `paged_attention`) against
the JAX package, its Pallas kernels run in interpret mode.

Inputs come from seeded numpy and go to both packages. Tolerances:
- swiglu / rotary, float32: 1e-5 absolute (the JAX side may fuse a
  multiply-add, the port rounds each product and sum; the JAX test of
  these kernels uses the same bound); bfloat16: one bf16 ulp (rtol 2^-7),
  as fp32 results a few ulps apart may round to neighbouring bf16 values.
  The port's rotary equals the port's models/yoco.apply_rotary exactly.
- paged decode attention, float32: 2e-5 (the TPU kernel's online softmax
  per page against one softmax over the row); bfloat16: 2e-2 absolute
  (~2 bf16 ulps at unit scale), as the two round the probabilities to bf16
  against different row maxima. A length-0 row is exactly 0 in both.
- PagePool: block tables, lengths, pages in use and both pools equal.

CUDA tests (marked `cuda`) hold the kernels in csrc/paged_attention.cu and
csrc/fused.cu against these plain versions on the card and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu_torch.models import yoco as tyoco
from unilm_tpu_torch.ops import fused as tfused
from unilm_tpu_torch.ops import paged_attention as tpa
from unilm_tpu_torch.runtime import paged_kv as tkv

torch.set_num_threads(1)

BF16_ULP = 2.0 ** -7


def _jnp(x: np.ndarray, dtype: str):
    return jnp.asarray(x).astype(dtype)


def _torch(x: np.ndarray, dtype: str):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _tol(dtype: str):
    return dict(atol=1e-5, rtol=0) if dtype == "float32" else \
        dict(atol=1e-6, rtol=BF16_ULP)


# --------------------------------------------------------------------------- #
# swiglu (#15) and rotary (#16)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype,u_dtype", [("float32", "float32"),
                                           ("bfloat16", "bfloat16"),
                                           ("bfloat16", "float32")])
@pytest.mark.parametrize("shape", [(3, 50, 128), (1037, 72)])
def test_swiglu_matches_jax(shape, dtype, u_dtype):
    """(3, 50, 128) is the JAX test's shape; 1037 rows is past one block of
    the TPU kernel (1024) and not a multiple of it."""
    from unilm_tpu.ops.fused import swiglu as jswiglu

    rng = np.random.RandomState(0)
    g = (rng.randn(*shape) * 3).astype(np.float32)
    u = rng.randn(*shape).astype(np.float32)
    want = jswiglu(_jnp(g, dtype), _jnp(u, u_dtype), interpret=True)
    got = tfused.swiglu(_torch(g, dtype), _torch(u, u_dtype))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    np.testing.assert_array_equal(
        _np(got), _np(tfused.swiglu_plain(_torch(g, dtype),
                                          _torch(u, u_dtype))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [4, 1])
def test_rotary_matches_jax_and_yoco(H, dtype):
    from unilm_tpu.ops.fused import rotary_apply as jrotary

    B, T, D = 2, 24, 32
    x = np.random.RandomState(1).randn(B, T, H, D).astype(np.float32)
    sin, cos = tyoco.rotary_sin_cos(torch.arange(T), D)
    want = jrotary(_jnp(x, dtype), jnp.asarray(sin.numpy()),
                   jnp.asarray(cos.numpy()), interpret=True)
    xt = _torch(x, dtype)
    got = tfused.rotary_apply(xt, sin, cos)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    assert torch.equal(got, tyoco.apply_rotary(xt, sin, cos))


# --------------------------------------------------------------------------- #
# PagePool
# --------------------------------------------------------------------------- #

CFG = dict(num_pages=12, page_size=4, num_heads=2, head_dim=8,
           max_pages_per_seq=6)
# (op, seq, tokens): appends interleave so that tables scatter; the free
# returns pages that the next sequence takes
SCRIPT = [("create", "a", 0), ("create", "b", 0), ("append", "a", 5),
          ("append", "b", 3), ("create", "c", 0), ("append", "a", 4),
          ("append", "c", 9), ("append", "b", 2), ("free", "a", 0),
          ("create", "d", 0), ("append", "d", 7), ("append", "c", 1),
          ("append", "b", 1)]


def _pools(dtype="float32"):
    from unilm_tpu.runtime.paged_kv import PagePool as JPagePool
    from unilm_tpu.runtime.paged_kv import PagedKVConfig as JCfg

    jp = JPagePool(JCfg(**CFG, dtype=getattr(jnp, dtype)))
    tp = tkv.PagePool(tkv.PagedKVConfig(**CFG, dtype=getattr(torch, dtype)),
                      device="cpu")
    return jp, tp


def _replay(jp, tp, script, rng):
    H, D = CFG["num_heads"], CFG["head_dim"]
    for op, sid, n in script:
        if op == "append":
            k = rng.randn(n, H, D).astype(np.float32)
            v = rng.randn(n, H, D).astype(np.float32)
            jp.append(sid, jnp.asarray(k), jnp.asarray(v))
            tp.append(sid, torch.from_numpy(k), torch.from_numpy(v))
        else:
            getattr(jp, op)(sid)
            getattr(tp, op)(sid)


def test_page_pool_matches_jax():
    jp, tp = _pools()
    _replay(jp, tp, SCRIPT, np.random.RandomState(2))
    assert tp.k_pool.shape == (12, 4, 2, 8) and tp.k_pool.dtype == torch.float32
    assert tp.pages_in_use == jp.pages_in_use == 7
    for sid in "bcd":
        assert tp.length(sid) == jp.length(sid)
        np.testing.assert_array_equal(tp.block_table(sid),
                                      jp.block_table(sid))
    # d took the pages a gave back
    assert list(tp.block_table("d")[:2]) == [0, 1]  # a held 0, 1, 3
    np.testing.assert_array_equal(tp.k_pool.numpy(), np.asarray(jp.k_pool))
    np.testing.assert_array_equal(tp.v_pool.numpy(), np.asarray(jp.v_pool))


def test_page_pool_exhaustion_and_budget_match_jax():
    """MemoryError when the free list runs dry, AssertionError past
    max_pages_per_seq, at the same call in both, leaving the same state."""
    jp, tp = _pools()
    _replay(jp, tp, [("create", "x", 0), ("create", "y", 0),
                     ("append", "x", 24)], np.random.RandomState(3))
    for pool in (jp, tp):
        with pytest.raises(AssertionError, match="sequence too long"):
            _replay_one(pool, "x", 1)
        with pytest.raises(MemoryError, match="exhausted"):
            _replay_one(pool, "y", 21)
    assert tp.pages_in_use == jp.pages_in_use == 12
    np.testing.assert_array_equal(tp.block_table("y"), jp.block_table("y"))
    assert tp.length("y") == jp.length("y") == 0


def _replay_one(pool, sid, n):
    k = np.zeros((n, CFG["num_heads"], CFG["head_dim"]), np.float32)
    conv = torch.from_numpy if isinstance(pool, tkv.PagePool) else jnp.asarray
    pool.append(sid, conv(k), conv(k))


# --------------------------------------------------------------------------- #
# paged decode attention (#11)
# --------------------------------------------------------------------------- #

def _paged_inputs(seed=4, B=4, H=2, D=64, page=8, P=20, MP=5):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, 1, H, D).astype(np.float32)
    kp = rng.randn(P, page, H * D).astype(np.float32)
    vp = rng.randn(P, page, H * D).astype(np.float32)
    tables = rng.permutation(P)[: B * MP].reshape(B, MP).astype(np.int32)
    lengths = np.asarray([0, 1, 17, MP * page], np.int32)
    return q, kp, vp, tables, lengths


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("flat", [True, False])
@pytest.mark.parametrize("scale", [None, 0.3])
def test_paged_decode_attention_matches_jax(dtype, atol, flat, scale):
    from unilm_tpu.ops.paged_attention import paged_decode_attention as jpda

    q, kp, vp, tables, lengths = _paged_inputs()
    B, _, H, D = q.shape
    if not flat:
        kp = kp.reshape(*kp.shape[:2], H, D)
        vp = vp.reshape(*vp.shape[:2], H, D)
    want = jpda(_jnp(q, dtype), _jnp(kp, dtype), _jnp(vp, dtype),
                jnp.asarray(tables), jnp.asarray(lengths), scale=scale,
                interpret=True)
    # entries past ceil(L / page) are never read: garbage there changes
    # nothing
    page = kp.shape[1]
    junk = tables.copy()
    for b, L in enumerate(lengths):
        junk[b, -(-L // page):] = 10 ** 6
    got = tpa.paged_decode_attention(
        _torch(q, dtype), _torch(kp, dtype), _torch(vp, dtype),
        torch.from_numpy(junk), torch.from_numpy(lengths), scale=scale)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (B, 1, H, D)
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)
    assert float(got[0].abs().max()) == 0.0
    assert float(np.abs(_np(want)[0]).max()) == 0.0


def test_paged_attention_over_page_pool_matches_jax():
    """runtime.paged_kv.paged_attention over the port's PagePool against
    the JAX function (use_kernel=False) over the JAX PagePool with the same
    history; the port's use_kernel=None on CPU tensors is the gather."""
    from unilm_tpu.runtime.paged_kv import paged_attention as jpaged

    jp, tp = _pools()
    rng = np.random.RandomState(5)
    _replay(jp, tp, SCRIPT, rng)
    sids = "bcd"
    q = rng.randn(len(sids), 1, CFG["num_heads"],
                  CFG["head_dim"]).astype(np.float32)
    tables = np.stack([jp.block_table(s) for s in sids])
    lengths = np.asarray([jp.length(s) for s in sids], np.int32)
    want = jpaged(jnp.asarray(q), jp.k_pool, jp.v_pool, jnp.asarray(tables),
                  jnp.asarray(lengths), use_kernel=False)
    t = torch.from_numpy
    got = tkv.paged_attention(t(q), tp.k_pool, tp.v_pool, t(tables),
                              t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    # the kernel's plain version reads the same pool to the same result
    twin = tpa.paged_decode_attention(t(q), tp.k_pool, tp.v_pool, t(tables),
                                      t(lengths))
    np.testing.assert_allclose(twin.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_paged_attention_kernel_on_cpu_tensors_raises():
    q, kp, vp, tables, lengths = _paged_inputs()
    t = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkv.paged_attention(t(q), t(kp), t(vp), t(tables), t(lengths),
                            use_kernel=True)


class _FakeCudaDevice(torch.Tensor):
    """A CPU tensor that names a CUDA device, so the wrappers take their
    kernel branch and their checks run (they raise before any launch)."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype).as_subclass(_FakeCudaDevice)


def test_paged_attention_dispatches_cuda_tensors_to_the_kernel(monkeypatch):
    seen = []
    monkeypatch.delenv("UNILM_TPU_DISABLE_PAGED_KERNEL", raising=False)
    monkeypatch.setattr(tkv, "paged_decode_attention",
                        lambda *a, **kw: seen.append(kw["scale"]) or "kernel")
    q, kp = _fake(2, 1, 2, 64), _fake(6, 8, 2, 64)
    tables = torch.zeros(2, 3, dtype=torch.int32)
    lengths = torch.ones(2, dtype=torch.int32)
    assert tkv.paged_attention(q, kp, kp, tables, lengths, scale=0.5) == "kernel"
    assert seen == [0.5]


@pytest.mark.parametrize("case", ["head_dim", "pool_dtype", "pool_shape",
                                  "swiglu_shape", "swiglu_dtype",
                                  "rotary_odd_d", "rotary_sin_shape"])
def test_kernel_wrappers_raise_on_what_they_do_not_take(case):
    f = _fake
    tables = torch.zeros(2, 3, dtype=torch.int32)
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        if case == "head_dim":  # 48: a head dim no launcher instantiates
            tpa.paged_decode_attention(f(2, 1, 2, 48), f(6, 8, 96),
                                       f(6, 8, 96), tables, lengths)
        elif case == "pool_dtype":
            tpa.paged_decode_attention(
                f(2, 1, 2, 64), f(6, 8, 128, dtype=torch.bfloat16),
                f(6, 8, 128, dtype=torch.bfloat16), tables, lengths)
        elif case == "pool_shape":
            tpa.paged_decode_attention(f(2, 1, 2, 64), f(6, 8, 96),
                                       f(6, 8, 96), tables, lengths)
        elif case == "swiglu_shape":
            tfused.swiglu(f(4, 8), f(8, 4))
        elif case == "swiglu_dtype":
            tfused.swiglu(f(4, 8, dtype=torch.float16),
                          f(4, 8, dtype=torch.float16))
        elif case == "rotary_odd_d":
            tfused.rotary_apply(f(1, 4, 2, 7), f(4, 3), f(4, 3))
        else:
            tfused.rotary_apply(f(1, 4, 2, 8), f(5, 4), f(5, 4))


# --------------------------------------------------------------------------- #
# on the card: the kernels against their plain versions
# --------------------------------------------------------------------------- #

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels build with nvcc "
                    "at first use); chip_smoke.py runs them on the H100")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 2e-5)])
@pytest.mark.parametrize("flat", [True, False])
def test_paged_kernel_matches_plain(card, dtype, atol, flat):
    B, H, D, page, P, MP = 4, 3, 96, 16, 40, 8
    rn = lambda *s: torch.randn(*s, generator=card, device="cuda").to(dtype)
    shape = (P, page, H * D) if flat else (P, page, H, D)
    q, kp, vp = rn(B, 1, H, D), rn(*shape), rn(*shape)
    tables = torch.randperm(P, generator=card, device="cuda")[:B * MP]
    tables = tables.reshape(B, MP).to(torch.int32)
    lengths = torch.tensor([0, 1, 77, MP * page], dtype=torch.int32,
                           device="cuda")
    out = tpa.paged_decode_attention(q, kp, vp, tables, lengths)
    ref = tpa.paged_decode_attention_plain(q, kp, vp, tables, lengths)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    assert float(out[0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_kernels_match_plain(card, dtype):
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else \
        dict(atol=1e-6, rtol=BF16_ULP)
    rn = lambda *s: torch.randn(*s, generator=card, device="cuda").to(dtype)
    g, u = rn(3, 1037, 72), rn(3, 1037, 72)
    torch.testing.assert_close(tfused.swiglu(g, u), tfused.swiglu_plain(g, u),
                               **tol)
    x = rn(2, 33, 4, 64)
    sin, cos = tyoco.rotary_sin_cos(torch.arange(33, device="cuda"), 64)
    assert torch.equal(tfused.rotary_apply(x, sin, cos),
                       tfused.rotary_apply_plain(x, sin, cos))
