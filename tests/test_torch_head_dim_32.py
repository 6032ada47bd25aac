"""Head dim 32 in the port's attention kernels, on the CPU: which head dims
each kernel admits, against the JAX package's own predicates, at the
shapes of the two paths that need D = 32 (MiniLM-L6-H384's distillation
student, 12 heads of 32; TrOCR-Small's decoder, 8 heads of 32) and at the
other head dims the kernels take; the one-pass selector at D = 32; the
dispatcher's kernel for each D = 32 call of those paths (a stand-in CUDA
tensor); and every wrapper's error for a head dim it has no instantiation
for (48: JAX takes it, no configuration of the repository uses it)."""

import jax
import jax.numpy as jnp
import pytest
import torch

from unilm_tpu.ops import doc_attention as jda
from unilm_tpu.ops import flash_attention as jfa
from unilm_tpu.ops import paged_attention as jpa
from unilm_tpu_torch.core import attention as tatt
from unilm_tpu_torch.ops import doc_attention as da
from unilm_tpu_torch.ops import flash_attention as tfa
from unilm_tpu_torch.ops import paged_attention as tpa

HEAD_DIMS = (32, 64, 96, 128)

# name: (kind, B, T, S, H); kind "doc" is a key-padding-mask call (#9 /
# #10), "flash" every other forward (#1 / #3 / #5 / #6 / #7 share the
# flash family's admissibility), "paged" a decode over pages of 16 (#11,
# #13 under JAX's kernel_supported)
PATH_CALLS = {
    "distill_student": ("doc", 32, 512, 512, 12),
    "trocr_small_cross_folded": ("flash", 32, 5, 578, 8),
    "trocr_small_cross_prefill": ("flash", 32, 1, 578, 8),
    "trocr_small_finetune_cross": ("flash", 32, 64, 578, 8),
    "trocr_small_finetune_self": ("flash", 32, 64, 64, 8),
    "trocr_small_decode": ("paged", 160, 1, 33, 8),
}


def _port(B, T, H, D):
    return torch.empty(B, T, H, D, dtype=torch.bfloat16, device="meta")


def _jax(B, T, H, D):
    return jax.ShapeDtypeStruct((B, T, H, D), jnp.bfloat16)


class _Launch(Exception):
    """Raised in place of a launch: the call got past every check."""


def _port_paged_admits(monkeypatch, B, H, D, page):
    """The port's own checks for the decode kernels, #11's wrapper and
    #13's, on stand-in CUDA tensors: False where a wrapper raises the
    ValueError of a call it does not take, True where it gets past its
    checks to the device (its launch, replaced here; on a host without
    CUDA, the first step there)."""
    def launch(*args, **kw):
        raise _Launch
    for kern in (tpa.KERNEL, tpa.PAGED_KERNEL):
        monkeypatch.setattr(kern, "launch", launch)
    f = lambda *s, dt=torch.bfloat16: _fake(*s, cls=_FakeCudaDevice, dtype=dt)
    q, pool, lens = f(B, 1, H, D), f(4, page, H * D), f(B, dt=torch.int32)
    admits = set()
    for call in (lambda: tpa.paged_decode_attention(
                     q, pool, pool, f(B, 4, dt=torch.int32), lens),
                 lambda: tpa.decode_attention(q[:, 0], pool, pool, lens, lens,
                                              4)):
        try:
            call()
        except ValueError:
            admits.add(False)
        except _Launch:
            admits.add(True)
        except (AssertionError, RuntimeError) as e:
            assert not torch.cuda.is_available() and "CUDA" in str(e), e
            admits.add(True)
    assert len(admits) == 1, "the decode wrappers disagree"
    return admits.pop()


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("name", sorted(PATH_CALLS))
def test_admissible_head_dims_agree_with_jax(name, D, monkeypatch):
    """At each path's call shape and every head dim the port's kernels
    take, the port admits the call exactly where JAX's predicate does (and
    JAX admits all of them: no D = 32 call falls off the kernels)."""
    kind, B, T, S, H = PATH_CALLS[name]
    if kind == "doc":
        kw = dict(causal=False, window=0, kv_len=None, q_offset=None)
        port = da.supports(_port(B, T, H, D), _port(B, S, H, D), None, **kw)
        want = jda.supports(_jax(B, T, H, D), _jax(B, S, H, D), None, **kw)
    elif kind == "flash":
        port = tfa.supports(_port(B, T, H, D), _port(B, S, H, D), None, 0)
        want = jfa.supports(_jax(B, T, H, D), _jax(B, S, H, D), None, 0)
    else:
        port = _port_paged_admits(monkeypatch, B, H, D, 16)
        want = jpa.kernel_supported(H, D, 16, jnp.bfloat16)
    assert port == want is True


@pytest.mark.parametrize("B,H,T,S", [(32, 8, 1, 1), (32, 8, 64, 64),
                                     (1, 8, 1, 1), (160, 8, 1, 33),
                                     (32, 8, 5, 578), (32, 12, 512, 512),
                                     (2, 64, 2048, 2048)])
def test_onepass_selector_at_head_dim_32(B, H, T, S):
    """`onepass_applies` is JAX's `_onepass_profitable` at D = 32 (the
    TrOCR-Small prompt's and fine-tune's self-attention take #5)."""
    for bias in (None, torch.empty(1, H, T, S, device="meta")):
        assert tfa.onepass_applies(B, H, T, S, 32, bias, 0) == \
            jfa._onepass_profitable(B, H, T, S, 32, bias, 0)
    assert tfa.onepass_applies(32, 8, 1, 1, 32, None, 0)
    assert tfa.onepass_applies(32, 8, 64, 64, 32, None, 0)


def test_every_kernel_module_admits_32():
    for mod in (tfa, da, tpa):
        assert mod.SUPPORTED_D == HEAD_DIMS
    for D in HEAD_DIMS:
        assert tfa.supports(_port(2, 8, 4, D), _port(2, 8, 4, D), None, 0)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


class _FakeCudaDevice(_FakeCuda):
    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(*shape, cls=_FakeCuda, dtype=torch.bfloat16):
    return torch.zeros(*shape, dtype=dtype).as_subclass(cls)


def test_dispatch_of_the_paths_calls_at_head_dim_32(monkeypatch):
    """The distill student's masked self-attention goes to #9, TrOCR-
    Small's cross-attention (no mask) to #3 and its causal self-attention
    to the flash family (#5 by the selector), each with D = 32."""
    seen = []

    def rec(name):
        def f(q, k, v, bias=None, key_padding_mask=None, scale=None, **kw):
            seen.append((name, tuple(q.shape)))
            return q
        return f

    monkeypatch.setattr(da, "doc_attention", rec("#9"))
    monkeypatch.setattr(tfa, "fused_encoder_attention", rec("#3"))
    monkeypatch.setattr(tfa, "flash_attention", rec("flash"))
    q = _fake(2, 40, 12, 32)
    tatt.attention(q, q, q, key_padding_mask=torch.ones(2, 40, dtype=bool))
    k = _fake(2, 578, 8, 32)
    tatt.attention(_fake(2, 5, 8, 32), k, k)
    s = _fake(2, 64, 8, 32)
    tatt.attention(s, s, s, causal=True)
    assert seen == [("#9", (2, 40, 12, 32)), ("#3", (2, 5, 8, 32)),
                    ("flash", (2, 64, 8, 32))]


def _calls(D):
    """Every CUDA wrapper of the attention kernels, on stand-in CUDA
    tensors of head dim D."""
    f = lambda *s, dt=torch.bfloat16: _fake(*s, cls=_FakeCudaDevice, dtype=dt)
    q, k, do = f(2, 8, 2, D), f(2, 8, 2, D), f(2, 8, 2, D)
    lse = f(2, 2, 8, dt=torch.float32)
    pool = f(4, 16, 2 * D)
    lens = torch.zeros(2, dtype=torch.int32)
    return {
        "#1": lambda: tfa._flash_forward_cuda(q, k, k, None, None, 0, None,
                                              True, 0),
        "#2": lambda: tfa.flash_forward_tri(q, k, k),
        "#3": lambda: tfa._encoder_forward(q, k, k, None, 1.0),
        "#4": lambda: tfa._encoder_backward_cuda(q, k, k, None, do, 1.0,
                                                 False),
        "#5": lambda: tfa._flash_forward_onepass_cuda(q, k, k, None, None, 0,
                                                      None, True, 0),
        "#6/#7": lambda: tfa._flash_backward_cuda(q, k, k, None, None, 0, 8,
                                                  q, lse, do, True, 0, False),
        "#8": lambda: tfa._flash_backward_fused_cuda(q, k, k, None, 0, 8, q,
                                                     lse, do, True, 0),
        "#9": lambda: da._doc_forward_cuda(q, k, k, None, False, None, 1.0),
        "#10": lambda: da._doc_backward_cuda(q, k, k, None, False, None, do,
                                             1.0),
        "#11": lambda: tpa.paged_decode_attention(
            f(2, 1, 2, D), pool, pool, torch.zeros(2, 2, dtype=torch.int32),
            lens),
        "#12": lambda: tpa.paged_decode_append_attention(
            f(2, 1, 2, D), f(2, 1, 2, D), f(2, 1, 2, D), pool, pool,
            torch.zeros(2, 2, dtype=torch.int32), lens),
        "#13": lambda: tpa.decode_attention(f(2, 2, D), pool, pool, lens,
                                            lens, 2),
    }


@pytest.mark.parametrize("kernel", sorted(_calls(48)))
def test_wrappers_raise_naming_a_head_dim_without_an_instantiation(kernel):
    """A CUDA call at a head dim no launcher instantiates raises a
    ValueError naming it, before any launch: never the plain version,
    never another head dim's instantiation."""
    with pytest.raises(ValueError, match="48"):
        _calls(48)[kernel]()
