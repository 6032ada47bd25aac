"""The attention kernels at head dim 32 on the card, against their plain
versions (marked `cuda`: they skip without one; chip_smoke.py's
d32_kernels phase runs the same checks at the paths' full shapes). The
kernels the plan tests do not already hold at D = 32: #1, #3, #6 / #7
(on #5's out and lse, as TrOCR-Small's fine-tune runs them), #10 and
#12. Bounds: relative L2 1e-2 in bf16, 1e-4 in fp32 (chip_smoke.py's);
decode outputs 2e-2 abs + 2e-2 rel with the pools bit-equal."""

import pytest
import torch

from unilm_tpu_torch.ops import doc_attention as da
from unilm_tpu_torch.ops import flash_attention as tfa
from unilm_tpu_torch.ops import paged_attention as tpa

DTYPES = [(torch.bfloat16, 1e-2), (torch.float32, 1e-4)]


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


def _rn(card, dtype):
    return lambda *s: torch.randn(*s, generator=card, device="cuda").to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", DTYPES)
@pytest.mark.parametrize("T,S,causal", [(2048, 2048, True), (70, 263, False),
                                        (1, 300, True)])
def test_flash_forward_at_head_dim_32(card, dtype, bound, T, S, causal):
    """#1 (a key-padding mask, a query offset at the keys' end)."""
    rn = _rn(card, dtype)
    q, k, v = rn(2, T, 4, 32) * 32 ** -0.5, rn(2, S, 4, 32), rn(2, S, 4, 32)
    mask = torch.rand(2, S, generator=card, device="cuda") > 0.2
    mask[:, -1] = True
    kw = dict(causal=causal, window=0)
    out, lse = tfa.flash_forward(q, k, v, None, mask, S - T, None, **kw)
    ref, rl = tfa.flash_forward_plain(q, k, v, None, mask, S - T, None, **kw)
    assert _rel(out, ref) <= bound and _rel(lse, rl) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", DTYPES)
@pytest.mark.parametrize("T", [1, 5, 64, 200])
def test_encoder_forward_at_head_dim_32(card, dtype, bound, T):
    """#3 at TrOCR-Small's cross-attention over 578 encoder tokens."""
    rn = _rn(card, dtype)
    q, k, v = rn(3, T, 8, 32), rn(3, 578, 8, 32), rn(3, 578, 8, 32)
    out = tfa.fused_encoder_attention(q, k, v)
    assert _rel(out, tfa.fused_encoder_attention_plain(q, k, v)) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", DTYPES)
@pytest.mark.parametrize("T", [17, 64, 129])
def test_flash_backward_at_head_dim_32(card, dtype, bound, T):
    """#6 / #7 on #5's out and lse, causal: dq, dk, dv."""
    rn = _rn(card, dtype)
    q = rn(4, T, 8, 32) * 32 ** -0.5
    k, v, do = rn(4, T, 8, 32), rn(4, T, 8, 32), rn(4, T, 8, 32)
    kw = dict(causal=True, window=0)
    out, lse = tfa.flash_forward_onepass(q, k, v, None, None, 0, None, **kw)
    got = tfa.flash_backward(q, k, v, None, None, 0, None, out, lse, do, **kw)
    ref = tfa.flash_backward_plain(q, k, v, None, None, 0, None, out, lse, do,
                                   **kw)
    for a, r in zip(got[:3], ref[:3]):
        assert _rel(a, r) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", DTYPES)
@pytest.mark.parametrize("T", [64, 512])
def test_doc_backward_at_head_dim_32(card, dtype, bound, T):
    """#10 at the distill student's 12 heads of 32, ragged lengths."""
    rn = _rn(card, dtype)
    q, k, v, do = (rn(3, T, 12, 32) for _ in range(4))
    mask = torch.arange(T, device="cuda")[None] < torch.tensor(
        [T, T // 2, 9], device="cuda")[:, None]
    got = da.doc_backward(q, k, v, None, mask, do)
    ref = da.doc_backward_plain(q, k, v, None, mask, do)
    for a, r in zip(got[:3], ref[:3]):
        assert _rel(a, r) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_append_at_head_dim_32(card, dtype):
    """#12 at 16 heads of 32 over scattered tables, the row write
    included."""
    rn = _rn(card, dtype)
    B, H, D, page, MP = 4, 16, 32, 64, 8
    P = 1 + B * MP
    tables = (torch.randperm(P - 1, generator=card, device="cuda")[:B * MP]
              + 1).reshape(B, MP).to(torch.int32)
    kp, vp = rn(P, page, H * D), rn(P, page, H * D)
    kp2, vp2 = kp.clone(), vp.clone()
    q, kn, vn = rn(B, 1, H, D), rn(B, 1, H, D), rn(B, 1, H, D)
    L = torch.tensor([0, 63, 64, 511], dtype=torch.int32, device="cuda")
    out = tpa.paged_decode_append_attention(q, kn, vn, kp, vp, tables, L)[0]
    ref = tpa.paged_decode_append_attention_plain(q, kn, vn, kp2, vp2, tables,
                                                  L)[0]
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
