#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (unilm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, one line each:
 1. device: requires CUDA; prints the card's name and power limit
    (nvidia-smi); turns TF32 off for matmul and cuDNN.
 2. build: compiles the hand-written kernels from unilm_tpu_torch/csrc/,
    one nvcc per source, all started together.
 3. flash: the flash-forward kernel against its plain version, bf16, over
    causal/offset/kv_len/key-padding/bias/window cases, D in {64, 96, 128},
    ragged T and S, and the Kosmos-2.5 prefill shape 1x2052x16x96.
 4. decode: the bf16 run-decode kernel against its plain version, B=3
    with lengths {0, 511, 1800}; written pool rows bit-equal.
 5. slice: the Kosmos-2.5 text decoder at full width (24 layers, E=1536,
    16 heads, FFN 6144, vocab 108481, bf16, random weights from a seed)
    serves three requests through runtime.generate (2052-token multimodal
    prompt, 32 greedy tokens): B=1, B=2, B=1. The launch counters must
    show every prefill layer and every decode step's layers went through
    the kernels; a teacher-forced run of the plain path must agree.
    Prints TTFT and ms/token for the kernel path and the plain path.
 6. int8_matmul: the int8 weight-only matmul kernel against its plain
    version, bf16 x, M in {1, 8, 64, 200} x the decoder's K x N.
 7. decode_int8: the int8-KV run-decode kernel against its plain version,
    B=8, lengths up to 2111; pools and scale sidecar bit-equal.
 8. paged_append: the block-table append-decode kernel against its plain
    version, B=8 on scattered tables with two inactive slots; non-trash
    pool pages bit-equal.
 9. engine_int8: runtime.serving.ServingEngine at the configuration of
    bench.py's serving line (8 slots, ctx 2048, int8 weights, int8 KV) on
    the same full-width decoder serves 10 requests of 2048 prompt tokens
    and 64 greedy tokens; every decode step must launch the int8 run
    kernel 24 times and every projection the int8 matmul. Then a
    teacher-forced B=8 decode against the plain path, decode and prefill
    times for both paths, and a plain-path engine on the same trace.
10. engine_bf16_prefix: the engine with bf16 weights and KV serves 4
    requests sharing a 1024-token prefix; the prefix cache must hit, the
    block-table kernel must run, and the streams must equal those of the
    same engine with prefix caching off.
11. flash_bwd (run right after flash): the flash-backward kernels (dq +
    dbias, dk/dv) against flash_backward_plain on the forward kernel's out
    and lse, bf16 and fp32, over causal + key-padding with a fully masked
    row, q_offset + kv_len, window, [B,H,T,S] and batch-summed [1,H,T,S]
    bias (B=3), a head- and a batch-broadcast bias read without dbias, D
    in {64, 96, 128}, ragged T and S; then at the train shape 2x2048x32x64
    causal with a key-padding mask, both kernels checked against the plain
    backward and timed beside it.
12. train: the 1.3B UniGPT (24 layers, E=2048, 32 heads, FFN 8192, vocab
    65037, T=2048, bf16 compute / fp32 params, random weights from the
    seed) built by unilm_tpu_torch.cli.train_gpt.build_trainer with the
    CLI's bench configuration (batch 8 = 4 microbatches x 2, fused CE,
    AdamW, clip 2.0, warmup 1) on a synthetic corpus: 4 optimizer steps on
    one repeated batch, whose first row starts with a pad. Every step must
    launch each of the flash forward, dq and dk/dv kernels 24 x 4 times;
    loss and grad norm finite, loss falling from step 2 on (step 1 has lr
    0). Prints ms/step, tokens/s and model TFLOP/s (train_mfu.py's count),
    a torch.profiler device-time breakdown of one microbatch and one
    optimizer update, a kernel-vs-plain teacher check on one sequence, and
    the CLI's main() end to end at 2 layers, E=256: 4 steps straight
    against 2 + save + resume + 2, bit-equal.
Then a JSON line with each kernel's launches (from its main-path phase,
counters set to 0 just before it: slice for flash_fwd and decode, the
engines for the int8 and block-table kernels, train for flash_bwd_dq and
flash_bwd_dkv), error and times, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.

Any failed check raises and the script exits non-zero. Without a CUDA
device it exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
PROMPT = 2052  # bench.py's Kosmos-2.5 decode prompt length
NEW_TOKENS = 32
IMAGE_TOKENS = 2048  # Kosmos-2.5 latent queries spliced into the prompt

# Tolerances. Kernel vs plain twin, bf16 outputs: the two sum in another
# order and round the probabilities against a running (kernel) or final
# (twin) row max, so outputs may differ by ~2 bf16 ulps (2^-7 relative).
OUT_ATOL, OUT_RTOL = 2e-2, 2e-2
LSE_ATOL = 1e-3  # fp32 log-sum-exp of the same fp32 scores
# Slice, kernel path vs plain path teacher-forced on the kernel path's
# tokens: bf16 activations through 24 layers; logits have std ~1 at this
# init, so 0.25 is ~64 bf16 ulps at unit scale.
LOGIT_ATOL = 0.25
ARGMAX_AGREE = 0.90

# Serving phases: the engine pool holds all 10 requests' runs side by side
# (8 + 10 * 40 + 8 pages per layer), so every slot gets a contiguous run.
ENGINE_PAGES = 8 + 10 * 40 + 8
ENGINE_REQUESTS, ENGINE_PROMPT, ENGINE_NEW = 10, 2048, 64
PREFIX, PREFIX_PROMPT, PREFIX_NEW = 1024, 1100, 32
NO_EOS = -1  # random weights: budgets, not an eos draw, end each request
PROJECTIONS_PER_LAYER = 6  # q, k, v, out, fc1, fc2

# Train phase: the 1.3B UniGPT (bench.py's train line) on a synthetic
# corpus written under WORK (listed in .gitignore, removed at the end).
WORK = Path(__file__).resolve().parent / "chip_smoke_work"
TRAIN_VOCAB = 65037
PAD = 1  # UniGPT padding_idx: every pad token is a masked key
# Teacher check, kernel path against plain path on one 2048-token sequence
# (bf16 activations, fp32 params). Readings on an H100 80GB HBM3 at 700 W
# (2 layers / 24 layers of full width, same seed and row): loss rel
# 3.88e-6 / 2.65e-6; global grad-norm rel 4.58e-6 / 1.89e-4 (bf16 rounding
# compounds down 24 backward layers); min per-tensor gradient cosine
# 0.99933 / 0.99991, both at a k_proj.bias, whose gradient is small (a key
# bias shifts every score of a row alike but for xPos's rotation). Each
# bound is about 10x the larger of the two deviations:
TEACHER_LOSS_REL = 4e-5
TEACHER_NORM_REL = 2e-3
TEACHER_COS = 0.993

KERNELS = {}  # JSON name -> CudaKernel (its launch counter)


def reset_counts() -> None:
    for kern in KERNELS.values():
        kern.launches = 0


def counts() -> dict:
    return {name: kern.launches for name, kern in KERNELS.items()}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters`
    back-to-back calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def close(x: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float):
    err = (x.float() - ref.float()).abs()
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    return ok, float(err.max()) if err.numel() else 0.0


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", f"{smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from unilm_tpu_torch.ops import _native

    t0 = time.time()
    paths = _native.build_all(KERNELS.values())
    for kern in KERNELS.values():
        kern.build()
    names = sorted({p.name for p in paths})
    phase("build", f"{len(names)} libraries built/loaded in "
          f"{time.time() - t0:.1f} s: {', '.join(names)}")


def phase_flash(fa, g) -> dict:
    dev = "cuda"
    bf = torch.bfloat16

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    # (B, T, S, H, D, causal, q_offset, kv_len, window, kpm, bias)
    cases = [
        (2, 200, 200, 4, 64, True, 0, None, 0, False, None),
        (2, 70, 263, 4, 96, True, 193, None, 0, False, None),
        (2, 131, 300, 2, 96, True, 0, 217, 0, False, None),
        (2, 97, 150, 2, 128, False, 0, None, 0, True, None),
        (2, 120, 120, 4, 96, True, 0, None, 0, False, "1H"),
        (3, 100, 77, 4, 64, False, 0, None, 0, False, "B1"),
        (2, 300, 300, 2, 96, True, 0, None, 50, False, None),
        (2, 45, 45, 2, 128, True, 0, None, 0, True, "1H"),
        (1, PROMPT, PROMPT, 16, 96, True, 0, None, 0, False, None),
    ]
    worst = 0.0
    for B, T, S, H, D, causal, qoff, kvl, window, kpm, bias in cases:
        q = rn(B, T, H, D) * D ** -0.5
        k, v = rn(B, S, H, D), rn(B, S, H, D)
        mask = None
        if kpm:
            mask = torch.rand(B, S, generator=g, device=dev) > 0.3
            mask[-1] = False  # one batch row fully masked -> out 0, lse 0
        b = None
        if bias == "1H":
            b = rn(1, H, T, S)
        elif bias == "B1":
            b = rn(B, 1, T, S)
        out, lse = fa.flash_forward(q, k, v, b, mask, qoff, kvl,
                                    causal=causal, window=window)
        ref, ref_lse = fa.flash_forward_plain(q, k, v, b, mask, qoff, kvl,
                                              causal=causal, window=window)
        torch.cuda.synchronize()
        ok_o, e_o = close(out, ref, OUT_ATOL, OUT_RTOL)
        ok_l, e_l = close(lse, ref_lse, LSE_ATOL, 0.0)
        check(bool(torch.isfinite(out.float()).all()), "flash: non-finite")
        if kpm:
            check(bool((out[-1] == 0).all() and (lse[-1] == 0).all()),
                  "flash: fully masked row is not out=0, lse=0")
        desc = (f"B{B} T{T} S{S} H{H} D{D} causal={causal} q_offset={qoff} "
                f"kv_len={kvl} window={window} kpm={kpm} bias={bias}")
        check(ok_o and ok_l, f"flash {desc}: out err {e_o}, lse err {e_l}")
        worst = max(worst, e_o)
        phase("flash", f"{desc}: out max|err| {e_o:.3g}, lse max|err| "
              f"{e_l:.3g} ok")

    q = rn(1, PROMPT, 16, 96) * 96 ** -0.5
    k, v = rn(1, PROMPT, 16, 96), rn(1, PROMPT, 16, 96)
    ms = cuda_ms(lambda: fa.flash_forward(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: fa.flash_forward_plain(q, k, v, causal=True))
    phase("flash", f"1x{PROMPT}x16x96 causal bf16: kernel {ms:.4f} ms, "
          f"plain twin {plain_ms:.4f} ms")
    return {"name": "flash_fwd", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "unilm_tpu/ops/flash_attention.py:99",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def grad_close(x: torch.Tensor, ref: torch.Tensor, bound: float):
    """max|err| <= 2 bound max|ref| and relative L2 <= bound (bound = 1e-2
    for bf16, 1e-4 for fp32); returns (ok, max|err|, rel L2)."""
    x, ref = x.float(), ref.float()
    err = (x - ref).abs()
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    rel = float((x - ref).norm() / ref.norm().clamp(min=1e-30))
    e = float(err.max()) if err.numel() else 0.0
    return e <= 2 * bound * scale and rel <= bound, e, rel


def phase_flash_bwd(fa, g) -> dict:
    """Kernels #6 and #7 against flash_backward_plain on the same inputs
    (out and lse from the forward kernel), bf16 and fp32."""
    dev = "cuda"
    # (B, T, S, H, D, causal, q_offset, kv_len, window, kpm, bias)
    cases = [
        (2, 200, 200, 4, 64, True, 0, None, 0, True, None),
        (2, 70, 263, 4, 96, True, 193, None, 0, False, None),
        (2, 131, 300, 2, 96, True, 40, 217, 0, False, None),
        (2, 97, 150, 2, 128, False, 0, None, 0, True, None),
        (2, 300, 300, 2, 96, True, 0, None, 50, False, None),
        (2, 120, 120, 4, 96, True, 0, None, 0, False, "BH"),
        (3, 100, 77, 4, 64, False, 0, None, 0, False, "1H"),
        (3, 130, 130, 2, 128, True, 0, None, 0, True, "1H"),
        (3, 100, 77, 4, 64, False, 0, None, 0, False, "B1"),  # no dbias
        (3, 90, 90, 2, 96, True, 0, None, 0, True, "1H-"),  # no dbias
        (2, 45, 45, 2, 128, True, 0, None, 0, True, "BH"),
    ]
    worst = 0.0
    for dtype, bound in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        def rn(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dtype)

        for B, T, S, H, D, causal, qoff, kvl, window, kpm, bias in cases:
            q = rn(B, T, H, D) * D ** -0.5
            k, v, do = rn(B, S, H, D), rn(B, S, H, D), rn(B, T, H, D)
            mask = None
            if kpm:
                mask = torch.rand(B, S, generator=g, device=dev) > 0.3
                mask[-1] = False  # one batch row fully masked
            b = None
            if bias == "BH":
                b = rn(B, H, T, S)
            elif bias in ("1H", "1H-"):
                b = rn(1, H, T, S)
            elif bias == "B1":
                b = rn(B, 1, T, S)
            out, lse = fa.flash_forward(q, k, v, b, mask, qoff, kvl,
                                        causal=causal, window=window)
            want_db = bias in ("BH", "1H")
            got = fa.flash_backward(q, k, v, b, mask, qoff, kvl, out, lse, do,
                                    causal=causal, window=window,
                                    want_dbias=want_db)
            ref = fa.flash_backward_plain(q, k, v, b, mask, qoff, kvl, out,
                                          lse, do, causal=causal,
                                          window=window)
            torch.cuda.synchronize()
            desc = (f"{str(dtype)[6:]} B{B} T{T} S{S} H{H} D{D} "
                    f"causal={causal} q_offset={qoff} kv_len={kvl} "
                    f"window={window} kpm={kpm} bias={bias}")
            names = ("dq", "dk", "dv", "dbias") if want_db else ("dq", "dk",
                                                                 "dv")
            errs = []
            for name, x, r in zip(names, got, ref):
                check(tuple(x.shape) == tuple(r.shape)
                      and bool(torch.isfinite(x.float()).all()),
                      f"flash_bwd {desc}: {name} shape/finite")
                ok, e, rel = grad_close(x, r, bound)
                check(ok, f"flash_bwd {desc}: {name} max|err| {e} rel L2 "
                      f"{rel} (bound {bound})")
                errs.append(f"{name} {e:.3g}/{rel:.2g}")
                if dtype == torch.bfloat16:
                    worst = max(worst, e)
            if kpm:
                check(bool((got[0][-1] == 0).all() and (got[1][-1] == 0).all()),
                      f"flash_bwd {desc}: fully masked row has gradients")
            phase("flash_bwd", f"{desc}: max|err|/rel L2 {', '.join(errs)} ok")

    # through autograd: a head-broadcast bias takes the plain recompute (its
    # own counter, not the kernels), as the JAX custom VJP does; its dq, dk
    # and dv are the kernels' (no fully masked row here)
    bf = torch.bfloat16
    B, T, H, D = 2, 96, 4, 64
    q, k, v = (torch.randn(B, T, H, D, generator=g, device=dev).to(bf)
               .requires_grad_() for _ in range(3))
    do = torch.randn(B, T, H, D, generator=g, device=dev).to(bf)
    b = torch.randn(B, 1, T, T, generator=g, device=dev).to(bf).requires_grad_()
    c0, r0 = counts(), fa.BWD_RECOMPUTE_LAUNCHES
    fa.flash_attention(q, k, v, bias=b, causal=True).backward(do)
    c1 = counts()
    check(fa.BWD_RECOMPUTE_LAUNCHES == r0 + 1 and c1["flash_bwd_dq"]
          == c0["flash_bwd_dq"] and c1["flash_bwd_dkv"] == c0["flash_bwd_dkv"],
          "flash_bwd: a head-broadcast bias did not take the recompute")
    qs = (q.detach() * D ** -0.5).contiguous()
    out, lse = fa.flash_forward(qs, k.detach(), v.detach(), b.detach(),
                                causal=True)
    want = fa.flash_backward(qs, k.detach(), v.detach(), b.detach(), None, 0,
                             None, out, lse, do, causal=True,
                             want_dbias=False)
    for name, x, r in (("dq", q.grad, want[0] * D ** -0.5),
                       ("dk", k.grad, want[1]), ("dv", v.grad, want[2])):
        ok, e, rel = grad_close(x, r, 1e-2)
        check(ok, f"flash_bwd recompute: {name} max|err| {e} rel L2 {rel}")
    check(tuple(b.grad.shape) == (B, 1, T, T)
          and bool(torch.isfinite(b.grad.float()).all()),
          "flash_bwd recompute: dbias shape/finite")
    phase("flash_bwd", "head-broadcast [B,1,T,S] bias through autograd: "
          "recompute counted, kernels not launched, dq/dk/dv match the "
          "kernels' (bound 1e-2)")

    # the train shape: 2 x 2048 x 32 heads x 64, causal, key-padding mask
    B, T, H, D = 2, 2048, 32, 64
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(bf) * D ** -0.5
    k, v, do = (torch.randn(B, T, H, D, generator=g, device=dev).to(bf)
                for _ in range(3))
    mask = torch.ones(B, T, dtype=torch.bool, device=dev)
    mask[1, :3] = False
    out, lse = fa.flash_forward(q, k, v, None, mask, causal=True)
    pair = lambda: fa.flash_backward(q, k, v, None, mask, 0, None, out, lse,
                                     do, causal=True)
    plain = lambda: fa.flash_backward_plain(q, k, v, None, mask, 0, None,
                                            out, lse, do, causal=True)
    # the kernels hold against the plain backward at this shape too (a
    # 32 x 32 x 2 grid of 64-row tiles, 32 key tiles per row at the end)
    got, ref = pair(), plain()
    torch.cuda.synchronize()
    errs = []
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        check(bool(torch.isfinite(x.float()).all()),
              f"flash_bwd train shape: {name} not finite")
        ok, e, rel = grad_close(x, r, 1e-2)
        check(ok, f"flash_bwd train shape: {name} max|err| {e} rel L2 {rel} "
              "(bound 1e-2)")
        errs.append(f"{name} {e:.3g}/{rel:.2g}")
        worst = max(worst, e)
    check(bool((got[0][1, :3] == 0).all()), "flash_bwd train shape: the "
          "fully masked leading rows have a dq")
    phase("flash_bwd", f"{B}x{T}x{H}x{D} causal+kpm bf16 (rows 0-2 of "
          f"example 1 fully masked): max|err|/rel L2 {', '.join(errs)} "
          "(bound 1e-2) ok")
    del got, ref
    mi = mask.to(torch.int32)
    delta = fa._delta(out, do)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))

    def dq_only():
        fa.BWD_KERNEL_DQ.launch(
            "flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), None,
            mi.data_ptr(), dq.data_ptr(), None, B, T, T, H, D, 0, 0, 0, T, 1,
            0, 0, 1, torch.cuda.current_stream().cuda_stream)

    def dkv_only():
        fa.BWD_KERNEL_DKV.launch(
            "flash_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), None,
            mi.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, T, H, D, 0, 0,
            0, T, 1, 0, 1, torch.cuda.current_stream().cuda_stream)

    times = {}
    for rnd in range(2):
        for name, fn in (("pair", pair), ("plain", plain)):
            times[name] = cuda_ms(fn, iters=5)
    dq_ms, dkv_ms = cuda_ms(dq_only, iters=10), cuda_ms(dkv_only, iters=10)
    fwd_ms = cuda_ms(lambda: fa.flash_forward(q, k, v, None, mask,
                                              causal=True), iters=10)
    flops = 2 * B * H * T * T * D / 2  # one causal T x T x D product
    phase("flash_bwd", f"{B}x{T}x{H}x{D} causal+kpm bf16: kernel pair "
          f"{times['pair']:.3f} ms (dq {dq_ms:.3f} ms = "
          f"{3 * flops / dq_ms / 1e9:.1f} TFLOP/s, dk/dv {dkv_ms:.3f} ms = "
          f"{4 * flops / dkv_ms / 1e9:.1f} TFLOP/s), plain backward "
          f"{times['plain']:.3f} ms; forward kernel {fwd_ms:.3f} ms "
          f"({2 * flops / fwd_ms / 1e9:.1f} TFLOP/s)")
    common = {"route": "cuda", "source": "unilm_tpu_torch/csrc/flash_bwd.cu",
              "max_abs_err": worst, "plain_ms": times["plain"],
              "pair_ms": times["pair"], "shape": f"{B}x{T}x{H}x{D} causal+kpm "
              "bf16 (plain_ms is the whole plain backward)"}
    return [dict(common, name="flash_bwd_dq", ms=dq_ms,
                 replaces="unilm_tpu/ops/flash_attention.py:1235"),
            dict(common, name="flash_bwd_dkv", ms=dkv_ms,
                 replaces="unilm_tpu/ops/flash_attention.py:1381")]


def phase_decode(pa, g) -> dict:
    dev = "cuda"
    bf = torch.bfloat16
    H, D, page, chunk, PP = 16, 96, 64, 8, 40  # cache 2052+64 geometry

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    B = 3
    lengths = torch.tensor([0, 511, 1800], dtype=torch.int32, device=dev)
    bases = torch.arange(B, dtype=torch.int32, device=dev) * PP
    kp, vp = rn(B * PP, page, H * D), rn(B * PP, page, H * D)
    q, kn, vn = rn(B, 1, H, D), rn(B, 1, H, D), rn(B, 1, H, D)
    kp2, vp2 = kp.clone(), vp.clone()
    out, _, _ = pa.run_decode_append_attention(q, kn, vn, kp, vp, bases,
                                               lengths, PP, None, chunk)
    ref, _, _ = pa.run_decode_append_attention_plain(
        q, kn, vn, kp2, vp2, bases, lengths, PP, None, chunk)
    torch.cuda.synchronize()
    ok, err = close(out, ref, OUT_ATOL, OUT_RTOL)
    check(ok, f"decode: out err {err}")
    check(torch.equal(kp, kp2) and torch.equal(vp, vp2),
          "decode: written pool rows differ from the plain twin's")
    phase("decode", f"B3 lengths [0, 511, 1800] H16 D96 page64 chunk8: out "
          f"max|err| {err:.3g}, pools bit-equal ok")

    # one layer of the slice's decode step: B=1, 2052 tokens in the run.
    # `ms` and `plain_ms` are the two wrappers, which both append the row,
    # timed like for like; `kernel_only_ms` is the kernel launch alone.
    L1 = torch.tensor([PROMPT], dtype=torch.int32, device=dev)
    b1 = torch.zeros(1, dtype=torch.int32, device=dev)
    kp1, vp1 = rn(PP, page, H * D), rn(PP, page, H * D)
    q1, kn1, vn1 = rn(1, 1, H, D), rn(1, 1, H, D), rn(1, 1, H, D)
    qs1 = (q1[:, 0] * D ** -0.5).contiguous()
    kernel_ms = cuda_ms(
        lambda: pa.decode_attention(qs1, kp1, vp1, b1, L1, PP), iters=100)
    ms = cuda_ms(lambda: pa.run_decode_append_attention(
        q1, kn1, vn1, kp1, vp1, b1, L1, PP, None, chunk), iters=50)
    plain_ms = cuda_ms(lambda: pa.run_decode_append_attention_plain(
        q1, kn1, vn1, kp1, vp1, b1, L1, PP, None, chunk), iters=50)
    phase("decode", f"B1 L{PROMPT} H16 D96: kernel alone {kernel_ms:.4f} ms; "
          f"with the row append: kernel wrapper {ms:.4f} ms, plain twin "
          f"{plain_ms:.4f} ms")
    return {"name": "decode_attention", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/decode_attention.cu",
            "replaces": "unilm_tpu/ops/paged_attention.py:497",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "kernel_only_ms": kernel_ms}


def make_request(rng: np.random.RandomState, B: int, vocab: int, E: int,
                 dev: str):
    """A Kosmos-2.5-shaped prompt: bos, 2048 image positions (features
    spliced in, segment 1), then text; random ids and features."""
    tokens = rng.randint(4, vocab, size=(B, PROMPT)).astype(np.int64)
    tokens[:, 0] = 0
    img_mask = np.zeros((B, PROMPT), bool)
    img_mask[:, 1:1 + IMAGE_TOKENS] = True
    feats = (rng.standard_normal((B, IMAGE_TOKENS, E)) * E ** -0.5)
    aux = (torch.from_numpy(feats.astype(np.float32)).to(dev, torch.bfloat16),
           torch.from_numpy(img_mask).to(dev),
           torch.from_numpy(img_mask.astype(np.int64)).to(dev))
    return torch.from_numpy(tokens).to(dev), aux


def phase_slice(fa, pa) -> dict:
    from unilm_tpu_torch.models.kosmos import (
        UniGPT, kosmos2_5, make_unigpt_generate_fns)
    from unilm_tpu_torch.runtime.generate import GenerationConfig, generate

    dev = "cuda"
    cfg = kosmos2_5(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                    image_tower=None, scan_layers=True)
    L = cfg.num_layers
    model = UniGPT(cfg, device=dev).eval()
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    phase("slice", f"kosmos2_5 text decoder: {L} layers, E={cfg.embed_dim}, "
          f"H={cfg.num_heads}, D={cfg.embed_dim // cfg.num_heads}, "
          f"FFN={cfg.ffn_dim}, vocab={cfg.vocab_size}: "
          f"{n_params / 1e9:.3f} B params, {n_bytes / 1e9:.2f} GB")
    cache_size = PROMPT + 64
    prefill, step = make_unigpt_generate_fns(model, cache_size)
    gcfg = GenerationConfig(beam_size=1, max_new_tokens=NEW_TOKENS,
                            min_new_tokens=NEW_TOKENS,
                            vocab_size=cfg.vocab_size)
    rng = np.random.RandomState(SEED)
    requests = [make_request(rng, B, cfg.vocab_size, cfg.embed_dim, dev)
                for B in (1, 2, 1)]

    # ---- the main path: three requests through generate ---------------
    reset_counts()
    results = []
    for ri, (prompt, aux) in enumerate(requests):
        logits, calls = [], {"prefill": 0, "step": 0}

        def pf(tokens, a):
            lg, c = prefill(tokens, a)
            calls["prefill"] += 1
            logits.append(lg)
            return lg, c

        def st(tokens, c, a):
            lg, c = step(tokens, c, a)
            calls["step"] += 1
            logits.append(lg)
            return lg, c

        f0, d0 = fa.KERNEL.launches, pa.KERNEL.launches
        torch.cuda.synchronize()
        t0 = time.time()
        toks, lengths = generate(gcfg, pf, st, prompt, aux)
        torch.cuda.synchronize()
        wall = time.time() - t0
        df, dd = fa.KERNEL.launches - f0, pa.KERNEL.launches - d0
        B = prompt.shape[0]
        check(tuple(toks.shape) == (B, PROMPT + NEW_TOKENS),
              f"request {ri}: tokens {tuple(toks.shape)}")
        check(calls["prefill"] == 1 and calls["step"] == NEW_TOKENS - 1,
              f"request {ri}: {calls}")
        check(df == L * calls["prefill"],
              f"request {ri}: flash launches {df} != {L} per prefill")
        check(dd == L * calls["step"],
              f"request {ri}: decode launches {dd} != {L} x {calls['step']}")
        for lg in logits:
            check(tuple(lg.shape) == (B, 1, cfg.vocab_size),
                  f"request {ri}: logits {tuple(lg.shape)}")
            check(bool(torch.isfinite(lg.float()).all()),
                  f"request {ri}: non-finite logits")
        check(bool((lengths == PROMPT + NEW_TOKENS).all()),
              f"request {ri}: lengths {lengths.tolist()}")
        results.append((prompt, aux, toks, logits))
        phase("slice", f"request {ri}: B={B}, {PROMPT}-token prompt -> "
              f"{NEW_TOKENS} tokens in {wall:.3f} s (generate, host clock); "
              f"flash launches +{df}, decode launches +{dd}; logits finite")
    launches = {"flash_fwd": fa.KERNEL.launches,
                "decode_attention": pa.KERNEL.launches}

    # ---- plain path, teacher-forced on request 0's kernel tokens -------
    plain = UniGPT(dataclasses.replace(cfg, use_flash=False), device=dev)
    plain.load_state_dict(model.state_dict(), assign=True)
    plain.eval()
    pprefill, pstep = make_unigpt_generate_fns(plain, cache_size)
    prompt, aux, toks, klogits = results[0]
    f0, d0 = fa.KERNEL.launches, pa.KERNEL.launches
    plg, pc = pprefill(prompt, aux)
    plogits = [plg]
    for j in range(NEW_TOKENS - 1):
        plg, pc = pstep(toks[:, PROMPT + j:PROMPT + j + 1], pc, None)
        plogits.append(plg)
    torch.cuda.synchronize()
    check(fa.KERNEL.launches == f0 and pa.KERNEL.launches == d0,
          "plain path launched a kernel")
    errs = [float((a.float() - b.float()).abs().max())
            for a, b in zip(klogits, plogits)]
    agree = np.mean([bool((a.argmax(-1) == b.argmax(-1)).all())
                     for a, b in zip(klogits, plogits)])
    check(max(errs) <= LOGIT_ATOL,
          f"slice: kernel vs plain logits max|err| {max(errs)} > {LOGIT_ATOL}")
    check(agree >= ARGMAX_AGREE,
          f"slice: argmax agreement {agree} < {ARGMAX_AGREE}")
    phase("slice", f"plain path teacher-forced on request 0: prefill "
          f"logits max|err| {errs[0]:.4f}, decode steps max|err| "
          f"{max(errs[1:]):.4f} (tol {LOGIT_ATOL}), argmax agreement "
          f"{agree:.3f} over {len(errs)} positions")

    # ---- TTFT and ms/token, kernel and plain paths in turn -------------
    prompt, aux = requests[0]
    steps = NEW_TOKENS - 1

    def timed(m):
        pf, st = make_unigpt_generate_fns(m, cache_size)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        lg, c = pf(prompt, aux)
        ev[1].record()
        tok = lg[:, -1:].argmax(-1)
        ev[2].record()
        for _ in range(steps):
            lg, c = st(tok, c, None)
            tok = lg[:, -1:].argmax(-1)
        ev[3].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3]) / steps

    timed(model)  # warm-up
    timed(plain)
    for rnd in range(2):
        for name, m in (("kernel", model), ("plain", plain)):
            ttft, tpot = timed(m)
            phase("slice", f"round {rnd} {name} path, B=1: TTFT (prefill) "
                  f"{ttft:.3f} ms, decode {tpot:.3f} ms/token "
                  f"(ctx {PROMPT}..{PROMPT + steps})")
    return launches


def ulp_tol(ref: torch.Tensor, n: float) -> torch.Tensor:
    """n bf16 ulps of each element of ref (8 significant bits)."""
    _, e = torch.frexp(ref.float())
    return n * torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - 8)


def phase_int8_matmul(qm, g) -> dict:
    """Kernel against plain, bf16 x, at the decoder's K x N and the M of
    decode (1, 8), a prefill chunk (64) and more (200). Tolerance: 2 bf16
    ulps of the plain result (both round one fp32 value to bf16) plus the
    fp32 sum-order term K * 2^-24 * (|x| @ |W|) * scale."""
    dev, bf = "cuda", torch.bfloat16
    worst, worst_ratio = 0.0, 0.0
    times = {}
    for K, N in ((1536, 1536), (1536, 6144), (6144, 1536)):
        w = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                          dtype=torch.int8)
        scale = ((torch.rand(N, generator=g, device=dev) + 0.5)
                 * (2.0 / (127 * K ** 0.5)))
        for M in (1, 8, 64, 200):
            x = torch.randn(M, K, generator=g, device=dev).to(bf)
            out = qm.int8_matmul(x, w, scale)
            ref = qm.int8_matmul_plain(x, w, scale)
            torch.cuda.synchronize()
            order = (K * 2.0 ** -24 * (x.float().abs() @ w.float().abs().t())
                     * scale)
            tol = ulp_tol(ref, 2) + order
            err = (out.float() - ref.float()).abs()
            ratio = float((err / tol).max())
            check(bool(torch.isfinite(out.float()).all()) and ratio <= 1.0,
                  f"int8_matmul M{M} K{K} N{N}: max|err| {float(err.max())}, "
                  f"{ratio:.3f} of the tolerance")
            worst, worst_ratio = max(worst, float(err.max())), max(
                worst_ratio, ratio)
            if (K, N) == (1536, 6144) and M in (8, 64):
                times[M] = (
                    cuda_ms(lambda: qm.int8_matmul(x, w, scale), iters=50),
                    cuda_ms(lambda: qm.int8_matmul_plain(x, w, scale),
                            iters=50))
        phase("int8_matmul", f"K{K} N{N}, M in 1/8/64/200: ok")
    for M, (ms, plain_ms) in times.items():
        phase("int8_matmul", f"M{M} K1536 N6144 bf16: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
    phase("int8_matmul", f"max|err| {worst:.3g}, at most {worst_ratio:.3f} "
          f"of the tolerance (2 bf16 ulps + fp32 order term)")
    return {"name": "int8_matmul", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "unilm_tpu/ops/quant.py:59", "max_abs_err": worst,
            "ms": times[8][0], "plain_ms": times[8][1],
            "shape": "M8 K1536 N6144 bf16", "ms_m64": times[64][0],
            "plain_ms_m64": times[64][1]}


def phase_decode_int8(pa, g) -> dict:
    dev, bf = "cuda", torch.bfloat16
    H, D, page, chunk, PP, B = 16, 96, 64, 8, 40, 8
    P = B * PP + chunk

    def pools():
        kp = torch.randint(-127, 128, (P, page, H * D), generator=g,
                           device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, (P, page, H * D), generator=g,
                           device=dev, dtype=torch.int8)
        sp = (torch.rand(P // chunk, 8, chunk * page, generator=g,
                         device=dev) * 0.02 + 1e-3)
        return kp, vp, sp

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    lens = [0, 63, 64, 511, 1800, 2111, 1024, 2047]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    bases = torch.arange(B, dtype=torch.int32, device=dev) * PP
    kp, vp, sp = pools()
    kp2, vp2, sp2 = kp.clone(), vp.clone(), sp.clone()
    q, kn, vn = rn(B, 1, H, D), rn(B, 1, H, D), rn(B, 1, H, D)
    out = pa.run_decode_append_attention(q, kn, vn, kp, vp, bases, lengths,
                                         PP, None, chunk, scale_pool=sp)[0]
    ref = pa.run_decode_append_attention_plain(
        q, kn, vn, kp2, vp2, bases, lengths, PP, None, chunk,
        scale_pool=sp2)[0]
    torch.cuda.synchronize()
    ok, err = close(out, ref, OUT_ATOL, OUT_RTOL)
    check(ok and bool(torch.isfinite(out.float()).all()),
          f"decode_int8: out err {err}")
    check(torch.equal(kp, kp2) and torch.equal(vp, vp2)
          and torch.equal(sp, sp2),
          "decode_int8: pools or sidecar differ from the plain version's")
    phase("decode_int8", f"B{B} lengths {lens} H16 D96 page64 chunk8: out "
          f"max|err| {err:.3g} (tol {OUT_ATOL} abs + {OUT_RTOL} rel), pools "
          f"and sidecar bit-equal ok")

    # B=8, every run at 2047 tokens: the serving step's shape
    L8 = torch.full((B,), 2047, dtype=torch.int32, device=dev)
    qs = (q[:, 0] * D ** -0.5).contiguous()
    kn0, vn0 = kn[:, 0].contiguous(), vn[:, 0].contiguous()
    kernel_ms = cuda_ms(lambda: pa.decode_attention_int8(
        qs, kp, vp, bases, L8, sp, kn0, vn0, PP, chunk), iters=100)
    ms = cuda_ms(lambda: pa.run_decode_append_attention(
        q, kn, vn, kp, vp, bases, L8, PP, None, chunk, scale_pool=sp),
        iters=50)
    plain_ms = cuda_ms(lambda: pa.run_decode_append_attention_plain(
        q, kn, vn, kp, vp, bases, L8, PP, None, chunk, scale_pool=sp),
        iters=20)
    phase("decode_int8", f"B8 L2047 H16 D96: kernel alone {kernel_ms:.4f} "
          f"ms; with the row append: kernel wrapper {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    return {"name": "decode_attention_int8", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/decode_attention.cu",
            "replaces": "unilm_tpu/ops/paged_attention.py:497",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "kernel_only_ms": kernel_ms, "shape": "B8 L2047 H16 D96 int8"}


def phase_paged_append(pa, g) -> dict:
    dev, bf = "cuda", torch.bfloat16
    H, D, page, MP, B = 16, 96, 64, 40, 8
    P = 1 + B * MP  # page 0 is the trash page

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    def scattered_tables(n_active):
        perm = torch.randperm(P - 1, generator=g, device=dev)[:B * MP] + 1
        tables = perm.reshape(B, MP).to(torch.int32)
        tables[n_active:] = 0  # inactive slots point at the trash page
        return tables.contiguous()

    lens = [0, 63, 64, 511, 1800, 2111, 0, 0]  # slots 6, 7 inactive
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    tables = scattered_tables(6)
    kp, vp = rn(P, page, H * D), rn(P, page, H * D)
    kp2, vp2 = kp.clone(), vp.clone()
    q, kn, vn = rn(B, 1, H, D), rn(B, 1, H, D), rn(B, 1, H, D)
    out = pa.paged_decode_append_attention(q, kn, vn, kp, vp, tables,
                                           lengths)[0]
    ref = pa.paged_decode_append_attention_plain(q, kn, vn, kp2, vp2, tables,
                                                 lengths)[0]
    torch.cuda.synchronize()
    ok, err = close(out[:6], ref[:6], OUT_ATOL, OUT_RTOL)
    check(ok and bool(torch.isfinite(out[:6].float()).all()),
          f"paged_append: active outputs err {err}")
    check(torch.equal(kp[1:], kp2[1:]) and torch.equal(vp[1:], vp2[1:]),
          "paged_append: non-trash pool pages differ from the plain "
          "version's")
    phase("paged_append", f"B{B} scattered tables, lengths {lens} (slots 6-7 "
          f"inactive) H16 D96 page64: active out max|err| {err:.3g}, "
          f"non-trash pages bit-equal ok")

    tables8 = scattered_tables(B)
    L8 = torch.full((B,), 2047, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: pa.paged_decode_append_attention(
        q, kn, vn, kp, vp, tables8, L8), iters=50)
    plain_ms = cuda_ms(lambda: pa.paged_decode_append_attention_plain(
        q, kn, vn, kp, vp, tables8, L8), iters=20)
    phase("paged_append", f"B8 L2047 H16 D96 scattered: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms (both write the row)")
    return {"name": "paged_append_attention", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/paged_append_attention.cu",
            "replaces": "unilm_tpu/ops/paged_attention.py:213",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "shape": "B8 L2047 H16 D96 bf16 scattered"}


def engine_model():
    """The full-width Kosmos-2.5 text decoder (bf16, random weights from
    the seed) as (config, state_dict) for the serving engine."""
    from unilm_tpu_torch.models.kosmos import UniGPT, kosmos2_5

    cfg = kosmos2_5(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                    image_tower=None, scan_layers=True)
    model = UniGPT(cfg, device="cuda").eval()
    model.init_weights(torch.Generator(device="cuda").manual_seed(SEED))
    return cfg, model.state_dict()


def run_engine(eng, batches):
    """Submit each batch and run the engine to the end; returns (outputs,
    decode steps, wall seconds)."""
    steps = [0]
    orig = eng.step

    def step():
        steps[0] += 1
        orig()

    eng.step = step
    torch.cuda.synchronize()
    t0 = time.time()
    for batch in batches:
        for rid, prompt in batch:
            eng.submit(rid, prompt)
        eng.run()
    torch.cuda.synchronize()
    return dict(eng.outputs), steps[0], time.time() - t0


def phase_engine_int8(cfg, sd) -> dict:
    from unilm_tpu_torch.runtime.serving import (
        PagedGPT, ServingConfig, ServingEngine, batched_sample)

    dev = "cuda"
    L = cfg.num_layers
    scfg = ServingConfig(max_batch=8, page_size=64, chunk_pages=8,
                         max_pages_per_seq=40, num_pages=ENGINE_PAGES,
                         prefill_bucket=64, max_new_tokens=ENGINE_NEW,
                         eos=NO_EOS, kv_dtype="int8", weight_dtype="int8")
    rng = np.random.RandomState(SEED + 1)
    prompts = [[int(t) for t in rng.randint(4, cfg.vocab_size,
                                            size=ENGINE_PROMPT)]
               for _ in range(ENGINE_REQUESTS)]
    trace = [[(f"r{i}", p) for i, p in enumerate(prompts)]]

    # ---- the main path: 10 requests, the last two wait for a free slot --
    eng = ServingEngine(cfg, scfg, sd, device=dev)
    reset_counts()
    outs, steps, wall = run_engine(eng, trace)
    got = counts()
    chunks = eng.stats["prefill_chunks"]
    check(all(len(outs[f"r{i}"]) == ENGINE_NEW
              for i in range(ENGINE_REQUESTS)),
          f"engine_int8: token counts {[len(v) for v in outs.values()]}")
    check(got["decode_attention_int8"] == L * steps,
          f"engine_int8: int8 decode launches {got['decode_attention_int8']}"
          f" != {L} x {steps} steps")
    check(got["int8_matmul"] == L * PROJECTIONS_PER_LAYER * (chunks + steps),
          f"engine_int8: int8 matmul launches {got['int8_matmul']} != "
          f"{L * PROJECTIONS_PER_LAYER} x ({chunks} chunks + {steps} steps)")
    check(got["paged_append_attention"] == 0 and got["decode_attention"] == 0,
          f"engine_int8: bf16 decode kernels launched: {got}")
    phase("engine_int8", f"{ENGINE_REQUESTS} requests x {ENGINE_PROMPT} "
          f"prompt + {ENGINE_NEW} greedy tokens: {chunks} prefill chunks, "
          f"{steps} decode steps in {wall:.2f} s (host clock); launches "
          f"int8 decode {got['decode_attention_int8']}, int8 matmul "
          f"{got['int8_matmul']}; stats {eng.stats}")
    launches = {k: got[k] for k in ("decode_attention_int8", "int8_matmul")}

    # ---- B=8 teacher-forced: kernel path against plain path ------------
    model_k = eng.model
    model_p = PagedGPT(eng.cfg, use_kernel=False, chunk_pages=8, device=dev)
    model_p.load_state_dict(model_k.state_dict(), assign=True)
    model_p.eval()
    B, MP = 8, scfg.max_pages_per_seq
    base = 8 + 40 * np.arange(B)
    tables = torch.tensor(base[:, None] + np.arange(MP)[None], device=dev,
                          dtype=torch.int32)
    bases = torch.tensor(base, device=dev, dtype=torch.int32)
    lengths = torch.tensor(2040 + 2 * np.arange(B), device=dev,
                           dtype=torch.int32)
    ones = torch.ones(B, dtype=torch.int32, device=dev)
    pools_k = eng.pools
    pools_p = tuple(t.clone() for t in pools_k)
    tok = torch.tensor(rng.randint(4, cfg.vocab_size, size=(B, 1)),
                       device=dev)
    errs, agree = [], []
    for j in range(4):
        c0 = counts()
        lk = model_k(tok, pools_k[0], pools_k[1], tables, lengths + j, ones,
                     bases=bases, scale_pool=pools_k[2])[0]
        c1 = counts()
        lp = model_p(tok, pools_p[0], pools_p[1], tables, lengths + j, ones,
                     scale_pool=pools_p[2])[0]
        torch.cuda.synchronize()
        check(counts() == c1 and c1["decode_attention_int8"]
              - c0["decode_attention_int8"] == L,
              "engine_int8: teacher-forced launch counts")
        errs.append(float((lk.float() - lp.float()).abs().max()))
        agree.extend((lk.argmax(-1) == lp.argmax(-1)).flatten().tolist())
        tok = lk.argmax(-1)
    agree = float(np.mean(agree))
    check(max(errs) <= LOGIT_ATOL and agree >= ARGMAX_AGREE,
          f"engine_int8: teacher-forced logits max|err| {max(errs)}, argmax "
          f"agreement {agree}")
    phase("engine_int8", f"teacher-forced B8 at ctx ~2040, kernel vs plain "
          f"path: logits max|err| {max(errs):.4f} (tol {LOGIT_ATOL}), argmax "
          f"agreement {agree:.3f} over {len(errs) * B} positions")

    # ---- decode step and prefill chunk times, both paths in turn --------
    zf = torch.zeros(B, device=dev)
    zi = torch.zeros(B, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def step(m, pools, use_bases):
        lg = m(tok, pools[0], pools[1], tables, lengths, ones,
               bases=bases if use_bases else None, scale_pool=pools[2])[0]
        return batched_sample(lg[:, -1], zf, zi, zf, gen)

    ptok = torch.tensor(rng.randint(4, cfg.vocab_size, size=(1, 64)),
                        device=dev)
    plen = torch.tensor([1024], dtype=torch.int32, device=dev)
    pnv = torch.tensor([64], dtype=torch.int32, device=dev)

    def prefill(m, pools):
        return m(ptok, pools[0], pools[1], tables[:1], plen, pnv,
                 scale_pool=pools[2])[0]

    for rnd in range(2):
        for name, m, pools in (("kernel", model_k, pools_k),
                               ("plain", model_p, pools_p)):
            ms = cuda_ms(lambda: step(m, pools, name == "kernel"), iters=5)
            pre = cuda_ms(lambda: prefill(m, pools), iters=5)
            phase("engine_int8", f"round {rnd} {name} path: B=8 decode step "
                  f"{ms:.3f} ms ({B * 1e3 / ms:.1f} tok/s), prefill chunk "
                  f"(64 tokens at ctx 1024) {pre:.3f} ms")
    del model_p, pools_p, eng, model_k, pools_k
    torch.cuda.empty_cache()

    # ---- a plain-path engine on the same trace -------------------------
    eng_p = ServingEngine(cfg, scfg, sd, device=dev, use_kernel=False)
    c0 = counts()
    outs_p, steps_p, wall_p = run_engine(eng_p, trace)
    check(counts() == c0, "engine_int8: the plain-path engine launched a "
          "kernel")
    same = [np.mean(np.asarray(outs[k]) == np.asarray(outs_p[k]))
            for k in outs]
    first = [next((i for i, (a, b) in enumerate(zip(outs[k], outs_p[k]))
                   if a != b), ENGINE_NEW) for k in outs]
    phase("engine_int8", f"plain-path engine, same trace: {steps_p} steps in "
          f"{wall_p:.2f} s; stream agreement {np.mean(same):.3f} of tokens, "
          f"{sum(f == ENGINE_NEW for f in first)}/{len(first)} streams "
          f"identical, first divergence per stream {first}")
    del eng_p
    torch.cuda.empty_cache()
    return launches


def phase_engine_bf16_prefix(cfg, sd) -> dict:
    import dataclasses as dc

    from unilm_tpu_torch.runtime.serving import ServingConfig, ServingEngine

    L = cfg.num_layers
    scfg = ServingConfig(max_batch=8, page_size=64, chunk_pages=8,
                         max_pages_per_seq=40, num_pages=ENGINE_PAGES,
                         prefill_bucket=64, max_new_tokens=PREFIX_NEW,
                         eos=NO_EOS)
    rng = np.random.RandomState(SEED + 2)
    prefix = [int(t) for t in rng.randint(4, cfg.vocab_size, size=PREFIX)]
    prompts = [prefix + [int(t) for t in rng.randint(
        4, cfg.vocab_size, size=PREFIX_PROMPT - PREFIX)] for _ in range(4)]
    # r0 first, so its pages are registered when r1-r3 arrive
    trace = [[("r0", prompts[0])],
             [(f"r{i}", prompts[i]) for i in range(1, 4)]]

    results = {}
    for caching in (True, False):
        eng = ServingEngine(cfg, dc.replace(scfg, prefix_caching=caching), sd,
                            device="cuda")
        reset_counts()
        outs, steps, wall = run_engine(eng, trace)
        got = counts()
        results[caching] = (outs, got, dict(eng.stats))
        check(all(len(v) == PREFIX_NEW for v in outs.values()),
              f"engine_bf16_prefix: token counts "
              f"{[len(v) for v in outs.values()]}")
        check(got["decode_attention"] + got["paged_append_attention"]
              == L * steps, f"engine_bf16_prefix: decode launches {got} != "
              f"{L} x {steps} steps")
        phase("engine_bf16_prefix", f"prefix_caching={caching}: 4 x "
              f"{PREFIX_PROMPT} tokens ({PREFIX} shared) + {PREFIX_NEW} "
              f"greedy: {steps} decode steps in {wall:.2f} s; launches run "
              f"{got['decode_attention']}, block-table "
              f"{got['paged_append_attention']}; stats {eng.stats}")
        del eng
        torch.cuda.empty_cache()
    (outs, got, stats), (outs_off, got_off, _) = results[True], results[False]
    check(stats["prefix_hit_pages"] == 3 * (PREFIX // 64),
          f"engine_bf16_prefix: prefix hits {stats['prefix_hit_pages']}")
    check(got["paged_append_attention"] > 0,
          "engine_bf16_prefix: the block-table kernel never ran")
    check(got_off["paged_append_attention"] == 0,
          "engine_bf16_prefix: caching off should keep every run contiguous")
    check(outs == outs_off, "engine_bf16_prefix: streams differ from the "
          "prefix-caching-off run")
    phase("engine_bf16_prefix", "streams equal the prefix-caching-off run")
    return {"paged_append_attention": got["paged_append_attention"]}


def write_corpus(prefix: str, vocab: int, n_docs: int, seed: int,
                 lead_pad_first: bool) -> None:
    """A synthetic MMapIndexedDataset: random documents of random length
    (the stream adds an eod after each), a run of pad tokens inside every
    fifth document; with lead_pad_first, the document the stream draws
    first (InfinitePermutationSourceIterator's permutation for `seed`)
    starts with a pad, so the first row of the first batch does."""
    import random

    from unilm_tpu_torch.data.indexed_dataset import build_indexed_dataset

    rng = np.random.RandomState(seed)
    docs = [rng.randint(4, vocab, size=rng.randint(64, 2000))
            for _ in range(n_docs)]
    for d in docs[::5]:
        at = rng.randint(1, len(d) - 4)
        d[at:at + rng.randint(1, 4)] = PAD
    if lead_pad_first:
        order = list(range(n_docs))
        random.Random(seed).shuffle(order)
        docs[order[0]][:2] = PAD
    build_indexed_dataset(prefix, docs)


def matmul_params(model) -> int:
    """benchmarks/train_mfu.py count_matmul_params: >= 2-D parameters
    except embedding tables, plus the tied output projection once."""
    n = sum(p.numel() for name, p in model.named_parameters()
            if p.ndim >= 2 and "embed" not in name)
    return n + model.embed_tokens.weight.numel()


def device_time_shares(prof, groups) -> dict:
    """Device time (ms) of the kernels a profile saw, summed by the first
    group whose substrings match the kernel's name (else "other")."""
    from torch.autograd import DeviceType

    out = {name: 0.0 for name, _ in groups}
    out["other"] = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = evt.self_cuda_time_total
        key = next((name for name, subs in groups
                    if any(s in evt.key for s in subs)), "other")
        out[key] += t / 1e3
    return out


def phase_train(fa, layers: int = 24) -> dict:
    """The 1.3B UniGPT train step at full width through the CLI's
    build_trainer, its profile, the kernel-vs-plain teacher check and the
    small-size CLI resume."""
    import shutil

    from unilm_tpu_torch.cli import train_gpt
    from unilm_tpu_torch.models.kosmos import UniGPT
    from unilm_tpu_torch.ops.fused_ce import chunked_cross_entropy

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    prefix = str(WORK / "corpus")
    write_corpus(prefix, TRAIN_VOCAB, 64, SEED, lead_pad_first=True)
    args = train_gpt.build_parser().parse_args([
        "--data", prefix, "--dim", "2048", "--layers", str(layers),
        "--heads", "32", "--ffn", "8192", "--vocab", str(TRAIN_VOCAB),
        "--tokens_per_sample", "2048", "--batch_size", "8",
        "--update_freq", "4", "--fused_ce", "--ce_chunk", "8192",
        "--warmup", "1", "--seed", str(SEED)])
    tr = train_gpt.build_trainer(args)
    model, cfg = tr.model, tr.cfg
    n_params = sum(p.numel() for p in model.parameters())
    n_mm = matmul_params(model)
    batch = tr.next_batch()  # [4, 2, 2048], repeated every step
    pads = int((batch == PAD).sum())
    check(int(batch[0, 0, 0]) == PAD, "train: the first row does not start "
          "with a pad")
    phase("train", f"UniGPT {layers} layers, E={cfg.embed_dim}, "
          f"H={cfg.num_heads}, FFN={cfg.ffn_dim}, vocab {cfg.vocab_size}, "
          f"T=2048, bf16 compute / fp32 params: {n_params / 1e9:.3f} B "
          f"params ({n_mm / 1e9:.3f} B matmul); batch 8 = 4 microbatches "
          f"x 2, {pads} pad tokens, row 0 starts with a pad")

    # ---- the main path: optimizer steps on one repeated batch ----------
    steps, losses, times = 4, [], []
    reset_counts()
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.time()
        tr.state, m = tr.step_fn(tr.state, batch)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        losses.append(float(m["loss"]))
        gn = float(m["grad_norm"])
        check(np.isfinite(losses[-1]) and np.isfinite(gn),
              f"train: step {i + 1} loss {losses[-1]} grad_norm {gn}")
        phase("train", f"step {i + 1}: loss {losses[-1]:.6f}, grad_norm "
              f"{gn:.4f}, lr {tr.sched(i):.3g}, {times[-1] * 1e3:.1f} ms "
              "(host clock)")
    got = counts()
    per_step = layers * args.update_freq
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(got[name] == per_step * steps,
              f"train: {name} launches {got[name]} != {per_step} x {steps}")
    check(all(losses[i + 1] < losses[i] for i in range(1, steps - 1)),
          f"train: loss does not fall from step 2 on: {losses}")
    launches = {k: got[k] for k in ("flash_bwd_dq", "flash_bwd_dkv")}
    step_s = float(np.mean(times[1:]))
    tokens = args.batch_size * args.tokens_per_sample
    flops = (6.0 * n_mm * tokens + 12.0 * layers * cfg.embed_dim
             * args.tokens_per_sample * tokens)
    phase("train", f"launches per step: flash_fwd/dq/dkv {per_step} each "
          f"({got}); steps 2-{steps}: {step_s * 1e3:.1f} ms/step, "
          f"{tokens / step_s:.0f} tokens/s, {flops / step_s / 1e12:.1f} model "
          f"TFLOP/s = {flops / step_s / 989e12 * 100:.1f}% of 989 TFLOP/s "
          f"bf16 dense; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # ---- device-time profile: one microbatch, then one optimizer update --
    from torch.profiler import ProfilerActivity, profile

    groups = [("flash_fwd #1", ["flash_fwd_kernel"]),
              ("flash_bwd_dq #6", ["flash_bwd_dq_kernel"]),
              ("flash_bwd_dkv #7", ["flash_bwd_dkv_kernel"]),
              ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet", "cublas",
                          "splitK"])]
    mb = batch[0]
    params = [p for p in model.parameters() if p.requires_grad]

    def micro():
        out = model(mb, return_features=True)
        s, n = chunked_cross_entropy(out[:, :-1], model.embed_tokens.weight,
                                     mb[:, 1:], chunk=args.ce_chunk)
        return torch.autograd.grad(s / n, params)

    micro()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        grads = micro()
        torch.cuda.synchronize()
    mb_shares = device_time_shares(prof, groups)
    opt_state = tr.state.opt_state
    scratch = [p.detach().clone() for p in params]
    state_copy = {k: ([t.clone() for t in v] if isinstance(v, list) else v)
                  for k, v in opt_state.items()}
    with profile(activities=acts) as prof:
        tr.tx.update(grads, state_copy, scratch)
        torch.cuda.synchronize()
    opt_ms = sum(device_time_shares(prof, []).values())
    del scratch, state_copy
    step_parts = {k: v * args.update_freq for k, v in mb_shares.items()}
    step_parts["optimizer"] = opt_ms
    total = sum(step_parts.values())
    if total <= 0:
        phase("train", "profiler saw no device time: shares not measured")
    else:
        phase("train", "device time per step (4 x one profiled microbatch + "
              f"one optimizer update) {total:.1f} ms: " + ", ".join(
                  f"{k} {v:.1f} ms ({100 * v / total:.1f}%)"
                  for k, v in step_parts.items()))
    del grads
    tr.state.opt_state = None  # the teacher check needs the memory
    torch.cuda.empty_cache()

    # ---- teacher check: kernel path against plain path, one sequence ---
    # the row of the batch with the most pad keys among those whose first
    # token is not a pad (a query with no visible key gives out = 0 in the
    # kernel and a uniform average in the plain path, as in JAX)
    flat = batch.reshape(-1, batch.shape[-1])
    rows = [i for i in range(flat.shape[0]) if int(flat[i, 0]) != PAD]
    row = max(rows, key=lambda i: int((flat[i] == PAD).sum()))
    seq = flat[row:row + 1]
    plain = UniGPT(dataclasses.replace(cfg, use_flash=False, remat=True),
                   device="cuda")
    plain.load_state_dict(model.state_dict(), assign=True)

    def loss_grads(m):
        out = m(seq, return_features=True)
        s, n = chunked_cross_entropy(out[:, :-1], m.embed_tokens.weight,
                                     seq[:, 1:], chunk=args.ce_chunk)
        loss = s / n
        ps = [p for p in m.parameters() if p.requires_grad]
        return float(loss.detach()), torch.autograd.grad(loss, ps)

    c0 = counts()
    lk, gk = loss_grads(model)
    c1 = counts()
    lp, gp = loss_grads(plain)
    torch.cuda.synchronize()
    check(counts() == c1 and c1["flash_bwd_dq"] - c0["flash_bwd_dq"]
          == layers, f"train teacher: launch counts {c0} -> {c1}")
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    nk = float(torch.sqrt(sum(g.float().pow(2).sum() for g in gk)))
    npl = float(torch.sqrt(sum(g.float().pow(2).sum() for g in gp)))
    cos = {n: float(torch.nn.functional.cosine_similarity(
        a.flatten().float(), b.flatten().float(), dim=0))
        for n, a, b in zip(names, gk, gp)}
    worst = min(cos, key=cos.get)
    loss_rel = abs(lk - lp) / abs(lp)
    norm_rel = abs(nk - npl) / npl
    phase("train", f"teacher check, batch row {row} (1 x 2048, "
          f"{int((seq == PAD).sum())} pads): loss kernel {lk:.6f} plain "
          f"{lp:.6f} (rel {loss_rel:.2e}, tol {TEACHER_LOSS_REL}); grad norm "
          f"kernel {nk:.5f} plain {npl:.5f} (rel {norm_rel:.2e}, tol "
          f"{TEACHER_NORM_REL}); min per-tensor cosine {cos[worst]:.5f} "
          f"({worst}, tol {TEACHER_COS})")
    check(loss_rel <= TEACHER_LOSS_REL and norm_rel <= TEACHER_NORM_REL
          and cos[worst] >= TEACHER_COS, "train: teacher check failed")
    del plain, gk, gp, tr, model
    torch.cuda.empty_cache()

    # ---- the CLI end to end at a small size: 4 steps vs 2 + resume + 2 --
    from unilm_tpu_torch.runtime.checkpoint import CheckpointManager

    small = str(WORK / "small")
    write_corpus(small, 4096, 48, SEED + 1, lead_pad_first=False)
    base = ["--data", small, "--dim", "256", "--layers", "2", "--heads", "4",
            "--ffn", "1024", "--vocab", "4096", "--tokens_per_sample", "256",
            "--batch_size", "4", "--update_freq", "2", "--fused_ce",
            "--ce_chunk", "1024", "--warmup", "1", "--save_every", "2",
            "--log_every", "100", "--seed", str(SEED)]
    c0 = counts()
    train_gpt.main(base + ["--save_dir", str(WORK / "a"), "--max_steps", "4"])
    train_gpt.main(base + ["--save_dir", str(WORK / "b"), "--max_steps", "2"])
    train_gpt.main(base + ["--save_dir", str(WORK / "b"), "--max_steps", "4"])
    ran = {k: counts()[k] - c0[k] for k in ("flash_fwd", "flash_bwd_dq",
                                            "flash_bwd_dkv")}
    sa, _, ma = CheckpointManager(str(WORK / "a")).restore(4)
    sb, _, mbm = CheckpointManager(str(WORK / "b")).restore(4)
    same = all(torch.equal(sa["model"][k], sb["model"][k])
               for k in sa["model"])
    same_opt = all(torch.equal(a, b) for a, b in zip(
        sa["opt_state"]["mu"] + sa["opt_state"]["nu"],
        sb["opt_state"]["mu"] + sb["opt_state"]["nu"]))
    check(same and same_opt and ma == mbm and all(v > 0 for v in ran.values()),
          f"train: CLI resume not bit-equal (params {same}, optimizer "
          f"{same_opt}, loss {ma} vs {mbm}, launches {ran})")
    phase("train", f"CLI main() 2 layers E=256 on the card: 4 steps straight "
          f"and 2 + resume + 2 end bit-equal (params, optimizer, loss "
          f"{ma['loss']:.6f}); launches {ran}")
    shutil.rmtree(WORK, ignore_errors=True)
    return launches


def main() -> int:
    smi = phase_device()
    from unilm_tpu_torch.ops import flash_attention as fa
    from unilm_tpu_torch.ops import paged_attention as pa
    from unilm_tpu_torch.ops import quant as qm

    KERNELS.update({"flash_fwd": fa.KERNEL, "decode_attention": pa.KERNEL,
                    "decode_attention_int8": pa.KERNEL_INT8,
                    "int8_matmul": qm.KERNEL,
                    "paged_append_attention": pa.APPEND_KERNEL,
                    "flash_bwd_dq": fa.BWD_KERNEL_DQ,
                    "flash_bwd_dkv": fa.BWD_KERNEL_DKV})
    phase_build()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = [phase_flash(fa, g), *phase_flash_bwd(fa, g), phase_decode(pa, g),
               phase_decode_int8(pa, g), phase_int8_matmul(qm, g),
               phase_paged_append(pa, g)]
    launches = phase_slice(fa, pa)
    cfg, sd = engine_model()
    launches.update(phase_engine_int8(cfg, sd))
    launches.update(phase_engine_bf16_prefix(cfg, sd))
    del cfg, sd
    torch.cuda.empty_cache()
    launches.update(phase_train(fa))
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
        check(kern["launches"] > 0, f"{kern['name']} never launched")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
