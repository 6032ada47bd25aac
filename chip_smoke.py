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
    flash_tri (right after flash): the lower-triangle causal forward (#2)
    against flash_forward_tri_plain, bf16 (relative L2 <= 1e-2) and fp32
    (<= 1e-4), out and lse: T = S in {1, 63, 64, 65, 160, 1000, 2048}, D
    in {64, 96, 128}, with and without a key-padding mask (one example's
    row 0 sees no key: out 0, lse 0), bias None, [B,H,T,S], [1,H,T,S],
    [B,1,T,S]; then the train shape 2x2048x32x64 causal+kpm, timed beside
    #1 on the same inputs, the plain twin and sdpa(is_causal=True).
    flash_bwd_fused (right after flash_bwd): the one-pass backward (#8)
    against flash_backward_fused_plain on #1's out and lse, bf16 and fp32,
    dq/dk/dv: causal + key-padding with a fully masked row, q_offset +
    kv_len, window, non-causal, ragged T != S, D in {64, 96, 128}; the
    train shape twice bit-equal, timed beside #6 + #7, the plain twin and
    sdpa's backward.
    encoder_bwd (right after encoder_attn): the encoder attention
    backward kernel (#4) against fused_encoder_backward_plain, bf16 and
    fp32, dq/dk/dv/dbias (relative L2 <= 1e-2 / 1e-4): bias None,
    [1,1,T,S], [1,H,T,S] (summed over the batch), [B,H,T,S], [B,1,T,S]
    (summed over the heads), ragged T != S, D in {64, 96, 128}, S up to
    2048, BEiT-B at B=256 (two runs bit-equal); timed at BEiT-B beside the
    plain twin and the backward of torch's scaled_dot_product_attention.
    encoder_attn (run after flash_bwd): the fused encoder attention
    kernel (#3) against its plain version, bf16 (relative L2 <= 1e-2) and
    fp32 (<= 1e-4): bias None, [1,1,T,S], [1,H,T,S], [B,H,T,S], ragged
    T != S, D in {64, 96, 128}, S up to 2048, BEiT-B 128x197x12x64 and
    BEiT-L/384 64x577x16x64; timed at BEiT-B beside the plain version and
    torch's scaled_dot_product_attention.
    doc_attn (after encoder_bwd): the doc attention kernel (#9) against
    doc_attention_plain, bf16 (relative L2 <= 1e-2) and fp32 (<= 1e-4):
    bias None, [1,1,T,S], [1,H,T,S], [B,H,T,S], head-major [H,B,T,S] and
    [H,1,T,S], with and without a key-padding mask (one example with
    every key masked), ragged T != S, D in {64, 96, 128}, S up to 2048, the
    Pix2Struct tower 1x2048x24x64 at scale 1.0 and the FUNSD shape
    32x709x12x64 (bf16, head-major bias, mask); timed there beside the
    plain version and SDPA with a float attn_mask.
    doc_bwd: its backward (#10) against doc_backward_plain over the same
    cases, dq/dk/dv/dbias (dbias reduced where the bias broadcasts), the
    FUNSD shape twice bit-equal; timed beside the plain twin and SDPA's
    backward with the float mask's gradient.
 4. decode: the bf16 run-decode kernel against its plain version, B=3
    with lengths {0, 511, 1800}; written pool rows bit-equal.
 5. slice: the Kosmos-2.5 text decoder at full width (24 layers, E=1536,
    16 heads, FFN 6144, vocab 108481, bf16, random weights from a seed)
    serves three requests through runtime.generate (2052-token multimodal
    prompt, 32 greedy tokens): B=1, B=2, B=1. The launch counters must
    show every prefill layer and every decode step's layers went through
    the kernels; a teacher-forced run of the plain path must agree.
    Prints TTFT and ms/token for the kernel path and the plain path.
    beit_eval: BEiT-B/224 at bench.py line 1's configuration (B=128,
    bf16, per-layer rel-pos bias, random weights from the seed) through
    cli/run_class_finetuning's evaluation loop on synthetic normalized
    images: exactly 12 launches of #3 and none of #1 per forward; img/s
    and ms/batch over 10 batches (CUDA events); a teacher check against
    the plain path; a device-time profile.
    beit_train: BEiT-B/224 fine-tuning at benchmarks/train_mfu.py
    bench_beit's configuration (B=256, bf16 / fp32 params, drop-path 0.1,
    EMA 0.9999, clip 3.0, 1000 classes) through
    cli/train_classification's build_trainer with the CLI's defaults
    (layer decay 0.9, mixup 0.8, cutmix 1.0, smoothing 0.1) on synthetic
    normalized images: 6 steps, the last 4 timed (CUDA events); exactly 12
    launches of #3 and 12 of #4 per step and none of #1/#6/#7; ms/step,
    img/s, model TFLOP/s (train_mfu.py's count), peak memory; a
    device-time profile (#3, #4, cuBLAS, elementwise, optimizer + EMA);
    a kernel-vs-plain teacher check on one batch (same mixup draw and
    drop-path flags); the plain path's step; then two
    BeitForMaskedImageModeling steps at bench_beit_pretrain's
    configuration (shared rel-pos bias, 75 blockwise-masked patches,
    vocab 8192), 12 + 12 launches per step.
    layoutlmv3_eval: LayoutLMv3-B at cli/run_funsd.py's configuration
    (float32, 7 labels, batch 8, max_len 512 + 197 visual tokens, random
    weights from the seed) through the CLI's evaluate_batches on synthetic
    documents with segment ids: exactly 12 launches of #9 and none of
    #1/#3 per forward; docs/s and ms/batch (CUDA events); a teacher check
    against the plain path; a device-time profile.
    layoutlmv3_train: LayoutLMv3-B fine-tuning at bench_layoutlmv3's
    configuration (B=32, 512 + 197 tokens, bf16 / fp32 params, fused
    head-major bias, AdamW lr 1e-5 wd 0.01, clip 1.0) through
    runtime.train.make_train_step: 6 steps, the last 4 timed; exactly 12
    launches of #9 and 12 of #10 per step, none of #1/#3/#4/#6/#7; ms/step,
    docs/s, model TFLOP/s, peak memory, a device-time profile, the bias
    lookup + table contraction alone, a kernel-vs-plain teacher check
    (the three bias tables' gradient cosines named), the plain path's step.
    ttft: kosmos2_5(bf16) with its Pix2Struct tower, as
    benchmarks/kosmos_ttft.py runs it: encode_image over 4096 patch
    slots, then the 2052-token prefill to the first token; exactly 43
    launches of #1 (18 tower layers, the resampler, 24 decoder layers)
    and none of #3; features and first-token logits against the plain
    path; then encode_image at 1024 patch slots: 18 launches of #9 in the
    tower, #1 only in the resampler, features against the plain path;
    TTFT for both paths; a device-time profile.
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
    train_schedules (inside train, on its trainer and model, before the
    teacher check): UNILM_TPU_TRI_FLASH and UNILM_TPU_FUSED_BWD set (and
    restored after), 4 more optimizer steps on the same batch; every step
    must launch #2 and #8 24 x 4 times and #1/#6/#7 never; loss and grad
    norm finite, loss falling from step 2 on; ms/step, tokens/s, model
    TFLOP/s, peak memory, a device-time profile (#2, #8, cuBLAS, other,
    optimizer), and a teacher check of one microbatch under both
    schedules against the default kernels at the train phase's bounds.
Then a JSON line with each kernel's launches (from its main-path phase,
counters set to 0 just before it: slice for flash_fwd and decode,
beit_eval for encoder_attention, beit_train for encoder_attention_bwd,
layoutlmv3_eval for doc_attention, layoutlmv3_train for doc_attention_bwd,
the engines for the int8 and block-table kernels, train for flash_bwd_dq
and flash_bwd_dkv, train_schedules for flash_tri and flash_bwd_fused),
error,
times (kernel, plain version, and `library_ms`, one torch call computing
the same function where one exists, else null) and `bound_ms` /
`bound_by` (the larger of the bytes over 3.35 TB/s and the operations
over the data-sheet peak), the nvidia-smi line, and as the last line
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

# BEiT eval (bench.py line 1): BEiT-B/224, B=128, bf16. Teacher check,
# kernel path against plain path on one batch. Reading on an H100 80GB
# HBM3 at 700 W: max |dlogit| 0.0073 (logits up to 2.55), top-1 agreement
# 0.9766 (3 of 128 images flip between near-tied classes of the random
# head). Bounds at ~10x: |dlogit| 0.08, disagreement 0.25.
BEIT_BATCH, BEIT_BATCHES = 128, 10
BEIT_LOGIT_ATOL = 0.08
BEIT_TOP1_AGREE = 0.75
# BEiT-B fine-tuning (benchmarks/train_mfu.py bench_beit): B=256, 224^2,
# drop-path 0.1, EMA 0.9999, clip 3.0, through cli/train_classification
# with its defaults (layer decay 0.9, mixup 0.8, cutmix 1.0, smoothing
# 0.1). Teacher check, kernel path against plain path on one batch with the
# same mixup draws and drop-path flags: loss, global grad norm, and the
# minimum per-tensor gradient cosine over every parameter but the key
# biases (their gradient is zero up to rounding: a key bias shifts every
# score of a row alike). Readings on an H100 80GB HBM3 at 700 W: loss rel
# 6.11e-6 / 3.05e-6, grad-norm rel 2.56e-6 / 7.41e-6, min cosine 0.99980 /
# 0.99979 (at the cls token), with #4 on fp32 CUDA cores / on the tensor
# cores. Bounds at ~10x the larger reading:
BEIT_TRAIN_BATCH, BEIT_TRAIN_STEPS, BEIT_TRAIN_TIMED = 256, 6, 4
BEIT_TEACHER_LOSS_REL = 6e-5
BEIT_TEACHER_NORM_REL = 8e-5
BEIT_TEACHER_COS = 0.998
# bench_beit_pretrain: 75 blockwise-masked patches of 196, vocab 8192
BEIT_MASKED, BEIT_PRETRAIN_STEPS = 75, 2
# Kosmos-2.5 TTFT (benchmarks/kosmos_ttft.py): 4096 patch slots, of which a
# 62 x 64 grid is the image and the rest padding; the tower's features and
# the first token's logits, kernel path against plain path. Readings on an
# H100 80GB HBM3 at 700 W: resampled features max|err| 0.0004, first-token
# logits 0.0835, the same first token. Bounds at ~10x. The tower's own
# output differs more (relative L2 0.227): the plain path rounds the
# unscaled (attn_scale 1.0) scores to bf16, as the JAX reference does, the
# kernel keeps them in fp32. So both bf16 towers are held against the
# tower in float32 on the plain path, and the kernel's must be the closer.
TTFT_PATCHES, TTFT_GRID = 4096, (62, 64)
TOWER_PAD = TTFT_PATCHES - TTFT_GRID[0] * TTFT_GRID[1]  # padded slots
TTFT_FEAT_ATOL = 0.004
TTFT_LOGIT_ATOL = 0.8

# The Kosmos-2.5 tower at 1024 patch slots (a 30 x 32 grid and padding):
# <= 2048 slots, so its masked attention takes the doc kernel (#9).
TOWER_SLOTS, TOWER_GRID = 1024, (30, 32)
# LayoutLMv3-B FUNSD eval (cli/run_funsd.py: float32, batch 8, max_len
# 512, with the image). Teacher check, kernel path (#9 on fp32 CUDA cores)
# against plain path on one batch, over the labelled tokens; both fp32,
# differing in summation order and the exp2 against the exp domain.
# Reading on an H100 80GB HBM3 at 700 W: max |dlogit| 4.34e-6 (logits up
# to 1.98), argmax agreement 1.0. Bounds: |dlogit| at ~10x, agreement 0.99.
LV3_EVAL_BATCHES = 10
LV3_EVAL_LOGIT_ATOL = 4e-5
LV3_EVAL_AGREE = 0.99
# LayoutLMv3-B FUNSD fine-tuning (benchmarks/train_mfu.py bench_layoutlmv3):
# B=32, bf16. Teacher check, kernel path against plain path on one batch:
# loss, global grad norm, and the minimum per-tensor gradient cosine over
# every parameter but the key biases (zero gradient up to rounding).
# Readings on an H100 80GB HBM3 at 700 W, two runs (the 6 steps before
# the check are not bit-reproducible, so the compared state differs from
# run to run): loss rel 1.91e-5 / 4.16e-5, grad-norm rel 5.00e-5 /
# 2.22e-4, min cosine 0.99992 / 0.99992 (word_embeddings), the three bias
# tables' cosines 1.00000. Bounds at ~10x the larger deviation:
LV3_TRAIN_BATCH, LV3_TRAIN_STEPS, LV3_TRAIN_TIMED = 32, 6, 4
LV3_TEACHER_LOSS_REL = 4e-4
LV3_TEACHER_NORM_REL = 2e-3
LV3_TEACHER_COS = 0.999

# The card's published peaks (NVIDIA H100 SXM data sheet, dense): a
# kernel's bound is the larger of its bytes over the memory rate and its
# operations over the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}

KERNELS = {}  # JSON name -> CudaKernel (its launch counter)


def roofline(nbytes: float, ops: float, kind: str = "bf16") -> dict:
    """{"bound_ms", "bound_by"}: the least time the card could take to move
    `nbytes` once and do `ops` operations of type `kind`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def sdpa(q, k, v, **kw):
    """torch's scaled_dot_product_attention on [B, T, H, D] tensors: the
    library yardstick (library_ms), timed here and used nowhere in the
    port."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)


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

    # (B, T, S, H, D, causal, q_offset, kv_len, window, kpm, bias, scaled)
    # kpm "rand": random keys masked and one batch row wholly; "tail": the
    # last TOWER_PAD keys, as the Pix2Struct tower's padded patch slots.
    # scaled: q times D^-0.5; the tower's attention is unscaled (scale 1.0).
    cases = [
        (2, 200, 200, 4, 64, True, 0, None, 0, None, None, True),
        (2, 70, 263, 4, 96, True, 193, None, 0, None, None, True),
        (2, 131, 300, 2, 96, True, 0, 217, 0, None, None, True),
        (2, 97, 150, 2, 128, False, 0, None, 0, "rand", None, True),
        (2, 120, 120, 4, 96, True, 0, None, 0, None, "1H", True),
        (3, 100, 77, 4, 64, False, 0, None, 0, None, "B1", True),
        (2, 300, 300, 2, 96, True, 0, None, 50, None, None, True),
        (2, 45, 45, 2, 128, True, 0, None, 0, "rand", "1H", True),
        (1, PROMPT, PROMPT, 16, 96, True, 0, None, 0, None, None, True),
        # the main path's other two shapes: the tower and the resampler
        (1, TTFT_PATCHES, TTFT_PATCHES, 24, 64, False, 0, None, 0, "tail",
         None, False),
        (1, IMAGE_TOKENS, IMAGE_TOKENS + TTFT_PATCHES, 16, 96, False, 0, None,
         0, None, None, True),
    ]
    worst = 0.0
    for B, T, S, H, D, causal, qoff, kvl, window, kpm, bias, scaled in cases:
        q = rn(B, T, H, D) * (D ** -0.5 if scaled else 1.0)
        k, v = rn(B, S, H, D), rn(B, S, H, D)
        mask = None
        if kpm == "rand":
            mask = torch.rand(B, S, generator=g, device=dev) > 0.3
            mask[-1] = False  # one batch row fully masked -> out 0, lse 0
        elif kpm == "tail":
            mask = torch.ones(B, S, dtype=torch.bool, device=dev)
            mask[:, S - TOWER_PAD:] = False
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
        if kpm == "rand":
            check(bool((out[-1] == 0).all() and (lse[-1] == 0).all()),
                  "flash: fully masked row is not out=0, lse=0")
        desc = (f"B{B} T{T} S{S} H{H} D{D} causal={causal} q_offset={qoff} "
                f"kv_len={kvl} window={window} kpm={kpm} bias={bias} "
                f"q_scale={'D^-0.5' if scaled else 1.0}")
        check(ok_o and ok_l, f"flash {desc}: out err {e_o}, lse err {e_l}")
        worst = max(worst, e_o)
        phase("flash", f"{desc}: out max|err| {e_o:.3g}, lse max|err| "
              f"{e_l:.3g} ok")

    q = rn(1, PROMPT, 16, 96) * 96 ** -0.5
    k, v = rn(1, PROMPT, 16, 96), rn(1, PROMPT, 16, 96)
    ms = cuda_ms(lambda: fa.flash_forward(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: fa.flash_forward_plain(q, k, v, causal=True))
    lib_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=True, scale=1.0))
    out, lse = fa.flash_forward(q, k, v, causal=True)
    pairs = PROMPT * (PROMPT + 1) / 2 * 16  # visible (query, key) pairs
    bd = roofline(nbytes(q, k, v, out, lse), 4 * pairs * 96)
    phase("flash", f"1x{PROMPT}x16x96 causal bf16: kernel {ms:.4f} ms, "
          f"plain twin {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
          f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")

    # the tower's shape, where #1 spends most of TTFT: unscaled q, the last
    # TOWER_PAD keys masked (sdpa takes the mask as a boolean attn_mask)
    S = TTFT_PATCHES
    q, k, v = rn(1, S, 24, 64), rn(1, S, 24, 64), rn(1, S, 24, 64)
    mask = torch.ones(1, S, dtype=torch.bool, device=dev)
    mask[:, S - TOWER_PAD:] = False
    t_ms = cuda_ms(lambda: fa.flash_forward(q, k, v, None, mask))
    t_plain = cuda_ms(lambda: fa.flash_forward_plain(q, k, v, None, mask))
    t_lib = cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask[:, None, None, :],
                                 scale=1.0))
    out, lse = fa.flash_forward(q, k, v, None, mask)
    t_bd = roofline(nbytes(q, k, v, mask, out, lse),
                    4 * S * (S - TOWER_PAD) * 24 * 64)
    phase("flash", f"1x{S}x24x64 tower (kpm, scale 1.0) bf16: kernel "
          f"{t_ms:.4f} ms, plain twin {t_plain:.4f} ms, sdpa {t_lib:.4f} ms, "
          f"bound {t_bd['bound_ms']:.4f} ms ({t_bd['bound_by']})")
    return {"name": "flash_fwd", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "unilm_tpu/ops/flash_attention.py:99",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, **bd,
            "shape": f"1x{PROMPT}x16x96 causal bf16",
            "tower_ms": t_ms, "tower_plain_ms": t_plain,
            "tower_library_ms": t_lib, "tower_bound_ms": t_bd["bound_ms"]}


def rel_l2(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.float(), ref.float()
    return float((x - ref).norm() / ref.norm().clamp(min=1e-30))


# The train shape of the 1.3B UniGPT's attention (2 sequences of 2048, 32
# heads of 64), where the two opt-in schedules are timed.
TRAIN_ATTN = (2, 2048, 32, 64)


def train_attn_inputs(g, with_do: bool = False):
    """q (scaled by D^-0.5), k, v[, dO] bf16 at TRAIN_ATTN and the train
    batch's key-padding mask (example 1's first 3 keys are pads)."""
    B, T, H, D = TRAIN_ATTN
    dev, bf = "cuda", torch.bfloat16
    rn = lambda: torch.randn(B, T, H, D, generator=g, device=dev).to(bf)
    q, k, v = rn() * D ** -0.5, rn(), rn()
    mask = torch.ones(B, T, dtype=torch.bool, device=dev)
    mask[1, :3] = False
    return (q, k, v, rn(), mask) if with_do else (q, k, v, mask)


def causal_pairs(mask: torch.Tensor, H: int) -> float:
    """Visible (query, key) pairs of a causal self-attention over the
    key-padding mask [B, T]: row t sees the valid keys 0..t."""
    return float(mask.int().cumsum(1).sum()) * H


def phase_flash_tri(fa, g) -> dict:
    """Kernel #2 against flash_forward_tri_plain, bf16 (relative L2 <=
    1e-2) and fp32 (<= 1e-4), out and lse: T = S in {1, 63, 64, 65, 160,
    1000, 2048}, D in {64, 96, 128}, with and without a key-padding mask
    (example 1's first key masked, so its row 0 sees no key), bias None,
    [B,H,T,S], [1,H,T,S], [B,1,T,S]; then the train shape, timed beside #1
    at the same shape, the plain twin and sdpa(is_causal=True)."""
    dev = "cuda"
    Ts, Ds = (1, 63, 64, 65, 160, 1000, 2048), (64, 96, 128)
    biases = (None, "BH", "1H", "B1")
    B, H = 2, 4
    worst = 0.0
    for dtype, bound in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        def rn(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dtype)

        for i in range(14):  # every T twice, every D, mask and bias kind
            T, D = Ts[i % 7], Ds[i % 3]
            kpm, bias = bool(i % 2), biases[(i // 2) % 4]
            q, k, v = rn(B, T, H, D) * D ** -0.5, rn(B, T, H, D), rn(B, T, H, D)
            mask = None
            if kpm:
                mask = torch.rand(B, T, generator=g, device=dev) > 0.3
                mask[0, 0] = True
                mask[1, 0] = False
            b = {None: None, "BH": (B, H), "1H": (1, H), "B1": (B, 1)}[bias]
            b = None if b is None else rn(*b, T, T)
            out, lse = fa.flash_forward_tri(q, k, v, b, mask)
            ref, ref_lse = fa.flash_forward_tri_plain(q, k, v, b, mask)
            torch.cuda.synchronize()
            desc = (f"{str(dtype)[6:]} B{B} T{T} H{H} D{D} kpm={kpm} "
                    f"bias={bias}")
            check(bool(torch.isfinite(out.float()).all()),
                  f"flash_tri {desc}: non-finite")
            r_o, r_l = rel_l2(out, ref), rel_l2(lse, ref_lse)
            check(r_o <= bound and r_l <= bound,
                  f"flash_tri {desc}: rel L2 out {r_o} lse {r_l} (bound "
                  f"{bound})")
            if kpm:
                check(bool((out[1, 0] == 0).all() and (lse[1, :, 0] == 0).all()),
                      f"flash_tri {desc}: the row with no key is not out=0, "
                      "lse=0")
            e = float((out.float() - ref.float()).abs().max())
            if dtype == torch.bfloat16:
                worst = max(worst, e)
            phase("flash_tri", f"{desc}: rel L2 out {r_o:.2e} lse {r_l:.2e}, "
                  f"max|err| {e:.3g} ok")

    # the train shape: checked, then timed beside #1 on the same inputs
    q, k, v, mask = train_attn_inputs(g)
    B, T, H, D = q.shape
    out, lse = fa.flash_forward_tri(q, k, v, None, mask)
    ref, ref_lse = fa.flash_forward_tri_plain(q, k, v, None, mask)
    r_o, r_l = rel_l2(out, ref), rel_l2(lse, ref_lse)
    check(r_o <= 1e-2 and r_l <= 1e-2,
          f"flash_tri train shape: rel L2 out {r_o} lse {r_l}")
    worst = max(worst, float((out.float() - ref.float()).abs().max()))
    del ref, ref_lse
    ms = cuda_ms(lambda: fa.flash_forward_tri(q, k, v, None, mask))
    fwd_ms = cuda_ms(lambda: fa.flash_forward(q, k, v, None, mask,
                                              causal=True))
    plain_ms = cuda_ms(lambda: fa.flash_forward_tri_plain(q, k, v, None, mask),
                       iters=3)
    lib_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=True, scale=1.0))
    ms2 = cuda_ms(lambda: fa.flash_forward_tri(q, k, v, None, mask))
    pairs = causal_pairs(mask, H)
    bd = roofline(nbytes(q, k, v, mask, out, lse), 4 * pairs * D)
    phase("flash_tri", f"{B}x{T}x{H}x{D} causal+kpm bf16: rel L2 out "
          f"{r_o:.2e} lse {r_l:.2e}; kernel #2 {ms:.4f} / {ms2:.4f} ms "
          f"({4 * pairs * D / ms / 1e9:.1f} TFLOP/s), #1 {fwd_ms:.4f} ms, "
          f"plain twin {plain_ms:.4f} ms, sdpa(is_causal) {lib_ms:.4f} ms, "
          f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    return {"name": "flash_tri", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/flash_tri.cu",
            "replaces": "unilm_tpu/ops/flash_attention.py:404",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, **bd, "flash_fwd_ms": fwd_ms,
            "shape": f"{B}x{T}x{H}x{D} causal+kpm bf16 (flash_fwd_ms: #1 on "
            "the same inputs)"}


def phase_flash_bwd_fused(fa, g) -> dict:
    """Kernel #8 against flash_backward_fused_plain on the forward kernel's
    out and lse, bf16 and fp32, dq/dk/dv at the flash_bwd bounds; then the
    train shape twice bit-equal, timed beside #6 + #7, the plain twin and
    sdpa's backward."""
    dev = "cuda"
    # (B, T, S, H, D, causal, q_offset, kv_len, window, kpm)
    cases = [
        (2, 200, 200, 4, 64, True, 0, None, 0, True),
        (2, 70, 263, 4, 96, True, 193, None, 0, False),
        (2, 131, 300, 2, 96, True, 40, 217, 0, False),
        (2, 300, 300, 2, 128, True, 0, None, 50, False),
        (2, 97, 150, 2, 128, False, 0, None, 0, True),
        (2, 160, 96, 4, 64, False, 0, None, 0, False),
        (2, 1000, 1000, 2, 64, True, 0, None, 0, True),
    ]
    worst = 0.0
    for dtype, bound in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        def rn(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dtype)

        for B, T, S, H, D, causal, qoff, kvl, window, kpm in cases:
            q = rn(B, T, H, D) * D ** -0.5
            k, v, do = rn(B, S, H, D), rn(B, S, H, D), rn(B, T, H, D)
            mask = None
            if kpm:
                mask = torch.rand(B, S, generator=g, device=dev) > 0.3
                mask[-1] = False  # one batch row fully masked
            kw = dict(causal=causal, window=window)
            out, lse = fa.flash_forward(q, k, v, None, mask, qoff, kvl, **kw)
            got = fa.flash_backward_fused(q, k, v, mask, qoff, kvl, out, lse,
                                          do, **kw)
            ref = fa.flash_backward_fused_plain(q, k, v, mask, qoff, kvl, out,
                                                lse, do, **kw)
            torch.cuda.synchronize()
            desc = (f"{str(dtype)[6:]} B{B} T{T} S{S} H{H} D{D} "
                    f"causal={causal} q_offset={qoff} kv_len={kvl} "
                    f"window={window} kpm={kpm}")
            errs = []
            for name, x, r in zip(("dq", "dk", "dv"), got, ref):
                check(tuple(x.shape) == tuple(r.shape)
                      and bool(torch.isfinite(x.float()).all()),
                      f"flash_bwd_fused {desc}: {name} shape/finite")
                ok, e, rel = grad_close(x, r, bound)
                check(ok, f"flash_bwd_fused {desc}: {name} max|err| {e} rel "
                      f"L2 {rel} (bound {bound})")
                errs.append(f"{name} {e:.3g}/{rel:.2g}")
                if dtype == torch.bfloat16:
                    worst = max(worst, e)
            if kpm:
                check(bool((got[0][-1] == 0).all() and (got[1][-1] == 0).all()),
                      f"flash_bwd_fused {desc}: fully masked row has "
                      "gradients")
            phase("flash_bwd_fused", f"{desc}: max|err|/rel L2 "
                  f"{', '.join(errs)} ok")

    # the train shape: checked, bit-equal twice, timed
    q, k, v, do, mask = train_attn_inputs(g, with_do=True)
    B, T, H, D = q.shape
    out, lse = fa.flash_forward(q, k, v, None, mask, causal=True)
    fused = lambda: fa.flash_backward_fused(q, k, v, mask, 0, None, out, lse,
                                            do, causal=True)
    pair = lambda: fa.flash_backward(q, k, v, None, mask, 0, None, out, lse,
                                     do, causal=True)
    plain = lambda: fa.flash_backward_fused_plain(q, k, v, mask, 0, None, out,
                                                  lse, do, causal=True)
    got, again, ref = fused(), fused(), plain()
    torch.cuda.synchronize()
    errs = []
    for name, x, x2, r in zip(("dq", "dk", "dv"), got, again, ref):
        check(torch.equal(x, x2), f"flash_bwd_fused train shape: {name} "
              "differs between two runs")
        ok, e, rel = grad_close(x, r, 1e-2)
        check(ok, f"flash_bwd_fused train shape: {name} max|err| {e} rel L2 "
              f"{rel} (bound 1e-2)")
        errs.append(f"{name} {e:.3g}/{rel:.2g}")
        worst = max(worst, e)
    check(bool((got[0][1, :3] == 0).all()), "flash_bwd_fused train shape: "
          "the fully masked leading rows have a dq")
    del got, again, ref
    ms = cuda_ms(fused)
    pair_ms = cuda_ms(pair)
    plain_ms = cuda_ms(plain, iters=3)
    ms2 = cuda_ms(fused)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    amask = causal[None, None] & mask[:, None, None, :]
    o = sdpa(qg, kg, vg, attn_mask=amask, scale=1.0)
    dot = do.transpose(1, 2)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), dot,
                                                 retain_graph=True), iters=5)
    del o, qg, kg, vg, amask
    pairs = causal_pairs(mask, H)
    delta = fa._delta(out, do)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    bd = roofline(nbytes(q, k, v, do, lse, delta, mask.int(), dq, dk, dv),
                  5 * 2 * pairs * D)
    phase("flash_bwd_fused", f"{B}x{T}x{H}x{D} causal+kpm bf16 (rows 0-2 of "
          f"example 1 fully masked): max|err|/rel L2 {', '.join(errs)}, two "
          f"runs bit-equal; kernel #8 {ms:.4f} / {ms2:.4f} ms "
          f"({10 * pairs * D / ms / 1e9:.1f} TFLOP/s), #6 + #7 {pair_ms:.4f} "
          f"ms, plain twin {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms, "
          f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    return {"name": "flash_bwd_fused", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/flash_bwd_fused.cu",
            "replaces": "unilm_tpu/ops/flash_attention.py:1520",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, **bd, "flash_bwd_pair_ms": pair_ms,
            "shape": f"{B}x{T}x{H}x{D} causal+kpm bf16 (ms with delta and "
            "the dq cast; flash_bwd_pair_ms: #6 + #7 on the same inputs)"}


def phase_encoder_attn(fa, g) -> dict:
    """Kernel #3 against fused_encoder_attention_plain on the same inputs,
    bf16 (relative L2 <= 1e-2) and fp32 (<= 1e-4): bias None, [1,1,T,S],
    [1,H,T,S] and [B,H,T,S], ragged T != S, D in {64, 96, 128}, S up to
    2048, the BEiT-B and the BEiT-L/384 shapes; then timed at BEiT-B."""
    dev = "cuda"
    # (B, T, S, H, D, bias)
    cases = [
        (2, 197, 197, 4, 64, None), (2, 197, 197, 4, 64, "11"),
        (2, 197, 197, 4, 64, "1H"), (3, 100, 77, 4, 96, "BH"),
        (2, 37, 301, 2, 128, "1H"), (2, 301, 37, 2, 64, None),
        (2, 131, 93, 3, 96, "11"), (1, 50, 2048, 2, 64, "1H"),
        (1, 70, 1500, 2, 128, None),
        (BEIT_BATCH, 197, 197, 12, 64, "1H"),  # BEiT-B/224
        (64, 577, 577, 16, 64, "1H"),          # BEiT-L/384
    ]
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    worst_abs = 0.0
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        def rn(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dtype)

        for B, T, S, H, D, bias in cases:
            q, k, v = rn(B, T, H, D), rn(B, S, H, D), rn(B, S, H, D)
            b = {None: None, "11": (1, 1, T, S), "1H": (1, H, T, S),
                 "BH": (B, H, T, S)}[bias]
            b = None if b is None else 2 * rn(*b)
            out = fa.fused_encoder_attention(q, k, v, b)
            ref = fa.fused_encoder_attention_plain(q, k, v, b)
            torch.cuda.synchronize()
            e, err = rel_l2(out, ref), float((out.float() - ref.float())
                                             .abs().max())
            desc = (f"{str(dtype)[6:]} B{B} T{T} S{S} H{H} D{D} "
                    f"bias={bias}")
            check(bool(torch.isfinite(out.float()).all()) and e <= tol,
                  f"encoder_attn {desc}: rel L2 {e} (bound {tol})")
            worst[dtype] = max(worst[dtype], e)
            if dtype == torch.bfloat16:
                worst_abs = max(worst_abs, err)
            del q, k, v, b, out, ref
        phase("encoder_attn", f"{str(dtype)[6:]}: {len(cases)} cases, worst "
              f"rel L2 {worst[dtype]:.3g} (bound {tol}) ok")

    bf = torch.bfloat16
    B, T, H, D = BEIT_BATCH, 197, 12, 64
    q, k, v = (torch.randn(B, T, H, D, generator=g, device=dev).to(bf)
               for _ in range(3))
    b = torch.randn(1, H, T, T, generator=g, device=dev).to(bf)
    times = {}
    for _ in range(2):
        for name, fn in (
                ("kernel", lambda: fa.fused_encoder_attention(q, k, v, b)),
                ("plain", lambda: fa.fused_encoder_attention_plain(q, k, v,
                                                                   b))):
            times[name] = cuda_ms(fn, iters=20)
    lib_ms = cuda_ms(lambda: sdpa(q, k, v, attn_mask=b), iters=20)
    out = fa.fused_encoder_attention(q, k, v, b)
    bd = roofline(nbytes(q, k, v, out, b), 4 * B * H * T * T * D)
    flops = 4 * B * H * T * T * D
    phase("encoder_attn", f"BEiT-B {B}x{T}x{H}x{D} bf16, bias [1,{H},{T},{T}]"
          f": kernel {times['kernel']:.4f} ms ({flops / times['kernel'] / 1e9:.1f}"
          f" TFLOP/s), plain {times['plain']:.4f} ms, sdpa {lib_ms:.4f} ms, "
          f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    return {"name": "encoder_attention", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/encoder_attention.cu",
            "replaces": "unilm_tpu/ops/flash_attention.py:580",
            "max_abs_err": worst_abs, "rel_l2_bf16": worst[torch.bfloat16],
            "rel_l2_fp32": worst[torch.float32], "ms": times["kernel"],
            "plain_ms": times["plain"], "library_ms": lib_ms, **bd,
            "shape": f"{B}x{T}x{H}x{D} bf16 bias [1,{H},{T},{T}]"}


def phase_encoder_bwd(fa, g) -> dict:
    """Kernel #4 against fused_encoder_backward_plain on the same inputs,
    bf16 and fp32: dq, dk, dv and dbias, each held by grad_close at 1e-2
    (bf16) or 1e-4 (fp32). Both compute p, dp and ds in fp32 from the same
    inputs and round ds and p to the inputs' type at the same places; they
    differ only in summation order and in the exp2 against the exp domain,
    so an element of ds or p can land on the other side of a bf16 rounding
    boundary (2^-8 relative) and the products differ by a few such ulps:
    1e-2 relative L2 in bf16, 1e-4 in fp32 (no rounding step at all).
    Cases: every bias broadcast ([1,1], [1,H] summed over the batch, [B,H],
    [B,1] summed over the heads), ragged T != S, D in {64, 96, 128}, S up
    to 2048, and BEiT-B at B=256, which two runs must give bit-equal. Then
    timed at BEiT-B beside the plain twin and sdpa's backward."""
    dev = "cuda"
    # (B, T, S, H, D, bias)
    cases = [
        (2, 197, 197, 4, 64, None), (2, 197, 197, 4, 64, "11"),
        (3, 197, 197, 4, 64, "1H"), (3, 100, 77, 4, 96, "BH"),
        (2, 77, 100, 4, 64, "B1"), (2, 37, 301, 2, 128, "1H"),
        (2, 301, 37, 2, 64, None), (2, 131, 93, 3, 96, "11"),
        (1, 50, 2048, 2, 64, "1H"), (2, 70, 1500, 2, 128, "B1"),
        (2, 64, 2048, 2, 128, "BH"),
        (BEIT_TRAIN_BATCH, 197, 197, 12, 64, "1H"),  # BEiT-B fine-tuning
    ]
    shapes = {None: None, "11": lambda B, H, T, S: (1, 1, T, S),
              "1H": lambda B, H, T, S: (1, H, T, S),
              "BH": lambda B, H, T, S: (B, H, T, S),
              "B1": lambda B, H, T, S: (B, 1, T, S)}
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    worst_abs = 0.0
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        def rn(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dtype)

        for B, T, S, H, D, bias in cases:
            q, k, v, do = rn(B, T, H, D), rn(B, S, H, D), rn(B, S, H, D), \
                rn(B, T, H, D)
            b = None if bias is None else 2 * rn(*shapes[bias](B, H, T, S))
            got = fa.fused_encoder_backward(q, k, v, b, do)
            ref = fa.fused_encoder_backward_plain(q, k, v, b, do)
            torch.cuda.synchronize()
            desc = (f"{str(dtype)[6:]} B{B} T{T} S{S} H{H} D{D} "
                    f"bias={bias}")
            for name, x, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
                if r is None:
                    check(x is None, f"encoder_bwd {desc}: {name} not None")
                    continue
                check(x.dtype == r.dtype and x.shape == r.shape,
                      f"encoder_bwd {desc}: {name} {x.dtype} {tuple(x.shape)}"
                      f" vs {r.dtype} {tuple(r.shape)}")
                ok, e, rel = grad_close(x, r, tol)
                check(bool(torch.isfinite(x).all()) and ok,
                      f"encoder_bwd {desc}: {name} max|err| {e} rel L2 {rel}"
                      f" (bound {tol})")
                worst[dtype] = max(worst[dtype], rel)
                if dtype == torch.bfloat16:
                    worst_abs = max(worst_abs, e)
            beit_b = (B, T, H) == (BEIT_TRAIN_BATCH, 197, 12)
            if dtype == torch.bfloat16 and beit_b:
                again = fa.fused_encoder_backward(q, k, v, b, do)
                check(all(torch.equal(x, y) for x, y in zip(got, again)),
                      "encoder_bwd: two runs at BEiT-B differ")
            del q, k, v, do, b, got, ref
        phase("encoder_bwd", f"{str(dtype)[6:]}: {len(cases)} cases, dq/dk/"
              f"dv/dbias worst rel L2 {worst[dtype]:.3g} (bound {tol}) ok"
              + ("; BEiT-B bit-equal across two runs"
                 if dtype == torch.bfloat16 else ""))

    bf = torch.bfloat16
    B, T, H, D = BEIT_TRAIN_BATCH, 197, 12, 64
    q, k, v, do = (torch.randn(B, T, H, D, generator=g, device=dev).to(bf)
                   for _ in range(4))
    b = torch.randn(1, H, T, T, generator=g, device=dev).to(bf)
    times = {}
    for _ in range(2):
        for name, fn in (
                ("kernel", lambda: fa.fused_encoder_backward(q, k, v, b, do)),
                ("plain", lambda: fa.fused_encoder_backward_plain(q, k, v, b,
                                                                  do))):
            times[name] = cuda_ms(fn, iters=10)
    # the yardstick: the backward alone of torch's SDPA with the bias as a
    # float mask that needs a gradient, one saved graph
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    bg = b.detach().clone().requires_grad_()
    o = sdpa(qg, kg, vg, attn_mask=bg)
    backend = type(o.grad_fn).__name__
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        o, (qg, kg, vg, bg), do.transpose(1, 2), retain_graph=True), iters=10)
    del o, qg, kg, vg, bg
    # the batch sum of dbias with 16x fewer dq blocks (more batch items per
    # block, fewer partial planes): the setting fa.DBIAS_BLOCKS chose against
    blocks = fa.DBIAS_BLOCKS
    fa.DBIAS_BLOCKS = blocks // 16
    fewer_ms = cuda_ms(lambda: fa.fused_encoder_backward(q, k, v, b, do),
                       iters=10)
    fa.DBIAS_BLOCKS = blocks
    dq, dk, dv, dbias = fa.fused_encoder_backward(q, k, v, b, do)
    flops = 10 * B * H * T * T * D
    bd = roofline(nbytes(q, k, v, do, b, dq, dk, dv, dbias), flops)
    phase("encoder_bwd", f"BEiT-B {B}x{T}x{H}x{D} bf16, bias [1,{H},{T},{T}]"
          f": kernel {times['kernel']:.4f} ms ({flops / times['kernel'] / 1e9:.1f}"
          f" TFLOP/s; {fewer_ms:.4f} ms with DBIAS_BLOCKS {blocks // 16} in "
          f"place of {blocks}), plain {times['plain']:.4f} ms, sdpa backward "
          f"{lib_ms:.4f} ms ({backend}), bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']})")
    return {"name": "encoder_attention_bwd", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/encoder_attention_bwd.cu",
            "replaces": "unilm_tpu/ops/flash_attention.py:711",
            "max_abs_err": worst_abs, "rel_l2_bf16": worst[torch.bfloat16],
            "rel_l2_fp32": worst[torch.float32], "ms": times["kernel"],
            "plain_ms": times["plain"], "library_ms": lib_ms,
            "library": f"sdpa backward ({backend})", **bd,
            "shape": f"{B}x{T}x{H}x{D} bf16 bias [1,{H},{T},{T}]"}


# FUNSD fine-tuning shape (benchmarks/train_mfu.py bench_layoutlmv3): 512
# text tokens + 197 visual tokens, 12 heads of 64
DOC_B, DOC_T, DOC_H, DOC_D = 32, 709, 12, 64
# (B, T, S, H, D, bias, masked, scale): every bias broadcast, [B|1,H|1,T,S]
# and head-major [H,B|1,T,S]; with and without a key-padding mask (the
# last example of a masked case has every key masked); ragged T != S; D in
# {64, 96, 128}; S up to 2048; and every shape a main path gives the
# kernels: the Pix2Struct tower unscaled at 1024 slots (the ttft phase's
# encode_image) and 2048, the eval CLI's fp32 batch of 8, the FUNSD
# fine-tuning batch of 32 (bf16 only: no fp32 path runs it)
DOC_CASES = [
    (2, 37, 40, 4, 64, None, True, None), (2, 197, 197, 4, 64, "11", True, None),
    (2, 100, 77, 4, 96, "1H", True, None), (3, 70, 45, 4, 64, "BH", True, None),
    (2, 64, 200, 2, 128, "BH", False, None), (3, 129, 131, 4, 64, "hm", True, None),
    (2, 301, 37, 2, 96, "hm1", True, None), (1, 50, 2048, 2, 64, "hm1", True, None),
    (2, 64, 2048, 2, 128, "BH", True, None), (2, 77, 100, 4, 64, "hm", False, None),
    (1, 1024, 1024, 24, 64, None, True, 1.0),  # the Kosmos-2.5 tower
    (1, 2048, 2048, 24, 64, None, True, 1.0),
    (8, DOC_T, DOC_T, DOC_H, DOC_D, "hm", True, None),  # FUNSD eval (fp32)
    (DOC_B, DOC_T, DOC_T, DOC_H, DOC_D, "hm", True, None),  # FUNSD training
]


def doc_inputs(da, g, dtype, B, T, S, H, D, bias, masked):
    """q, k, v, dO, the bias (a HeadMajorBias for "hm"/"hm1") and the bool
    mask of a DOC_CASES entry, on the card."""
    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    q, k, v, do = rn(B, T, H, D), rn(B, S, H, D), rn(B, S, H, D), rn(B, T, H, D)
    shape = {None: None, "11": (1, 1, T, S), "1H": (1, H, T, S),
             "BH": (B, H, T, S), "hm": (H, B, T, S), "hm1": (H, 1, T, S)}[bias]
    b = None if shape is None else 2 * rn(*shape)
    if bias in ("hm", "hm1"):
        b = da.HeadMajorBias(b)
    mask = None
    if masked:
        mask = torch.rand(B, S, generator=g, device="cuda") > 0.2
        mask[:, 0] = True
        if B > 1:
            mask[-1] = False  # an example whose keys are all masked
    return q, k, v, do, b, mask


def doc_sdpa_mask(da, b, mask):
    """The doc call's bias and key-padding mask as one float [B, H, T, S]
    attn_mask for torch's SDPA: the bias permuted, -inf at masked keys."""
    bias = b.bhts() if isinstance(b, da.HeadMajorBias) else b
    neg = torch.zeros(mask.shape, dtype=bias.dtype, device=bias.device)
    neg.masked_fill_(~mask, float("-inf"))
    return (bias + neg[:, None, None, :]).contiguous()


def doc_desc(dtype, case):
    B, T, S, H, D, bias, masked, scale = case
    return (f"{str(dtype)[6:]} B{B} T{T} S{S} H{H} D{D} bias={bias} "
            f"mask={masked}" + ("" if scale is None else f" scale={scale}"))


def phase_doc_attn(da, g) -> dict:
    """Kernel #9 against doc_attention_plain on the same inputs, bf16
    (relative L2 <= 1e-2) and fp32 (<= 1e-4) over DOC_CASES, then timed at
    the FUNSD shape (bf16, head-major bias, mask) beside the plain version
    and torch's SDPA with a float attn_mask (the bias plus -inf at masked
    keys)."""
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    worst_abs = 0.0
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        n = 0
        for case in DOC_CASES:
            B, T, S, H, D, bias, masked, scale = case
            if dtype == torch.float32 and B == DOC_B:
                continue
            q, k, v, _, b, mask = doc_inputs(da, g, dtype, B, T, S, H, D, bias,
                                             masked)
            out = da.doc_attention(q, k, v, b, mask, scale)
            ref = da.doc_attention_plain(q, k, v, b, mask, scale)
            torch.cuda.synchronize()
            e = rel_l2(out, ref)
            check(bool(torch.isfinite(out.float()).all()) and e <= tol,
                  f"doc_attn {doc_desc(dtype, case)}: rel L2 {e} (bound {tol})")
            worst[dtype] = max(worst[dtype], e)
            if dtype == torch.bfloat16:
                worst_abs = max(worst_abs, float((out.float() - ref.float())
                                                 .abs().max()))
            n += 1
            del q, k, v, b, mask, out, ref
        phase("doc_attn", f"{str(dtype)[6:]}: {n} cases, worst rel L2 "
              f"{worst[dtype]:.3g} (bound {tol}) ok")

    B, T, H, D = DOC_B, DOC_T, DOC_H, DOC_D
    q, k, v, _, b, mask = doc_inputs(da, g, torch.bfloat16, B, T, T, H, D,
                                     "hm", True)
    mask[-1] = True  # every example with keys, as in the model
    am = doc_sdpa_mask(da, b, mask)
    times = {}
    for _ in range(2):
        for name, fn in (
                ("kernel", lambda: da.doc_attention(q, k, v, b, mask)),
                ("plain", lambda: da.doc_attention_plain(q, k, v, b, mask))):
            times[name] = cuda_ms(fn, iters=10)
    lib_ms = cuda_ms(lambda: sdpa(q, k, v, attn_mask=am), iters=10)
    out = da.doc_attention(q, k, v, b, mask)
    flops = 4 * B * H * T * T * D
    bd = roofline(nbytes(q, k, v, out, b.hbts, mask), flops)
    phase("doc_attn", f"FUNSD {B}x{T}x{H}x{D} bf16, head-major bias "
          f"[{H},{B},{T},{T}], mask: kernel {times['kernel']:.4f} ms "
          f"({flops / times['kernel'] / 1e9:.1f} TFLOP/s), plain "
          f"{times['plain']:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
          f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    return {"name": "doc_attention", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/doc_attention.cu",
            "replaces": "unilm_tpu/ops/doc_attention.py:69",
            "max_abs_err": worst_abs, "rel_l2_bf16": worst[torch.bfloat16],
            "rel_l2_fp32": worst[torch.float32], "ms": times["kernel"],
            "plain_ms": times["plain"], "library_ms": lib_ms, **bd,
            "shape": f"{B}x{T}x{H}x{D} bf16 bias [{H},{B},{T},{T}] + mask"}


def phase_doc_bwd(da, g) -> dict:
    """Kernel #10 against doc_backward_plain on the same inputs over
    DOC_CASES, bf16 and fp32: dq, dk, dv and dbias (ds, summed where the
    bias broadcasts), each held by grad_close at 1e-2 (bf16) or 1e-4
    (fp32), for the reasons phase_encoder_bwd gives; the FUNSD shape twice,
    bit-equal. Then timed at the FUNSD shape beside the plain twin and the
    backward of SDPA with the float mask's gradient."""
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    worst_abs = 0.0
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        n = 0
        for case in DOC_CASES:
            B, T, S, H, D, bias, masked, scale = case
            if dtype == torch.float32 and B == DOC_B:
                continue
            q, k, v, do, b, mask = doc_inputs(da, g, dtype, B, T, S, H, D,
                                              bias, masked)
            got = da.doc_backward(q, k, v, b, mask, do, scale)
            ref = da.doc_backward_plain(q, k, v, b, mask, do, scale)
            torch.cuda.synchronize()
            desc = doc_desc(dtype, case)
            for name, x, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
                if r is None:
                    check(x is None, f"doc_bwd {desc}: {name} not None")
                    continue
                check(x.dtype == r.dtype and x.shape == r.shape,
                      f"doc_bwd {desc}: {name} {x.dtype} {tuple(x.shape)} vs "
                      f"{r.dtype} {tuple(r.shape)}")
                ok, e, rel = grad_close(x, r, tol)
                check(bool(torch.isfinite(x.float()).all()) and ok,
                      f"doc_bwd {desc}: {name} max|err| {e} rel L2 {rel} "
                      f"(bound {tol})")
                worst[dtype] = max(worst[dtype], rel)
                if dtype == torch.bfloat16:
                    worst_abs = max(worst_abs, e)
            if B == DOC_B:
                again = da.doc_backward(q, k, v, b, mask, do, scale)
                check(all(torch.equal(x, y) for x, y in zip(got, again)),
                      "doc_bwd: two runs at the FUNSD shape differ")
                del again
            n += 1
            del q, k, v, do, b, mask, got, ref
        phase("doc_bwd", f"{str(dtype)[6:]}: {n} cases, dq/dk/dv/dbias worst "
              f"rel L2 {worst[dtype]:.3g} (bound {tol}) ok"
              + ("; FUNSD bit-equal across two runs"
                 if dtype == torch.bfloat16 else ""))

    B, T, H, D = DOC_B, DOC_T, DOC_H, DOC_D
    q, k, v, do, b, mask = doc_inputs(da, g, torch.bfloat16, B, T, T, H, D,
                                      "hm", True)
    mask[-1] = True
    times = {}
    for _ in range(2):
        for name, fn in (
                ("kernel", lambda: da.doc_backward(q, k, v, b, mask, do)),
                ("plain", lambda: da.doc_backward_plain(q, k, v, b, mask,
                                                        do))):
            times[name] = cuda_ms(fn, iters=5)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    am = doc_sdpa_mask(da, b, mask).requires_grad_()
    o = sdpa(qg, kg, vg, attn_mask=am)
    backend = type(o.grad_fn).__name__
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        o, (qg, kg, vg, am), do.transpose(1, 2), retain_graph=True), iters=5)
    del o, qg, kg, vg, am
    dq, dk, dv, dbias = da.doc_backward(q, k, v, b, mask, do)
    flops = 10 * B * H * T * T * D
    bd = roofline(nbytes(q, k, v, do, b.hbts, mask, dq, dk, dv, dbias), flops)
    phase("doc_bwd", f"FUNSD {B}x{T}x{H}x{D} bf16, head-major bias, mask: "
          f"kernel {times['kernel']:.4f} ms ({flops / times['kernel'] / 1e9:.1f}"
          f" TFLOP/s), plain {times['plain']:.4f} ms, sdpa backward "
          f"{lib_ms:.4f} ms ({backend}), bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']})")
    return {"name": "doc_attention_bwd", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/doc_attention_bwd.cu",
            "replaces": "unilm_tpu/ops/doc_attention.py:108",
            "max_abs_err": worst_abs, "rel_l2_bf16": worst[torch.bfloat16],
            "rel_l2_fp32": worst[torch.float32], "ms": times["kernel"],
            "plain_ms": times["plain"], "library_ms": lib_ms,
            "library": f"sdpa backward ({backend})", **bd,
            "shape": f"{B}x{T}x{H}x{D} bf16 bias [{H},{B},{T},{T}] + mask"}


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
    # the yardstick: one backward call of torch's SDPA on the same rows
    # (causal + the same key-padding mask as a boolean mask), dq, dk and dv
    # together
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    amask = causal[None, None] & mask[:, None, None, :]
    o = sdpa(qg, kg, vg, attn_mask=amask, scale=1.0)
    dot = do.transpose(1, 2)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), dot,
                                                 retain_graph=True), iters=5)
    del o, qg, kg, vg, amask
    pairs = float(mask.int().cumsum(1).sum()) * H  # visible (query, key)
    ins = nbytes(q, k, v, do, lse, delta, mi)
    bd_dq = roofline(ins + nbytes(dq), 3 * 2 * pairs * D)
    bd_dkv = roofline(ins + nbytes(dk, dv), 4 * 2 * pairs * D)
    phase("flash_bwd", f"sdpa backward (dq, dk, dv) {lib_ms:.3f} ms; bounds "
          f"dq {bd_dq['bound_ms']:.4f} ms ({bd_dq['bound_by']}), dk/dv "
          f"{bd_dkv['bound_ms']:.4f} ms ({bd_dkv['bound_by']})")
    common = {"route": "cuda", "source": "unilm_tpu_torch/csrc/flash_bwd.cu",
              "max_abs_err": worst, "plain_ms": times["plain"],
              "pair_ms": times["pair"], "library_ms": lib_ms,
              "shape": f"{B}x{T}x{H}x{D} causal+kpm bf16 (plain_ms is the "
              "whole plain backward, library_ms one sdpa backward)"}
    return [dict(common, name="flash_bwd_dq", ms=dq_ms, **bd_dq,
                 replaces="unilm_tpu/ops/flash_attention.py:1235"),
            dict(common, name="flash_bwd_dkv", ms=dkv_ms, **bd_dkv,
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
    # the yardstick: torch's SDPA of the query over the same run's L + 1
    # rows (contiguous in the pool); it appends nothing
    run = lambda pool: pool.reshape(1, PP * page, H, D)[:, :PROMPT + 1]
    lib_ms = cuda_ms(lambda: sdpa(q1, run(kp1), run(vp1)), iters=100)
    L = PROMPT + 1
    bd = roofline(2 * L * H * D * 2 + 4 * H * D * 2, 4 * H * L * D)
    phase("decode", f"B1 L{PROMPT} H16 D96: kernel alone {kernel_ms:.4f} ms; "
          f"with the row append: kernel wrapper {ms:.4f} ms, plain twin "
          f"{plain_ms:.4f} ms; sdpa over the run {lib_ms:.4f} ms; bound "
          f"{bd['bound_ms']:.5f} ms ({bd['bound_by']})")
    return {"name": "decode_attention", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/decode_attention.cu",
            "replaces": "unilm_tpu/ops/paged_attention.py:497",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "kernel_only_ms": kernel_ms, "library_ms": lib_ms, **bd,
            "shape": f"B1 L{PROMPT} H16 D96 bf16, row append included"}


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


def phase_beit_eval(fa) -> dict:
    """BEiT-B/224 at bench.py line 1's configuration (B=128, bf16, 12
    layers, per-layer rel-pos bias, random weights from the seed) through
    the port's run_class_finetuning evaluation loop on synthetic normalized
    images: 12 launches of kernel #3 and none of #1 per forward, img/s,
    a kernel-vs-plain teacher check and a device-time profile."""
    from unilm_tpu_torch.cli import run_class_finetuning as rcf
    from unilm_tpu_torch.models import beit

    dev = torch.device("cuda")
    args = rcf.build_parser().parse_args([
        "--model", "beit_base_patch16_224", "--data_path", "unused",
        "--eval", "--batch_size", str(BEIT_BATCH), "--seed", str(SEED)])
    model = rcf.build_model(args, dev)
    cfg = model.cfg
    L = cfg.num_layers
    g = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        # flax initialises the rel-pos tables to zero; random tables make
        # the bias the kernel reads matter
        for m in model.modules():
            if isinstance(m, beit.Beit2DRelativePositionBias):
                m.relative_position_bias_table.normal_(0.0, 0.5, generator=g)
    n_params = sum(p.numel() for p in model.parameters())
    images = [torch.randn(BEIT_BATCH, cfg.img_size, cfg.img_size, 3,
                          generator=g, device=dev) for _ in range(2)]
    # labels on the host, as the CLI's folder reader yields them
    labels = np.random.RandomState(SEED).randint(0, cfg.num_classes,
                                                 BEIT_BATCH)
    phase("beit_eval", f"BEiT-B/224: {L} layers, E={cfg.embed_dim}, "
          f"H={cfg.num_heads}, {cfg.num_patches + 1} tokens, bf16 compute / "
          f"fp32 params, {n_params / 1e6:.1f} M params; batch {BEIT_BATCH}")

    # ---- the main path: one batch through the CLI's evaluation loop ----
    reset_counts()
    logits, lab = rcf.evaluate_batches(model, [(images[0], labels)])
    torch.cuda.synchronize()
    got = counts()
    check(got["encoder_attention"] == L and got["flash_fwd"] == 0,
          f"beit_eval: launches per forward {got} (want {L} of #3, 0 of #1)")
    check(logits.shape == (BEIT_BATCH, cfg.num_classes)
          and bool(np.isfinite(logits).all()), "beit_eval: logits shape or "
          "finite")
    launches = {"encoder_attention": got["encoder_attention"]}

    # ---- img/s over BEIT_BATCHES batches after warm-up ------------------
    batches = [(images[i % 2], labels) for i in range(BEIT_BATCHES)]
    rcf.evaluate_batches(model, batches[:2])
    reset_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    rcf.evaluate_batches(model, batches)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1]) / BEIT_BATCHES
    check(counts()["encoder_attention"] == L * BEIT_BATCHES,
          f"beit_eval: {counts()['encoder_attention']} launches over "
          f"{BEIT_BATCHES} batches")
    phase("beit_eval", f"{BEIT_BATCHES} batches of {BEIT_BATCH} through "
          f"evaluate_batches: {ms:.3f} ms/batch, "
          f"{BEIT_BATCH * 1e3 / ms:.1f} img/s (CUDA events)")

    # ---- teacher check: the plain path on the same batch ----------------
    plain = beit.BeitForImageClassification(
        dataclasses.replace(cfg, use_flash=False), device=dev)
    plain.load_state_dict(model.state_dict())
    plain.eval()
    c0 = counts()
    plogits, _ = rcf.evaluate_batches(plain, [(images[0], labels)])
    check(counts() == c0, "beit_eval: the plain path launched a kernel")
    dl = float(np.abs(logits - plogits).max())
    agree = float((logits.argmax(-1) == plogits.argmax(-1)).mean())
    phase("beit_eval", f"teacher check, kernel vs plain path on one batch: "
          f"max |dlogit| {dl:.4f} (tol {BEIT_LOGIT_ATOL}, logits max "
          f"{float(np.abs(plogits).max()):.3f}), top-1 agreement "
          f"{agree:.4f} (tol {BEIT_TOP1_AGREE})")
    check(dl <= BEIT_LOGIT_ATOL and agree >= BEIT_TOP1_AGREE,
          "beit_eval: teacher check failed")
    ms_plain = cuda_ms(lambda: rcf.evaluate_batches(plain, batches[:1]),
                       iters=3, warmup=1)
    phase("beit_eval", f"plain path {ms_plain:.3f} ms/batch "
          f"({BEIT_BATCH * 1e3 / ms_plain:.1f} img/s)")
    del plain

    # ---- device-time profile of one batch -------------------------------
    from torch.profiler import ProfilerActivity, profile

    groups = [("encoder_attention #3", ["encoder_attn_kernel"]),
              ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet", "cublas",
                          "splitK"]),
              ("layer norm", ["layer_norm", "LayerNorm"])]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rcf.evaluate_batches(model, batches[:1])
        torch.cuda.synchronize()
    shares = device_time_shares(prof, groups)
    total = sum(shares.values())
    if total <= 0:
        phase("beit_eval", "profiler saw no device time: shares not measured")
    else:
        phase("beit_eval", f"device time per batch {total:.3f} ms of "
              f"{ms:.3f} ms: " + ", ".join(
                  f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                  for k, v in shares.items()))
    del model
    torch.cuda.empty_cache()
    return launches


def phase_beit_train(fa) -> dict:
    """BEiT-B fine-tuning at bench_beit's configuration through
    cli/train_classification's build_trainer on synthetic normalized
    images: 12 launches of #3 and 12 of #4 per step, ms/step, img/s, model
    TFLOP/s, peak memory, a device-time profile, the plain path's step, a
    kernel-vs-plain teacher check, then two BeitForMaskedImageModeling
    steps at bench_beit_pretrain's configuration."""
    from torch.profiler import ProfilerActivity, profile

    from unilm_tpu_torch.cli import train_classification as tcl
    from unilm_tpu_torch.data.masking import MaskingGenerator
    from unilm_tpu_torch.models import beit
    from unilm_tpu_torch.runtime import optim, train

    dev = torch.device("cuda")
    B = BEIT_TRAIN_BATCH
    args = tcl.build_parser().parse_args([
        "--model", "beit_base_patch16_224", "--data_path", "unused",
        "--batch_size", str(B), "--nb_classes", "1000", "--drop_path", "0.1",
        "--ema_decay", "0.9999", "--clip_grad", "3.0", "--seed", str(SEED)])
    # an ImageNet-sized item list: the schedule's length (30 epochs of 40
    # batches, 5 of warmup); the images themselves are synthetic
    items = [(f"synthetic/{i}", i % 1000) for i in range(40 * B)]

    def trainer(use_flash):
        tr = tcl.build_trainer(args, items, use_flash=use_flash)
        g = torch.Generator(device=dev).manual_seed(SEED)
        with torch.no_grad():  # random tables, so the bias and dbias matter
            for m in tr.model.modules():
                if isinstance(m, beit.Beit2DRelativePositionBias):
                    m.relative_position_bias_table.normal_(0.0, 0.5,
                                                           generator=g)
        return tr

    tr = trainer(True)
    model, cfg, L = tr.model, tr.cfg, tr.cfg.num_layers
    T = cfg.num_patches + 1
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    images = [torch.randn(B, cfg.img_size, cfg.img_size, 3, generator=g,
                          device=dev) for _ in range(2)]
    labels = torch.randint(0, 1000, (B,), generator=g, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    n_mm = sum(p.numel() for name, p in model.named_parameters()
               if p.ndim >= 2 and "embed" not in name)  # train_mfu's count
    phase("beit_train", f"BEiT-B/224 fine-tuning: {L} layers, E="
          f"{cfg.embed_dim}, H={cfg.num_heads}, {T} tokens, batch {B}, bf16 "
          f"compute / fp32 params, {n_params / 1e6:.1f} M params; drop-path "
          f"0.1, layer decay {args.layer_decay}, mixup {args.mixup} / cutmix "
          f"{args.cutmix}, smoothing {args.label_smoothing}, EMA "
          f"{args.ema_decay}, clip {args.clip_grad}")

    # ---- the main path: BEIT_TRAIN_STEPS steps, the last ones timed -----
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    metrics = []
    torch.cuda.synchronize()
    reset_counts()
    for i in range(BEIT_TRAIN_STEPS):
        if i == BEIT_TRAIN_STEPS - BEIT_TRAIN_TIMED:
            torch.cuda.reset_peak_memory_stats()
            ev[0].record()
        batch = tr.make_batch(images[i % 2], labels, tr.state.step)
        tr.state, m = tr.step_fn(tr.state, batch)
        metrics.append(m)
    ev[1].record()
    torch.cuda.synchronize()
    got = counts()
    ms = ev[0].elapsed_time(ev[1]) / BEIT_TRAIN_TIMED
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"beit_train: loss {losses} grad norm {norms}")
    n = BEIT_TRAIN_STEPS
    check(got["encoder_attention"] == L * n
          and got["encoder_attention_bwd"] == L * n
          and got["flash_fwd"] == got["flash_bwd_dq"] == 0
          and got["flash_bwd_dkv"] == 0,
          f"beit_train: launches over {n} steps {got} (want {L} of #3 and "
          f"{L} of #4 per step, none of #1/#6/#7)")
    launches = {"encoder_attention_bwd": got["encoder_attention_bwd"]}
    flops = 6.0 * n_mm * B * T + 12.0 * L * cfg.embed_dim * T * B * T
    phase("beit_train", "steps " + ", ".join(
        f"{i + 1}: loss {lo:.4f} grad norm {gn:.3f}"
        for i, (lo, gn) in enumerate(zip(losses, norms))))
    phase("beit_train", f"launches per step: {L} of #3, {L} of #4, none of "
          f"#1/#6/#7; steps {n - BEIT_TRAIN_TIMED + 1}-{n}: {ms:.2f} ms/step "
          f"(CUDA events), {B * 1e3 / ms:.1f} img/s, {flops / ms / 1e9:.1f} "
          f"model TFLOP/s = {flops / ms / 1e9 / 989 * 100:.1f}% of 989 "
          f"TFLOP/s bf16 dense; peak memory {peak:.1f} GiB")

    # ---- device-time profile: forward + backward, then optimizer + EMA --
    groups = [("encoder_attention #3", ["encoder_attn_kernel"]),
              ("encoder_attention_bwd #4", ["enc_bwd_"]),
              ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet", "cublas",
                          "splitK"])]
    batch = tr.make_batch(images[0], labels, tr.state.step)
    params = train.trainable(model)

    def fwd_bwd():
        loss, _ = tr.loss_fn(model, batch)
        return torch.autograd.grad(loss, params)

    grads = fwd_bwd()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        grads = fwd_bwd()
        torch.cuda.synchronize()
    parts = device_time_shares(prof, groups)
    parts["elementwise and other"] = parts.pop("other")
    scratch = [p.detach().clone() for p in params]
    ema = [e.clone() for e in tr.state.ema_params]
    opt = {k: ([t.clone() for t in v] if isinstance(v, list) else v)
           for k, v in tr.state.opt_state.items()}
    with profile(activities=acts) as prof:
        tr.tx.update(grads, opt, scratch)
        with torch.no_grad():
            for e, p in zip(ema, scratch):
                e.mul_(args.ema_decay).add_(p, alpha=1.0 - args.ema_decay)
        torch.cuda.synchronize()
    parts["optimizer + EMA"] = sum(device_time_shares(prof, []).values())
    del scratch, ema, opt, grads
    total = sum(parts.values())
    if total <= 0:
        phase("beit_train", "profiler saw no device time: shares not measured")
    else:
        phase("beit_train", f"device time per step {total:.2f} ms of "
              f"{ms:.2f} ms ({100 * total / ms:.0f}% busy): " + ", ".join(
                  f"{k} {v:.2f} ms ({100 * v / total:.1f}%)"
                  for k, v in parts.items()))

    # ---- teacher check: kernel path against plain path, one batch -------
    plain = trainer(False)
    plain.model.load_state_dict(model.state_dict())
    c0 = counts()

    def loss_grads(t):
        loss, _ = t.loss_fn(t.model, batch)
        ps = train.trainable(t.model)
        return float(loss.detach()), torch.autograd.grad(loss, ps)

    lk, gk = loss_grads(tr)
    c1 = counts()
    lp, gp = loss_grads(plain)
    torch.cuda.synchronize()
    check(counts() == c1 and c1["encoder_attention_bwd"]
          - c0["encoder_attention_bwd"] == L,
          f"beit_train teacher: launch counts {c0} -> {c1} -> {counts()}")
    names = [nm for nm, _ in model.named_parameters()]
    nk = float(optim.global_norm(gk))
    npl = float(optim.global_norm(gp))
    cos = {nm: float(torch.nn.functional.cosine_similarity(
        a.flatten().float(), b.flatten().float(), dim=0))
        for nm, a, b in zip(names, gk, gp) if not nm.endswith("k_proj.bias")}
    worst = min(cos, key=cos.get)
    loss_rel, norm_rel = abs(lk - lp) / abs(lp), abs(nk - npl) / npl
    phase("beit_train", f"teacher check, one batch, same mixup draw and "
          f"drop-path flags: loss kernel {lk:.6f} plain {lp:.6f} (rel "
          f"{loss_rel:.2e}, tol {BEIT_TEACHER_LOSS_REL}); grad norm kernel "
          f"{nk:.5f} plain {npl:.5f} (rel {norm_rel:.2e}, tol "
          f"{BEIT_TEACHER_NORM_REL}); min per-tensor cosine {cos[worst]:.5f} "
          f"({worst}, tol {BEIT_TEACHER_COS})")
    check(loss_rel <= BEIT_TEACHER_LOSS_REL
          and norm_rel <= BEIT_TEACHER_NORM_REL
          and cos[worst] >= BEIT_TEACHER_COS, "beit_train: teacher check "
          "failed")
    del gk, gp

    # ---- the plain path's step -------------------------------------------
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for i in range(3):
        if i == 1:
            ev[0].record()
        b = plain.make_batch(images[i % 2], labels, plain.state.step)
        plain.state, _ = plain.step_fn(plain.state, b)
    ev[1].record()
    torch.cuda.synchronize()
    check(counts() == c1, "beit_train: the plain path launched a kernel")
    ms_plain = ev[0].elapsed_time(ev[1]) / 2
    phase("beit_train", f"plain path (use_flash=False) {ms_plain:.2f} ms/step "
          f"({B * 1e3 / ms_plain:.1f} img/s); kernel path {ms:.2f} ms")
    del plain, tr, model, batch
    torch.cuda.empty_cache()

    # ---- pretraining: BeitForMaskedImageModeling, bench_beit_pretrain ----
    pcfg = beit.beit_base_patch16_224(
        dtype=torch.bfloat16, drop_path_rate=0.1, use_shared_rel_pos_bias=True,
        use_rel_pos_bias=False)
    mim = beit.BeitForMaskedImageModeling(pcfg, device=dev)
    mim.init_weights(torch.Generator(device=dev).manual_seed(SEED)).train()
    with torch.no_grad():
        mim.backbone.rel_pos_bias.relative_position_bias_table.normal_(
            0.0, 0.5, generator=g)
    gen = MaskingGenerator(cfg.grid_size, num_masking_patches=BEIT_MASKED,
                           rng=np.random.default_rng(SEED))
    masks = torch.from_numpy(np.stack([gen().reshape(-1) for _ in range(B)])
                             ).bool().to(dev)
    targets = torch.randint(0, pcfg.vocab_size, (B, cfg.num_patches),
                            generator=g, device=dev)
    tx = optim.create_optimizer(list(mim.named_parameters()), 1.5e-3,
                                betas=(0.9, 0.98), weight_decay=0.05)

    def mim_loss(m, b):
        s, cnt = train.cross_entropy_loss(
            m(b["x"], b["mask"], torch.Generator(device=dev).manual_seed(
                b["seed"])), b["y"], mask=b["mask"])
        return s / cnt, {}

    state = train.TrainState.create(mim, tx)
    step = train.make_train_step(mim_loss, tx, clip_grad_norm=3.0)
    c0 = counts()
    pl = []
    t0 = time.time()
    for i in range(BEIT_PRETRAIN_STEPS):
        state, m = step(state, {"x": images[i % 2], "mask": masks,
                                "y": targets, "seed": SEED + i})
        pl.append((float(m["loss"]), float(m["grad_norm"])))
    torch.cuda.synchronize()
    dt = (time.time() - t0) / BEIT_PRETRAIN_STEPS
    ran = {k: counts()[k] - c0[k] for k in c0}
    check(all(np.isfinite(x) for lg in pl for x in lg)
          and ran["encoder_attention"] == L * BEIT_PRETRAIN_STEPS
          and ran["encoder_attention_bwd"] == L * BEIT_PRETRAIN_STEPS
          and ran["flash_fwd"] == 0,
          f"beit_train pretraining: losses {pl}, launches {ran}")
    phase("beit_train", f"pretraining (BeitForMaskedImageModeling, shared "
          f"rel-pos bias, {int(masks[0].sum())} of {cfg.num_patches} patches "
          f"masked, vocab {pcfg.vocab_size}, B={B}): "
          + ", ".join(f"step {i + 1} loss {lo:.4f} grad norm {gn:.3f}"
                      for i, (lo, gn) in enumerate(pl))
          + f"; {L} + {L} launches of #3/#4 per step; {dt * 1e3:.1f} ms/step "
          "(host clock, first steps)")
    del mim, state, step
    torch.cuda.empty_cache()
    return launches


def lv3_eval_batch(cfg, rng, B: int, T: int) -> dict:
    """A synthetic FUNSD batch as the CLI's funsd_batches yields it
    (numpy, on the host): <s> ... </s> documents of 200-510 tokens padded
    to T, sorted word boxes, 8-token segments (-1 on specials and pads),
    labels on the first subword of each 1-3-token word, normalized
    224x224 pages."""
    ids = np.full((B, T), cfg.pad_token_id, np.int64)
    mask = np.zeros((B, T), np.int64)
    bbox = np.zeros((B, T, 4), np.int64)
    seg = np.full((B, T), -1, np.int64)
    labels = np.full((B, T), -100, np.int64)
    for i in range(B):
        n = rng.randint(200, T - 1)
        ids[i, 0], ids[i, 1:n - 1], ids[i, n - 1] = 0, rng.randint(
            3, cfg.vocab_size - 1, n - 2), 2
        mask[i, :n] = 1
        xy = np.sort(rng.randint(0, 900, (n - 2, 2, 2)), axis=1)
        bbox[i, 1:n - 1] = xy.transpose(0, 2, 1).reshape(n - 2, 4)
        seg[i, 1:n - 1] = np.arange(n - 2) // 8
        first = np.cumsum(rng.randint(1, 4, n)) - 1  # word starts
        first = first[first < n - 2] + 1
        labels[i, first] = rng.randint(0, cfg.num_labels, len(first))
    images = (rng.rand(B, 224, 224, 3) * 2 - 1).astype(np.float32)
    return dict(input_ids=ids, attention_mask=mask, bbox=bbox, labels=labels,
                segments=seg, images=images)


def phase_layoutlmv3_eval() -> dict:
    """LayoutLMv3-B at the FUNSD eval CLI's configuration (cli/run_funsd.py:
    LayoutLMv3Config(num_labels=7), float32, max_len 512, batch 8, with the
    image; random weights from the seed) through the port CLI's
    evaluate_batches on synthetic documents: exactly 12 launches of #9 and
    none of #1/#3 per forward, docs/s and ms/batch (CUDA events), a teacher
    check against the plain path, a device-time profile."""
    from unilm_tpu_torch.cli import run_funsd as rf
    from unilm_tpu_torch.models import layoutlmv3 as lm

    dev = torch.device("cuda")
    args = rf.build_parser().parse_args([
        "--data_path", "unused", "--tokenizer", "unused", "--seed", str(SEED)])
    model = rf.build_model(args, dev)
    cfg, L, B = model.cfg, model.cfg.num_layers, args.batch_size
    rng = np.random.RandomState(SEED)
    batches = [lv3_eval_batch(cfg, rng, B, args.max_len) for _ in range(2)]
    n_params = sum(p.numel() for p in model.parameters())
    S = args.max_len + cfg.visual_len
    phase("layoutlmv3_eval", f"LayoutLMv3-B FUNSD eval: {L} layers, E="
          f"{cfg.hidden_size}, H={cfg.num_heads}, {args.max_len} text + "
          f"{cfg.visual_len} visual tokens, float32, {n_params / 1e6:.1f} M "
          f"params; batch {B}, segment-aware 1D bias (valid_span)")

    # ---- the main path: one batch through the CLI's evaluation loop ----
    reset_counts()
    logits, labels = rf.evaluate_batches(model, batches[:1])
    torch.cuda.synchronize()
    got = counts()
    check(got["doc_attention"] == L and got["flash_fwd"] == 0
          and got["encoder_attention"] == 0,
          f"layoutlmv3_eval: launches per forward {got} (want {L} of #9, none "
          "of #1/#3)")
    check(logits.shape == (B, args.max_len, 7) and bool(np.isfinite(
        logits).all()), "layoutlmv3_eval: logits shape or finite")
    launches = {"doc_attention": got["doc_attention"]}
    f1 = rf.score(logits, labels)

    # ---- docs/s over LV3_EVAL_BATCHES batches after warm-up -------------
    timed = [batches[i % 2] for i in range(LV3_EVAL_BATCHES)]
    rf.evaluate_batches(model, timed[:2])
    reset_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    rf.evaluate_batches(model, timed)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1]) / LV3_EVAL_BATCHES
    check(counts()["doc_attention"] == L * LV3_EVAL_BATCHES,
          f"layoutlmv3_eval: {counts()['doc_attention']} launches over "
          f"{LV3_EVAL_BATCHES} batches")
    phase("layoutlmv3_eval", f"{LV3_EVAL_BATCHES} batches of {B} through "
          f"evaluate_batches: {ms:.3f} ms/batch, {B * 1e3 / ms:.1f} docs/s "
          f"(CUDA events, host-to-card copies included); entity F1 of the "
          f"random model {f1['f1']:.4f}")

    # ---- teacher check: the plain path on the same batch ----------------
    plain = lm.LayoutLMv3ForTokenClassification(
        dataclasses.replace(cfg, use_flash=False), device=dev)
    plain.load_state_dict(model.state_dict())
    plain.eval()
    c0 = counts()
    plogits, _ = rf.evaluate_batches(plain, batches[:1])
    check(counts() == c0, "layoutlmv3_eval: the plain path launched a kernel")
    keep = labels != -100
    dl = float(np.abs(logits - plogits)[keep].max())
    agree = float((logits.argmax(-1) == plogits.argmax(-1))[keep].mean())
    phase("layoutlmv3_eval", f"teacher check, kernel vs plain path on one "
          f"batch: max |dlogit| over labelled tokens {dl:.2e} (tol "
          f"{LV3_EVAL_LOGIT_ATOL}, logits max "
          f"{float(np.abs(plogits).max()):.3f}), argmax agreement "
          f"{agree:.4f} (tol {LV3_EVAL_AGREE})")
    check(dl <= LV3_EVAL_LOGIT_ATOL and agree >= LV3_EVAL_AGREE,
          "layoutlmv3_eval: teacher check failed")
    ms_plain = cuda_ms(lambda: rf.evaluate_batches(plain, batches[:1]),
                       iters=3, warmup=1)
    phase("layoutlmv3_eval", f"plain path {ms_plain:.3f} ms/batch "
          f"({B * 1e3 / ms_plain:.1f} docs/s)")
    del plain

    # ---- device-time profile of one batch -------------------------------
    from torch.profiler import ProfilerActivity, profile

    # #9's fp32 path runs #3's body (csrc/encoder_attention.cuh), so its
    # kernel carries #3's name; #3 itself launched no time here (above)
    groups = [("doc_attention #9", ["doc_fwd", "encoder_attn_kernel"]),
              ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet", "cublas",
                          "splitK"]),
              ("bias lookup (gather)", ["index", "gather"]),
              ("layer norm", ["layer_norm", "LayerNorm"])]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rf.evaluate_batches(model, batches[:1])
        torch.cuda.synchronize()
    shares = device_time_shares(prof, groups)
    total = sum(shares.values())
    if total <= 0:
        phase("layoutlmv3_eval", "profiler saw no device time: shares not "
              "measured")
    else:
        phase("layoutlmv3_eval", f"device time per batch {total:.3f} ms of "
              f"{ms:.3f} ms: " + ", ".join(
                  f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                  for k, v in shares.items()))
    del model
    torch.cuda.empty_cache()
    return launches


def phase_layoutlmv3_train() -> dict:
    """LayoutLMv3-B FUNSD fine-tuning at benchmarks/train_mfu.py
    bench_layoutlmv3's configuration, nothing cut (B=32, 512 text + 197
    visual tokens, bf16 compute / fp32 params, fused bias, no remat, 7
    labels, AdamW lr 1e-5 with weight decay 0.01 on every parameter, clip
    1.0, data drawn as there) through runtime.train.make_train_step: 6
    steps, the last 4 timed; exactly 12 launches of #9 and 12 of #10 per
    step and none of #1/#3/#4/#6/#7; ms/step, docs/s, model TFLOP/s, peak
    memory, a device-time profile, a teacher check against the plain path
    and the plain path's step."""
    from torch.profiler import ProfilerActivity, profile

    from unilm_tpu_torch.models import layoutlmv3 as lm
    from unilm_tpu_torch.ops import bucket_bias as bbias
    from unilm_tpu_torch.runtime import optim, train

    dev = torch.device("cuda")
    B, T = LV3_TRAIN_BATCH, 512
    cfg = lm.layoutlmv3_base(dtype=torch.bfloat16, num_labels=7)

    def build(c):
        m = lm.LayoutLMv3ForTokenClassification(c, device=dev)
        return m.init_weights(torch.Generator(device=dev).manual_seed(SEED))

    model = build(cfg).train()
    L, E, S = cfg.num_layers, cfg.hidden_size, T + cfg.visual_len
    rng0 = np.random.RandomState(0)  # train_mfu.py:480-486
    ids = rng0.randint(3, cfg.vocab_size - 1, (B, T))
    xy = rng0.randint(0, 900, (B, T, 2, 2))
    xy.sort(axis=2)
    bbox = xy.transpose(0, 1, 3, 2).reshape(B, T, 4)
    imgs = rng0.rand(B, 224, 224, 3)
    labels = rng0.randint(0, 7, (B, T))
    batch = {"ids": torch.from_numpy(ids).to(dev),
             "bbox": torch.from_numpy(bbox).to(dev),
             "imgs": torch.from_numpy(imgs).to(dev, torch.bfloat16),
             "y": torch.from_numpy(labels).to(dev)}

    def loss_fn(m, b):
        s, n = train.cross_entropy_loss(m(b["ids"], b["bbox"], None,
                                          b["imgs"]), b["y"])
        return s / n, {}

    def trainer(m):
        tx = optim.AdamW(1e-5, weight_decay=0.01)
        return (train.TrainState.create(m, tx), tx,
                train.make_train_step(loss_fn, tx, clip_grad_norm=1.0))

    state, tx, step = trainer(model)
    n_params = sum(p.numel() for p in model.parameters())
    n_mm = sum(p.numel() for name, p in model.named_parameters()
               if p.ndim >= 2 and "embed" not in name)  # train_mfu's count
    phase("layoutlmv3_train", f"LayoutLMv3-B FUNSD fine-tuning: {L} layers, "
          f"E={E}, H={cfg.num_heads}, {T} text + {cfg.visual_len} visual "
          f"tokens, batch {B}, bf16 compute / fp32 params, fused head-major "
          f"bias, {n_params / 1e6:.1f} M params; AdamW lr 1e-5 wd 0.01, clip "
          "1.0")

    # ---- the main path: LV3_TRAIN_STEPS steps, the last ones timed -----
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    metrics = []
    torch.cuda.synchronize()
    reset_counts()
    for i in range(LV3_TRAIN_STEPS):
        if i == LV3_TRAIN_STEPS - LV3_TRAIN_TIMED:
            torch.cuda.reset_peak_memory_stats()
            ev[0].record()
        state, m = step(state, batch)
        metrics.append(m)
    ev[1].record()
    torch.cuda.synchronize()
    got = counts()
    ms = ev[0].elapsed_time(ev[1]) / LV3_TRAIN_TIMED
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"layoutlmv3_train: loss {losses} grad norm {norms}")
    n = LV3_TRAIN_STEPS
    others = ("flash_fwd", "encoder_attention", "encoder_attention_bwd",
              "flash_bwd_dq", "flash_bwd_dkv")
    check(got["doc_attention"] == L * n and got["doc_attention_bwd"] == L * n
          and all(got[k] == 0 for k in others),
          f"layoutlmv3_train: launches over {n} steps {got} (want {L} of #9 "
          f"and {L} of #10 per step, none of #1/#3/#4/#6/#7)")
    launches = {"doc_attention_bwd": got["doc_attention_bwd"]}
    flops = 6.0 * n_mm * B * S + 12.0 * L * E * S * B * S
    phase("layoutlmv3_train", "steps " + ", ".join(
        f"{i + 1}: loss {lo:.4f} grad norm {gn:.3f}"
        for i, (lo, gn) in enumerate(zip(losses, norms))))
    phase("layoutlmv3_train", f"launches per step: {L} of #9, {L} of #10, "
          f"none of #1/#3/#4/#6/#7; steps {n - LV3_TRAIN_TIMED + 1}-{n}: "
          f"{ms:.2f} ms/step (CUDA events), {B * 1e3 / ms:.1f} docs/s, "
          f"{flops / ms / 1e9:.1f} model TFLOP/s = "
          f"{flops / ms / 1e9 / 989 * 100:.1f}% of 989 TFLOP/s bf16 dense; "
          f"peak memory {peak:.1f} GiB")

    # ---- device-time profile: forward + backward, then the optimizer ----
    groups = [("doc_attention #9", ["doc_fwd"]),
              ("doc_attention_bwd #10", ["doc_bwd"]),
              ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet", "cublas",
                          "splitK"]),
              ("bias gather", ["index", "gather"])]
    params = train.trainable(model)

    def fwd_bwd(m):
        loss, _ = loss_fn(m, batch)
        return loss, torch.autograd.grad(loss, train.trainable(m))

    _, grads = fwd_bwd(model)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        _, grads = fwd_bwd(model)
        torch.cuda.synchronize()
    parts = device_time_shares(prof, groups)
    parts["elementwise and other"] = parts.pop("other")
    scratch = [p.detach().clone() for p in params]
    opt = {k: ([t.clone() for t in v] if isinstance(v, list) else v)
           for k, v in state.opt_state.items()}
    with profile(activities=acts) as prof:
        tx.update(grads, opt, scratch)
        torch.cuda.synchronize()
    parts["optimizer"] = sum(device_time_shares(prof, []).values())
    del scratch, opt
    # the shared bias alone: its lookup forward and its table contraction
    # backward (counted above in the gather, cuBLAS and elementwise groups)
    lv3 = model.layoutlmv3
    tables = [t for t in lv3.bias_tables() if t is not None]
    with torch.no_grad():
        pos = torch.cat([torch.arange(T, device=dev), torch.arange(
            cfg.visual_len, device=dev)]).expand(B, S)
        fb = torch.cat([batch["bbox"], lv3.visual_bbox.expand(B, -1, -1)], 1)
        packed = bbias.pack_bucket_planes(*lm.relative_bucket_planes(
            cfg, pos, fb, None, cfg.visual_len))
    gbias = torch.ones(cfg.num_heads, B, S, S, dtype=cfg.dtype, device=dev)

    def bias_fwd_bwd():
        hb = bbias.bias_grad_collector(tables, packed, cfg.head_scale,
                                       cfg.dtype)
        return torch.autograd.grad(hb, tables, gbias)

    bias_ms = cuda_ms(bias_fwd_bwd, iters=3, warmup=1)
    del gbias
    total = sum(parts.values())
    if total <= 0:
        phase("layoutlmv3_train", "profiler saw no device time: shares not "
              "measured")
    else:
        phase("layoutlmv3_train", f"device time per step {total:.2f} ms of "
              f"{ms:.2f} ms ({100 * total / ms:.0f}% busy): " + ", ".join(
                  f"{k} {v:.2f} ms ({100 * v / total:.1f}%)"
                  for k, v in parts.items())
              + f"; the bias lookup + table contraction alone {bias_ms:.2f} "
              "ms (CUDA events)")

    # ---- teacher check: kernel path against plain path, one batch -------
    plain = build(dataclasses.replace(cfg, use_flash=False)).train()
    plain.load_state_dict(model.state_dict())
    c0 = counts()
    lk, gk = fwd_bwd(model)
    c1 = counts()
    lp, gp = fwd_bwd(plain)
    torch.cuda.synchronize()
    check(counts() == c1 and c1["doc_attention_bwd"]
          - c0["doc_attention_bwd"] == L,
          f"layoutlmv3_train teacher: launch counts {c0} -> {c1} -> "
          f"{counts()}")
    lk, lp = float(lk.detach()), float(lp.detach())
    names = [nm for nm, _ in model.named_parameters()]
    nk, npl = float(optim.global_norm(gk)), float(optim.global_norm(gp))
    cos = {nm: float(torch.nn.functional.cosine_similarity(
        a.flatten().float(), b.flatten().float(), dim=0))
        for nm, a, b in zip(names, gk, gp) if not nm.endswith("k_proj.bias")}
    worst = min(cos, key=cos.get)
    tabs = ", ".join(f"{nm.split('.')[-1]} {cos[nm]:.5f}" for nm in names
                     if nm.split(".")[-1].startswith("rel_pos"))
    loss_rel, norm_rel = abs(lk - lp) / abs(lp), abs(nk - npl) / npl
    phase("layoutlmv3_train", f"teacher check, one batch: loss kernel {lk:.6f}"
          f" plain {lp:.6f} (rel {loss_rel:.2e}, tol {LV3_TEACHER_LOSS_REL}); "
          f"grad norm kernel {nk:.5f} plain {npl:.5f} (rel {norm_rel:.2e}, "
          f"tol {LV3_TEACHER_NORM_REL}); min per-tensor cosine "
          f"{cos[worst]:.5f} ({worst}, tol {LV3_TEACHER_COS}); bias tables: "
          f"{tabs}")
    check(loss_rel <= LV3_TEACHER_LOSS_REL
          and norm_rel <= LV3_TEACHER_NORM_REL
          and cos[worst] >= LV3_TEACHER_COS,
          "layoutlmv3_train: teacher check failed")
    del gk, gp, grads, state, step, tx, model
    torch.cuda.empty_cache()

    # ---- the plain path's step -------------------------------------------
    pstate, _, pstep = trainer(plain)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for i in range(3):
        if i == 1:
            ev[0].record()
        pstate, _ = pstep(pstate, batch)
    ev[1].record()
    torch.cuda.synchronize()
    check(counts() == c1, "layoutlmv3_train: the plain path launched a kernel")
    ms_plain = ev[0].elapsed_time(ev[1]) / 2
    phase("layoutlmv3_train", f"plain path (use_flash=False) {ms_plain:.2f} "
          f"ms/step ({B * 1e3 / ms_plain:.1f} docs/s); kernel path {ms:.2f} "
          "ms")
    del plain, pstate, pstep, batch
    torch.cuda.empty_cache()
    return launches


def tower_patches(cfg, dev, slots: int, grid) -> torch.Tensor:
    """`slots` flattened patches, bf16: a grid of random 16x16x3 patches
    with their (row+1, col+1) ids, zero-padded."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    nr, nc = grid
    patches = torch.zeros(1, slots, 2 + cfg.pix2struct.patch_dim, device=dev)
    rows = torch.arange(nr, device=dev).repeat_interleave(nc) + 1
    cols = torch.arange(nc, device=dev).repeat(nr) + 1
    patches[0, :nr * nc, 0] = rows.float()
    patches[0, :nr * nc, 1] = cols.float()
    patches[0, :nr * nc, 2:] = torch.randn(nr * nc, cfg.pix2struct.patch_dim,
                                           generator=g, device=dev)
    return patches.to(torch.bfloat16)


def ttft_inputs(cfg, dev):
    """benchmarks/kosmos_ttft.py's request: bos, <image>, the image
    tokens, </image>, a task token (T = image tokens + 4, segment 1 over
    the image span), and TTFT_PATCHES flattened patches in a 62 x 64 grid
    (`tower_patches`)."""
    Q = cfg.latent_query_num
    T = Q + 4
    tokens = torch.full((1, T), 4, dtype=torch.long, device=dev)
    img_mask = torch.zeros(1, T, dtype=torch.bool, device=dev)
    img_mask[:, 2:2 + Q] = True
    segs = torch.zeros(1, T, dtype=torch.long, device=dev)
    segs[:, 1:3 + Q] = 1
    return tokens, img_mask, segs, tower_patches(cfg, dev, TTFT_PATCHES,
                                                 TTFT_GRID)


def phase_ttft(fa) -> dict:
    """Kosmos-2.5 TTFT as benchmarks/kosmos_ttft.py runs it:
    kosmos2_5(bf16 compute and params) with its Pix2Struct tower, encode_image
    over 4096 patch slots, then the 2052-token prefill through
    make_unigpt_generate_fns to the first token. Exactly 43 launches of
    kernel #1 (18 tower layers + the resampler + 24 decoder layers) and
    none of #3 per TTFT; features and first-token logits against the plain
    path."""
    from unilm_tpu_torch.models.kosmos import (
        UniGPT, kosmos2_5, make_unigpt_generate_fns)

    dev = "cuda"
    cfg = kosmos2_5(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                    scan_layers=True)
    model = UniGPT(cfg, device=dev).eval()
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED))
    tower = sum(p.numel() for p in model.img_model.parameters())
    conn = sum(p.numel() for p in model.img_connector.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    want = cfg.pix2struct.num_layers + 1 + cfg.num_layers
    tokens, img_mask, segs, patches = ttft_inputs(cfg, dev)
    T = tokens.shape[1]
    cache_size = T + 64
    phase("ttft", f"kosmos2_5 bf16: tower {cfg.pix2struct.num_layers} layers "
          f"E={cfg.pix2struct.hidden_size} ({tower / 1e6:.1f} M fp32 params), "
          f"resampler {cfg.latent_query_num} queries ({conn / 1e6:.1f} M), "
          f"decoder {cfg.num_layers} layers: {n_params / 1e9:.3f} B params; "
          f"{TTFT_PATCHES} patch slots ({TTFT_GRID[0] * TTFT_GRID[1]} "
          f"valid), {T}-token prompt")

    def first_token(m):
        prefill, _ = make_unigpt_generate_fns(m, cache_size)
        with torch.no_grad():
            feats = m.encode_image(patches)
            logits, _ = prefill(tokens, (feats, img_mask, segs))
        return feats, logits, logits[:, -1].argmax(-1)

    # ---- the main path: one TTFT ----------------------------------------
    reset_counts()
    feats, logits, tok = first_token(model)
    torch.cuda.synchronize()
    got = counts()
    check(got["flash_fwd"] == want and got["encoder_attention"] == 0,
          f"ttft: launches {got} (want {want} of #1, 0 of #3)")
    check(tuple(feats.shape) == (1, cfg.latent_query_num, cfg.embed_dim)
          and tuple(logits.shape) == (1, 1, cfg.vocab_size)
          and bool(torch.isfinite(feats.float()).all())
          and bool(torch.isfinite(logits.float()).all()),
          "ttft: features/logits shape or finite")
    launches = {"ttft_flash_fwd": got["flash_fwd"]}

    # ---- the plain path on the same request -----------------------------
    plain_cfg = dataclasses.replace(
        cfg, use_flash=False,
        pix2struct=dataclasses.replace(cfg.pix2struct, use_flash=False))
    plain = UniGPT(plain_cfg, device=dev)
    plain.load_state_dict(model.state_dict())
    plain.eval()
    c0 = counts()
    pfeats, plogits, ptok = first_token(plain)
    torch.cuda.synchronize()
    check(counts() == c0, "ttft: the plain path launched a kernel")
    with torch.no_grad():
        tf, _ = model.img_model(patches)
        ptf, _ = plain.img_model(patches)
        ref32 = type(model.img_model)(dataclasses.replace(
            cfg.pix2struct, dtype=torch.float32, use_flash=False), device=dev)
        ref32.load_state_dict(model.img_model.state_dict())
        tf32, _ = ref32(patches.float())
        del ref32
    e_tower = float((tf - ptf).abs().max())
    rel_tower = rel_l2(tf, ptf)
    rel_k32, rel_p32 = rel_l2(tf, tf32), rel_l2(ptf, tf32)
    e_feat = float((feats.float() - pfeats.float()).abs().max())
    e_log = float((logits.float() - plogits.float()).abs().max())
    phase("ttft", f"kernel vs plain path: tower output max|err| {e_tower:.4f}"
          f" (|x| max {float(ptf.abs().max()):.3f}), rel L2 {rel_tower:.4g}; "
          f"against the float32 plain tower, rel L2 kernel {rel_k32:.4g}, "
          f"plain {rel_p32:.4g}; resampled features "
          f"{e_feat:.4f} (tol {TTFT_FEAT_ATOL}), first-token logits "
          f"{e_log:.4f} (tol {TTFT_LOGIT_ATOL}), first token "
          f"{int(tok)} vs {int(ptok)}")
    check(e_feat <= TTFT_FEAT_ATOL and e_log <= TTFT_LOGIT_ATOL
          and rel_k32 <= rel_p32, "ttft: kernel vs plain path")

    # ---- the tower at TOWER_SLOTS (<= 2048): its mask takes #9 ----------
    p1k = tower_patches(cfg, dev, TOWER_SLOTS, TOWER_GRID)
    c0 = counts()
    with torch.no_grad():
        f1k = model.encode_image(p1k)
        torch.cuda.synchronize()
        ran = {k: counts()[k] - c0[k] for k in c0}
        pf1k = plain.encode_image(p1k)
    nl = cfg.pix2struct.num_layers
    check(ran["doc_attention"] == nl and ran["flash_fwd"] == 1
          and ran["encoder_attention"] == 0,
          f"ttft: encode_image at {TOWER_SLOTS} slots launched {ran} (want "
          f"{nl} of #9 in the tower, 1 of #1 in the resampler)")
    e1k = float((f1k.float() - pf1k.float()).abs().max())
    phase("ttft", f"encode_image at {TOWER_SLOTS} patch slots "
          f"({TOWER_GRID[0] * TOWER_GRID[1]} valid): {nl} launches of #9 in "
          f"the tower, #1 only in the resampler; resampled features vs the "
          f"plain path max|err| {e1k:.4f} (tol {TTFT_FEAT_ATOL})")
    check(bool(torch.isfinite(f1k.float()).all()) and e1k <= TTFT_FEAT_ATOL,
          "ttft: 1024-slot features vs the plain path")

    # ---- TTFT, kernel and plain paths in turn ---------------------------
    def timed(m):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        prefill, _ = make_unigpt_generate_fns(m, cache_size)
        torch.cuda.synchronize()
        with torch.no_grad():
            ev[0].record()
            f = m.encode_image(patches)
            ev[1].record()
            lg, _ = prefill(tokens, (f, img_mask, segs))
            lg[:, -1].argmax(-1)
            ev[2].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[2]), ev[0].elapsed_time(ev[1])

    timed(model)
    timed(plain)
    for rnd in range(2):
        for name, m in (("kernel", model), ("plain", plain)):
            ttft, enc = timed(m)
            phase("ttft", f"round {rnd} {name} path: TTFT {ttft:.3f} ms "
                  f"(encode_image {enc:.3f} ms, prefill {ttft - enc:.3f} ms)")
    del plain

    # ---- device-time profile of one kernel-path TTFT -------------------
    from torch.profiler import ProfilerActivity, profile

    groups = [("flash_fwd #1", ["flash_fwd_kernel"]),
              ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet", "cublas",
                          "splitK"])]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        first_token(model)
        torch.cuda.synchronize()
    shares = device_time_shares(prof, groups)
    total = sum(shares.values())
    if total <= 0:
        phase("ttft", "profiler saw no device time: shares not measured")
    else:
        phase("ttft", f"device time per TTFT {total:.3f} ms: " + ", ".join(
            f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
            for k, v in shares.items()))
    del model
    torch.cuda.empty_cache()
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
    # The products run in bf16 after the dequantize.
    M, K, N = 8, 1536, 6144
    bd = roofline(N * K + N * 4 + M * K * 2 + M * N * 2, 2 * M * N * K)
    phase("int8_matmul", f"M8 K1536 N6144 bound {bd['bound_ms']:.5f} ms "
          f"({bd['bound_by']})")
    # library yardstick: torch._weight_int8pack_mm(x, w [N, K], scales [N])
    # computes x @ (w * scale)^T, with the scales in x's dtype (bf16 here,
    # so it may differ from the plain version by the scales' rounding,
    # 2^-9 relative). Timed here only; the port never calls it.
    w = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                      dtype=torch.int8)
    scale = ((torch.rand(N, generator=g, device=dev) + 0.5)
             * (2.0 / (127 * K ** 0.5)))
    x = torch.randn(M, K, generator=g, device=dev).to(bf)
    scale_bf = scale.to(bf)
    lib_ms = None
    try:
        lib = torch._weight_int8pack_mm(x, w, scale_bf)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        phase("int8_matmul", f"torch._weight_int8pack_mm on the card raised "
              f"{type(e).__name__}: {str(e).splitlines()[0]} (library_ms "
              f"null)")
    else:
        rel = rel_l2(lib, qm.int8_matmul_plain(x, w, scale))
        check(rel <= 1e-2, f"int8_matmul: torch._weight_int8pack_mm is not "
              f"the same function (rel L2 {rel:.3g})")
        lib_ms = cuda_ms(lambda: torch._weight_int8pack_mm(x, w, scale_bf),
                         iters=50)
        phase("int8_matmul", f"M8 K1536 N6144 torch._weight_int8pack_mm "
              f"{lib_ms:.4f} ms (rel L2 {rel:.3g} against plain)")
    return {"name": "int8_matmul", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "unilm_tpu/ops/quant.py:59", "max_abs_err": worst,
            "library_ms": lib_ms, **bd,
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
    # bytes: the int8 K/V rows of the eight runs, the scale slabs that
    # cover them, q, the new rows and the output; no torch call attends
    # over int8 rows with a scale sidecar (library_ms null)
    L = 2048
    slabs = B * PP // chunk
    bd = roofline(2 * B * L * H * D + slabs * sp[0].numel() * 4
               + 4 * B * H * D * 2, 4 * B * H * L * D)
    phase("decode_int8", f"B8 L2047 bound {bd['bound_ms']:.5f} ms "
          f"({bd['bound_by']})")
    return {"name": "decode_attention_int8", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/decode_attention.cu",
            "replaces": "unilm_tpu/ops/paged_attention.py:497",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "kernel_only_ms": kernel_ms, "library_ms": None, **bd,
            "shape": "B8 L2047 H16 D96 int8"}


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
    # no torch call reads K/V through a block table (library_ms null)
    L = 2048
    bd = roofline(2 * B * L * H * D * 2 + 4 * B * H * D * 2, 4 * B * H * L * D)
    phase("paged_append", f"B8 L2047 bound {bd['bound_ms']:.5f} ms "
          f"({bd['bound_by']})")
    return {"name": "paged_append_attention", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/paged_append_attention.cu",
            "replaces": "unilm_tpu/ops/paged_attention.py:213",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, **bd,
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


SCHEDULES = ("UNILM_TPU_TRI_FLASH", "UNILM_TPU_FUSED_BWD")


def phase_train_schedules(fa, tr, batch, args, flops: float) -> dict:
    """train_schedules: the train phase's trainer and model, on the same
    repeated batch, under the JAX package's two opt-in schedules (both
    variables set here and restored after): 4 more optimizer steps, each
    launching #2 and #8 24 x 4 times and #1/#6/#7 never; ms/step, tokens/s,
    model TFLOP/s, peak memory, a device-time profile of one microbatch and
    one optimizer update; a teacher check of one microbatch on the same
    parameters under both schedules against the default kernels (the train
    phase's bounds)."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from unilm_tpu_torch.ops.fused_ce import chunked_cross_entropy

    model = tr.model
    layers = len(model.decoder.layers)
    per_step = layers * args.update_freq
    params = [p for p in model.parameters() if p.requires_grad]
    mb = batch[0]

    def micro():
        out = model(mb, return_features=True)
        s, n = chunked_cross_entropy(out[:, :-1], model.embed_tokens.weight,
                                     mb[:, 1:], chunk=args.ce_chunk)
        loss = s / n
        return float(loss.detach()), torch.autograd.grad(loss, params)

    saved = {k: os.environ.get(k) for k in SCHEDULES}
    try:
        for k in SCHEDULES:
            os.environ[k] = "1"
        steps, losses, times = 4, [], []
        torch.cuda.reset_peak_memory_stats()
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
                  f"train_schedules: step {i + 1} loss {losses[-1]} "
                  f"grad_norm {gn}")
            phase("train_schedules", f"step {i + 1}: loss {losses[-1]:.6f}, "
                  f"grad_norm {gn:.4f}, {times[-1] * 1e3:.1f} ms (host "
                  "clock)")
        got = counts()
        peak = torch.cuda.max_memory_allocated()
        for name in ("flash_tri", "flash_bwd_fused"):
            check(got[name] == per_step * steps,
                  f"train_schedules: {name} launches {got[name]} != "
                  f"{per_step} x {steps}")
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            check(got[name] == 0, f"train_schedules: {name} launched "
                  f"{got[name]} times")
        check(all(losses[i + 1] < losses[i] for i in range(1, steps - 1)),
              f"train_schedules: loss does not fall from step 2 on: {losses}")
        launches = {k: got[k] for k in ("flash_tri", "flash_bwd_fused")}
        step_s = float(np.mean(times[1:]))
        tokens = args.batch_size * args.tokens_per_sample
        phase("train_schedules", f"launches per step: flash_tri/"
              f"flash_bwd_fused {per_step} each, flash_fwd/dq/dkv 0 ({got}); "
              f"steps 2-{steps}: {step_s * 1e3:.1f} ms/step, "
              f"{tokens / step_s:.0f} tokens/s, {flops / step_s / 1e12:.1f} "
              f"model TFLOP/s = {flops / step_s / 989e12 * 100:.1f}% of 989 "
              f"TFLOP/s bf16 dense; peak memory {peak / 2**30:.1f} GiB")

        groups = [("flash_tri #2", ["flash_tri_tc_kernel"]),
                  ("flash_bwd_fused #8", ["flash_bwd_fused_tc_kernel",
                                          "dq_cast_kernel"]),
                  ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet", "cublas",
                              "splitK"])]
        micro()
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            _, grads = micro()
            torch.cuda.synchronize()
        parts = {k: v * args.update_freq
                 for k, v in device_time_shares(prof, groups).items()}
        scratch = [p.detach().clone() for p in params]
        state_copy = {k: ([t.clone() for t in v] if isinstance(v, list)
                          else v) for k, v in tr.state.opt_state.items()}
        with profile(activities=acts) as prof:
            tr.tx.update(grads, state_copy, scratch)
            torch.cuda.synchronize()
        parts["optimizer"] = sum(device_time_shares(prof, []).values())
        del scratch, state_copy, grads
        total = sum(parts.values())
        if total <= 0:
            phase("train_schedules", "profiler saw no device time: shares "
                  "not measured")
        else:
            phase("train_schedules", "device time per step (4 x one profiled "
                  f"microbatch + one optimizer update) {total:.1f} ms: " +
                  ", ".join(f"{k} {v:.1f} ms ({100 * v / total:.1f}%)"
                            for k, v in parts.items()))

        # teacher: one microbatch, the same parameters, schedules vs default
        c0 = counts()
        ls, gs = micro()
        c1 = counts()
        for k in SCHEDULES:
            del os.environ[k]
        ld, gd = micro()
        c2 = counts()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(c1["flash_tri"] - c0["flash_tri"] == layers
          and c1["flash_bwd_fused"] - c0["flash_bwd_fused"] == layers
          and c2["flash_bwd_dq"] - c1["flash_bwd_dq"] == layers
          and c2["flash_tri"] == c1["flash_tri"],
          f"train_schedules teacher: launch counts {c0} -> {c1} -> {c2}")
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    ns = float(torch.sqrt(sum(g.float().pow(2).sum() for g in gs)))
    nd = float(torch.sqrt(sum(g.float().pow(2).sum() for g in gd)))
    cos = {n: float(torch.nn.functional.cosine_similarity(
        a.flatten().float(), b.flatten().float(), dim=0))
        for n, a, b in zip(names, gs, gd)}
    worst = min(cos, key=cos.get)
    loss_rel, norm_rel = abs(ls - ld) / abs(ld), abs(ns - nd) / nd
    phase("train_schedules", f"teacher check, microbatch 0 (2 x 2048): loss "
          f"#2/#8 {ls:.6f} #1/#6/#7 {ld:.6f} (rel {loss_rel:.2e}, tol "
          f"{TEACHER_LOSS_REL}); grad norm {ns:.5f} vs {nd:.5f} (rel "
          f"{norm_rel:.2e}, tol {TEACHER_NORM_REL}); min per-tensor cosine "
          f"{cos[worst]:.5f} ({worst}, tol {TEACHER_COS})")
    check(loss_rel <= TEACHER_LOSS_REL and norm_rel <= TEACHER_NORM_REL
          and cos[worst] >= TEACHER_COS, "train_schedules: teacher check "
          "failed")
    del gs, gd
    torch.cuda.empty_cache()
    return launches


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
    launches.update(phase_train_schedules(fa, tr, batch, args, flops))
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
    from unilm_tpu_torch.ops import doc_attention as da
    from unilm_tpu_torch.ops import flash_attention as fa
    from unilm_tpu_torch.ops import paged_attention as pa
    from unilm_tpu_torch.ops import quant as qm

    KERNELS.update({"flash_fwd": fa.KERNEL,
                    "flash_tri": fa.TRI_KERNEL,
                    "encoder_attention": fa.ENCODER_KERNEL,
                    "decode_attention": pa.KERNEL,
                    "decode_attention_int8": pa.KERNEL_INT8,
                    "int8_matmul": qm.KERNEL,
                    "paged_append_attention": pa.APPEND_KERNEL,
                    "flash_bwd_dq": fa.BWD_KERNEL_DQ,
                    "flash_bwd_dkv": fa.BWD_KERNEL_DKV,
                    "flash_bwd_fused": fa.FUSED_BWD_KERNEL,
                    "encoder_attention_bwd": fa.ENCODER_BWD_KERNEL,
                    "doc_attention": da.FWD_KERNEL,
                    "doc_attention_bwd": da.BWD_KERNEL})
    phase_build()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = [phase_flash(fa, g), phase_flash_tri(fa, g),
               *phase_flash_bwd(fa, g), phase_flash_bwd_fused(fa, g),
               phase_encoder_attn(fa, g), phase_encoder_bwd(fa, g),
               phase_doc_attn(da, g), phase_doc_bwd(da, g),
               phase_decode(pa, g), phase_decode_int8(pa, g),
               phase_int8_matmul(qm, g), phase_paged_append(pa, g)]
    launches = phase_slice(fa, pa)
    launches.update(phase_beit_eval(fa))
    launches.update(phase_beit_train(fa))
    launches.update(phase_layoutlmv3_eval())
    launches.update(phase_layoutlmv3_train())
    launches.update(phase_ttft(fa))
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
