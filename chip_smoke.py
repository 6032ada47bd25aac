#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (unilm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, one line each:
 1. device: requires CUDA; prints the card's name and power limit
    (nvidia-smi); turns TF32 off for matmul and cuDNN.
 2. build: compiles the hand-written kernels from unilm_tpu_torch/csrc/.
 3. flash: the flash-forward kernel against its plain twin, bf16, over
    causal/offset/kv_len/key-padding/bias/window cases, D in {64, 96, 128},
    ragged T and S, and the Kosmos-2.5 prefill shape 1x2052x16x96.
 4. decode: the decode-attention kernel against its plain twin, bf16,
    B=3 with lengths {0, 511, 1800}; written pool rows bit-equal.
 5. slice: the Kosmos-2.5 text decoder at full width (24 layers, E=1536,
    16 heads, FFN 6144, vocab 108481, bf16, random weights from a seed)
    serves three requests through runtime.generate (2052-token multimodal
    prompt, 32 greedy tokens): B=1, B=2, B=1. The launch counters must
    show every prefill layer and every decode step's layers went through
    the kernels; a teacher-forced run of the plain path must agree.
    Prints TTFT and ms/token for the kernel path and the plain path.
Then a JSON line with each kernel's launches, error and times, the
nvidia-smi line, and as the last line {"ok": true, "device": {...}}.

Any failed check raises and the script exits non-zero. Without a CUDA
device it exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

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


def phase_build(fa, pa) -> None:
    t0 = time.time()
    for kern in (fa.KERNEL, pa.KERNEL):
        kern.build()
    phase("build", f"{fa.KERNEL.source.name} + {pa.KERNEL.source.name} "
          f"built/loaded in {time.time() - t0:.1f} s")


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
    fa.KERNEL.launches = 0
    pa.KERNEL.launches = 0
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


def main() -> int:
    smi = phase_device()
    from unilm_tpu_torch.ops import flash_attention as fa
    from unilm_tpu_torch.ops import paged_attention as pa

    phase_build(fa, pa)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = [phase_flash(fa, g), phase_decode(pa, g)]
    launches = phase_slice(fa, pa)
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
