#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (unilm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, one line each; every line printed starts with its phase and the
seconds since the script started ("[flash 35s] ..."):
 1. device: requires CUDA; prints the card's name and power limit
    (nvidia-smi); turns TF32 off for matmul and cuDNN.
 2. build: compiles the hand-written kernels from unilm_tpu_torch/csrc/,
    one nvcc per source, all started together; beside them `nvcc -Xptxas
    -v` on the Hopper sources (flash_fwd.cu, flash_bwd.cu, flash_tri.cu,
    encoder_attention.cu, doc_attention.cu, doc_attention_bwd.cu,
    decode_attention.cu's split walk, onepass_attention.cu's and
    encoder_attention_bwd.cu's bf16 entries, flash_bwd_fused.cu,
    int8_matmul.cu's wgmma kernel, paged_attention.cu's split walk)
    prints each kernel's registers and spill bytes and fails on a spill or
    a serialised wgmma. "With L2 flushed" below means after a 64 MB read.
 3. flash: the flash-forward kernel (#1; bf16 is the wgmma/TMA kernel)
    against its plain version, bf16, over causal/offset/kv_len/key-padding/
    bias/window cases that hit each class of key tile (skipped, interior,
    boundary: the diagonal, a window edge and kv_len mid-tile), T < 64, D
    in {64, 96, 128}, ragged T and S, fully masked rows (out 0, lse 0), the
    Kosmos-2.5 prefill shape 1x2052x16x96, YOCO's long self-layer
    prefill 1x4096 over 4128 keys, 16x64, causal, window 1024, kv_len 4096,
    and GAD's verify (search) 1x17x16x96 over the 2560-slot pool, causal,
    q_offset = start, kv_len = start + 17, at two starts; then device
    time and TFLOP/s at the slice's prefill, the tower (1x4096x24x64,
    key-padding mask, scale 1.0), the train shape (2x2048x32x64
    causal+kpm) and the verify, beside the plain twin, sdpa and the bound;
    the train shape run twice, bit-equal.
    onepass (right after flash): the one-pass short-sequence forward (#5)
    against flash_forward_onepass_plain at #1's tolerances (bf16; fp32 at
    1e-4): yoco_chat's self-layer prefill 8x128 over 256 slots (causal,
    window 1024, kv_len 128) and decode (T=1, q_offset 140, kv_len 141),
    its cross layer (no window), the TPU kernel's fast path (S=200,
    non-causal, full kv), a key-padding mask with a fully masked row (out
    0, lse 0), [1,H,T,S] and [B,1,T,S] biases, fp32 at D=96 and 128, S and
    T up to 2048, the bf16 plan's edges (T 16 / 17 between the short-q
    walk and the wgmma rows, S 256 / 257, a second 64-row consumer); timed
    at the prefill and decode shapes beside #1 on the same inputs, the
    plain twin and sdpa with a boolean mask.
    flash_tri (right after flash): the lower-triangle causal forward (#2)
    against flash_forward_tri_plain, bf16 (relative L2 <= 1e-2) and fp32
    (<= 1e-4), out and lse: T = S in {1, 63, 64, 65, 160, 1000, 2048}, D
    in {64, 96, 128}, with and without a key-padding mask (one example's
    row 0 sees no key: out 0, lse 0), bias None, [B,H,T,S], [1,H,T,S],
    [B,1,T,S]; bf16 also at T in {127, 128, 129, 255, 257} with and
    without the mask (the 128-row tiles' edges); then the train shape
    2x2048x32x64 causal+kpm, bit-equal twice, device time in two turns
    beside #1 on the same inputs, the plain twin and sdpa(is_causal=True).
    flash_bwd_fused (right after flash_bwd): the one-pass backward (#8)
    against flash_backward_fused_plain on #1's out and lse, bf16 and fp32,
    dq/dk/dv: causal + key-padding with a fully masked row, q_offset +
    kv_len, window, non-causal, ragged T != S, D in {64, 96, 128}, T and S
    at the 64-row / 64- and 128-key tile edges; the train shape twice
    bit-equal, timed (CUDA events and device time) beside #6 + #7, the
    plain twin and sdpa's backward.
    encoder_bwd (right after encoder_attn): the encoder attention
    backward kernel (#4) against fused_encoder_backward_plain, bf16 and
    fp32, dq/dk/dv/dbias (relative L2 <= 1e-2 / 1e-4): bias None,
    [1,1,T,S], [1,H,T,S] (summed over the batch), [B,H,T,S], [B,1,T,S]
    (summed over the heads), ragged T != S, D in {64, 96, 128}, S up to
    2048, BEiT-B at B=256 (two runs bit-equal); timed at BEiT-B beside the
    plain twin and the backward of torch's scaled_dot_product_attention
    (CUDA events), and as device time; prints the batch groups and the
    partial planes' bytes of `enc_bwd_plan`.
    encoder_attn (run after flash_bwd): the fused encoder attention
    kernel (#3) against its plain version, bf16 (relative L2 <= 1e-2) and
    fp32 (<= 1e-4): bias None, [1,1,T,S], [1,H,T,S], [B,H,T,S], ragged
    T != S, D in {64, 96, 128}, S up to 2048, S in {208, 256, 257} (the
    bf16 kernel's whole-row and streamed plans), BEiT-B 128x197x12x64 and
    BEiT-L/384 64x577x16x64; device time at BEiT-B and BEiT-L/384 in two
    turns beside torch's scaled_dot_product_attention, the plain version
    and the bound.
    doc_attn (after encoder_bwd): the doc attention kernel (#9) against
    doc_attention_plain, bf16 (relative L2 <= 1e-2) and fp32 (<= 1e-4):
    bias None, [1,1,T,S], [1,H,T,S], [B,H,T,S], head-major [H,B,T,S] and
    [H,1,T,S], with and without a key-padding mask (one example with
    every key masked), ragged T != S, D in {64, 96, 128}, S up to 2048, the
    Pix2Struct tower 1x2048x24x64 at scale 1.0 and the FUNSD shape
    32x709x12x64 (bf16, head-major bias, mask, twice bit-equal); bf16 at
    the tiles' edges (T, S in {63, 64, 65, 127, 128, 129}, D 64/96/128,
    each twice bit-equal); timed at FUNSD beside the plain version and
    SDPA with a float attn_mask (CUDA events and device time), and as
    device time at the tower's 1x1024x24x64 beside SDPA.
    doc_bwd: its backward (#10; bf16: three wgmma launches, profiler
    names `doc_bwd_*`) against doc_backward_plain over the same cases,
    dq/dk/dv/dbias (dbias reduced where the bias broadcasts), the FUNSD
    shape twice bit-equal; timed beside the plain twin and SDPA's backward
    with the float mask's gradient.
 4. decode: the bf16 run-decode kernel (#13, the split walk, profiler name
    `decode_run_split_sm90`) against its plain version, B=3 with lengths
    {0, 511, 1800}, and B=1 at the edges of the split plan and at 2052;
    written pool rows bit-equal; the kernel alone timed (device time)
    back to back and with L2 flushed beside sdpa over the same run.
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
    tower, #1 only in the resampler, features against the plain path, and
    its device time split (#9, #1, cuBLAS, other); TTFT for both paths; a
    device-time profile.
    decode_int8_bs1: bench.py line 4 at full width: kosmos2_5 bf16
    without the tower, scanned, the text decoder's projections and the LM
    head int8 (kosmos_infer --int8's quantization) and the KV pool int8;
    a 2052-token prompt, a cache of 2052 + 4000 slots, 64 greedy steps
    through runtime.generate: exactly 24 launches of #1 and 144 + 1 of
    #14 in the prefill, 24 of #13-int8 and 145 of #14 a step; ms/token on
    the host clock over the 64 steps (3 rounds), the prefill time, device
    time a step by group (#14 on the layers, #14 at the head timed alone,
    #13-int8, cuBLAS, other) and the busy share; the plain path
    teacher-forced (8 steps); #14 alone at the head (M1 and M5 x K1536 x
    N108481, the last 64-channel tile holding one channel) and at the
    prefill's M2052, against int8_matmul_plain, timed back to back and
    with L2 flushed beside the bound and a dequantized-W bf16 cuBLAS
    product; #13-int8 alone at B1 L2052 and at kosmos_infer's B5 L2053
    (a 2116-slot cache) against its plain version, the three pools
    bit-equal, with its split count.
    kosmos_infer: cli/kosmos_infer.py's build_pipeline at full width with
    --int8 --beam 5 --max_new_tokens 64 (random weights) on patches made
    on the card: 4096 slots (43 launches of #1 a TTFT), then 2048 slots
    (18 of #9 in the tower); 24 of #13-int8 and 145 of #14 a beam step;
    --beam 1 equal to beam search of width 1; two beam steps at B=5, a
    `_gather_beams` that duplicates a parent between them, held against
    the plain path (logits within LOGIT_ATOL, argmax agreement); the best
    beam's score recomputed teacher-forced on the plain path (a secondary
    check); the beam step's device time by group, `_gather_beams`' pool
    copy its own group.
    trocr_kernels: TrOCR's kernels alone at its shapes against their plain
    versions: #13 bf16 on the short pools (page 16, chunk 2, 4 pages a
    run, H16 D64) at B160 and B5, lengths at the page, slab and run
    edges (1 .. 34), pools bit-equal; #3 at the DeiT encoder's
    32x578x12x64 and the folded cross-attention's 32x5x578x16x64; #14 at
    M160 (K1024 -> N1024 / 4096, K4096 -> N1024), the prefill's cross K/V
    projection M18496 K768 N1024 and the head M160 K1024 N50265; each
    timed (device time, back to back and with L2 flushed) beside the
    plain version, sdpa or a dequantized-W cuBLAS product, and the bound.
    trocr / trocr_int8: trocr_base (DeiT-B/16 at 384, the 12-layer
    post-LN decoder, E 1024, vocab 50265) bf16 through
    cli/trocr_infer.py's pipeline (random weights from seed 0; int8:
    --int8), beam 5, 32 new tokens, synthetic 384x384 images, at B=1 and
    B=32: 12 launches of #3 per encode; in the prefill 12 of #5 (the
    1-token prompt's causal self-attention) and 12 of #3 (the
    cross-attention over the 578 encoder tokens); 12 of #3 (the folded
    cross-attention) and 12 of #13 a decode step; under --int8 121 of #14
    in the prefill and 97 a step; the cross K/V at one address from the
    prefill to the last step, untiled; ms/batch and lines/s; device time
    a step by group beside the search and `_gather_beams`; the encoder
    features and two beam steps (a parent-duplicating gather between
    them) against the plain path, LOGIT_ATOL / ARGMAX_AGREE.
    kosmos2_kernels: Kosmos-2's kernels alone at its shapes against their
    plain versions: #3 and #4 (dq, dk, dv) at the CLIP tower's
    Bx257x257x16x64 and the resampler's Bx64x321x32x64, #5 at the
    prefill's causal Bx75x32x64, #13 bf16 on the decoder's pools (page
    16, chunk 2, 8 pages a run, H32 D64), each at B 8 and 1; timed (device
    time, back to back and with L2 flushed) beside the plain version, sdpa
    (or sdpa's backward) and the bound.
    kosmos2: kosmos2(bf16) at full width (ViT-L/14 at 224, 64 latent
    queries, the 24-layer E=2048 decoder; 1.66 B params, random weights
    from the seed) through cli/kosmos_ground_eval.py's --kosmos2 model and
    its refcoco prompt (prefix <phrase>a dog</phrase>, byte-tokenizer
    ids, a 75-token prompt), 224x224 pseudo-images from load_image, B=1
    and B=8, 32 greedy tokens: exactly 25 launches of #3 an encode, 24 of
    #5 a prefill, 24 of #13 a step and nothing else; the markup through
    parse_grounded_text, printed only (random weights, and the byte
    tokenizer renders the model's ids past its own as off-grid patch
    indices); TTFT (host and device time), ms/token, a step's
    device time by kernel group, busy share, peak memory; encode_image's
    features, the prefill's logits and two decode steps against the
    plain twin; then one SEED-Bench scoring forward through
    cli/kosmos_seedbench.py (4 questions x 4 choices: 25 #3, 24 #5), its
    mean answer log-probs and argmax choices against the plain twin's.
    kosmos2_train: cli/train_gpt.py --vl_data at kosmos2()'s widths (bf16,
    --remat, --fused_ce, batch 2 x 512 tokens) over a laion_obj shard
    written to chip_smoke_work/, 3 AdamW steps: finite losses, exactly 25
    #3 and 25 #4, 24 #6 and 24 #7 and 48 #1 (the forward, again under
    --remat) a step; ms/step, peak memory; a 2-layer copy (tower and
    decoder) against its plain twin on the first batch: float32 loss,
    grad norm and per-tensor gradient cosines, bf16 grad norm and cosines
    at the train phase's gates, the bf16 loss at KOSMOS2_TEACHER_LOSS_REL
    (the k_proj biases without xPos, whose exact gradient is 0, by norm
    only).
    beit_family_kernels: the BEiT family's kernels alone at each of its
    shapes against their plain versions (relative L2 1e-2 in bf16, 1e-4
    in float32): #3 at 64x197x12x64 (BEiT-3's vision forwards), at
    captioning's 32x229 with the [1,1,229,229] uni-mask bias and at
    VQ-KD's 64x196 in bf16 and float32, #9 at VQA's 32x237 and the
    retrieval text tower's 64x40 with their key-padding masks, #4 at
    BEiT-2's 64x197 with the shared [1,12,197,197] bias and its dbias;
    timed (device time, back to back and with L2 flushed) beside the plain
    version, sdpa (or sdpa's backward) and the bound.
    beit3: beit3_base() built through models/registry (768 wide, 12
    layers, 12 heads, vocab 64010, 224 px, bf16, random weights from the
    seed) and each head of models/beit3.py and models/vlmo.py on synthetic
    images and questions of 6-40 tokens padded to 40: classification at
    B=64 (12 #3 a forward), VQA at B=32 (237 tokens, the padding mask: 12
    #9), captioning at B=32 (32 text tokens under the uni-mask: 12 #3),
    retrieval (the image tower at B=64: 12 #3, the text tower at B=64 over
    the 40 padded tokens: 12 #9), NLVR2 at B=16 (two joint forwards: 24
    #9), VLMo ITM and MLM at B=32 (12 #9 each); every launch count exact;
    each head against its plain twin (max |dlogit| 0.08, logits relative
    L2 2e-2, argmax agreement 75%; retrieval: each tower's embeddings at
    relative L2 2e-2 and the same best text wherever the plain path's lead
    is clear); host ms a forward, img/s or pairs/s, device time by group.
    beit2: VQKD() in bf16 takes the ids of 64 synthetic images (12 #3),
    at least 90% equal to the plain path's; one update_ema=True pass of
    the float32 VQKD (15 #3), its codebook and cluster sizes within 1e-4
    of the plain path's and its reconstruction (and the decoder alone on
    one quantized input) within 1e-4 relative L2; DalleEncoder() ids at 112 px (B=64, float32,
    library convolutions) against the CPU on two images; then 3 steps of
    BEiT2ForMaskedImageModelingCLS at Beit2PretrainConfig() widths (bf16,
    B=64, MaskingGenerator's 75-patch masks, the VQ-KD ids as targets,
    the masked CE of both heads through runtime.train.make_train_step):
    12 #3 and 12 #4 a step, ms/step, peak memory, device time by group, a
    kernel-vs-plain teacher check of one batch at the BEiT fine-tune
    gates (loss 6e-5 rel, grad norm 8e-5, cosine 0.998).
    yoco_chat: yoco_base (12 sliding-window + 12 cross layers, E=1024, 16
    heads, bf16 compute / fp32 params, random weights from the seed)
    through runtime.generate: B=8, a 128-token prompt, a 256-slot cache,
    128 greedy tokens (eos never drawn); exactly 24 launches of #5 per
    forward and none of #1/#2; tokens/s, prefill ms and decode ms/token
    for the kernel and plain paths, peak memory, a device-time profile
    (#5's share); the plain path teacher-forced on the kernel's tokens.
    yoco_long: the same model, B=1, a 4096-token prompt in a 4128-slot
    cache, 32 tokens: 24 launches of #1 per forward (the self layers with
    the window) and none of #5; TTFT, decode ms/token, the plain path
    teacher-forced.
    search (after trocr_int8): aggressive decoding on the Kosmos-2.5
    decoder at full width (bf16, the slice's 2052-token prompt, block 16,
    64 tokens) with two drafts, greedy's tokens with every 5th corrupted
    and one always wrong: every verify call's logits against the plain
    twin teacher-forced (LOGIT_ATOL, ARGMAX_AGREE), exactly 24 launches of
    #1 (or #5) a verify and none of #13; model calls, tokens a verify, ms
    a token beside greedy's. Constrained beam 5 with two ordered phrases a
    line on Kosmos-2.5 (B=1: 24 #1 in the prefill, 24 #13 a step) and on
    TrOCR-Base through cli/trocr_infer's pipeline (B=32: 12 #5 + 12 #3 in
    the prefill, 12 #3 + 12 #13 a step): every hypothesis with `met`
    holds its phrases in order, the best teacher-forced on the kernel and
    the plain path within BEAM_SCORE_ATOL of its score, ms a step beside
    plain beam search's.
    docai_kernels (after train_options' encoder part): the kernels of the
    Document AI and TrOCR fine-tune paths alone at those paths' shapes
    against their plain versions (bf16 relative L2 1e-2, fp32 1e-4,
    gradients by grad_close): #9 at LayoutLMv2's 32x561 (fp32) and 16x561
    (bf16) with the dense per-example [B, 12, 561, 561] bias and the
    key-padding mask, and at LayoutLM / MarkupLM's 32x512 (fp32) and
    16x512 (bf16) with the mask alone; #10 at the two bf16 shapes; TrOCR's
    #4 at the DeiT encoder's 32x578x12x64, #3 and #4 at the decoder's
    cross-attention 32x64 over 578 slots, #5 at its causal self-attention
    32x64x16x64 and #6 / #7 on #5's out and lse; each timed as device
    time beside the plain version, sdpa (or sdpa's backward) and the bound.
    docai: layoutlm_base, markuplm_base and layoutlmv2_base (12 layers,
    E=768, 12 heads, random weights from the seed) through
    models/registry.build: eval in float32 at B=32 over 512 token slots
    with padded rows (LayoutLMv2 with 224x224 pages: 512 + 49 tokens under
    its dense bias), exactly 12 launches of #9 a forward and nothing else,
    docs/s, the valid tokens' logits against the plain path (LayoutLMv3's
    eval bounds); MarkupLM's QA head once; then 3 bf16 fine-tune steps at
    B=16 (AdamW lr 1e-5 wd 0.01, clip 1.0; LayoutLMv2's loss adds the RE
    head over 64 entity pairs): exactly 12 #9 and 12 #10 a step, ms/step,
    docs/s, peak memory, device time by kernel group, a teacher check of
    one batch against the plain path at LayoutLMv3's fine-tune bounds.
    trocr_train (after trocr_int8): trocr_base fine-tuning at full width
    (bf16 / fp32 params) through runtime/train.teacher_forced_loss and
    runtime.train.make_train_step, B=32 synthetic 384x384 lines with
    32-64 target tokens, label smoothing 0.1, AdamW lr 2e-5 wd 0.01, clip
    1.0: 3 steps at dropout 0 and 3 at 0.1, exactly 24 #3, 24 #4, 12 #5,
    12 #6 and 12 #7 a step at both rates; ms/step, lines/s, peak memory,
    device time by group; a teacher check at dropout 0 at the initial
    weights against the bf16 plain path at the train phase's bounds: loss,
    grad norm and every tensor's gradient cosine (the key biases by the
    norm only); printed beside it, the same with JAX's flash delta from
    the bf16 out, and after the steps the plain path against itself with
    its weights perturbed by 2^-11.
    trocr_small / trocr_small_int8 / trocr_small_train (after
    trocr_train): the same three for trocr_small (a 12-layer DeiT of 6
    heads of 64 at 384, the 6-layer E=256 decoder of 8 heads of 32):
    cli/trocr_infer.py --arch trocr_small --bf16 --beam 5 [--int8] at B=1
    and B=32, 12 #3 at D = 64 an encode, 6 #5 and 6 #3 at D = 32 a
    prefill, 6 #3 and 6 #13 at D = 32 a step (int8 61 / 49 #14), against
    the plain path as trocr's; the fine-tune step's 18 #3, 18 #4 (12 at
    D = 64, 6 at D = 32), 6 #5, 6 #6 and 6 #7 at D = 32, its teacher at
    trocr_train's bounds.
    spm: cli/trocr_eval.py --spm tests/fixtures/tiny_digits.model on its
    synthetic lines (the CLI's full-width model at 64 px), beam 5: per
    batch 12 #3 + 12 #5 + 12 #3 in encode and prefill, 12 #3 + 12 #13 a
    decode step, exactly; the VLTokenizer "spm" backend's ids of a
    grounding prompt; data/spm.py against the sentencepiece package where
    it is installed (printed).
    reproduce_baseline (after beit2): cli/reproduce_baseline.py --smoke on
    the card for trocr_iam, funsd, kosmos_ocr, beit_base_eval and
    beit_large_eval: a well-formed verdict each.
    train_options (after layoutlmv3_train; its UniGPT part inside train,
    after train_schedules), each run 3 timed steps and a profiled one:
    BEiT-B (B=256) without remat, under remat "dots" (24 #3 + 12 #4 a
    step: the recompute relaunches #3) and with attention_dropout 0.1
    (the plain attention: no #3/#4); LayoutLMv3-B FUNSD (B=32) at dropout
    0.1 (12 + 12 #9/#10);
    the 1.3B UniGPT: microbatch 0 under "dots" against "full" at the
    teacher's bounds, steps without remat (96 #1/#6/#7 a step)
    and under "full" and "dots" (192 #1, 96 #6/#7), its four microbatches
    at dropout 0.1 twice from one seed bit-equal and once from another
    different (96 #1/#6/#7 each); ms/step (host clock), the device time
    of a step and peak memory each.
 6. int8_matmul: the int8 weight-only matmul kernel (#14) against its
    plain version, bf16 x, M in {1, 8, 64, 200} x the decoder's three
    projection shapes (K x N 1536 x 1536, 1536 x 6144, 6144 x 1536), each
    call twice and bit-equal; device time at the three shapes at M 1/8/64,
    back to back and with L2 flushed, beside the plain version and the
    bound; at M8 K1536 N6144 beside torch._weight_int8pack_mm (library_ms)
    and a bf16 cuBLAS product with a dequantized copy of W (a yardstick
    only).
 7. decode_int8: the int8-KV run-decode kernel against its plain version,
    B=8, lengths up to 2111 and the edges of the B=8 split plan, then the
    short caches' page 16, chunk 2 at B=8 and B=1; pools and scale sidecar
    bit-equal; timed back to back and with L2 flushed.
 8. paged_append: the block-table append-decode kernel against its plain
    version, B=8 on scattered tables with two inactive slots; non-trash
    pool pages bit-equal.
    paged: the read-only block-table kernel (#11) against
    paged_decode_attention_plain at the Kosmos-2.5 decoder's width (B=8,
    16 heads of 96), pages of 64 and 16, lengths 2047, 1800, 1536, 1024,
    777, 300, 1, 0 over tables drawn from a permutation of the pool, bf16
    (OUT_ATOL / OUT_RTOL) and fp32 (1e-5), flat and 4-D pools; the L == 0
    row exactly 0, each call twice and bit-equal; timed (device time, back
    to back and with L2 flushed, the flushed time held against the bound)
    at those lengths and at 8 x 2047, page 64, beside the plain version.
    fused (kernel and path phase): swiglu (#15) and rotary (#16) through
    the ops.fused API at yoco_base's widths, bf16 and fp32: swiglu on
    [1, 4096, 4096] and [8, 128, 4096], rotary on q [1, 4096, 16, 64] and
    k [1, 4096, 4, 64] with models/yoco.rotary_sin_cos; 4 launches each,
    held against the plain versions (one bf16 ulp; fp32 1e-5) and rotary
    against models/yoco.apply_rotary; timed beside the plain versions and,
    for swiglu, the eager F.silu(g) * u (two calls).
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
    page_pool: runtime.paged_kv at kosmos2_5()'s decoder width: 24
    layers, each with its own PagePool of [256, 64, 16, 96] bf16 (2.4 GB
    of K+V in all); 8 sequences' prompts (the paged phase's lengths, the
    empty one 129) appended in interleaved 128-token chunks; 64 decode
    steps, each appending one seeded random K/V row per sequence and layer
    and calling paged_attention per layer over lengths + 1 tokens (#11,
    24 x 64 launches exactly); at step 32 two sequences are freed and two
    new ones (prompts of 1000 and 500) take their pages; steps 0, 32 and
    63 held against use_kernel=False (0.05: its scores are bf16) and the
    plain twin (OUT_ATOL / OUT_RTOL); ms/step, and a torch.profiler split
    of one step (#11, index_put, copies, host gaps) with its busy share.
11. flash_bwd (run right after flash): the flash-backward kernels (#6 dq
    + dbias, #7 dk/dv; bf16 the wgmma/TMA kernels) against
    flash_backward_plain on the forward kernel's out and lse, bf16 and
    fp32, over every class of tile in both walks (skipped, interior,
    boundary at the causal diagonal mid-tile, a window edge and kv_len
    mid-tile), causal + key-padding with a fully masked row and a causal
    row whose one key is padding (zero gradients), [B,H,T,S] and
    batch-summed [1,H,T,S] bias (B=3, D=64/96/128), a head- and a
    batch-broadcast bias read without dbias, T < 64, D in {64, 96, 128}
    (128 at T = S = 2048), ragged T and S; then at the train shape
    2x2048x32x64 causal with a key-padding mask, both kernels checked
    against the plain backward, bit-equal twice, and timed as device time
    beside sdpa's backward and the plain backward, with TFLOP/s. In bf16
    #6 takes delta = rowsum(p dp) exactly, in a first sweep: near-uniform
    rows (keys whose v share a large common part) hold dq, dk and dv at a
    cosine of 0.9999 to float32 autograd.
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
    against 2 + save + resume + 2, bit-equal (its T=256, 4-head forward
    fits the one-pass budget and runs #5, not #1).
    train_schedules (inside train, on its trainer and model, before the
    teacher check): UNILM_TPU_TRI_FLASH and UNILM_TPU_FUSED_BWD set (and
    restored after), 4 more optimizer steps on the same batch; every step
    must launch #2 and #8 24 x 4 times and #1/#6/#7 never; loss and grad
    norm finite, loss falling from step 2 on; ms/step, tokens/s, model
    TFLOP/s, peak memory, a device-time profile (#2, #8, cuBLAS, other,
    optimizer), and a teacher check of one microbatch under both
    schedules against the default kernels at the train phase's bounds.
    #8's bf16 delta is #6's sweep launched alone: 24 x 4 a step.
13. moe_train, moe_serve, ring (the MoE and parallel slice, on a one-rank
    NCCL group): the MoE UniGPT at the 1.3B width, 8 layers (4 MoE of 8
    experts, top-2), 4 steps through build_trainer's model and stream,
    its parameters placed by make_mesh / infer_param_shardings /
    shard_parameters, routed as in training (capacity 1.0, the random
    policy), #1/#6/#7 8 x 4 a step, a profile and a teacher check; the
    serving engine on it, bf16 then int8 weights (experts and router in
    full precision), decode and #14 launches counted, 4 teacher-forced
    steps against the plain path routed to the kernel path's experts
    (rows whose own routing would differ counted); the ring's chunk steps (parallel/
    ring_attention.py chunk_forward / merge / chunk_backward, the ring of
    4 ranks played by a loop here) over 2 x 8192 tokens with a
    non-contiguous mask and an all-masked example against #1/#6/#7 on the
    whole sequence, #6 / #7 with the ring's delta timed on one chunk
    ("ring_chunk" under flash_bwd_dq / flash_bwd_dkv), then 2
    SeqParallelLM steps at 2 layers.
14. registry_kernels, registry_text, registry_speech (the registry's
    last eight architectures and their kin, after reproduce_baseline):
    #3 at BEATs' 8x496 with the T5 bias and at UniLM's 8x512 with the
    -1e30 seq2seq bias, #9 at E5's 64x512 (ragged), #13 at UniLM's beam
    decode, each alone against its plain version and timed; e5_base eval
    and an InfoNCE step (#9, #10; the step's teacher in float32),
    unilm_seq2seq_base's train forward (#3) and beam 5 (#3, #13),
    xlmt_base and deltalm_base beam 5 and a label-smoothed step (no
    kernel, as JAX's use_flash=False), retnet_base chunk-parallel then
    recurrent (no kernel), the Diff Transformer's forward (no kernel);
    wavlm_base (float32, no kernel), BEATs classification and tokenizer
    ids (#3), SpeechT5 asr_forward / tts_forward (#3, #5), a SpeechLM
    pretrain step (#3, #4), kosmos2 with the WavLM audio tower (#3, #5,
    #13); the kernel-free models' float32 output on one example, card
    against CPU (1e-4 relative).
15. detection_kernels, rcnn, fcos, segmentation (DiT / LayoutLMv3
    detection and BEiT segmentation, after registry_speech; DiT-B /
    BEiT-B at full width, random weights from the seed): #1 and #6 / #7
    at rcnn's 2x2501x12x64 (non-causal, no mask) and #3 / #4 at fcos's
    8x1025x12x64 with the [1,12,1025,1025] bias and without, fp32 and
    bf16, each alone against its plain version and timed beside sdpa and
    its bound; cascade_dit_base(800 px, 5 classes, mask_on) loaded by
    convert_rcnn from a synthetic detectron2 state dict, eval at B=2 in
    float32 and bf16 (exactly 12 #1 a forward; images/s, proposals/s, the
    NMS sweeps, each part's device time; taps, kept proposals and the
    matched detections' scores and boxes against the plain path), then
    cli/train_detection --head rcnn at 800 px (2 steps: 12 #1 + 12 #6 +
    12 #7 a step; the eval: 12 #1 a batch); the FCOS head through the CLI
    at 512 px, B=8, with --preset dit (the per-layer bias) and
    layoutlmv3 (12 #3 + 12 #4 a step, 12 #3 an eval batch); BEiT-B
    UperNet through cli/train_segmentation at 512 px, 150 classes, B=4
    (the same counts); each path's eval logits and one train batch's loss
    and gradients against the plain path, ms/step, img/s, peak memory
    and a step's device time by kernel group.
16. latentlm, textdiffuser2, distill, dpo, misc_ops (the last slice,
    after segmentation; each at its configuration's full width, random
    weights from the seed): LatentLM (LatentLMConfig(), bf16) over 4 x
    1024 tokens with the σ-VAE's 256 latents of each 128 px image, one
    AdamW step on CE + the diffusion loss (12 #1 + 12 #6 + 12 #7), the
    backbone (12 #1), DDIM over every slot and the VAE's decode; the
    TextDiffuser-2 pipeline's greedy plan (4 #5 a planner call), its
    render and a UNet diffusion_loss step (no kernel); MiniLM v2
    distillation e5_base -> MiniLM-L6-H384's published student (12 heads
    of 32) over 32 ragged rows (18 #9, 12 at D = 64 and 6 at D = 32, and
    5 #10 at D = 32 a step; the q/k/v capture's forward launches equal to
    an uncaptured one's); a DPO step on kosmos2's text decoder, policy and
    reference (48 #1 + 24 #6 + 24 #7); LongNet's dilated attention, a
    ReSA decode step and DynamicConv in float32 (no kernel). Each against
    its plain path (or the CPU in float32), with ms, peak memory and a
    step's device time by kernel group. The total time since the start
    is printed before the JSON lines.
d32_kernels (right after paged): every attention launcher at head_dim
32 against its plain version, bf16 and fp32, at the D = 32 paths' shapes
(the distill student's #9 / #10, TrOCR-Small's #3 / #4 / #5 / #6 / #7 /
#13 bf16 and int8) and off the paths (#1 / #2 / #8 at 2x2048x64x32
causal + kpm, #11 / #12 at 16 heads of 32), one table of cases
(`d32_cases`); each launch tallied at its head dim (`by_head_dim`, which
the main-path phases also read); bf16 timed beside the plain version,
the library call and the bound (`attn_bound`, `flash_bwd_bounds`,
`decode_bound`: the functions every phase's bounds come from).
Then a JSON line of the two int8 paths', the TrOCR paths', the
Kosmos-2 paths', the BEiT family's, search's, train_options', Document
AI's, TrOCR fine-tuning's, the registry slice's and the detection
slice's and the last slice's measurements ("paths"), and one
with each kernel's launches, summed over its main-path phases and listed
by phase in `launches_by_path` (counters set to 0 just before each: slice,
decode_int8_bs1 and kosmos_infer for flash_fwd, slice for decode,
yoco_chat for onepass_attention,
beit_eval for encoder_attention, beit_train for encoder_attention_bwd,
layoutlmv3_eval and kosmos_infer for doc_attention, layoutlmv3_train
for doc_attention_bwd, the engines, decode_int8_bs1 and kosmos_infer for
the int8 kernels, trocr and trocr_int8 for encoder_attention,
onepass_attention and decode_attention, trocr_int8 for int8_matmul,
kosmos2 for encoder_attention, onepass_attention and decode_attention,
kosmos2_train for encoder_attention, encoder_attention_bwd, flash_fwd,
flash_bwd_dq and flash_bwd_dkv, beit3 for encoder_attention and
doc_attention, beit2 for encoder_attention and encoder_attention_bwd, the
engines for the block-table kernel, train for flash_bwd_dq
and flash_bwd_dkv, train_schedules for flash_tri and flash_bwd_fused,
page_pool for paged_attention, fused for swiglu and rotary, search for
flash_fwd, encoder_attention, onepass_attention and decode_attention,
train_options for flash_fwd, flash_bwd_dq, flash_bwd_dkv,
encoder_attention, encoder_attention_bwd, doc_attention and
doc_attention_bwd, docai for doc_attention and doc_attention_bwd,
trocr_train for encoder_attention, encoder_attention_bwd,
onepass_attention, flash_bwd_dq and flash_bwd_dkv, spm for
encoder_attention, onepass_attention and decode_attention,
reproduce_baseline for doc_attention and encoder_attention, moe_train
for flash_fwd, flash_bwd_dq and flash_bwd_dkv, moe_serve for the decode
kernels and int8_matmul, ring for flash_fwd (onepass_attention where it
applies), flash_bwd_dq and flash_bwd_dkv, registry_text for
doc_attention, doc_attention_bwd, encoder_attention and
decode_attention, registry_speech for encoder_attention,
encoder_attention_bwd, onepass_attention and decode_attention, rcnn for
flash_fwd, flash_bwd_dq and flash_bwd_dkv, fcos and segmentation for
encoder_attention and encoder_attention_bwd, latentlm and dpo for
flash_fwd, flash_bwd_dq and flash_bwd_dkv, textdiffuser2 for
onepass_attention, distill for doc_attention and doc_attention_bwd,
trocr_small, trocr_small_int8 and trocr_small_train as their trocr
twins), the D = 32 cases under "d32" (every attention launcher),
error, the TrOCR shapes under "trocr" (encoder_attention,
decode_attention, int8_matmul), the Kosmos-2 shapes under "kosmos2"
(encoder_attention, encoder_attention_bwd, onepass_attention,
decode_attention), the BEiT family's under "beit_family"
(encoder_attention, encoder_attention_bwd, doc_attention), Document AI's
under "docai" (doc_attention, doc_attention_bwd) and TrOCR fine-tuning's
under "trocr_train" (encoder_attention, encoder_attention_bwd,
onepass_attention, flash_bwd_dq, flash_bwd_dkv), the registry slice's
under "registry" (encoder_attention, doc_attention, decode_attention),
the detection slice's under "detection" (flash_fwd, flash_bwd_dq,
flash_bwd_dkv, encoder_attention, encoder_attention_bwd),
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
import functools
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
# the plain-path engine replays the trace's first requests only: the
# whole trace took 87 s of host time on the plain path (H100 80GB HBM3,
# 700 W), a twelfth of the smoke
ENGINE_PLAIN_REQUESTS = 2
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

# YOCO (yoco_base: 12 sliding-window + 12 cross layers, E=1024, 16 heads,
# 4 kv heads, FFN 4096, vocab 64000; bf16 compute / fp32 params, random
# weights from the seed). yoco_chat: a short chat turn, 8 rows of a
# 128-token prompt in a 256-slot cache, 128 greedy tokens: every attention
# call fits the one-pass budget (#5). yoco_long: one 4096-token prompt in
# a 4128-slot cache, 32 tokens: past the budget, every call is #1's.
YOCO_CHAT_B, YOCO_CHAT_PROMPT, YOCO_CHAT_CACHE, YOCO_CHAT_NEW = 8, 128, 256, 128
YOCO_LONG_PROMPT, YOCO_LONG_CACHE, YOCO_LONG_NEW = 4096, 4128, 32
YOCO_TEACHER_STEPS = 16  # decode steps of the teacher-forced plain check

# The card's published peaks (NVIDIA H100 SXM data sheet, dense): a
# kernel's bound is the larger of its bytes over the memory rate and its
# operations over the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}

KERNELS = {}  # JSON name -> CudaKernel (its launch counter)

def by_head_dim() -> dict:
    """{kernel: {D: launches}} since reset_counts(): each attention
    wrapper names its head dim at the launch (CudaKernel.by_head_dim)."""
    return {k: dict(sorted(kern.by_head_dim.items()))
            for k, kern in sorted(KERNELS.items()) if kern.by_head_dim}


def roofline(nbytes: float, ops: float, kind: str = "bf16") -> dict:
    """{"bound_ms", "bound_by"}: the least time the card could take to move
    `nbytes` once and do `ops` operations of type `kind`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def attn_bound(pairs: float, D: int, products: int, *tensors,
               kind: str = "bf16") -> dict:
    """An attention kernel's bound: the `tensors` its call reads or writes,
    each once, and `products` matrix products of 2 D operations over each
    of its `pairs` visible (query, key) pairs: a forward makes two (S = Q
    Kᵀ, P V), a one-call backward five (S, dP, dQ, dK, dV)."""
    return roofline(nbytes(*tensors), products * 2 * pairs * D, kind)


def flash_bwd_bounds(pairs: float, q, k, v, do, lse, mask, dq, dk, dv,
                     kind: str = "bf16") -> tuple:
    """#6's and #7's bounds on one backward's tensors: each reads q, k, v,
    dout, lse, delta (lse's size) and the mask; #6 writes dq over three
    products (S, dP, dQ), #7 dk and dv over four (S, dP, dK, dV)."""
    D, ins = q.shape[-1], (q, k, v, do, lse, lse, mask)
    return (attn_bound(pairs, D, 3, *ins, dq, kind=kind),
            attn_bound(pairs, D, 4, *ins, dk, dv, kind=kind))


def decode_bound(rows: float, B: int, H: int, D: int, item: int,
                 new_rows: bool, extra: float = 0,
                 kind: str = "bf16") -> dict:
    """A decode kernel's bound (#11, #12, #13): `rows` K and V rows of
    `item`-byte elements read in all; B bf16 queries read and outputs
    written; with `new_rows`, B new K / V rows read and written to the pool
    too; `extra` bytes (lengths, scale slabs); 4 D operations a row and
    head."""
    return roofline(2 * rows * H * D * item
                    + (4 if new_rows else 2) * B * H * D * 2 + extra,
                    4 * rows * H * D, kind)


def sdpa(q, k, v, **kw):
    """torch's scaled_dot_product_attention on [B, T, H, D] tensors: the
    library yardstick (library_ms), timed here and used nowhere in the
    port."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)


def reset_counts() -> None:
    for kern in KERNELS.values():
        kern.launches = 0
        kern.by_head_dim.clear()


def counts() -> dict:
    return {name: kern.launches for name, kern in KERNELS.items()}


LAST_PHASE = [""]  # the phase that printed last, for PROFILER_LOST
T0 = time.time()


def phase(name: str, msg: str) -> None:
    """One line: the phase, the seconds since the script started, msg."""
    LAST_PHASE[0] = name
    print(f"[{name} {time.time() - T0:.0f}s] {msg}", flush=True)


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


PROFILER_MISSES = []
PROFILER_LOST = []  # "phase/kernels: records lost of records expected"
FLUSH_KERNELS = []  # the kernel names of cold_ms's flush, once seen


def device_ms(fn, iters: int = 20, only: str = None,
              tries: int = 3, exclude=()) -> float:
    """Mean device time of fn() in ms, from a torch.profiler trace of
    `iters` back-to-back calls: the CUDA kernels whose name holds `only`
    (without `only`, every kernel whose name is not in `exclude`). Unlike
    cuda_ms it leaves out the card's idle gaps, so it is a kernel's own
    time even where the host's wrapper, not the kernel, sets the pace of
    back-to-back calls (microsecond kernels).

    CUPTI now and then loses kernel records from a trace: a sum over the
    records once read #9 at a twelfth of its time. So each kernel name's
    time is the mean of the records the trace kept, times the number of
    times it runs a call. With `only`, that is the launches the KERNELS
    counters saw in one untimed call (each kernel a wrapper's launch
    starts runs once a launch); without, or where no counter moved, the
    name's records over `iters`, rounded up. The records a trace lost
    are noted in PROFILER_LOST and printed at the end. A trace that
    shows no device time is taken again, up to `tries` times; after that
    the call is timed with CUDA events (cuda_ms: every kernel of fn() and
    the gaps between them, so an upper bound), and the miss is noted in
    PROFILER_MISSES and printed."""
    from torch.profiler import ProfilerActivity, profile

    c0 = counts()
    fn()
    torch.cuda.synchronize()
    moved = [n - c0[k] for k, n in counts().items() if n > c0[k]]
    per_call = min(moved) if only and moved else 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        timed = {k: tn for k, tn in device_kernel_times(prof, True).items()
                 if (only in k if only else k not in exclude)}
        if sum(t for t, _ in timed.values()) > 0:
            runs = {k: max(per_call, -(-n // iters))
                    for k, (_, n) in timed.items()}
            lost = sum(runs[k] * iters - n for k, (_, n) in timed.items())
            if lost:
                PROFILER_LOST.append(
                    f"{LAST_PHASE[0]}/{only or 'all'}: {lost} of "
                    f"{sum(runs.values()) * iters}")
            return sum(t / n * runs[k] for k, (t, n) in timed.items())
    ms = cuda_ms(fn, iters)
    PROFILER_MISSES.append(only or "any kernel")
    print(f"device_ms: {tries} profiler traces saw no device time "
          f"({only or 'any kernel'}); CUDA events instead: {ms:.4f} ms",
          flush=True)
    return ms


def device_kernel_times(prof, counts: bool = False) -> dict:
    """Device time (ms) of each kernel name a profile saw; with `counts`,
    (ms, number of records) of each."""
    from torch.autograd import DeviceType

    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = evt.self_cuda_time_total
        t0, n0 = out.get(evt.key, (0.0, 0))
        out[evt.key] = (t0 + t / 1e3, n0 + evt.count)
    return out if counts else {k: t for k, (t, _) in out.items()}


def cold_ms(fn, only: str = None, iters: int = 20) -> float:
    """device_ms of the `only` kernels of fn() (without `only`, of all of
    fn()'s kernels) with the L2 cache flushed before every call, for
    kernels whose inputs would otherwise stay L2-resident across
    back-to-back calls. The flush reads 64 MB (more than the H100's 50 MB
    L2) and writes nothing: a flush by a write leaves the cache full of
    dirty lines, whose write-back then competes with the timed kernel's
    reads."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.ones(16 << 20, dtype=torch.int32, device="cuda")
    # leave out the flush's kernels: their names, from the first trace of
    # the flush that kept its records (CUPTI may lose every record of a
    # short trace, so the names are kept for the later calls)
    for _ in range(0 if only or FLUSH_KERNELS else 3):
        flush.sum()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                flush.sum()
            torch.cuda.synchronize()
        FLUSH_KERNELS.extend(device_kernel_times(prof))
        if FLUSH_KERNELS:
            break
    skip = tuple(FLUSH_KERNELS)
    check(bool(only or skip), "cold_ms: three traces of the flush showed "
          "no kernel")
    return device_ms(lambda: (flush.sum(), fn()), iters, only,
                     exclude=skip)


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


# the Hopper kernels: the wgmma sources, the split decode walks and #5's
# short-q walk; in decode_attention.cu only the walk's entries
# (`decode_run_`), and in paged_attention.cu only #11's (`paged_split_`),
# not the fp32 pools' CUDA-core body they share with #12; in
# onepass_attention.cu and encoder_attention_bwd.cu only the bf16 entries
# (`onepass_kernel_sm90` / `_walk`, `enc_bwd_*_sm90`), not the fp32
# CUDA-core bodies; doc_attention.cu's `doc_fwd_sm90` with #3's fp32 body
# and flash_bwd_fused.cu's `flash_bwd_fused_sm90` with #7's fp32 body
# (FUSED); int8_matmul.cu's `int8_mm_sm90`, not the fp32 x kernel
PTXAS_SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "flash_tri.cu",
                 "encoder_attention.cu", "doc_attention.cu",
                 "doc_attention_bwd.cu", "decode_attention.cu",
                 "onepass_attention.cu", "encoder_attention_bwd.cu",
                 "flash_bwd_fused.cu", "int8_matmul.cu",
                 "paged_attention.cu")


def ptxas_entries(text: str) -> list:
    """(kernel, registers, spill store bytes) per entry of `nvcc -Xptxas
    -v` output; a kernel reads as name<template args>."""
    import re

    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+((?:flash|encoder|"
                      r"doc_bwd|doc_fwd|decode_run|paged_split)_\w+?|"
                      r"enc_bwd_\w+?_sm90|onepass_kernel_(?:sm90|walk)|"
                      r"int8_mm_sm90)I(\w*?)EEv", line)
        if m:
            args = re.findall(r"Li(\d+)", m.group(2))
            kind = ",fp32" if m.group(2).startswith("f") else ""
            name, spill = f"{m.group(1)}<{','.join(args)}{kind}>", 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def phase_build() -> None:
    from unilm_tpu_torch.ops import _native

    t0 = time.time()
    nvcc = _native._nvcc()
    _native.BUILD.mkdir(parents=True, exist_ok=True)
    ptxas = {src: subprocess.Popen(
        [nvcc, *_native.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(_native.BUILD / f"ptxas_report.{src}.so"),
         str(_native.CSRC / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in PTXAS_SOURCES}
    paths = _native.build_all(KERNELS.values())
    for kern in KERNELS.values():
        kern.build()
    names = sorted({p.name for p in paths})
    phase("build", f"{len(names)} libraries built/loaded in "
          f"{time.time() - t0:.1f} s: {', '.join(names)}")
    for src, proc in ptxas.items():
        text = proc.communicate()[0]
        (_native.BUILD / f"ptxas_report.{src}.so").unlink(missing_ok=True)
        check(proc.returncode == 0, f"build: nvcc -Xptxas -v {src}: {text}")
        entries = ptxas_entries(text)
        check(bool(entries), f"build: no ptxas report for {src}: {text}")
        phase("build", f"ptxas {src}: " + ", ".join(
            f"{n} {r} registers, {sp} bytes spilled" for n, r, sp in entries))
        check(all(sp == 0 for _, _, sp in entries)
              and "serializ" not in text.lower(),
              f"build: {src} spills or serialises a wgmma: {text}")


def phase_flash(fa, g) -> dict:
    """Kernel #1 (bf16: the wgmma/TMA kernel) against flash_forward_plain
    over every class of key tile the kernel tells apart: skipped, interior
    and boundary tiles under causal with a q_offset that puts the diagonal
    mid-tile, kv_len and a window edge mid-tile, T < 64, T and S ragged
    (2052, 4128), D = 64, 96 and 128 causal and not, both bias broadcasts,
    a key-padding mask with a fully masked batch row and a causal row 0
    with no key (out 0, lse 0); two fp32 cases (the CUDA-core body) at
    1e-4. Then the main path's three shapes (the
    slice's prefill, the tower, the train step's attention), device time
    beside the plain twin, sdpa and the bound, with TFLOP/s; the train
    shape twice, bit-equal."""
    from unilm_tpu_torch.core.transformer import _scan_pool_geometry

    dev = "cuda"
    bf = torch.bfloat16
    page, _, pp = _scan_pool_geometry(PROMPT + GAD_NEW)
    gad_pool = page * pp  # the search phase's pool: keys a layer holds

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    # (B, T, S, H, D, causal, q_offset, kv_len, window, kpm, bias, scaled)
    # kpm "rand": random keys masked and one batch row wholly; "first": key
    # 0 of batch row 1 masked, so its causal row 0 sees no key; "tail": the
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
        # T < 64: one consumer warpgroup holds every row, the other none
        (3, 33, 33, 4, 64, True, 0, None, 0, "first", None, True),
        (2, 50, 190, 4, 96, False, 0, None, 0, None, None, True),
        # the diagonal 16 rows into a key tile (q_offset 400); q_offset and
        # window together; kv_len mid-tile without causal
        (1, 300, 700, 4, 64, True, 400, None, 0, None, None, True),
        (2, 260, 777, 2, 96, True, 517, None, 300, None, "B1", True),
        (2, 200, 500, 4, 128, False, 0, 333, 0, None, None, True),
        # non-causal D = 96, ragged, with the padding mask
        (2, 333, 419, 4, 96, False, 0, None, 0, "rand", None, True),
        (1, PROMPT, PROMPT, 16, 96, True, 0, None, 0, None, None, True),
        # the main path's other two shapes: the tower and the resampler
        (1, TTFT_PATCHES, TTFT_PATCHES, 24, 64, False, 0, None, 0, "tail",
         None, False),
        (1, IMAGE_TOKENS, IMAGE_TOKENS + TTFT_PATCHES, 16, 96, False, 0, None,
         0, None, None, True),
        # YOCO's long self-layer prefill (yoco_long): past the one-pass
        # budget, so #1 with the window over a 4128-slot cache
        (1, YOCO_LONG_PROMPT, YOCO_LONG_CACHE, 16, 64, True, 0,
         YOCO_LONG_PROMPT, 1024, None, None, True),
        # GAD's verify (search): [last, 16 drafted] at the accepted length
        # over a layer's whole pool, kv_len hiding the stale rows past it
        *[(1, GAD_BLOCK + 1, gad_pool, 16, 96, True, start,
           start + GAD_BLOCK + 1, 0, None, None, True)
          for start in (PROMPT, PROMPT + GAD_NEW - GAD_BLOCK - 1)],
    ]
    worst = 0.0
    for B, T, S, H, D, causal, qoff, kvl, window, kpm, bias, scaled in cases:
        q = rn(B, T, H, D) * (D ** -0.5 if scaled else 1.0)
        k, v = rn(B, S, H, D), rn(B, S, H, D)
        mask = None
        if kpm == "rand":
            mask = torch.rand(B, S, generator=g, device=dev) > 0.3
            mask[-1] = False  # one batch row fully masked -> out 0, lse 0
        elif kpm == "first":
            mask = torch.ones(B, S, dtype=torch.bool, device=dev)
            mask[1, 0] = False  # causal row 0 of batch row 1 sees no key
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
        if kpm == "first":
            check(bool((out[1, 0] == 0).all() and (lse[1, :, 0] == 0).all()),
                  "flash: the row with no key is not out=0, lse=0")
        desc = (f"B{B} T{T} S{S} H{H} D{D} causal={causal} q_offset={qoff} "
                f"kv_len={kvl} window={window} kpm={kpm} bias={bias} "
                f"q_scale={'D^-0.5' if scaled else 1.0}")
        check(ok_o and ok_l, f"flash {desc}: out err {e_o}, lse err {e_l}")
        worst = max(worst, e_o)
        phase("flash", f"{desc}: out max|err| {e_o:.3g}, lse max|err| "
              f"{e_l:.3g} ok")

    # fp32 keeps the CUDA-core body: held at 1e-4, as #5's fp32 cases
    for B, T, S, H, D, qoff, bias in ((2, 70, 263, 4, 96, 193, None),
                                      (2, 97, 150, 2, 128, 0, "B1")):
        q = torch.randn(B, T, H, D, generator=g, device=dev) * D ** -0.5
        k = torch.randn(B, S, H, D, generator=g, device=dev)
        v = torch.randn(B, S, H, D, generator=g, device=dev)
        b = (None if bias is None
             else torch.randn(B, 1, T, S, generator=g, device=dev))
        out, lse = fa.flash_forward(q, k, v, b, None, qoff, causal=True)
        ref, ref_lse = fa.flash_forward_plain(q, k, v, b, None, qoff,
                                              causal=True)
        ok_o, e_o = close(out, ref, 1e-4, 1e-4)
        ok_l, e_l = close(lse, ref_lse, 1e-4, 0.0)
        desc = (f"float32 B{B} T{T} S{S} H{H} D{D} causal q_offset={qoff} "
                f"bias={bias}")
        check(ok_o and ok_l, f"flash {desc}: out err {e_o}, lse err {e_l}")
        phase("flash", f"{desc}: out max|err| {e_o:.3g}, lse max|err| "
              f"{e_l:.3g} ok")

    # the main path's shapes, device time per call (the profiler). Bound and
    # TFLOP/s count 4 D flops per visible (query, key) pair.
    def slice_inputs():
        q = rn(1, PROMPT, 16, 96) * 96 ** -0.5
        return q, rn(1, PROMPT, 16, 96), rn(1, PROMPT, 16, 96), None

    def tower_inputs():
        S = TTFT_PATCHES
        mask = torch.ones(1, S, dtype=torch.bool, device=dev)
        mask[:, S - TOWER_PAD:] = False
        return rn(1, S, 24, 64), rn(1, S, 24, 64), rn(1, S, 24, 64), mask

    timed = {}
    for key, make, causal in (("slice", slice_inputs, True),
                              ("tower", tower_inputs, False),
                              ("train", lambda: train_attn_inputs(g), True)):
        q, k, v, mask = make()
        B, T, H, D = q.shape
        fwd = lambda: fa.flash_forward(q, k, v, None, mask, causal=causal)
        ms = device_ms(fwd, only="flash_fwd_sm90")
        plain_ms = device_ms(lambda: fa.flash_forward_plain(
            q, k, v, None, mask, causal=causal), iters=3)
        if causal:
            # the train batch's pads are keys a causal row could see: sdpa
            # takes is_causal alone, so its yardstick leaves them visible
            lib_ms = device_ms(lambda: sdpa(q, k, v, is_causal=True,
                                            scale=1.0))
            pairs = (causal_pairs(mask, H) if mask is not None
                     else B * H * T * (T + 1) / 2)
        else:
            lib_ms = device_ms(lambda: sdpa(
                q, k, v, attn_mask=mask[:, None, None, :], scale=1.0))
            pairs = B * H * T * float(mask.sum())
        out, lse = fwd()
        bd = attn_bound(pairs, D, 2, q, k, v, mask, out, lse)
        tflops = 4 * pairs * D / ms / 1e9
        timed[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          tflops=tflops, **bd)
        desc = (f"{B}x{T}x{H}x{D} " + ("causal" if causal else "non-causal")
                + ("+kpm" if mask is not None else "")
                + ("" if key != "tower" else ", scale 1.0") + " bf16")
        phase("flash", f"{key} {desc}, device time: kernel {ms:.4f} ms "
              f"({tflops:.1f} TFLOP/s), plain twin {plain_ms:.4f} ms, sdpa "
              f"{lib_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
              f"({bd['bound_by']}); kernel / sdpa {ms / lib_ms:.2f}")
        if key == "train":
            again, _ = fwd()
            check(torch.equal(out, again), "flash: two runs at the train "
                  "shape differ")
            phase("flash", f"train {desc}: two runs bit-equal")
        del q, k, v, mask, out, lse

    # GAD's verify (search): the last block's 17 rows at their offset
    # over the pool, kv_len = start + 17; sdpa takes the same boolean mask
    T = GAD_BLOCK + 1
    start = PROMPT + GAD_NEW - T
    kvl = start + T
    q = rn(1, T, 16, 96) * 96 ** -0.5
    k, v = rn(1, gad_pool, 16, 96), rn(1, gad_pool, 16, 96)
    fwd = lambda: fa.flash_forward(q, k, v, None, None, start, kvl,
                                   causal=True)
    ms = device_ms(fwd, only="flash_fwd_sm90")
    plain_ms = device_ms(lambda: fa.flash_forward_plain(
        q, k, v, None, None, start, kvl, causal=True), iters=3)
    kpos = torch.arange(gad_pool, device=dev)
    qpos = start + torch.arange(T, device=dev)
    vis = (kpos[None] <= qpos[:, None]) & (kpos[None] < kvl)
    lib_ms = device_ms(lambda: sdpa(q, k, v, attn_mask=vis[None, None],
                                    scale=1.0))
    pairs = 16 * float(vis.sum())
    out, lse = fwd()
    # the bytes a verify needs: q, the kv_len rows of K and V, out, lse
    bd = roofline(nbytes(q, out, lse) + 2 * kvl * 16 * 96 * 2,
                  4 * pairs * 96)
    timed["gad_verify"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               tflops=4 * pairs * 96 / ms / 1e9, **bd)
    phase("flash", f"gad_verify 1x{T}x16x96 causal q_offset {start} kv_len "
          f"{kvl} over {gad_pool} keys bf16, device time: kernel {ms:.4f} ms,"
          f" plain twin {plain_ms:.4f} ms, sdpa (bool mask) {lib_ms:.4f} ms, "
          f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}); kernel / sdpa "
          f"{ms / lib_ms:.2f}")
    del q, k, v, out, lse
    sl = timed["slice"]
    return {"name": "flash_fwd", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "unilm_tpu/ops/flash_attention.py:99",
            "max_abs_err": worst, "ms": sl["ms"], "plain_ms": sl["plain_ms"],
            "library_ms": sl["library_ms"], "bound_ms": sl["bound_ms"],
            "bound_by": sl["bound_by"], "tflops": sl["tflops"],
            "shape": f"1x{PROMPT}x16x96 causal bf16",
            **{f"{key}_{name}": timed[key][name]
               for key in ("tower", "train", "gad_verify")
               for name in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "tflops")}}


def phase_onepass(fa, g) -> dict:
    """Kernel #5 against flash_forward_onepass_plain at #1's tolerances
    (bf16; fp32 at 1e-4), over YOCO's shapes, the TPU kernel's options and
    the bf16 plan's edges (T 16 / 17 between the walk and the wgmma rows,
    S 256 / 257 at the 128-key chunks); then timed at yoco_chat's prefill
    and decode shapes beside #1 on the same inputs, the plain twin and
    sdpa with a boolean mask."""
    dev = "cuda"
    bf, f32 = torch.bfloat16, torch.float32
    C, P = YOCO_CHAT_CACHE, YOCO_CHAT_PROMPT
    # (B, T, S, H, D, causal, q_offset, kv_len, window, kpm, bias, dtype)
    cases = [
        # yoco_chat: self-layer prefill and decode (window), cross layer
        (8, P, C, 16, 64, True, 0, P, 1024, None, None, bf),
        (8, 1, C, 16, 64, True, 140, 141, 1024, None, None, bf),
        (8, P, C, 16, 64, True, 0, P, 0, None, None, bf),
        (8, 1, C, 16, 64, True, 140, 141, 0, None, None, bf),
        # the TPU kernel's fast path: non-causal, full kv, S = 200
        (4, 200, 200, 16, 64, False, 0, None, 0, None, None, bf),
        # key-padding mask, the last batch row fully masked
        (3, 100, 150, 8, 64, False, 0, None, 0, "rand", None, bf),
        (2, 120, 120, 4, 96, True, 0, None, 0, None, "1H", bf),
        (3, 100, 77, 4, 64, False, 0, None, 0, None, "B1", bf),
        (2, 45, 45, 2, 128, True, 0, None, 0, "rand", "1H", bf),
        (2, 70, 263, 4, 96, True, 193, None, 0, None, None, f32),
        (2, 97, 150, 2, 128, False, 0, None, 0, "rand", "B1", f32),
        (2, 64, 300, 4, 128, True, 200, 260, 50, None, None, f32),
        # the longest rows the kernel holds: S = 2048 (a window past the
        # first key tiles), T = 2048
        (2, 64, 2048, 4, 64, True, 1984, None, 256, None, None, bf),
        (1, 2048, 2048, 2, 128, True, 0, None, 0, None, None, f32),
        # the bf16 plan's edges (fa.onepass_tile_plan): T = 16 takes the
        # walk, T = 17 the wgmma rows; S = 256 is two whole 128-key
        # chunks, 257 a third of one key; 65 rows put one in a second
        # consumer
        (2, 16, 256, 4, 64, True, 240, None, 0, None, None, bf),
        (2, 16, 257, 4, 128, False, 0, None, 0, "rand", "B1", bf),
        (2, 17, 257, 4, 96, True, 240, None, 0, "rand", "1H", bf),
        (2, 65, 256, 4, 64, True, 191, None, 100, None, "B1", bf),
    ]
    worst = 0.0
    for B, T, S, H, D, causal, qoff, kvl, window, kpm, bias, dt in cases:
        def rn(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dt)

        q = rn(B, T, H, D) * D ** -0.5
        k, v = rn(B, S, H, D), rn(B, S, H, D)
        mask = None
        if kpm == "rand":
            mask = torch.rand(B, S, generator=g, device=dev) > 0.3
            mask[-1] = False  # one batch row fully masked -> out 0, lse 0
        b = None
        if bias == "1H":
            b = rn(1, H, T, S)
        elif bias == "B1":
            b = rn(B, 1, T, S)
        out, lse = fa.flash_forward_onepass(q, k, v, b, mask, qoff, kvl,
                                            causal=causal, window=window)
        ref, ref_lse = fa.flash_forward_onepass_plain(
            q, k, v, b, mask, qoff, kvl, causal=causal, window=window)
        torch.cuda.synchronize()
        if dt == bf:
            ok_o, e_o = close(out, ref, OUT_ATOL, OUT_RTOL)
            ok_l, e_l = close(lse, ref_lse, LSE_ATOL, 0.0)
            worst = max(worst, e_o)
        else:
            ok_o, e_o = close(out, ref, 1e-4, 1e-4)
            ok_l, e_l = close(lse, ref_lse, 1e-4, 0.0)
        desc = (f"{str(dt)[6:]} B{B} T{T} S{S} H{H} D{D} causal={causal} "
                f"q_offset={qoff} kv_len={kvl} window={window} kpm={kpm} "
                f"bias={bias}")
        check(bool(torch.isfinite(out.float()).all()
                   and torch.isfinite(lse).all()),
              f"onepass {desc}: non-finite")
        if kpm == "rand":
            check(bool((out[-1] == 0).all() and (lse[-1] == 0).all()),
                  f"onepass {desc}: fully masked row is not out=0, lse=0")
        check(ok_o and ok_l, f"onepass {desc}: out err {e_o}, lse err {e_l}")
        phase("onepass", f"{desc}: out max|err| {e_o:.3g}, lse max|err| "
              f"{e_l:.3g} ok")

    # ---- timed at yoco_chat's self-layer shapes: device time per call
    # (the kernels take microseconds, less than their wrappers' host
    # time, so back-to-back CUDA events would time the host) ------------
    times = {}
    for name, T, qoff, kvl in (("prefill", P, 0, P),
                               ("decode", 1, 140, 141)):
        B, H, D, S, W = YOCO_CHAT_B, 16, 64, C, 1024
        q = torch.randn(B, T, H, D, generator=g, device=dev).to(bf) * 0.125
        k, v = (torch.randn(B, S, H, D, generator=g, device=dev).to(bf)
                for _ in range(2))
        kw = dict(causal=True, window=W)
        five = lambda: fa.flash_forward_onepass(q, k, v, None, None, qoff,
                                                kvl, **kw)
        keep = fa._keep_mask(T, S, qoff, kvl, True, W, None, dev)[0, 0]
        ms = device_ms(five)
        ms1 = device_ms(lambda: fa.flash_forward(q, k, v, None, None, qoff,
                                                 kvl, **kw))
        plain = device_ms(lambda: fa.flash_forward_onepass_plain(
            q, k, v, None, None, qoff, kvl, **kw))
        lib = device_ms(lambda: sdpa(q, k, v, attn_mask=keep, scale=1.0))
        ms_again = device_ms(five)
        call_ms = cuda_ms(five, 50, 5)
        out, lse = five()
        # what the function needs: q, the kv_len visible K/V rows, out, lse
        pairs = float(keep.sum()) * B * H
        bd = roofline(nbytes(q, out, lse) + 2 * B * kvl * H * D * 2,
                      4 * pairs * D)
        times[name] = dict(ms=min(ms, ms_again), flash_fwd_ms=ms1,
                           plain_ms=plain, library_ms=lib, **bd)
        phase("onepass", f"yoco_chat {name} {B}x{T}x{H}x{D} over a {S}-slot "
              f"cache (q_offset {qoff}, kv_len {kvl}, window {W}) bf16, "
              f"device time per call: #5 {ms:.4f} / {ms_again:.4f} ms, #1 "
              f"{ms1:.4f} ms, plain twin {plain:.4f} ms, sdpa (bool mask) "
              f"{lib:.4f} ms, bound {bd['bound_ms']:.5f} ms "
              f"({bd['bound_by']}); #5 back to back (CUDA events, host "
              f"paced) {call_ms:.4f} ms a call")
    pre, dec = times["prefill"], times["decode"]
    return {"name": "onepass_attention", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/onepass_attention.cu",
            "replaces": "unilm_tpu/ops/flash_attention.py:978",
            "max_abs_err": worst, "ms": pre["ms"],
            "plain_ms": pre["plain_ms"], "library_ms": pre["library_ms"],
            "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
            "shape": f"{YOCO_CHAT_B}x{P}x16x64 over {C} slots, causal, "
                     f"window 1024, kv_len {P}, bf16 (yoco_chat prefill; "
                     f"flash_fwd_ms: #1 on the same inputs)",
            "flash_fwd_ms": pre["flash_fwd_ms"],
            "decode_ms": dec["ms"], "decode_flash_fwd_ms": dec["flash_fwd_ms"],
            "decode_plain_ms": dec["plain_ms"],
            "decode_library_ms": dec["library_ms"],
            "decode_bound_ms": dec["bound_ms"]}


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
    [B,H,T,S], [1,H,T,S], [B,1,T,S]; bf16 also at the 128-row tiles' edges,
    T in {127, 128, 129, 255, 257} with and without the mask; then the
    train shape, device time in two turns beside #1 on the same inputs,
    the plain twin and sdpa(is_causal=True)."""
    dev = "cuda"
    Ts, Ds = (1, 63, 64, 65, 160, 1000, 2048), (64, 96, 128)
    edges = (127, 128, 129, 255, 257)
    biases = (None, "BH", "1H", "B1")
    B, H = 2, 4
    worst = 0.0
    for dtype, bound in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        def rn(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dtype)

        cases = [(Ts[i % 7], Ds[i % 3], bool(i % 2), biases[(i // 2) % 4])
                 for i in range(14)]  # every T twice, every D, mask and bias
        if dtype == torch.bfloat16:
            cases += [(T, Ds[i % 3], kpm, biases[i % 4])
                      for i, T in enumerate(edges) for kpm in (False, True)]
        for T, D, kpm, bias in cases:
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
    again, _ = fa.flash_forward_tri(q, k, v, None, mask)
    check(torch.equal(out, again), "flash_tri: two runs at the train shape "
          "differ")
    # device time in two turns: #2, #1, then #1, #2
    calls = {
        "tri": (lambda: fa.flash_forward_tri(q, k, v, None, mask),
                "flash_tri_sm90"),
        "fwd": (lambda: fa.flash_forward(q, k, v, None, mask, causal=True),
                "flash_fwd_sm90")}
    turns = {key: [] for key in calls}
    for order in (("tri", "fwd"), ("fwd", "tri")):
        for key in order:
            fn, name = calls[key]
            turns[key].append(device_ms(fn, only=name))
    ms, fwd_ms = min(turns["tri"]), min(turns["fwd"])
    plain_ms = device_ms(lambda: fa.flash_forward_tri_plain(q, k, v, None, mask),
                         iters=3)
    lib_ms = device_ms(lambda: sdpa(q, k, v, is_causal=True, scale=1.0))
    pairs = causal_pairs(mask, H)
    bd = attn_bound(pairs, D, 2, q, k, v, mask, out, lse)
    tflops = 4 * pairs * D / ms / 1e9
    phase("flash_tri", f"{B}x{T}x{H}x{D} causal+kpm bf16: rel L2 out "
          f"{r_o:.2e} lse {r_l:.2e}, two runs bit-equal; device time: kernel "
          f"#2 {turns['tri'][0]:.4f} / {turns['tri'][1]:.4f} ms ({tflops:.1f} "
          f"TFLOP/s), #1 on the same inputs {turns['fwd'][0]:.4f} / "
          f"{turns['fwd'][1]:.4f} ms, plain twin {plain_ms:.4f} ms, "
          f"sdpa(is_causal) {lib_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']}); #2 / #1 {ms / fwd_ms:.3f}")
    return {"name": "flash_tri", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/flash_tri.cu",
            "replaces": "unilm_tpu/ops/flash_attention.py:404",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, **bd, "tflops": tflops,
            "flash_fwd_ms": fwd_ms,
            "shape": f"{B}x{T}x{H}x{D} causal+kpm bf16 (flash_fwd_ms: #1 on "
            "the same inputs; device time, the lesser of two turns)"}


def phase_flash_bwd_fused(fa, g) -> dict:
    """Kernel #8 against flash_backward_fused_plain on the forward kernel's
    out and lse, bf16 and fp32, dq/dk/dv at the flash_bwd bounds, with the
    bf16 kernel's tile edges (64-row q tiles, 128-key blocks at D = 64 and
    64-key ones at D = 96 / 128: T, S in {63, 64, 65, 127, 128, 129}); then
    the train shape twice bit-equal, timed (CUDA events and device time)
    beside #6 + #7, the plain twin and sdpa's backward."""
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
        (2, 63, 63, 3, 96, True, 0, None, 0, True),
        (2, 64, 64, 3, 128, False, 0, None, 0, True),
        (2, 65, 65, 3, 64, True, 0, None, 0, True),
        (2, 127, 129, 3, 128, True, 2, None, 0, True),
        (2, 128, 128, 3, 96, False, 0, None, 0, False),
        (2, 129, 127, 3, 64, False, 0, None, 0, True),
        (2, 129, 129, 3, 128, True, 0, None, 70, True),
        (2, 65, 127, 3, 96, True, 62, None, 0, True),
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

    # near-uniform rows (flash_bwd's case): #8 takes the exact delta
    # rowsum(p dp) from #6's sweep launched alone, as #6 does; cosines to
    # float32 autograd on the same bf16-rounded inputs, bound 0.9999
    B, T, H, D = 4, 64, 16, 64
    f32 = torch.float32
    q = (randn(g, B, T, H, D, dtype=f32) * D ** -0.5).to(torch.bfloat16)
    k, do = randn(g, B, T, H, D), randn(g, B, T, H, D)
    v = (0.01 * randn(g, B, T, H, D, dtype=f32)
         + randn(g, 1, 1, H, D, dtype=f32)).to(torch.bfloat16)
    out, lse = fa.flash_forward(q, k, v, None, None, causal=True)
    n_delta = fa.BWD_KERNEL_DELTA.launches
    got = fa.flash_backward_fused(q, k, v, None, 0, None, out, lse, do,
                                  causal=True)
    check(fa.BWD_KERNEL_DELTA.launches == n_delta + 1, "flash_bwd_fused: the "
          "bf16 call did not launch #6's delta sweep once")
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    o32, _ = fa.flash_forward_plain(*ref, None, None, 0, None, causal=True)
    want = torch.autograd.grad(o32, ref, do.float())
    cos = lambda a, b: float(torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.flatten(), dim=0))
    cs = [cos(x, w) for x, w in zip(got, want)]
    check(min(cs) >= 0.9999, f"flash_bwd_fused near-uniform rows: dq/dk/dv "
          f"cosines to float32 {cs} (bound 0.9999)")
    phase("flash_bwd_fused", f"near-uniform rows, v = a common part + 1% "
          f"noise, {B}x{T}x{H}x{D} bf16 causal: #8 dq, dk, dv cosines to "
          f"float32 autograd {', '.join(f'{c:.6f}' for c in cs)} (bound "
          "0.9999)")
    del q, k, v, do, out, lse, got, ref, o32, want

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
    # device time: the kernel alone, then every kernel of the call (#6's
    # delta sweep, the zeroing, the kernel and the dq cast) beside #6 +
    # #7's call
    dev_k = device_ms(fused, only="flash_bwd_fused_sm90")
    dev_all = device_ms(fused)
    dev_pair = device_ms(pair)
    dev_k2 = device_ms(fused, only="flash_bwd_fused_sm90")
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    amask = causal[None, None] & mask[:, None, None, :]
    o = sdpa(qg, kg, vg, attn_mask=amask, scale=1.0)
    dot = do.transpose(1, 2)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), dot,
                                                 retain_graph=True), iters=5)
    dev_lib = device_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), dot,
                                                    retain_graph=True), iters=5)
    del o, qg, kg, vg, amask
    pairs = causal_pairs(mask, H)
    delta = fa._delta(out, do)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    bd = attn_bound(pairs, D, 5, q, k, v, do, lse, delta, mask.int(), dq, dk,
                    dv)
    phase("flash_bwd_fused", f"{B}x{T}x{H}x{D} causal+kpm bf16 (rows 0-2 of "
          f"example 1 fully masked): max|err|/rel L2 {', '.join(errs)}, two "
          f"runs bit-equal; kernel #8 {ms:.4f} / {ms2:.4f} ms "
          f"({10 * pairs * D / ms / 1e9:.1f} TFLOP/s), #6 + #7 {pair_ms:.4f} "
          f"ms, plain twin {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms "
          f"(CUDA events); device time: kernel {dev_k:.4f} / {dev_k2:.4f} ms "
          f"({10 * pairs * D / dev_k / 1e9:.1f} TFLOP/s), the whole call "
          f"{dev_all:.4f} ms, #6 + #7's call {dev_pair:.4f} ms, sdpa backward "
          f"{dev_lib:.4f} ms; bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    return {"name": "flash_bwd_fused", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/flash_bwd_fused.cu",
            "replaces": "unilm_tpu/ops/flash_attention.py:1520",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, **bd, "flash_bwd_pair_ms": pair_ms,
            "device_ms": dev_k, "call_device_ms": dev_all,
            "pair_device_ms": dev_pair, "library_device_ms": dev_lib,
            "shape": f"{B}x{T}x{H}x{D} causal+kpm bf16 (ms with delta and "
            "the dq cast; flash_bwd_pair_ms: #6 + #7 on the same inputs)"}


def phase_encoder_attn(fa, g) -> dict:
    """Kernel #3 against fused_encoder_attention_plain on the same inputs,
    bf16 (relative L2 <= 1e-2) and fp32 (<= 1e-4): bias None, [1,1,T,S],
    [1,H,T,S] and [B,H,T,S], ragged T != S, D in {64, 96, 128}, S up to
    2048, the edges of the bf16 kernel's plans (S = 208 and 256: whole
    rows, two score products; 257: streamed), the BEiT-B and the
    BEiT-L/384 shapes; then device time at BEiT-B and BEiT-L/384 in two
    turns beside the plain twin, sdpa and the bound."""
    dev = "cuda"
    # (B, T, S, H, D, bias)
    cases = [
        (2, 197, 197, 4, 64, None), (2, 197, 197, 4, 64, "11"),
        (2, 197, 197, 4, 64, "1H"), (3, 100, 77, 4, 96, "BH"),
        (2, 37, 301, 2, 128, "1H"), (2, 301, 37, 2, 64, None),
        (2, 131, 93, 3, 96, "11"), (1, 50, 2048, 2, 64, "1H"),
        (1, 70, 1500, 2, 128, None),
        # the bf16 kernel's plan edges: whole rows up to 256 keys, streamed
        (2, 197, 208, 3, 64, None), (2, 197, 208, 3, 64, "1H"),
        (2, 64, 256, 2, 96, None), (2, 64, 256, 2, 96, "BH"),
        (2, 129, 257, 2, 128, None), (2, 129, 257, 2, 128, "11"),
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

    # BEiT-B/224 and BEiT-L/384 with their [1, H, T, T] relative position
    # bias: device time, kernel and sdpa in two turns
    bf = torch.bfloat16
    timed = {}
    for key, (B, T, H, D) in (("beitB", (BEIT_BATCH, 197, 12, 64)),
                              ("beitL", (64, 577, 16, 64))):
        q, k, v = (torch.randn(B, T, H, D, generator=g, device=dev).to(bf)
                   for _ in range(3))
        b = torch.randn(1, H, T, T, generator=g, device=dev).to(bf)
        kern = lambda: fa.fused_encoder_attention(q, k, v, b)
        lib = lambda: sdpa(q, k, v, attn_mask=b)
        turns = {"kernel": [], "sdpa": []}
        for order in (("kernel", "sdpa"), ("sdpa", "kernel")):
            for name in order:
                turns[name].append(device_ms(
                    kern if name == "kernel" else lib,
                    only="encoder_attn_sm90" if name == "kernel" else None))
        ms, lib_ms = min(turns["kernel"]), min(turns["sdpa"])
        plain_ms = device_ms(lambda: fa.fused_encoder_attention_plain(
            q, k, v, b), iters=3)
        out = kern()
        bd = attn_bound(B * H * T * T, D, 2, q, k, v, out, b)
        tflops = 4 * B * H * T * T * D / ms / 1e9
        timed[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          tflops=tflops, **bd)
        phase("encoder_attn", f"{key} {B}x{T}x{H}x{D} bf16, bias [1,{H},{T},"
              f"{T}], device time: kernel {turns['kernel'][0]:.4f} / "
              f"{turns['kernel'][1]:.4f} ms ({tflops:.1f} TFLOP/s), sdpa "
              f"{turns['sdpa'][0]:.4f} / {turns['sdpa'][1]:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
              f"({bd['bound_by']}); kernel / sdpa {ms / lib_ms:.3f}")
        del q, k, v, b, out
    bb = timed["beitB"]
    return {"name": "encoder_attention", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/encoder_attention.cu",
            "replaces": "unilm_tpu/ops/flash_attention.py:580",
            "max_abs_err": worst_abs, "rel_l2_bf16": worst[torch.bfloat16],
            "rel_l2_fp32": worst[torch.float32], "ms": bb["ms"],
            "plain_ms": bb["plain_ms"], "library_ms": bb["library_ms"],
            "bound_ms": bb["bound_ms"], "bound_by": bb["bound_by"],
            "tflops": bb["tflops"],
            "shape": f"{BEIT_BATCH}x197x12x64 bf16 bias [1,12,197,197] "
            "(device time, the lesser of two turns); beitL_*: 64x577x16x64",
            **{f"beitL_{name}": timed["beitL"][name]
               for name in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "tflops")}}


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
    timed at BEiT-B beside the plain twin and sdpa's backward (CUDA events
    around the calls), and as device time (its launches in a profile)."""
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
    dev_ms = device_ms(lambda: fa.fused_encoder_backward(q, k, v, b, do),
                       iters=10, only="enc_bwd_")
    plan = fa.enc_bwd_plan(B, T, T, H, D, tuple(b.shape),
                           sms=torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    dq, dk, dv, dbias = fa.fused_encoder_backward(q, k, v, b, do)
    flops = 10 * B * H * T * T * D
    bd = attn_bound(B * H * T * T, D, 5, q, k, v, do, b, dq, dk, dv, dbias)
    phase("encoder_bwd", f"BEiT-B {B}x{T}x{H}x{D} bf16, bias [1,{H},{T},{T}]"
          f": kernel {times['kernel']:.4f} ms (CUDA events; device time "
          f"{dev_ms:.4f} ms, {flops / dev_ms / 1e9:.1f} TFLOP/s; "
          f"{plan['groups']} batch groups of {plan['group']}, "
          f"{plan['blocks']} dk/dv blocks, partial planes "
          f"{plan['partial_bytes'] / 1e6:.1f} MB, dbias tile stride "
          f"{plan['tp']}), plain {times['plain']:.4f} ms, sdpa backward "
          f"{lib_ms:.4f} ms ({backend}), bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']})")
    return {"name": "encoder_attention_bwd", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/encoder_attention_bwd.cu",
            "replaces": "unilm_tpu/ops/flash_attention.py:711",
            "max_abs_err": worst_abs, "rel_l2_bf16": worst[torch.bfloat16],
            "rel_l2_fp32": worst[torch.float32], "ms": times["kernel"],
            "device_ms": dev_ms,
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


# #9's bf16 tile edges: 64-row consumers, 128-row blocks, 64-key tiles
DOC_EDGES = (63, 64, 65, 127, 128, 129)


def phase_doc_attn(da, g) -> dict:
    """Kernel #9 against doc_attention_plain on the same inputs, bf16
    (relative L2 <= 1e-2) and fp32 (<= 1e-4) over DOC_CASES, the FUNSD
    shape twice bit-equal; bf16 also at the tiles' edges (T and S in
    DOC_EDGES, D cycling over 64, 96 and 128, a head-major bias, a mask
    with one example wholly masked), each twice bit-equal. Then timed at
    the FUNSD shape (bf16, head-major bias, mask) beside the plain version
    and torch's SDPA with a float attn_mask (the bias plus -inf at masked
    keys), CUDA events and device time, and as device time at the
    Pix2Struct tower's 1x1024x24x64 (mask, scale 1.0) beside SDPA with a
    boolean mask."""
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
            if B == DOC_B:
                check(torch.equal(out, da.doc_attention(q, k, v, b, mask,
                                                        scale)),
                      "doc_attn: two runs at the FUNSD shape differ")
            worst[dtype] = max(worst[dtype], e)
            if dtype == torch.bfloat16:
                worst_abs = max(worst_abs, float((out.float() - ref.float())
                                                 .abs().max()))
            n += 1
            del q, k, v, b, mask, out, ref
        phase("doc_attn", f"{str(dtype)[6:]}: {n} cases, worst rel L2 "
              f"{worst[dtype]:.3g} (bound {tol}) ok"
              + ("; FUNSD bit-equal across two runs"
                 if dtype == torch.bfloat16 else ""))
    edge = 0.0
    for T in DOC_EDGES:
        for S in DOC_EDGES:
            D = (64, 96, 128)[(T + S) % 3]
            case = (2, T, S, 3, D, "hm", True, None)
            q, k, v, _, b, mask = doc_inputs(da, g, torch.bfloat16, *case[:7])
            out = da.doc_attention(q, k, v, b, mask)
            again = da.doc_attention(q, k, v, b, mask)
            ref = da.doc_attention_plain(q, k, v, b, mask)
            torch.cuda.synchronize()
            e = rel_l2(out, ref)
            check(bool(torch.isfinite(out.float()).all()) and e <= 1e-2
                  and torch.equal(out, again),
                  f"doc_attn edge {doc_desc(torch.bfloat16, case)}: rel L2 "
                  f"{e} (bound 1e-2), bit-equal {torch.equal(out, again)}")
            edge = max(edge, e)
            worst_abs = max(worst_abs, float((out.float() - ref.float())
                                             .abs().max()))
    worst[torch.bfloat16] = max(worst[torch.bfloat16], edge)
    phase("doc_attn", f"bf16 tile edges: T, S in {DOC_EDGES}, D 64/96/128, "
          f"head-major bias, mask: {len(DOC_EDGES) ** 2} cases, worst rel L2 "
          f"{edge:.3g} (bound 1e-2), each bit-equal twice")

    B, T, H, D = DOC_B, DOC_T, DOC_H, DOC_D
    q, k, v, _, b, mask = doc_inputs(da, g, torch.bfloat16, B, T, T, H, D,
                                     "hm", True)
    mask[-1] = True  # every example with keys, as in the model
    am = doc_sdpa_mask(da, b, mask)
    kern = lambda: da.doc_attention(q, k, v, b, mask)
    lib = lambda: sdpa(q, k, v, attn_mask=am)
    times = {}
    for _ in range(2):
        for name, fn in (
                ("kernel", kern),
                ("plain", lambda: da.doc_attention_plain(q, k, v, b, mask))):
            times[name] = cuda_ms(fn, iters=10)
    lib_ms = cuda_ms(lib, iters=10)
    dev = {"kernel": device_ms(kern, only="doc_fwd"), "sdpa": device_ms(lib)}
    dev["kernel2"] = device_ms(kern, only="doc_fwd")
    out = kern()
    flops = 4 * B * H * T * T * D
    bd = attn_bound(B * H * T * T, D, 2, q, k, v, out, b.hbts, mask)
    phase("doc_attn", f"FUNSD {B}x{T}x{H}x{D} bf16, head-major bias "
          f"[{H},{B},{T},{T}], mask: kernel {times['kernel']:.4f} ms "
          f"({flops / times['kernel'] / 1e9:.1f} TFLOP/s), plain "
          f"{times['plain']:.4f} ms, sdpa {lib_ms:.4f} ms (CUDA events); "
          f"device time kernel {dev['kernel']:.4f} / {dev['kernel2']:.4f} "
          f"ms, sdpa {dev['sdpa']:.4f} ms; bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']})")
    del q, k, v, b, mask, am, out

    # the Pix2Struct tower at 1024 patch slots: no bias, a mask, scale 1.0
    B, T, H, D = 1, TOWER_SLOTS, 24, 64
    q, k, v, _, _, mask = doc_inputs(da, g, torch.bfloat16, B, T, T, H, D,
                                     None, True)
    bm = mask[:, None, None, :]
    tower = {"kernel": device_ms(lambda: da.doc_attention(q, k, v, None, mask,
                                                          1.0),
                                 only="doc_fwd"),
             "sdpa": device_ms(lambda: sdpa(q, k, v, attn_mask=bm,
                                            scale=1.0))}
    tbd = attn_bound(B * H * T * T, D, 2, q, k, v, q, mask)  # out: q's size
    phase("doc_attn", f"tower {B}x{T}x{H}x{D} bf16, mask, scale 1.0: device "
          f"time kernel {tower['kernel']:.4f} ms, sdpa (bool mask) "
          f"{tower['sdpa']:.4f} ms, bound {tbd['bound_ms']:.4f} ms "
          f"({tbd['bound_by']})")
    return {"name": "doc_attention", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/doc_attention.cu",
            "replaces": "unilm_tpu/ops/doc_attention.py:69",
            "max_abs_err": worst_abs, "rel_l2_bf16": worst[torch.bfloat16],
            "rel_l2_fp32": worst[torch.float32], "ms": times["kernel"],
            "plain_ms": times["plain"], "library_ms": lib_ms, **bd,
            "device_ms": dev["kernel"], "library_device_ms": dev["sdpa"],
            "tower_device_ms": tower["kernel"],
            "tower_library_device_ms": tower["sdpa"],
            "shape": f"{DOC_B}x{DOC_T}x{DOC_H}x{DOC_D} bf16 bias "
            f"[{DOC_H},{DOC_B},{DOC_T},{DOC_T}] + mask (ms: CUDA events; "
            f"tower: 1x{TOWER_SLOTS}x24x64, mask, scale 1.0)"}


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
    bd = attn_bound(B * H * T * T, D, 5, q, k, v, do, b.hbts, mask, dq, dk,
                    dv, dbias)
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
    (out and lse from the forward kernel), bf16 (the wgmma kernels) and
    fp32 (the CUDA-core bodies), over every class of tile in both walks:
    skipped, interior and boundary tiles at the causal diagonal (mid-tile
    through a q_offset), a window edge and kv_len mid-tile; T < 64, ragged
    T and S, D = 64, 96 and 128 (128 at T = S = 2048), every bias
    broadcast, dbias summed over B = 3 (acc_b), dead rows (a fully masked
    example, a causal row whose one key is padding) with zero gradients;
    near-uniform rows whose exact delta a delta from the bf16 out would
    lose, against float32 autograd. Then the train shape: checked,
    bit-equal twice, and timed as device time (#6, #7, the pair, sdpa's
    backward) with TFLOP/s and bounds (#6's: the three products of the
    function, not the two its delta sweep recomputes)."""
    dev = "cuda"
    # (B, T, S, H, D, causal, q_offset, kv_len, window, kpm, bias); kpm
    # True: random keys masked and the last example wholly; "first": key 0
    # of example 1 masked, so its causal row 0 sees no key
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
        # the diagonal 16 rows into a key tile (q_offset 400), q_offset
        # with a window edge mid-tile, kv_len mid-tile without causal
        (1, 300, 700, 4, 64, True, 400, None, 0, False, None),
        (2, 260, 777, 2, 96, True, 517, None, 300, False, "B1"),
        (2, 200, 500, 4, 128, False, 0, 333, 0, False, None),
        # T < 64: #6's second consumer holds no row, #7's q walk one tile
        (3, 33, 33, 4, 64, True, 0, None, 0, "first", None),
        (2, 50, 190, 4, 96, False, 0, None, 0, False, "BH"),
        # acc_b at D = 96, and D = 128 at T = S = 2048 (#7's 64-key blocks)
        (3, 150, 150, 2, 96, True, 0, None, 0, "first", "1H"),
        (2, 2048, 2048, 2, 128, True, 0, None, 0, True, None),
    ]
    worst = 0.0
    for dtype, bound in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        def rn(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dtype)

        for B, T, S, H, D, causal, qoff, kvl, window, kpm, bias in cases:
            q = rn(B, T, H, D) * D ** -0.5
            k, v, do = rn(B, S, H, D), rn(B, S, H, D), rn(B, T, H, D)
            mask = None
            if kpm == "first":
                mask = torch.ones(B, S, dtype=torch.bool, device=dev)
                mask[1, 0] = False
            elif kpm:
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
            if kpm == "first":
                check(bool((got[0][1, 0] == 0).all()), f"flash_bwd {desc}: "
                      "the causal row with no key has a dq")
            elif kpm:
                check(bool((got[0][-1] == 0).all() and (got[1][-1] == 0).all()),
                      f"flash_bwd {desc}: fully masked row has gradients")
            phase("flash_bwd", f"{desc}: max|err|/rel L2 {', '.join(errs)} ok")

    # near-uniform rows over keys whose v share a large common part (the
    # random TrOCR decoder's late self-attention): dp - delta is ~100x
    # below dp, so a delta from the bf16 out loses dq and dk; #6's exact
    # rowsum(p dp) keeps them. Cosines to float32 autograd on the same
    # (bf16-rounded) inputs, beside the twin given JAX's rowsum(dO out)
    B, T, H, D = 4, 64, 16, 64
    f32 = torch.float32
    q = (randn(g, B, T, H, D, dtype=f32) * D ** -0.5).to(torch.bfloat16)
    k, do = randn(g, B, T, H, D), randn(g, B, T, H, D)
    v = (0.01 * randn(g, B, T, H, D, dtype=f32)
         + randn(g, 1, 1, H, D, dtype=f32)).to(torch.bfloat16)
    out, lse = fa.flash_forward(q, k, v, None, None, causal=True)
    got = fa.flash_backward(q, k, v, None, None, 0, None, out, lse, do,
                            causal=True)
    jax_rule = fa.flash_backward_plain(q, k, v, None, None, 0, None, out, lse,
                                       do, causal=True,
                                       delta=fa._delta(out, do))
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    o32, _ = fa.flash_forward_plain(*ref, None, None, 0, None, causal=True)
    want = torch.autograd.grad(o32, ref, do.float())
    cos = lambda a, b: float(torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.flatten(), dim=0))
    cs = [cos(x, w) for x, w in zip(got[:3], want)]
    cj = [cos(x, w) for x, w in zip(jax_rule[:3], want)]
    check(min(cs) >= 0.9999, f"flash_bwd near-uniform rows: dq/dk/dv cosines "
          f"to float32 {cs} (bound 0.9999)")
    phase("flash_bwd", f"near-uniform rows, v = a common part + 1% noise, "
          f"{B}x{T}x{H}x{D} bf16 causal: #6/#7 dq, dk, dv cosines to float32 "
          f"autograd {', '.join(f'{c:.6f}' for c in cs)} (bound 0.9999); "
          f"the twin with a delta from the bf16 out "
          f"{', '.join(f'{c:.6f}' for c in cj)}")
    del q, k, v, do, out, lse, got, jax_rule, ref, o32, want

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
    # 2x96x4x64 fits the one-pass budget: the forward is #5's, not #1's
    check(c1["onepass_attention"] == c0["onepass_attention"] + 1
          and c1["flash_fwd"] == c0["flash_fwd"],
          "flash_bwd: the recompute case's forward did not take #5")
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
          "forward on #5, recompute counted, kernels not launched, dq/dk/dv "
          "match the kernels' (bound 1e-2)")

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
    # the kernels hold against the plain backward at this shape too, and
    # two runs give the same bits
    got, again, ref = pair(), pair(), plain()
    torch.cuda.synchronize()
    errs = []
    for name, x, x2, r in zip(("dq", "dk", "dv"), got, again, ref):
        check(bool(torch.isfinite(x.float()).all()),
              f"flash_bwd train shape: {name} not finite")
        check(torch.equal(x, x2), f"flash_bwd train shape: {name} differs "
              "between two runs")
        ok, e, rel = grad_close(x, r, 1e-2)
        check(ok, f"flash_bwd train shape: {name} max|err| {e} rel L2 {rel} "
              "(bound 1e-2)")
        errs.append(f"{name} {e:.3g}/{rel:.2g}")
        worst = max(worst, e)
    check(bool((got[0][1, :3] == 0).all()), "flash_bwd train shape: the "
          "fully masked leading rows have a dq")
    phase("flash_bwd", f"{B}x{T}x{H}x{D} causal+kpm bf16 (rows 0-2 of "
          f"example 1 fully masked): max|err|/rel L2 {', '.join(errs)} "
          "(bound 1e-2), two runs bit-equal ok")
    del got, again, ref
    mi = mask.to(torch.int32)
    delta = fa._delta(out, do)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))

    def dq_only():
        fa.BWD_KERNEL_DQ.launch(
            "flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), None,
            mi.data_ptr(), dq.data_ptr(), None, B, T, T, H, D, 0, 0, 0, T, 1,
            0, 0, fa.DELTA_SWEEP, 1, torch.cuda.current_stream().cuda_stream)

    def dkv_only():
        fa.BWD_KERNEL_DKV.launch(
            "flash_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), None,
            mi.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, T, H, D, 0, 0,
            0, T, 1, 0, 1, torch.cuda.current_stream().cuda_stream)

    # the yardstick: one backward call of torch's SDPA on the same rows
    # (causal + the same key-padding mask as a boolean mask), dq, dk and dv
    # together
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    amask = causal[None, None] & mask[:, None, None, :]
    o = sdpa(qg, kg, vg, attn_mask=amask, scale=1.0)
    dot = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(o, (qg, kg, vg), dot,
                                           retain_graph=True)
    # device time, in turns: kernel, library, library, kernel
    times = {}
    for name, fn, only in (("dq", dq_only, "flash_bwd_dq_sm90"),
                           ("dkv", dkv_only, "flash_bwd_dkv_sm90"),
                           ("pair", pair, None), ("sdpa", sdpa_bwd, None),
                           ("sdpa2", sdpa_bwd, None), ("pair2", pair, None),
                           ("dkv2", dkv_only, "flash_bwd_dkv_sm90"),
                           ("dq2", dq_only, "flash_bwd_dq_sm90")):
        times[name] = device_ms(fn, only=only)
    times["plain"] = device_ms(plain, iters=3)
    fwd_ms = device_ms(lambda: fa.flash_forward(q, k, v, None, mask,
                                                causal=True),
                       only="flash_fwd_sm90")
    del o, qg, kg, vg, amask
    dq_ms, dkv_ms = times["dq"], times["dkv"]
    lib_ms = times["sdpa"]
    pairs = causal_pairs(mask, H)  # visible (query, key)
    product = 2 * pairs * D  # operations of one product over them
    bd_dq, bd_dkv = flash_bwd_bounds(pairs, q, k, v, do, lse, mi, dq, dk, dv)
    tf = lambda n, ms: n * product / ms / 1e9
    phase("flash_bwd", f"{B}x{T}x{H}x{D} causal+kpm bf16, device time: #6 "
          f"dq {dq_ms:.4f} / {times['dq2']:.4f} ms ({tf(3, dq_ms):.1f} "
          f"TFLOP/s; bound {bd_dq['bound_ms']:.4f} ms, {bd_dq['bound_by']}), "
          f"#7 dk/dv {dkv_ms:.4f} / {times['dkv2']:.4f} ms "
          f"({tf(4, dkv_ms):.1f} TFLOP/s; bound {bd_dkv['bound_ms']:.4f} ms, "
          f"{bd_dkv['bound_by']}); #6 + #7 {dq_ms + dkv_ms:.4f} ms "
          f"({tf(7, dq_ms + dkv_ms):.1f} TFLOP/s), the wrapper's pair with "
          f"delta {times['pair']:.4f} / {times['pair2']:.4f} ms; sdpa "
          f"backward (dq, dk, dv) {lib_ms:.4f} / {times['sdpa2']:.4f} ms; "
          f"pair / sdpa {(dq_ms + dkv_ms) / lib_ms:.2f}; plain backward "
          f"{times['plain']:.4f} ms; forward #1 {fwd_ms:.4f} ms")
    common = {"route": "cuda", "source": "unilm_tpu_torch/csrc/flash_bwd.cu",
              "max_abs_err": worst, "plain_ms": times["plain"],
              "pair_ms": times["pair"], "library_ms": lib_ms,
              "shape": f"{B}x{T}x{H}x{D} causal+kpm bf16, device time "
              "(plain_ms is the whole plain backward, library_ms one sdpa "
              "backward, pair_ms both kernels with delta)"}
    return [dict(common, name="flash_bwd_dq", ms=dq_ms, **bd_dq,
                 tflops=tf(3, dq_ms),
                 replaces="unilm_tpu/ops/flash_attention.py:1235"),
            dict(common, name="flash_bwd_dkv", ms=dkv_ms, **bd_dkv,
                 tflops=tf(4, dkv_ms),
                 replaces="unilm_tpu/ops/flash_attention.py:1381")]


def split_edges(pa, B: int, H: int, D: int, itemsize: int) -> list:
    """Token counts n at the edges of the split walk's plan for B
    sequences of H heads (ops/paged_attention.decode_split_plan): 0 and 1,
    one tile (SPLIT_TILE tokens) +- 1, nsplit tiles +- 1 (every split's
    range crosses from one tile to two) and nsplit * ngrp tiles +- 1
    (every token group's first tile of every split, and one more)."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = pa.decode_split_plan(B, H, 0, n_sm, D, itemsize)
    t = pa.SPLIT_TILE
    return sorted({e + d for e in (t, plan["nsplit"] * t,
                                   plan["nsplit"] * plan["ngrp"] * t)
                   for d in (-1, 0, 1)} | {0, 1})


DECODE_ONLY = "decode_run_split"  # the split walk's CUDA kernel


def phase_decode(pa, g) -> dict:
    """Kernel #13 on bf16 pools (the split walk) against
    run_decode_append_attention_plain: B3 at lengths [0, 511, 1800], then
    B1 (the slice's plan) at every edge of the split plan and at the
    slice's 2052, each within OUT_ATOL / OUT_RTOL, the written pool rows
    bit-equal. Then timed at the slice's B1 L2052 (device time): the kernel
    alone back to back and with L2 flushed, beside sdpa over the same run
    both ways, and the wrapper with the row append beside the plain
    version."""
    dev = "cuda"
    bf = torch.bfloat16
    H, D, page, chunk, PP = 16, 96, 64, 8, 40  # cache 2052+64 geometry

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    worst = 0.0
    cases = [[0, 511, 1800]] + [[n - 1] for n in split_edges(pa, 1, H, D, 2)
                                 if n >= 1] + [[PROMPT]]
    for lens in cases:
        B = len(lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
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
        check(ok and bool(torch.isfinite(out.float()).all()),
              f"decode: lengths {lens}: out err {err}")
        check(torch.equal(kp, kp2) and torch.equal(vp, vp2),
              f"decode: lengths {lens}: written pool rows differ from the "
              f"plain twin's")
        worst = max(worst, err)
    phase("decode", f"H16 D96 page64 chunk8, lengths {cases}: out max|err| "
          f"{worst:.3g} (tol {OUT_ATOL} abs + {OUT_RTOL} rel), pools "
          f"bit-equal ok")

    # one layer of the slice's decode step: B=1, 2052 tokens in the run.
    # `ms` and `plain_ms` are the two wrappers, which both append the row,
    # timed like for like; `kernel_only_ms` is the kernel launch alone.
    # Device time (the profiler): back to back, these microsecond calls
    # are paced by the host, which CUDA events would count.
    L1 = torch.tensor([PROMPT], dtype=torch.int32, device=dev)
    b1 = torch.zeros(1, dtype=torch.int32, device=dev)
    kp1, vp1 = rn(PP, page, H * D), rn(PP, page, H * D)
    q1, kn1, vn1 = rn(1, 1, H, D), rn(1, 1, H, D), rn(1, 1, H, D)
    qs1 = (q1[:, 0] * D ** -0.5).contiguous()
    alone = lambda: pa.decode_attention(qs1, kp1, vp1, b1, L1, PP)
    # the yardstick: torch's SDPA of the query over the same run's L + 1
    # rows (contiguous in the pool); it appends nothing
    run = lambda pool: pool.reshape(1, PP * page, H, D)[:, :PROMPT + 1]
    lib = lambda: sdpa(q1, run(kp1), run(vp1))
    kernel_ms, lib_ms = device_ms(alone, only=DECODE_ONLY), device_ms(lib)
    kernel_cold, lib_cold = cold_ms(alone, DECODE_ONLY), cold_ms(lib)
    ms = device_ms(lambda: pa.run_decode_append_attention(
        q1, kn1, vn1, kp1, vp1, b1, L1, PP, None, chunk))
    plain_ms = device_ms(lambda: pa.run_decode_append_attention_plain(
        q1, kn1, vn1, kp1, vp1, b1, L1, PP, None, chunk))
    bd = decode_bound(PROMPT + 1, 1, H, D, 2, new_rows=True)
    phase("decode", f"B1 L{PROMPT} H16 D96, device time: kernel alone "
          f"{kernel_ms:.4f} ms back to back, {kernel_cold:.4f} ms with L2 "
          f"flushed; sdpa over the run {lib_ms:.4f} / {lib_cold:.4f} ms "
          f"(kernel / sdpa {kernel_ms / lib_ms:.2f}x, {kernel_cold / lib_cold:.2f}x "
          f"flushed); with the row append: kernel wrapper {ms:.4f} ms, plain "
          f"twin {plain_ms:.4f} ms; bound {bd['bound_ms']:.5f} ms "
          f"({bd['bound_by']})")
    return {"name": "decode_attention", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/decode_attention.cu",
            "replaces": "unilm_tpu/ops/paged_attention.py:497",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "kernel_only_ms": kernel_ms,
            "kernel_only_ms_l2_flushed": kernel_cold, "library_ms": lib_ms,
            "library_ms_l2_flushed": lib_cold, **bd,
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

    # ---- the decode step's device time (profiler): #13's share ---------
    pf, st = make_unigpt_generate_fns(model, cache_size)
    lg, c = pf(prompt, aux)
    tok = lg[:, -1:].argmax(-1)
    n = 4
    shares = decode_step_shares(lambda: st(tok, c, None), n)
    phase("slice", f"decode step (B=1, ctx {PROMPT + 1}+, kernel path), "
          f"device time a step (mean of {n}): {sum(shares.values()) / n:.4f} "
          f"ms, of it " + ", ".join(f"{k} {v / n:.4f}"
                                    for k, v in shares.items()))
    return launches


def decode_step_shares(step, n: int) -> dict:
    """Device time (ms) by kernel group of n calls of a decode step:
    #13's split walk, the flash forward, cuBLAS, the int8 matmul, the
    rest."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    return device_time_shares(prof, [
        ("#13", [DECODE_ONLY]), ("#1", ["flash_fwd"]),
        ("#14", [INT8_ONLY, "int8_matmul"]),
        ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet", "cublas", "splitK"])])


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

    groups = [("encoder_attention #3", ["encoder_attn_sm90",
                                        "encoder_attn_kernel"]),
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
    groups = [("encoder_attention #3", ["encoder_attn_sm90",
                                        "encoder_attn_kernel"]),
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
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        model.encode_image(p1k)
        torch.cuda.synchronize()
    tshares = device_time_shares(prof, [
        ("#9 tower", ["doc_fwd"]), ("#1 resampler", ["flash_fwd"]),
        ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet", "cublas", "splitK"])])
    ttotal = sum(tshares.values())
    if ttotal > 0:
        phase("ttft", f"encode_image at {TOWER_SLOTS} slots: device time "
              f"{ttotal:.3f} ms: " + ", ".join(
                  f"{k} {v:.3f} ms ({100 * v / ttotal:.1f}%)"
                  for k, v in tshares.items()))
    else:
        phase("ttft", f"encode_image at {TOWER_SLOTS} slots: the profiler saw "
              "no device time: shares not measured")

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

    groups = [("#1 tower (D=64)", ["flash_fwd_sm90<64>"]),
              ("#1 resampler + decoder (D=96)", ["flash_fwd_sm90<96>"]),
              ("#1 other", ["flash_fwd_sm90", "flash_fwd_fp32"]),
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


# the decoder's projections: q/k/v/out, fc1, fc2 as (K, N)
INT8_SHAPES = ((1536, 1536), (1536, 6144), (6144, 1536))
INT8_ONLY = "int8_mm"  # #14's bf16 kernel (csrc/int8_matmul.cu int8_mm_sm90)


def phase_int8_matmul(qm, g) -> dict:
    """#14 against plain, bf16 x, at the decoder's three projection shapes
    and the M of decode (1, 8), a prefill chunk (64) and more (200), each
    call twice and bit-equal (the split-K merge sums in split order).
    Tolerance: 2 bf16 ulps of the plain result (both round one fp32 value
    to bf16) plus the fp32 sum-order term K * 2^-24 * (|x| @ |W|) * scale.
    Then device time at the three shapes at M 1/8/64, back to back and
    with L2 flushed, beside the plain version and each shape's bound; at
    M8 K1536 N6144 beside two yardsticks: torch._weight_int8pack_mm
    (library_ms) and a bf16 cuBLAS product with a dequantized copy of W
    (twice the weight bytes; printed only)."""
    dev, bf = "cuda", torch.bfloat16
    worst, worst_ratio = 0.0, 0.0
    times, bounds = {}, {}
    for K, N in INT8_SHAPES:
        w = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                          dtype=torch.int8)
        scale = ((torch.rand(N, generator=g, device=dev) + 0.5)
                 * (2.0 / (127 * K ** 0.5)))
        for M in (1, 8, 64, 200):
            x = torch.randn(M, K, generator=g, device=dev).to(bf)
            out = qm.int8_matmul(x, w, scale)
            again = qm.int8_matmul(x, w, scale)
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
            check(torch.equal(out, again), f"int8_matmul M{M} K{K} N{N}: two "
                  f"runs differ")
            worst, worst_ratio = max(worst, float(err.max())), max(
                worst_ratio, ratio)
            if M == 200:
                continue
            key = f"M{M} K{K} N{N}"
            call = lambda: qm.int8_matmul(x, w, scale)
            times[key] = (device_ms(call, only=INT8_ONLY),
                          device_ms(lambda: qm.int8_matmul_plain(x, w, scale)),
                          cold_ms(call, INT8_ONLY))
            bounds[key] = roofline(N * K + N * 4 + M * K * 2 + M * N * 2,
                                   2 * M * N * K)
        phase("int8_matmul", f"K{K} N{N}, M in 1/8/64/200: ok, bit-equal "
              f"twice")
    for key, (ms, plain_ms, cold) in times.items():
        bd = bounds[key]
        phase("int8_matmul", f"{key} bf16, device time: kernel {ms:.4f} ms "
              f"back to back, {cold:.4f} ms with L2 flushed "
              f"({cold / bd['bound_ms']:.2f}x the bound), plain "
              f"{plain_ms:.4f} ms; bound {bd['bound_ms']:.5f} ms "
              f"({bd['bound_by']})")
    phase("int8_matmul", f"max|err| {worst:.3g}, at most {worst_ratio:.3f} "
          f"of the tolerance (2 bf16 ulps + fp32 order term)")
    M, K, N = 8, 1536, 6144
    key = f"M{M} K{K} N{N}"
    bd = bounds[key]
    w = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                      dtype=torch.int8)
    scale = ((torch.rand(N, generator=g, device=dev) + 0.5)
             * (2.0 / (127 * K ** 0.5)))
    x = torch.randn(M, K, generator=g, device=dev).to(bf)
    cold = times[key][2]
    # second yardstick: a bf16 product with a dequantized copy of W (the
    # copy made once, outside the timing), reading twice the weight bytes;
    # back to back its 19 MB sit in L2, so it is held to the kernel with
    # L2 flushed
    wd = (w.float() * scale[:, None]).to(bf)
    dq_ms = device_ms(lambda: torch.matmul(x, wd.t()))
    dq_cold = cold_ms(lambda: torch.matmul(x, wd.t()))
    # library yardstick: torch._weight_int8pack_mm(x, w [N, K], scales [N])
    # computes x @ (w * scale)^T, with the scales in x's dtype (bf16 here,
    # so it may differ from the plain version by the scales' rounding,
    # 2^-9 relative). Timed here only; the port never calls it.
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
        lib_ms = device_ms(lambda: torch._weight_int8pack_mm(x, w, scale_bf))
    phase("int8_matmul", f"{key} device time: kernel {times[key][0]:.4f} ms "
          f"back to back, {cold:.4f} ms with L2 flushed; bound "
          f"{bd['bound_ms']:.5f} ms; torch._weight_int8pack_mm "
          f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} ms; bf16 cuBLAS "
          f"with a dequantized copy of W {dq_ms:.4f} ms back to back, "
          f"{dq_cold:.4f} ms with L2 flushed (yardstick only)")
    return {"name": "int8_matmul", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "unilm_tpu/ops/quant.py:59", "max_abs_err": worst,
            "library_ms": lib_ms, **bd,
            "ms": times[key][0], "plain_ms": times[key][1],
            "ms_l2_flushed": cold, "dequant_bf16_cublas_ms": dq_ms,
            "dequant_bf16_cublas_ms_l2_flushed": dq_cold,
            "shape": f"{key} bf16",
            "ms_by_shape": {k: v[0] for k, v in times.items()},
            "ms_l2_flushed_by_shape": {k: v[2] for k, v in times.items()},
            "plain_ms_by_shape": {k: v[1] for k, v in times.items()},
            "bound_ms_by_shape": {k: v["bound_ms"]
                                  for k, v in bounds.items()}}


def phase_decode_int8(pa, g) -> dict:
    """Kernel #13 on int8 pools (the split walk) against the plain version
    at B8: the lengths [0, 63, 64, 511, 1800, 2111, 1024, 2047] and the
    eight edges of the B8 split plan, within OUT_ATOL / OUT_RTOL, pools
    and sidecar bit-equal; the same at the short caches' page 16, chunk 2
    (slabs of 32 tokens, caches under 1024 slots), B8 and B1. Then timed at
    the serving step's B8 L2047 (device time): the kernel alone back to
    back and with L2 flushed, and the wrapper (quantize + append) beside
    the plain version."""
    from unilm_tpu_torch.core.transformer import _scan_pool_geometry

    dev, bf = "cuda", torch.bfloat16
    H, D, page, chunk, PP, B = 16, 96, 64, 8, 40, 8
    P = B * PP + chunk

    def pools(P, page, chunk):
        kp = torch.randint(-127, 128, (P, page, H * D), generator=g,
                           device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, (P, page, H * D), generator=g,
                           device=dev, dtype=torch.int8)
        sp = (torch.rand(P // chunk, 8, chunk * page, generator=g,
                         device=dev) * 0.02 + 1e-3)
        return kp, vp, sp

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    def held(lens, P, page, chunk, PP):
        Bc = len(lens)
        bases = torch.arange(Bc, dtype=torch.int32, device=dev) * PP
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        kp, vp, sp = pools(P, page, chunk)
        kp2, vp2, sp2 = kp.clone(), vp.clone(), sp.clone()
        q, kn, vn = rn(Bc, 1, H, D), rn(Bc, 1, H, D), rn(Bc, 1, H, D)
        out = pa.run_decode_append_attention(q, kn, vn, kp, vp, bases,
                                             lengths, PP, None, chunk,
                                             scale_pool=sp)[0]
        ref = pa.run_decode_append_attention_plain(
            q, kn, vn, kp2, vp2, bases, lengths, PP, None, chunk,
            scale_pool=sp2)[0]
        torch.cuda.synchronize()
        ok, err = close(out, ref, OUT_ATOL, OUT_RTOL)
        where = f"decode_int8: page {page} chunk {chunk} lengths {lens}"
        check(ok and bool(torch.isfinite(out.float()).all()),
              f"{where}: out err {err}")
        check(torch.equal(kp, kp2) and torch.equal(vp, vp2)
              and torch.equal(sp, sp2),
              f"{where}: pools or sidecar differ from the plain version's")
        return err, (q, kn, vn, kp, vp, sp, bases)

    worst = 0.0
    edges = split_edges(pa, B, H, D, 1)
    cases = [[0, 63, 64, 511, 1800, 2111, 1024, 2047], (edges * B)[:B]]
    for lens in cases:
        err, (q, kn, vn, kp, vp, sp, bases) = held(lens, P, page, chunk, PP)
        worst = max(worst, err)
    phase("decode_int8", f"B{B} lengths {cases} H16 D96 page64 chunk8: out "
          f"max|err| {worst:.3g} (tol {OUT_ATOL} abs + {OUT_RTOL} rel), "
          f"pools and sidecar bit-equal ok")
    # the short geometry: a 1000-slot cache's page 16, chunk 2, 64 pages a
    # run; lengths at the page, slab and split edges and the run's end
    page16, chunk16, PP16 = _scan_pool_geometry(1000)
    cases16 = [[0, 15, 16, 31, 32, 511, 998, 999], [999]]
    short = max(held(lens, len(lens) * PP16, page16, chunk16, PP16)[0]
                for lens in cases16)
    worst = max(worst, short)
    phase("decode_int8", f"page {page16} chunk {chunk16} ({PP16} pages a "
          f"run) lengths {cases16}: out max|err| {short:.3g}, pools and "
          f"sidecar bit-equal ok")

    # B=8, every run at 2047 tokens: the serving step's shape
    L8 = torch.full((B,), 2047, dtype=torch.int32, device=dev)
    qs = (q[:, 0] * D ** -0.5).contiguous()
    kn0, vn0 = kn[:, 0].contiguous(), vn[:, 0].contiguous()
    alone = lambda: pa.decode_attention_int8(
        qs, kp, vp, bases, L8, sp, kn0, vn0, PP, chunk)
    # device time (the profiler), as in phase_decode
    kernel_ms = device_ms(alone, only=DECODE_ONLY)
    kernel_cold = cold_ms(alone, DECODE_ONLY)
    ms = device_ms(lambda: pa.run_decode_append_attention(
        q, kn, vn, kp, vp, bases, L8, PP, None, chunk, scale_pool=sp))
    plain_ms = device_ms(lambda: pa.run_decode_append_attention_plain(
        q, kn, vn, kp, vp, bases, L8, PP, None, chunk, scale_pool=sp),
        iters=10)
    # bytes: the int8 K/V rows of the eight runs, the scale slabs that
    # cover them, q, the new rows and the output; no torch call attends
    # over int8 rows with a scale sidecar (library_ms null)
    L = 2048
    slabs = B * PP // chunk
    bd = decode_bound(B * L, B, H, D, 1, new_rows=True,
                      extra=slabs * sp[0].numel() * 4)
    phase("decode_int8", f"B8 L2047 H16 D96, device time: kernel alone "
          f"{kernel_ms:.4f} ms back to back, {kernel_cold:.4f} ms with L2 "
          f"flushed ({kernel_cold / bd['bound_ms']:.2f}x the bound); with "
          f"the row append: kernel wrapper {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; bound {bd['bound_ms']:.5f} ms "
          f"({bd['bound_by']})")
    return {"name": "decode_attention_int8", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/decode_attention.cu",
            "replaces": "unilm_tpu/ops/paged_attention.py:497",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "kernel_only_ms": kernel_ms,
            "kernel_only_ms_l2_flushed": kernel_cold, "library_ms": None,
            **bd, "shape": "B8 L2047 H16 D96 int8"}


# bench.py line 4 (`bench_decode`): kosmos2_5 bf16 without the tower, the
# scanned stack, int8 projections + int8 head + int8 KV; a prompt of 2052
# tokens (all 4), a cache of 2052 + 4000 slots, 64 greedy steps.
LINE4_PROMPT, LINE4_CACHE, LINE4_STEPS, LINE4_REPEATS = 2052, 2052 + 4000, 64, 3
LINE4_TEACHER_STEPS = 8  # decode steps of the teacher-forced plain check
# kosmos_infer --int8 --beam 5 at full width: 64 new tokens after the
# 2052-token prompt (2048 image tokens), the tower over 4096 patch slots,
# then once over 2048 slots (a 44 x 46 grid), where #9 takes the tower.
INFER_BEAM, INFER_NEW = 5, 64
INFER_SLOTS_2K, INFER_GRID_2K = 2048, (44, 46)
# The best beam's length-normalised score (mean log-probability of its 64
# tokens), recomputed teacher-forced on the plain path (use_flash=False,
# the plain int8 matmul): both paths round bf16 activations through 24
# layers, and the teacher check above bounds single logits by LOGIT_ATOL;
# the mean of 64 log-probabilities moves far less. Readings on an H100
# 80GB HBM3 at 700 W, beam score -4.8677: plain path 0.0194 off, the
# kernel path at B=1 0.0010 off. A secondary check: no reading under a
# faulty beam step has been taken, so the bound is not shown to reject
# one; the B=5 step held logit for logit against the plain path is what
# checks the beam step's rows.
BEAM_SCORE_ATOL = 0.05


def quantized_unigpt(cfg, sd, dev):
    """kosmos_infer --int8's quantization of a UniGPT state dict: every
    text-decoder projection and the LM head int8 (ops.quant.
    quantize_state_dict, models.kosmos.quantize_lm_head_state_dict), the
    KV pool int8; returns the model on `dev`."""
    from unilm_tpu_torch.models.kosmos import (UniGPT,
                                               quantize_lm_head_state_dict)
    from unilm_tpu_torch.ops.quant import quantize_state_dict

    sd = quantize_lm_head_state_dict(quantize_state_dict(sd))
    cfg = dataclasses.replace(cfg, quant_weights=True, quant_lm_head=True,
                              kv_cache_dtype="int8", scan_layers=True)
    model = UniGPT(cfg, device=dev).eval()
    model.load_state_dict(sd, strict=True, assign=True)
    return model


def plain_twin(model):
    """The same weights on the plain path: use_flash=False (the tower's
    too) and every QuantDense on int8_matmul_plain."""
    from unilm_tpu_torch.models.kosmos import UniGPT
    from unilm_tpu_torch.ops.quant import QuantDense

    cfg = model.cfg
    cfg = dataclasses.replace(
        cfg, use_flash=False,
        pix2struct=dataclasses.replace(cfg.pix2struct, use_flash=False),
        clip=dataclasses.replace(cfg.clip, use_flash=False))
    plain = UniGPT(cfg, device="cuda").eval()
    plain.load_state_dict(model.state_dict(), strict=True, assign=True)
    for m in plain.modules():
        if isinstance(m, QuantDense):
            m.use_kernel = False
    return plain


# kernel groups of an int8 decode step's profile
STEP_GROUPS = [("#14", [INT8_ONLY, "int8_matmul"]), ("#13-int8", [DECODE_ONLY]),
               ("#1", ["flash_fwd"]),
               ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet", "cublas",
                           "splitK"])]


def profile_steps(fn, n: int, step_groups=STEP_GROUPS) -> tuple:
    """Device time (ms) by `step_groups` of n calls of fn (after one
    untimed call), per call, and the four costliest kernels of "other"
    (name, ms a call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    groups = device_time_shares(prof, step_groups)
    named = [sub for _, subs in step_groups for sub in subs]
    other = sorted(((t / n, k) for k, t in device_kernel_times(prof).items()
                    if not any(s in k for s in named)), reverse=True)[:4]
    return ({k: v / n for k, v in groups.items()},
            [(k[:60], t) for t, k in other])


def int8_case(qm, x, w, scale) -> tuple:
    """#14 against int8_matmul_plain on x [M, K], W [N, K]: (max|err|,
    ratio to the tolerance of phase_int8_matmul, the error's max over the
    last 64-channel tile), checked <= 1, and two runs bit-equal."""
    out = qm.int8_matmul(x, w, scale)
    again = qm.int8_matmul(x, w, scale)
    ref = qm.int8_matmul_plain(x, w, scale)
    K = x.shape[1]
    order = K * 2.0 ** -24 * (x.float().abs() @ w.float().abs().t()) * scale
    err = (out.float() - ref.float()).abs()
    ratio = float((err / (ulp_tol(ref, 2) + order)).max())
    tile = (w.shape[0] - 1) // 64 * 64
    shape = f"M{x.shape[0]} K{K} N{w.shape[0]}"
    check(bool(torch.isfinite(out.float()).all()) and ratio <= 1.0,
          f"int8_matmul {shape}: max|err| {float(err.max())}, {ratio:.3f} "
          f"of the tolerance")
    check(torch.equal(out, again), f"int8_matmul {shape}: two runs differ")
    return float(err.max()), ratio, float(err[:, tile:].max())


def int8_times(qm, x, w, scale) -> dict:
    """Device time of #14 on x, W back to back and with L2 flushed, the
    plain version, a bf16 cuBLAS product with a dequantized copy of W (a
    yardstick: twice the weight bytes, the copy made outside the timing)
    and the bound."""
    M, K = x.shape
    N = w.shape[0]
    call = lambda: qm.int8_matmul(x, w, scale)
    wd = (w.float() * scale[:, None]).to(torch.bfloat16)
    out = {"ms": device_ms(call, only=INT8_ONLY),
           "ms_l2_flushed": cold_ms(call, INT8_ONLY),
           "plain_ms": device_ms(lambda: qm.int8_matmul_plain(x, w, scale),
                                 iters=5),
           "dequant_bf16_cublas_ms": device_ms(lambda: x @ wd.t()),
           "dequant_bf16_cublas_ms_l2_flushed": cold_ms(lambda: x @ wd.t()),
           **roofline(N * K + N * 4 + M * K * 2 + M * N * 2, 2 * M * N * K)}
    del wd
    return out


def phase_decode_int8_bs1(qm, pa, g) -> tuple:
    """bench.py line 4 at full width through runtime.generate: the 2052-
    token prefill (24 launches of #1, 144 + 1 of #14) and 64 greedy steps
    (24 of #13-int8 and 145 of #14 each); ms/token on the host clock over
    the 64 steps in LINE4_REPEATS rounds; device time a step by kernel
    group (the head's #14 timed alone) and the busy share; the plain path
    teacher-forced; #14 alone at the head's M1 and M5 x K1536 x N108481
    and at the prefill's M2052 against the plain version, timed beside
    its bound and a dequantized-W cuBLAS product; #13-int8 alone at B1
    L2052. Returns (launches, extra fields for the kernels line)."""
    from unilm_tpu_torch.core.transformer import _scan_pool_geometry
    from unilm_tpu_torch.models.kosmos import (
        UniGPT, kosmos2_5, make_unigpt_generate_fns)
    from unilm_tpu_torch.runtime.generate import GenerationConfig, generate

    dev, name = "cuda", "decode_int8_bs1"
    cfg0 = kosmos2_5(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                     image_tower=None, scan_layers=True,
                     kv_cache_dtype="int8")
    base = UniGPT(cfg0, device=dev)
    base.init_weights(torch.Generator(device=dev).manual_seed(SEED))
    model = quantized_unigpt(cfg0, base.state_dict(), dev)
    del base
    torch.cuda.empty_cache()
    cfg, L, T = model.cfg, cfg0.num_layers, LINE4_PROMPT
    n_bytes = sum(t.numel() * t.element_size()
                  for t in model.state_dict().values())
    phase(name, f"kosmos2_5 bf16, no tower, scanned, int8 projections + "
          f"head + KV: {L} layers, vocab {cfg.vocab_size}, {n_bytes / 1e9:.3f}"
          f" GB of weights; prompt {T} tokens, cache {LINE4_CACHE} slots")
    tokens = torch.full((1, T), 4, dtype=torch.long, device=dev)
    prefill, step = make_unigpt_generate_fns(model, LINE4_CACHE)
    per_fwd = L * PROJECTIONS_PER_LAYER + 1

    # ---- the main path: prefill + 64 greedy steps through generate -----
    seen = {}

    def pf(tok, aux):
        out = prefill(tok, aux)
        torch.cuda.synchronize()
        seen["prefill"] = counts()
        return out

    calls = {"step": 0}

    def st(tok, c, aux):
        calls["step"] += 1
        return step(tok, c, aux)

    gcfg = GenerationConfig(beam_size=1, max_new_tokens=LINE4_STEPS + 1,
                            min_new_tokens=LINE4_STEPS + 1,
                            vocab_size=cfg.vocab_size)
    reset_counts()
    toks, lengths = generate(gcfg, pf, st, tokens)
    torch.cuda.synchronize()
    got, pre = counts(), seen["prefill"]
    S = calls["step"]
    check(S == LINE4_STEPS and tuple(toks.shape) == (1, T + S + 1)
          and int(lengths[0]) == T + S + 1, f"{name}: {S} steps, tokens "
          f"{tuple(toks.shape)}")
    check(pre["flash_fwd"] == L and pre["int8_matmul"] == per_fwd
          and pre["decode_attention_int8"] == 0,
          f"{name}: prefill launches {pre} (want {L} of #1, {per_fwd} of "
          f"#14)")
    check(got["decode_attention_int8"] == L * S
          and got["int8_matmul"] == per_fwd * (S + 1)
          and got["flash_fwd"] == L and got["decode_attention"] == 0
          and got["onepass_attention"] == 0,
          f"{name}: launches {got} (want {L} x {S} of #13-int8, {per_fwd} x "
          f"{S + 1} of #14, {L} of #1)")
    launches = {k: got[k] for k in ("flash_fwd", "int8_matmul",
                                    "decode_attention_int8")}
    phase(name, f"generate: prefill + {S} greedy steps; launches #1 "
          f"{got['flash_fwd']} (all in the prefill), #14 "
          f"{got['int8_matmul']} ({per_fwd} a forward), #13-int8 "
          f"{got['decode_attention_int8']} ({L} a step)")

    # ---- ms/token on the host clock (bench.py's loop) -------------------
    lg, c0 = prefill(tokens, None)
    tok0 = lg[:, -1:].argmax(-1)

    def loop():
        tok, c = tok0, c0
        for _ in range(LINE4_STEPS):
            lg, c = step(tok, c, None)
            tok = lg[:, -1:].argmax(-1)
        return tok

    loop()
    torch.cuda.synchronize()
    per_tok = []
    for _ in range(LINE4_REPEATS):
        t0 = time.time()
        loop()
        torch.cuda.synchronize()
        per_tok.append((time.time() - t0) / LINE4_STEPS * 1e3)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    prefill(tokens, None)
    ev[1].record()
    torch.cuda.synchronize()
    ttft = ev[0].elapsed_time(ev[1])

    # ---- device time a step by group, the head alone, busy share ------
    shares, top = profile_steps(lambda: step(tok0, c0, None), 4)
    dev_step = sum(shares.values())
    x1 = torch.randn(1, 1, cfg.embed_dim, generator=g, device=dev).to(
        torch.bfloat16)
    head_ms = device_ms(lambda: model.lm_head_q(x1), only=INT8_ONLY)
    host = float(np.median(per_tok))
    shares_split = {"#14 layers": shares["#14"] - head_ms,
                    "#14 head": head_ms,
                    **{k: v for k, v in shares.items() if k != "#14"}}
    phase(name, f"ms/token (host clock, {LINE4_STEPS} steps, ctx {T + 1}.."
          f"{T + LINE4_STEPS}): " + ", ".join(f"{t:.3f}" for t in per_tok)
          + f"; prefill (TTFT, CUDA events) {ttft:.3f} ms")
    phase(name, f"device time a step {dev_step:.4f} ms (busy share "
          f"{100 * dev_step / host:.1f}% of {host:.3f} ms): " + ", ".join(
              f"{k} {v:.4f}" for k, v in shares_split.items())
          + "; other's largest: " + ", ".join(f"{k} {t:.4f}" for k, t in top))

    # ---- the plain path teacher-forced on the kernel path's tokens -----
    plain = plain_twin(model)
    ppf, pst = make_unigpt_generate_fns(plain, LINE4_CACHE)
    c1 = counts()
    klogits, plogits = [], []
    lk, ck = prefill(tokens, None)
    lp, cp = ppf(tokens, None)
    klogits.append(lk)
    plogits.append(lp)
    for j in range(LINE4_TEACHER_STEPS):
        t = toks[:, T + j:T + j + 1]
        lk, ck = step(t, ck, None)
        lp, cp = pst(t, cp, None)
        klogits.append(lk)
        plogits.append(lp)
    torch.cuda.synchronize()
    plain_launched = {k: counts()[k] - c1[k] for k in c1}
    check(plain_launched["int8_matmul"] == per_fwd * (LINE4_TEACHER_STEPS + 1)
          and plain_launched["decode_attention_int8"]
          == L * LINE4_TEACHER_STEPS, f"{name}: teacher launches "
          f"{plain_launched} (the kernel side only)")
    errs = [float((a.float() - b.float()).abs().max())
            for a, b in zip(klogits, plogits)]
    agree = float(np.mean([bool((a.argmax(-1) == b.argmax(-1)).all())
                           for a, b in zip(klogits, plogits)]))
    check(max(errs) <= LOGIT_ATOL and agree >= ARGMAX_AGREE,
          f"{name}: kernel vs plain logits max|err| {max(errs)}, argmax "
          f"agreement {agree}")
    phase(name, f"plain path teacher-forced: prefill logits max|err| "
          f"{errs[0]:.4f}, {LINE4_TEACHER_STEPS} steps {max(errs[1:]):.4f} "
          f"(tol {LOGIT_ATOL}), argmax agreement {agree:.3f}")
    del plain, cp, ck, c0
    torch.cuda.empty_cache()

    # ---- #14 alone at the head (M1, M5) and the prefill's M2052 --------
    w, scale = model.lm_head_q.weight_i8, model.lm_head_q.scale
    N, K = w.shape
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    head = {}
    for M in (1, INFER_BEAM):
        x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        err, ratio, tile_err = int8_case(qm, x, w, scale)
        plan = qm.int8_matmul_plan(M, N, K, n_sm)
        head[f"M{M} K{K} N{N}"] = {"max_abs_err": err,
                                   "err_over_tol": ratio,
                                   "last_tile_max_abs_err": tile_err,
                                   "blocks": plan["blocks"],
                                   "ksplit": plan["ksplit"],
                                   **int8_times(qm, x, w, scale)}
    for key, r in head.items():
        phase(name, f"#14 at the head {key} ({r['blocks']} blocks, ksplit "
              f"{r['ksplit']}; the last 64-channel tile holds "
              f"{N - (N - 1) // 64 * 64} channel(s), max|err| there "
              f"{r['last_tile_max_abs_err']:.3g}): max|err| "
              f"{r['max_abs_err']:.3g} ({r['err_over_tol']:.3f} of the "
              f"tolerance); device time {r['ms']:.4f} ms back to back, "
              f"{r['ms_l2_flushed']:.4f} flushed, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}; {r['ms_l2_flushed'] / r['bound_ms']:.2f}x), "
              f"plain {r['plain_ms']:.4f}, dequantized-W bf16 cuBLAS "
              f"{r['dequant_bf16_cublas_ms']:.4f} / "
              f"{r['dequant_bf16_cublas_ms_l2_flushed']:.4f} flushed")
    prefill_m = {}
    for Kp, Np in INT8_SHAPES:
        wp = torch.randint(-127, 128, (Np, Kp), generator=g, device=dev,
                           dtype=torch.int8)
        sp = ((torch.rand(Np, generator=g, device=dev) + 0.5)
              * (2.0 / (127 * Kp ** 0.5)))
        x = torch.randn(T, Kp, generator=g, device=dev).to(torch.bfloat16)
        err, ratio, _ = int8_case(qm, x, wp, sp)
        r = {"max_abs_err": err, "err_over_tol": ratio,
             **int8_times(qm, x, wp, sp)}
        prefill_m[f"M{T} K{Kp} N{Np}"] = r
        phase(name, f"#14 at the prefill's M{T} K{Kp} N{Np}: max|err| "
              f"{err:.3g} ({ratio:.3f} of the tolerance); device time "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, dequantized-W "
              f"bf16 cuBLAS {r['dequant_bf16_cublas_ms']:.4f} "
              f"({r['ms'] / r['dequant_bf16_cublas_ms']:.2f}x), bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})")

    # ---- #13-int8 alone at B1 L2052 (this phase's geometry) and at B5
    # L2053 (kosmos_infer's beam step: 5 rows, a 2116-slot cache) -------
    H, D = cfg.num_heads, cfg.embed_dim // cfg.num_heads
    k13 = {}
    for Bc, cache, Lc in ((1, LINE4_CACHE, T), (INFER_BEAM, T + INFER_NEW,
                                                  T + 1)):
        page, chunk, PP = _scan_pool_geometry(cache)
        plan = pa.decode_split_plan(Bc, H, Lc, n_sm, D, 1)
        spans = [t1 - t0 for t0, t1 in plan["ranges"]]
        kp = torch.randint(-127, 128, (Bc * PP, page, H * D), generator=g,
                           device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, (Bc * PP, page, H * D), generator=g,
                           device=dev, dtype=torch.int8)
        spool = (torch.rand(Bc * PP // chunk, 8, chunk * page, generator=g,
                            device=dev) * 0.02 + 1e-3)
        q, kn, vn = (torch.randn(Bc, 1, H, D, generator=g, device=dev).to(
            torch.bfloat16) for _ in range(3))
        bases = torch.arange(Bc, dtype=torch.int32, device=dev) * PP
        lens = torch.full((Bc,), Lc, dtype=torch.int32, device=dev)
        refs = [t.clone() for t in (kp, vp, spool)]
        out = pa.run_decode_append_attention(q, kn, vn, kp, vp, bases, lens,
                                             PP, None, chunk,
                                             scale_pool=spool)[0]
        ref = pa.run_decode_append_attention_plain(
            q, kn, vn, *refs[:2], bases, lens, PP, None, chunk,
            scale_pool=refs[2])[0]
        torch.cuda.synchronize()
        ok, err13 = close(out, ref, OUT_ATOL, OUT_RTOL)
        key = f"B{Bc} L{Lc}"
        check(ok and bool(torch.isfinite(out.float()).all())
              and torch.equal(kp, refs[0]) and torch.equal(vp, refs[1])
              and torch.equal(spool, refs[2]),
              f"{name}: #13-int8 {key}: out err {err13} or pools differ")
        # the splits tile [0, Lc) in order: each starts where the last ended
        bounds = [0] + [t1 for _, t1 in plan["ranges"]]
        check(all(t0 == bounds[i] for i, (t0, _) in enumerate(plan["ranges"]))
              and bounds[-1] == Lc and spans[0] > 0,
              f"{name}: #13-int8 {key}: split plan ranges {plan['ranges']}")
        qs = (q[:, 0] * D ** -0.5).contiguous()
        alone = lambda: pa.decode_attention_int8(
            qs, kp, vp, bases, lens, spool, kn[:, 0].contiguous(),
            vn[:, 0].contiguous(), PP, chunk)
        r = k13[key] = {
            "max_abs_err": err13, "nsplit": plan["nsplit"],
            "kernel_only_ms": device_ms(alone, only=DECODE_ONLY),
            "kernel_only_ms_l2_flushed": cold_ms(alone, DECODE_ONLY),
            **decode_bound(Bc * Lc, Bc, H, D, 1, new_rows=True,
                           extra=Bc * -(-Lc // (chunk * page)) * 8 * chunk
                           * page * 4)}
        phase(name, f"#13-int8 {key} H{H} D{D} page {page} chunk {chunk}: "
              f"{plan['nsplit']} split(s) a head (decode_split_plan at B{Bc},"
              f" {n_sm} SMs; spans {spans}), out max|err| {err13:.3g}, the "
              f"three pools bit-equal; kernel alone {r['kernel_only_ms']:.4f}"
              f" ms back to back, {r['kernel_only_ms_l2_flushed']:.4f} "
              f"flushed, bound {r['bound_ms']:.5f} ({r['bound_by']})")
    del model
    torch.cuda.empty_cache()
    extra = {"int8_matmul": {"head": head, "prefill": prefill_m},
             "decode_attention_int8": k13,
             "line4": {"ms_per_token_host": per_tok, "ttft_ms": ttft,
                       "device_ms_per_step": dev_step,
                       "device_ms_per_step_by_group": shares_split}}
    return launches, extra


def phase_kosmos_infer(qm) -> tuple:
    """cli/kosmos_infer.py's build_pipeline at full width with --int8
    --beam 5 --max_new_tokens 64 (random weights from seed 0) on patches
    made on the card: 4096 slots (#1 in the tower, 43 launches a TTFT),
    then 2048 slots (#9 in the tower); #13-int8 and #14 at every beam step;
    --beam 1 against beam search of width 1; the best beam's score
    recomputed teacher-forced on the plain path; the beam step's device
    time by group, `_gather_beams`' copy its own group. Two beam steps at
    B=5 (a gather between them) are held against the plain path, logits
    within LOGIT_ATOL."""
    from unilm_tpu_torch.cli import kosmos_infer
    from unilm_tpu_torch.models.kosmos import make_unigpt_generate_fns
    from unilm_tpu_torch.runtime import generate as gen_mod

    dev, name = "cuda", "kosmos_infer"
    t0 = time.time()
    pipe = kosmos_infer.build_pipeline(kosmos_infer.build_parser().parse_args(
        ["--image", "unused", "--int8", "--beam", str(INFER_BEAM),
         "--max_new_tokens", str(INFER_NEW)]))
    torch.cuda.synchronize()
    model, cfg = pipe.model, pipe.model.cfg
    L, nl, P = cfg.num_layers, cfg.pix2struct.num_layers, pipe.tokens.shape[1]
    per_fwd = L * PROJECTIONS_PER_LAYER + 1
    check(cfg.kv_cache_dtype == "int8" and cfg.quant_lm_head
          and not any(isinstance(m, qm.QuantDense)
                      for m in model.img_model.modules()),
          f"{name}: --int8 config {cfg}")
    phase(name, f"build_pipeline --int8 --beam {INFER_BEAM} --max_new_tokens "
          f"{INFER_NEW}: {time.time() - t0:.1f} s; prompt {P} tokens, cache "
          f"{pipe.cache_size}; tower {nl} layers (not quantized)")
    calls = {"prefill": 0, "step": 0}
    prefill, step = pipe.prefill, pipe.step

    def pf(tok, aux):
        calls["prefill"] += 1
        return prefill(tok, aux)

    def st(tok, c, aux):
        calls["step"] += 1
        return step(tok, c, aux)

    pipe.prefill, pipe.step = pf, st
    p4k = tower_patches(cfg, dev, TTFT_PATCHES, TTFT_GRID)
    p2k = tower_patches(cfg, dev, INFER_SLOTS_2K, INFER_GRID_2K)

    # ---- the main path: 4096 slots, then 2048 slots -------------------
    reset_counts()
    runs = {}
    for slots, patches in ((TTFT_PATCHES, p4k), (INFER_SLOTS_2K, p2k)):
        c0 = counts()
        calls.update(prefill=0, step=0)
        torch.cuda.synchronize()
        t0 = time.time()
        toks, scores = pipe.generate(patches)
        torch.cuda.synchronize()
        wall = time.time() - t0
        ran = {k: counts()[k] - c0[k] for k in c0}
        S = calls["step"]
        check(tuple(toks.shape) == (1, INFER_BEAM, P + INFER_NEW)
              and bool(torch.isfinite(scores).all())
              and bool((scores[0, :-1] >= scores[0, 1:]).all()),
              f"{name}: {slots} slots: tokens {tuple(toks.shape)}, scores "
              f"{scores.tolist()}")
        tower_ok = (ran["flash_fwd"] == nl + 1 + L and ran["doc_attention"]
                    == 0 if slots > 2048 else ran["doc_attention"] == nl
                    and ran["flash_fwd"] == 1 + L)
        check(tower_ok and calls["prefill"] == 1
              and ran["decode_attention_int8"] == L * S
              and ran["int8_matmul"] == per_fwd * (S + 1)
              and ran["encoder_attention"] == 0,
              f"{name}: {slots} slots: launches {ran}, {S} steps")
        runs[slots] = (toks, scores, wall, S, ran)
        phase(name, f"{slots} patch slots: beam {INFER_BEAM}, {S} steps in "
              f"{wall:.3f} s (host clock, {wall * 1e3 / (S + 1):.2f} ms a "
              f"forward); launches #1 {ran['flash_fwd']}, #9 "
              f"{ran['doc_attention']}, #13-int8 {ran['decode_attention_int8']}"
              f" ({L} a step), #14 {ran['int8_matmul']} ({per_fwd} a "
              f"forward); best score {float(scores[0, 0]):.4f}")
    got = counts()
    launches = {k: got[k] for k in ("flash_fwd", "doc_attention",
                                    "int8_matmul", "decode_attention_int8")}
    pipe.prefill, pipe.step = prefill, step

    # ---- --beam 1 (greedy) against beam search of width 1 --------------
    g1 = dataclasses.replace(pipe.gcfg, beam_size=1)
    pipe.gcfg = g1
    greedy, _ = pipe.generate(p4k)
    pipe.gcfg = dataclasses.replace(g1, beam_size=INFER_BEAM)
    with torch.no_grad():
        feats = model.encode_image(p4k)
        b1, _ = gen_mod.beam_generate(g1, prefill, step, pipe.tokens,
                                      (feats, pipe.img_mask, pipe.segs))
    check(torch.equal(greedy[0], b1[0, 0]), f"{name}: --beam 1 differs from "
          f"beam search of width 1")
    phase(name, f"--beam 1 (greedy) equals beam_generate(beam_size=1): "
          f"{INFER_NEW} tokens")

    # ---- the best beam's score, teacher-forced ------------------------
    toks, scores = runs[TTFT_PATCHES][:2]
    best = toks[0, 0]
    gen_ids = best[P:].tolist()
    n_gen = (gen_ids.index(kosmos_infer.EOS) + 1
             if kosmos_infer.EOS in gen_ids else len(gen_ids))

    def forced_score(m, pf_, st_):
        with torch.no_grad():
            f = m.encode_image(p4k)
            lg, c = pf_(pipe.tokens, (f, pipe.img_mask, pipe.segs))
            total = 0.0
            for j in range(n_gen):
                lp = torch.log_softmax(lg[0, -1].float(), -1)
                total += float(lp[best[P + j]])
                if j + 1 < n_gen:
                    lg, c = st_(best[None, P + j:P + j + 1], c, None)
        return total / n_gen

    plain = plain_twin(model)
    c1 = counts()
    s_plain = forced_score(plain, *make_unigpt_generate_fns(
        plain, pipe.cache_size))
    check(counts() == c1, f"{name}: the plain path launched a kernel")
    s_kernel = forced_score(model, prefill, step)
    beam_score = float(scores[0, 0])
    phase(name, f"best beam ({n_gen} tokens): search score {beam_score:.5f},"
          f" teacher-forced B=1 kernel path {s_kernel:.5f}, plain path "
          f"{s_plain:.5f} (tol {BEAM_SCORE_ATOL})")
    check(abs(s_plain - beam_score) <= BEAM_SCORE_ATOL
          and abs(s_kernel - beam_score) <= BEAM_SCORE_ATOL,
          f"{name}: teacher-forced scores vs the beam's")

    # ---- the beam step at B=5 held against the plain path --------------
    # the prefill tiled to five beams, a step on the five final beams'
    # first tokens, a _gather_beams that duplicates a parent, a step on
    # their second tokens: every row of #13-int8 at B5 on the 2116-slot
    # pool and of #14 at M5, the gather's fresh copies under the in-place
    # appends. Both sides take the kernel tower's features (the tower is
    # held against its plain version in the ttft phase).
    reorder = torch.tensor([[0, 0, 1, 2, 3]], device=dev)

    def beam_steps(pf_, st_):
        with torch.no_grad():
            c = gen_mod._tile_cache(pf_(pipe.tokens, (
                feats, pipe.img_mask, pipe.segs))[1], INFER_BEAM)
            out = []
            for j in range(2):
                if j:
                    c = gen_mod._gather_beams(c, reorder, 1, INFER_BEAM)
                lg, c = st_(toks[0, :, P + j:P + j + 1], c, None)
                out.append(lg[:, -1].float())
        torch.cuda.synchronize()
        return out, c

    c2 = counts()
    klog, c5 = beam_steps(prefill, step)
    kran = {k: counts()[k] - c2[k] for k in c2}
    check(kran["decode_attention_int8"] == 2 * L
          and kran["int8_matmul"] == 3 * per_fwd and kran["flash_fwd"] == L,
          f"{name}: B={INFER_BEAM} steps launched {kran}")
    c2 = counts()
    plog, _ = beam_steps(*make_unigpt_generate_fns(plain, pipe.cache_size))
    check(counts() == c2, f"{name}: the plain path launched a kernel")
    step_errs = [float((a - b).abs().max()) for a, b in zip(klog, plog)]
    step_agree = float(torch.cat([a.argmax(-1) == b.argmax(-1)
                                  for a, b in zip(klog, plog)]).float().mean())
    check(all(np.isfinite(step_errs)) and max(step_errs) <= LOGIT_ATOL
          and step_agree >= ARGMAX_AGREE,
          f"{name}: B={INFER_BEAM} step logits max|err| {step_errs}, argmax "
          f"agreement {step_agree}")
    phase(name, f"beam step B={INFER_BEAM} (two steps, a gather "
          f"{reorder[0].tolist()} between them) vs the plain path: ["
          f"{INFER_BEAM}, "
          f"{cfg.vocab_size}] logits max|err| " + ", ".join(
              f"{e:.4f}" for e in step_errs) + f" (tol {LOGIT_ATOL}), argmax "
          f"agreement {step_agree:.3f} over the {2 * INFER_BEAM} rows")
    del plain, plog, klog
    torch.cuda.empty_cache()

    # ---- the beam step's device time by group --------------------------
    tok5 = torch.full((INFER_BEAM, 1), 4, dtype=torch.long, device=dev)
    shares, top = profile_steps(lambda: step(tok5, c5, None), 4)
    lg5 = step(tok5, c5, None)[0]
    scfg = pipe.gcfg

    def search():
        lp = torch.log_softmax(lg5[:, -1].float(), -1)
        lp = gen_mod._adjust_logprobs(lp, pipe.tokens.expand(INFER_BEAM, -1),
                                      1, P, scfg)
        return gen_mod._topk_over_beams(lp[None], 2 * INFER_BEAM)

    search_ms = device_ms(search)
    idx = torch.tensor([[0, 0, 1, 2, 3]], device=dev)
    gather_ms = device_ms(lambda: gen_mod._gather_beams(c5, idx, 1,
                                                        INFER_BEAM))
    pool_bytes = sum(t.numel() * t.element_size() for t in (
        c5["decoder"]["kv_pool_key"], c5["decoder"]["kv_pool_value"],
        c5["decoder"]["kv_pool_scale"]))
    groups = {**shares, "search (log_softmax + top-k)": search_ms,
              "_gather_beams": gather_ms}
    dev_total = sum(groups.values())
    wall, S = runs[TTFT_PATCHES][2], runs[TTFT_PATCHES][3]
    phase(name, f"beam step (B={INFER_BEAM}, ctx {P}+), device time "
          f"{dev_total:.4f} ms: " + ", ".join(
              f"{k} {v:.4f}" for k, v in groups.items())
          + "; other's largest: " + ", ".join(f"{k} {t:.4f}" for k, t in top)
          + f"; _gather_beams copies {pool_bytes / 1e9:.3f} GB "
          f"({pool_bytes / INFER_BEAM / 1e9:.3f} GB a beam: "
          f"{2 * pool_bytes / (gather_ms * 1e-3) / 1e9:.0f} GB/s read + "
          f"write)")
    del c5, pipe, model
    torch.cuda.empty_cache()
    extra = {"kosmos_infer": {
        "beam_step_device_ms_by_group": groups,
        "gather_beams_gb": pool_bytes / 1e9,
        "host_ms_per_forward_4096_slots": wall * 1e3 / (S + 1),
        "best_score": beam_score, "plain_teacher_score": s_plain,
        "beam_step_logits_max_abs_err": step_errs,
        "beam_step_argmax_agreement": step_agree}}
    return launches, extra


# TrOCR-Base beam-search OCR (benchmarks/trocr_decode.py's configuration):
# trocr_base bf16 (a DeiT-B/16 encoder at 384, 578 tokens; a 12-layer
# post-LN decoder, E 1024, 16 heads, vocab 50265), beam 5, 32 new tokens
# (min_new_tokens 32: random weights would stop early), at B=1
# (interactive) and B=32 (bulk eval), through cli/trocr_infer.py's
# pipeline (a 1 + 32-slot cache: page 16, chunk 2, 4 pages a layer).
TROCR_BEAM, TROCR_NEW, TROCR_BATCHES = 5, 32, (1, 32)
TROCR_TIMED = 3  # timed generate calls a batch size
TROCR_S, TROCR_LAYERS = 24 * 24 + 2, 12  # encoder tokens, layers a stack
# the decode pools' geometry at D 64, H 16, and the lengths held there:
# the page (16), slab (32) and run edges up to the 34-slot cache
TROCR_LENGTHS = [1, 15, 16, 17, 31, 32, 33, 34]
ENCODER_ONLY = "encoder_attn"  # #3's kernels (bf16 encoder_attn_sm90)
ONEPASS_ONLY = "onepass_kernel"  # #5's kernels (the walk at T <= 16)
# the kernel path's encoder features against the plain path's: relative
# L2 (0.0095 at B=1 and B=32 on an H100) beside the LOGIT_ATOL max error
FEATURE_REL_L2 = 2e-2
TROCR_GROUPS = [("#3", [ENCODER_ONLY]), ("#13", [DECODE_ONLY]),
                ("#14", [INT8_ONLY, "int8_matmul"]), ("#5", [ONEPASS_ONLY]),
                ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet", "cublas",
                            "splitK"])]
# the decoder layers of each TrOCR the smoke drives (trocr_small's 8 heads
# of 32 take the kernels' D = 32 instantiations)
TROCR_ARCH = {"trocr_base": TROCR_LAYERS, "trocr_small": 6}


def phase_trocr_kernels(fa, pa, qm, g, dev: str = "cuda") -> dict:
    """The kernels of TrOCR's path alone, at its shapes, against their
    plain versions: #13 bf16 on the short pools (page 16, chunk 2, 4
    pages a run, H16 D64) at B160 (the B=32 beam step) and B5 (B=1), the
    lengths at the page, slab and run edges, within OUT_ATOL / OUT_RTOL,
    pools bit-equal; #5 at the prefill's causal self-attention over the
    1-token prompt (B x 1 x 1 x 16 x 64, B 32 and 1), bf16 within #1's
    bounds (OUT_ATOL / OUT_RTOL, lse LSE_ATOL); #3 at B 32 and 1 in its
    three roles, bf16 (relative L2 <= 1e-2, as phase_encoder_attn): the
    encoder's Bx578x578x12x64, the prefill's cross-attention Bx1x578x16x64
    and the decode's folded Bx5x578x16x64; #14 at the decode's M160 (K1024 -> N1024 / 4096,
    K4096 -> N1024), the prefill's cross K/V projection M18496 K768 N1024
    and the head's M160 K1024 N50265 (int8_case). Each timed (device
    time, back to back and with L2 flushed) beside the plain version, one
    PyTorch call of the same function (sdpa; cuBLAS on a dequantized W)
    and the bound. Returns {kernel name: {"trocr": {...}}} for the
    kernels line."""
    from unilm_tpu_torch.core.transformer import _scan_pool_geometry

    bf, name = torch.bfloat16, "trocr_kernels"
    H, D = 16, 64
    page, chunk, PP = _scan_pool_geometry(2 + TROCR_NEW)
    check((page, chunk, PP) == (16, 2, 4), f"{name}: pool geometry "
          f"{(page, chunk, PP)}")

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    # ---- #13 bf16 at page 16, D 64 -------------------------------------
    cases = [(TROCR_LENGTHS * 20)[:TROCR_BEAM * TROCR_BATCHES[1]],
             TROCR_LENGTHS[:TROCR_BEAM], TROCR_LENGTHS[3:]]
    worst13 = 0.0
    for lens in cases:
        Bc = len(lens)
        bases = torch.arange(Bc, dtype=torch.int32, device=dev) * PP
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        kp, vp = rn(Bc * PP, page, H * D), rn(Bc * PP, page, H * D)
        q, kn, vn = rn(Bc, 1, H, D), rn(Bc, 1, H, D), rn(Bc, 1, H, D)
        kp2, vp2 = kp.clone(), vp.clone()
        out = pa.run_decode_append_attention(q, kn, vn, kp, vp, bases,
                                             lengths, PP, None, chunk)[0]
        ref = pa.run_decode_append_attention_plain(
            q, kn, vn, kp2, vp2, bases, lengths, PP, None, chunk)[0]
        torch.cuda.synchronize()
        ok, err = close(out, ref, OUT_ATOL, OUT_RTOL)
        check(ok and bool(torch.isfinite(out.float()).all())
              and torch.equal(kp, kp2) and torch.equal(vp, vp2),
              f"{name}: #13 B{Bc} lengths {sorted(set(lens))}: out err "
              f"{err} or pools differ")
        worst13 = max(worst13, err)
    phase(name, f"#13 bf16 page {page} chunk {chunk} ({PP} pages a run) "
          f"H{H} D{D}, B{len(cases[0])} and B{len(cases[1])}, lengths "
          f"{TROCR_LENGTHS}: out max|err| {worst13:.3g} (tol {OUT_ATOL} abs "
          f"+ {OUT_RTOL} rel), pools bit-equal")
    # timed at the B=32 beam step's B160, every run 32 tokens long
    Bc, L = TROCR_BEAM * TROCR_BATCHES[1], 32
    bases = torch.arange(Bc, dtype=torch.int32, device=dev) * PP
    lengths = torch.full((Bc,), L, dtype=torch.int32, device=dev)
    kp, vp = rn(Bc * PP, page, H * D), rn(Bc * PP, page, H * D)
    q, kn, vn = rn(Bc, 1, H, D), rn(Bc, 1, H, D), rn(Bc, 1, H, D)
    qs = (q[:, 0] * D ** -0.5).contiguous()
    alone = lambda: pa.decode_attention(qs, kp, vp, bases, lengths, PP)
    run = lambda pool: pool.reshape(Bc, PP * page, H, D)[:, :L + 1]
    lib = lambda: sdpa(q, run(kp), run(vp))
    k13 = {"shape": f"B{Bc} L{L} H{H} D{D} page {page} bf16",
           "max_abs_err": worst13,
           "ms": device_ms(alone, only=DECODE_ONLY),
           "ms_l2_flushed": cold_ms(alone, DECODE_ONLY),
           "plain_ms": device_ms(lambda: pa.run_decode_append_attention_plain(
               q, kn, vn, kp, vp, bases, lengths, PP, None, chunk), iters=3),
           "library_ms": device_ms(lib), "library_ms_l2_flushed": cold_ms(lib),
           **decode_bound(Bc * (L + 1), Bc, H, D, 2, new_rows=False)}
    phase(name, f"#13 {k13['shape']}, device time: kernel {k13['ms']:.4f} ms "
          f"back to back, {k13['ms_l2_flushed']:.4f} flushed; sdpa over the "
          f"runs {k13['library_ms']:.4f} / {k13['library_ms_l2_flushed']:.4f};"
          f" plain {k13['plain_ms']:.4f}; bound {k13['bound_ms']:.5f} "
          f"({k13['bound_by']})")
    del kp, vp

    # ---- #5: the prefill's self-attention over the 1-token prompt -------
    k5 = {}
    for B in (TROCR_BATCHES[1], TROCR_BATCHES[0]):
        check(fa.onepass_applies(B, H, 1, 1, D, None, 0),
              f"{name}: #5 does not take B{B}x1x1x{H}x{D}")
        # q scaled in its own dtype, as fa.flash_attention hands it on
        q, k, v = rn(B, 1, H, D) * D ** -0.5, rn(B, 1, H, D), rn(B, 1, H, D)
        kw = dict(causal=True, window=0)
        five = lambda: fa.flash_forward_onepass(q, k, v, None, None, 0,
                                                None, **kw)
        out, lse = five()
        ref, ref_lse = fa.flash_forward_onepass_plain(q, k, v, None, None, 0,
                                                      None, **kw)
        torch.cuda.synchronize()
        ok_o, e_o = close(out, ref, OUT_ATOL, OUT_RTOL)
        ok_l, e_l = close(lse, ref_lse, LSE_ATOL, 0.0)
        check(ok_o and ok_l and bool(torch.isfinite(out.float()).all()
                                     and torch.isfinite(lse).all()),
              f"{name}: #5 B{B}x1x1x{H}x{D} causal: out err {e_o}, lse err "
              f"{e_l}")
        lib = lambda: sdpa(q, k, v, is_causal=True, scale=1.0)
        r = k5[f"B{B}"] = {
            "shape": f"{B}x1x1x{H}x{D} causal bf16 (the prefill's prompt)",
            "max_abs_err": e_o, "lse_max_abs_err": e_l,
            "ms": device_ms(five, only=ONEPASS_ONLY),
            "ms_l2_flushed": cold_ms(five, ONEPASS_ONLY),
            "plain_ms": device_ms(lambda: fa.flash_forward_onepass_plain(
                q, k, v, None, None, 0, None, **kw), iters=3),
            "library_ms": device_ms(lib), "library_ms_l2_flushed": cold_ms(lib),
            **attn_bound(B * H, D, 2, q, k, v, out, lse)}
        phase(name, f"#5 {r['shape']}: out max|err| {e_o:.3g}, lse max|err| "
              f"{e_l:.3g} (tol {OUT_ATOL} abs + {OUT_RTOL} rel, lse "
              f"{LSE_ATOL}); device time {r['ms']:.4f} ms back to back, "
              f"{r['ms_l2_flushed']:.4f} flushed; sdpa {r['library_ms']:.4f} "
              f"/ {r['library_ms_l2_flushed']:.4f}; plain {r['plain_ms']:.4f};"
              f" bound {r['bound_ms']:.5f} ({r['bound_by']})")
        del q, k, v, out, lse, ref, ref_lse

    # ---- #3: the encoder, the prefill's and the decode's cross-attention --
    k3 = {}
    for key, (B, T, S, Hh) in (
            (f"{role} B{B}", dims) for B in (TROCR_BATCHES[1], TROCR_BATCHES[0])
            for role, dims in (("encoder", (B, TROCR_S, TROCR_S, 12)),
                               ("cross_prefill", (B, 1, TROCR_S, H)),
                               ("cross_folded", (B, TROCR_BEAM, TROCR_S, H)))):
        q, k, v = rn(B, T, Hh, D), rn(B, S, Hh, D), rn(B, S, Hh, D)
        out = fa.fused_encoder_attention(q, k, v)
        ref = fa.fused_encoder_attention_plain(q, k, v)
        torch.cuda.synchronize()
        e = rel_l2(out, ref)
        check(bool(torch.isfinite(out.float()).all()) and e <= 1e-2,
              f"{name}: #3 {key} {B}x{T}x{S}x{Hh}x{D}: rel L2 {e}")
        kern = lambda: fa.fused_encoder_attention(q, k, v)
        lib = lambda: sdpa(q, k, v)
        r = k3[key] = {
            "shape": f"{B}x{T}x{S}x{Hh}x{D} bf16, no bias", "rel_l2": e,
            "max_abs_err": float((out.float() - ref.float()).abs().max()),
            "ms": device_ms(kern, only=ENCODER_ONLY),
            "ms_l2_flushed": cold_ms(kern, ENCODER_ONLY),
            "plain_ms": device_ms(lambda: fa.fused_encoder_attention_plain(
                q, k, v), iters=3),
            "library_ms": device_ms(lib), "library_ms_l2_flushed": cold_ms(lib),
            **attn_bound(B * Hh * T * S, D, 2, q, k, v, out)}
        phase(name, f"#3 {key} {r['shape']}: rel L2 {e:.3g} (bound 1e-2); "
              f"device time {r['ms']:.4f} ms back to back, "
              f"{r['ms_l2_flushed']:.4f} flushed; sdpa {r['library_ms']:.4f}"
              f" / {r['library_ms_l2_flushed']:.4f}; plain "
              f"{r['plain_ms']:.4f}; bound {r['bound_ms']:.5f} "
              f"({r['bound_by']}; flushed {r['ms_l2_flushed'] / r['bound_ms']:.2f}x)")
        del q, k, v, out, ref

    # ---- #14 at the int8 decoder's shapes -------------------------------
    k14 = {}
    for M, K, N in ((160, 1024, 1024), (160, 1024, 4096), (160, 4096, 1024),
                    (TROCR_BATCHES[1] * TROCR_S, 768, 1024),
                    (160, 1024, 50265)):
        w = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                          dtype=torch.int8)
        sc = ((torch.rand(N, generator=g, device=dev) + 0.5)
              * (2.0 / (127 * K ** 0.5)))
        x = torch.randn(M, K, generator=g, device=dev).to(bf)
        err, ratio, _ = int8_case(qm, x, w, sc)
        r = {"max_abs_err": err, "err_over_tol": ratio,
             **int8_times(qm, x, w, sc)}
        r["library_ms"] = r["dequant_bf16_cublas_ms"]
        k14[f"M{M} K{K} N{N}"] = r
        phase(name, f"#14 M{M} K{K} N{N}: max|err| {err:.3g} ({ratio:.3f} "
              f"of the tolerance), bit-equal twice; device time {r['ms']:.4f}"
              f" ms back to back, {r['ms_l2_flushed']:.4f} flushed; "
              f"dequantized-W bf16 cuBLAS {r['dequant_bf16_cublas_ms']:.4f} "
              f"/ {r['dequant_bf16_cublas_ms_l2_flushed']:.4f} "
              f"({r['ms_l2_flushed'] / r['dequant_bf16_cublas_ms_l2_flushed']:.2f}x"
              f" flushed); plain {r['plain_ms']:.4f}; bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})")
        del w, x
    torch.cuda.empty_cache()
    return {"decode_attention": {"trocr": k13},
            "onepass_attention": {"trocr": k5},
            "encoder_attention": {"trocr": k3},
            "int8_matmul": {"trocr": k14}}


def trocr_pipeline(int8: bool, arch: str = "trocr_base"):
    """cli/trocr_infer.py's build_pipeline for `arch` (--arch) bf16, beam
    5, 32 new tokens (random weights from seed 0; --int8 when asked), with
    min_new_tokens 32 so that every line takes its 31 decode steps."""
    from unilm_tpu_torch.cli import trocr_infer
    from unilm_tpu_torch.models import trocr as trocr_models

    argv = ["--image", "unused", "--arch", arch, "--bf16", "--beam",
            str(TROCR_BEAM), "--max_new_tokens", str(TROCR_NEW)] + (
                ["--int8"] if int8 else [])
    pipe = trocr_infer.build_pipeline(trocr_infer.build_parser().parse_args(
        argv))
    pipe.gcfg = dataclasses.replace(pipe.gcfg, min_new_tokens=TROCR_NEW)
    want = getattr(trocr_models, arch)(dtype=torch.bfloat16,
                                       quant_weights=int8)
    check(pipe.model.cfg == want and want.dec_layers == TROCR_ARCH[arch]
          and want.num_patches + 2 == TROCR_S,
          f"{arch}: config {pipe.model.cfg}")
    return pipe


def trocr_plain(model):
    """The same weights on the plain path: use_flash=False and every
    QuantDense on int8_matmul_plain."""
    from unilm_tpu_torch.models.trocr import TrOCRModel
    from unilm_tpu_torch.ops.quant import QuantDense

    plain = TrOCRModel(dataclasses.replace(model.cfg, use_flash=False),
                       device=next(model.parameters()).device).eval()
    plain.load_state_dict(model.state_dict(), strict=True)
    for m in plain.modules():
        if isinstance(m, QuantDense):
            m.use_kernel = False
    return plain


def phase_trocr(qm, int8: bool, arch: str = "trocr_base") -> tuple:
    """TrOCR beam-search OCR (`arch`: trocr_base, or trocr_small with its
    8 decoder heads of 32) through cli/trocr_infer.py's pipeline (bf16;
    `int8`: --int8) on synthetic 384x384 images made on the card, at B=1
    and B=32: launches exact, and each at its head dim (trocr_base: 12 #3
    per encode; the prefill 12 #5 for the 1-token prompt's self-attention
    and 12 #3 over the encoder; 12 #3 and 12 #13 a decode step; under
    int8 121 #14 in the prefill and 97 a step, else none; trocr_small: 12
    #3 at D = 64 an encode, 6 #5 and 6 #3 at D = 32 a prefill, 6 #3 and
    6 #13 at D = 32 a step, int8 61 and 49 #14); the cross K/V [B, L, 578,
    H, D] neither
    tiled nor copied by a beam step (one data_ptr from prefill to the
    last step); ms/batch and lines/s (host clock, TROCR_TIMED calls);
    device time a B*5-row decode step by kernel group beside the search
    and `_gather_beams` (the pools' copy only); the kernel path against
    the plain path on the same images: the encoder features, then two
    beam steps teacher-forced on the plain twin from the kernel path's
    features, a `_gather_beams` duplicating a parent between them, logits
    within LOGIT_ATOL with argmax agreement >= ARGMAX_AGREE. Returns
    (launches, the path's numbers)."""
    from unilm_tpu_torch.models.trocr import make_generate_fns
    from unilm_tpu_torch.runtime import generate as gen_mod

    name = ("trocr" if arch == "trocr_base" else arch) + (
        "_int8" if int8 else "")
    t0 = time.time()
    pipe = trocr_pipeline(int8, arch)
    model, cfg, dev = pipe.model, pipe.model.cfg, pipe.device
    L, K, P = cfg.dec_layers, TROCR_BEAM, 1
    E, De = cfg.enc_layers, cfg.enc_dim // cfg.enc_heads
    Hd, Dh = cfg.dec_heads, cfg.dec_dim // cfg.dec_heads
    n_bytes = sum(t.numel() * t.element_size()
                  for t in model.state_dict().values())
    phase(name, f"build_pipeline --bf16 --beam {K} --max_new_tokens "
          f"{TROCR_NEW}{' --int8' if int8 else ''}: {time.time() - t0:.1f} s;"
          f" {n_bytes / 1e9:.3f} GB of weights; cache {pipe.cache_size} "
          f"slots")
    # int8: the decoder's quantized projections (self q, k, v, out, cross
    # q, k, v, out, fc1, fc2 a layer in the prefill; a step reuses the
    # cross K/V) and the head
    per14 = (10 * L + 1, 8 * L + 1) if int8 else (0, 0)
    prefill, step = pipe.prefill, pipe.step
    seen = {"steps": 0, "ptrs": set()}

    def pf(tok, aux):
        out = prefill(tok, aux)
        torch.cuda.synchronize()
        seen["prefill"] = counts()
        return out

    def st(tok, c, aux):
        dec = c["text_decoder"]["decoder"]
        seen["ptrs"].add((dec["cross_key"].data_ptr(),
                          dec["cross_value"].data_ptr()))
        seen["shape"] = tuple(dec["cross_key"].shape)
        seen["steps"] += 1
        return step(tok, c, aux)

    plain = trocr_plain(model)
    ppf, pst = make_generate_fns(plain, pipe.cache_size)
    launches, numbers = {}, {}
    for B in TROCR_BATCHES:
        imgs = torch.randn(B, cfg.img_size, cfg.img_size, 3, generator=torch.
                           Generator(device=dev).manual_seed(SEED),
                           device=dev).to(torch.bfloat16)
        # ---- the main path, counted --------------------------------------
        pipe.prefill, pipe.step = pf, st
        seen.update(steps=0, ptrs=set())
        reset_counts()
        with torch.no_grad():
            enc_feats = model.encode(imgs)
        torch.cuda.synchronize()
        enc_counts, enc_d = counts(), by_head_dim()
        reset_counts()
        toks, scores = pipe.generate(imgs)
        torch.cuda.synchronize()
        pipe.prefill, pipe.step = prefill, step
        got, pre, S = counts(), seen["prefill"], seen["steps"]
        got_d = by_head_dim()
        check(enc_counts["encoder_attention"] == E
              and sum(enc_counts.values()) == E
              and enc_d == {"encoder_attention": {De: E}},
              f"{name}: B={B} encode launched {enc_counts}, by head dim "
              f"{enc_d} (want {E} of #3 at D = {De})")
        # generate: the encode, the prefill (#5 for the prompt's self-
        # attention, #3 over the encoder output), then S steps
        check(tuple(toks.shape) == (B, K, P + TROCR_NEW) and S == TROCR_NEW - 1
              and bool(torch.isfinite(scores).all())
              and bool((scores[:, :-1] >= scores[:, 1:]).all()),
              f"{name}: B={B} tokens {tuple(toks.shape)}, {S} steps, scores "
              f"{scores[0].tolist()}")
        want_pre = {"encoder_attention": E + L, "onepass_attention": L,
                    "int8_matmul": per14[0]}
        want = {"encoder_attention": E + L + L * S, "onepass_attention": L,
                "decode_attention": L * S,
                "int8_matmul": per14[0] + per14[1] * S}
        want_d = {"decode_attention": {Dh: L * S},
                  "encoder_attention": {De: E},
                  "onepass_attention": {Dh: L}}
        want_d["encoder_attention"][Dh] = (
            want_d["encoder_attention"].get(Dh, 0) + L + L * S)
        check(all(pre[k] == v for k, v in want_pre.items())
              and pre["decode_attention"] == 0
              and all(got[k] == v for k, v in want.items())
              and sum(got.values()) == sum(want.values())
              and got_d == want_d,
              f"{name}: B={B} launches {got}, prefill {pre}, by head dim "
              f"{got_d} (want {want}, prefill {want_pre}, {want_d})")
        check(len(seen["ptrs"]) == 1
              and seen["shape"] == (B, L, TROCR_S, Hd, Dh),
              f"{name}: B={B} cross K/V seen at {len(seen['ptrs'])} "
              f"addresses, shape {seen['shape']} (want one, untiled)")
        for k, v in got.items():
            if v:
                launches[k] = launches.get(k, 0) + v
        # ---- ms/batch, lines/s on the host clock -------------------------
        walls = []
        for _ in range(TROCR_TIMED):
            torch.cuda.synchronize()
            t1 = time.time()
            pipe.generate(imgs)
            torch.cuda.synchronize()
            walls.append((time.time() - t1) * 1e3)
        ms = float(np.median(walls))
        # ---- a decode step's device time by group -----------------------
        with torch.no_grad():
            lg, c = prefill(toks[:, 0, :1], enc_feats)
            c = gen_mod._tile_cache(c, K)
        tokK = toks[:, :, P:P + 1].reshape(B * K, 1)
        shares, top = profile_steps(lambda: step(tokK, c, None), 4,
                                    TROCR_GROUPS)
        lgK = step(tokK, c, None)[0]
        scfg = pipe.gcfg

        def search():
            lp = torch.log_softmax(lgK[:, -1].float(), -1)
            lp = gen_mod._adjust_logprobs(
                lp, toks[:, :, :P].reshape(B * K, P), 1, P, scfg)
            return gen_mod._topk_over_beams(lp.reshape(B, K, -1), 2 * K)

        idx = torch.tensor([[0, 0, 1, 2, 3]] * B, device=dev)
        gathered = gen_mod._gather_beams(c, idx, B, K)
        dec, gdec = c["text_decoder"]["decoder"], gathered["text_decoder"][
            "decoder"]
        check(gdec["cross_key"] is dec["cross_key"]
              and gdec["cross_value"] is dec["cross_value"]
              and gdec["kv_pool_key"].data_ptr() != dec["kv_pool_key"].data_ptr(),
              f"{name}: _gather_beams copied the cross K/V or not the pools")
        del gathered
        gather_ms = device_ms(lambda: gen_mod._gather_beams(c, idx, B, K))
        pool_gb = nbytes(dec["kv_pool_key"], dec["kv_pool_value"]) / 1e9
        cross_gb = nbytes(dec["cross_key"], dec["cross_value"]) / 1e9
        groups = {**shares, "search (log_softmax + top-k)": device_ms(search),
                  "_gather_beams": gather_ms}
        dev_step = sum(groups.values())
        host_step = ms / (S + 1)  # the encode shared out
        phase(name, f"B={B} beam {K}: {S} steps; launches #3 "
              f"{got['encoder_attention']} ({E} an encode, {L} in the "
              f"prefill, {L} a step), #5 "
              f"{got['onepass_attention']} (the prefill), #13 "
              f"{got['decode_attention']} ({L} a step), #14 "
              f"{got['int8_matmul']}; by head dim {got_d}; cross K/V "
              f"{cross_gb:.3f} GB, one address from prefill to step {S}")
        phase(name, f"B={B}: {ms:.1f} ms/batch (host clock, median of "
              + ", ".join(f"{w:.1f}" for w in walls) + f") -> "
              f"{B * 1e3 / ms:.2f} lines/s; device time a {B * K}-row step "
              f"{dev_step:.4f} ms (host {host_step:.2f} ms a forward, "
              f"{100 * dev_step / host_step:.1f}% busy): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in groups.items())
              + "; other's largest: " + ", ".join(f"{k} {t:.4f}"
                                                  for k, t in top)
              + f"; _gather_beams copies the pools' {pool_gb:.3f} GB "
              f"({2 * pool_gb / (gather_ms * 1e-3):.0f} GB/s read + write), "
              f"not the cross K/V")

        # ---- kernel path vs plain path, teacher-forced --------------------
        reorder = torch.tensor([[0, 0, 1, 2, 3]] * B, device=dev)

        def beam_steps(pf_, st_):
            with torch.no_grad():
                cc = gen_mod._tile_cache(pf_(toks[:, 0, :1], enc_feats)[1], K)
                out = []
                for j in range(2):
                    if j:
                        cc = gen_mod._gather_beams(cc, reorder, B, K)
                    lgj, cc = st_(toks[:, :, P + j:P + j + 1].reshape(B * K, 1),
                                  cc, None)
                    out.append(lgj[:, -1].float())
            torch.cuda.synchronize()
            return out

        c0 = counts()
        with torch.no_grad():
            pfeats = plain.encode(imgs)
        klog = beam_steps(prefill, step)
        c1 = counts()
        plog = beam_steps(ppf, pst)
        check(counts() == c1 and c1 != c0, f"{name}: B={B} the plain path "
              f"launched a kernel, or the kernel path none")
        feat_err = float((enc_feats.float() - pfeats.float()).abs().max())
        feat_rel = rel_l2(enc_feats, pfeats)
        errs = [float((a - b).abs().max()) for a, b in zip(klog, plog)]
        agree = float(torch.cat([a.argmax(-1) == b.argmax(-1)
                                 for a, b in zip(klog, plog)]).float().mean())
        check(feat_err <= LOGIT_ATOL and feat_rel <= FEATURE_REL_L2
              and all(np.isfinite(errs))
              and max(errs) <= LOGIT_ATOL and agree >= ARGMAX_AGREE,
              f"{name}: B={B} kernel vs plain: features max|err| {feat_err}, "
              f"rel L2 {feat_rel}, step logits {errs}, argmax agreement "
              f"{agree}")
        phase(name, f"B={B} vs the plain path: encoder features max|err| "
              f"{feat_err:.4f} (tol {LOGIT_ATOL}), rel L2 {feat_rel:.3g} (tol "
              f"{FEATURE_REL_L2}); two beam steps "
              f"({B * K} rows, a gather {reorder[0].tolist()} between them) "
              f"logits max|err| " + ", ".join(f"{e:.4f}" for e in errs)
              + f" (tol {LOGIT_ATOL}), argmax agreement {agree:.3f}")
        numbers[f"B{B}"] = {
            "ms_per_batch_host": walls, "lines_per_s": B * 1e3 / ms,
            "decode_step_device_ms_by_group": groups,
            "decode_step_device_ms": dev_step,
            "gather_beams_gb": pool_gb, "cross_kv_gb": cross_gb,
            "encoder_features_max_abs_err": feat_err,
            "encoder_features_rel_l2": feat_rel,
            "beam_step_logits_max_abs_err": errs,
            "beam_step_argmax_agreement": agree}
        del c, lgK, enc_feats, pfeats, klog, plog, imgs
        torch.cuda.empty_cache()
    del pipe, model, plain
    torch.cuda.empty_cache()
    return launches, {name: numbers}


# ---- Kosmos-2 (kosmos2(): the open_clip ViT-L/14 tower, 64 latent queries,
# the 24-layer E=2048 UniGPT decoder) ------------------------------------
KOSMOS2_BATCHES, KOSMOS2_NEW, KOSMOS2_TIMED = (1, 8), 32, 3
KOSMOS2_TOWER = 24  # tower layers; the decoder has 24 too
KOSMOS2_S, KOSMOS2_Q = (224 // 14) ** 2 + 1, 64  # tower tokens, queries
KOSMOS2_PREFIX = "<phrase>a dog</phrase>"  # the refcoco prompt's prefix
# the refcoco prompt's length: <s>, <image>, Q slots, </image>,
# <grounding> and the prefix's 7 byte-tokenizer ids
KOSMOS2_P = 3 + KOSMOS2_Q + 1 + 7
ENC_BWD_ONLY = "enc_bwd_"  # #4's kernels
# encode_image's features, kernel path against plain path: relative L2
# (0.0038 at B=1 and B=8 on an H100 80GB HBM3 at 700 W)
KOSMOS2_FEATURE_REL_L2 = 1e-2
# kosmos2_train's 2-layer copy in bf16, kernel path against plain path on
# the stream's first batch (130 text targets): loss rel 6.81e-5 on an
# H100 80GB HBM3 at 700 W, of which the plain path's own bf16 rounding is
# most (4.12e-5 from the float32 loss, the kernel path 2.68e-5). A mean
# over so few targets moves more than the train phase's (TEACHER_LOSS_REL);
# its bound is ~10x the reading:
KOSMOS2_TEACHER_LOSS_REL = 7e-4
KOSMOS2_GROUPS = [("#13", [DECODE_ONLY]), ("#5", [ONEPASS_ONLY]),
                  ("#3", [ENCODER_ONLY]), ("#1", ["flash_fwd"]),
                  ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet", "cublas",
                              "splitK"])]
# a SEED-Bench candidate's mean answer log-prob, kernel path against plain
# path: the logits agree within LOGIT_ATOL, and a log-softmax entry moves
# by at most twice its logit's error; the mean over the answer's tokens
# is held at 0.1. The argmax choice must agree wherever the plain path's
# best choice leads its second by more than twice that.
SEED_LOGP_ATOL = 0.1
SEED_QUESTIONS = [("What is shown in the image?", ["a dog", "a cat",
                                                   "a red car", "a tree"]),
                  ("How many people are there?", ["one", "two", "three",
                                                  "none"]),
                  ("Where is the dog?", ["on the grass", "in a car",
                                         "under a table", "on a bed"]),
                  ("What color is the car?", ["red", "blue", "green",
                                              "white"])]


def kosmos2_model():
    """cli/kosmos_ground_eval.py's --kosmos2 model (random weights
    from seed 0) and its arguments, with the byte tokenizer (the card's
    machine has no cl100k_base file)."""
    from unilm_tpu_torch.cli import kosmos_ground_eval as ge
    from unilm_tpu_torch.data.vl_loaders import VLTokenizer
    from unilm_tpu_torch.models.kosmos import kosmos2

    tok = VLTokenizer(backend="bytes")
    args = ge.build_parser().parse_args([
        "--task", "refcoco", "--data", "unused", "--kosmos2",
        "--max_new_tokens", str(KOSMOS2_NEW), "--seed", str(SEED)])
    model = ge.build_model(args, tok)
    want = kosmos2(dtype=torch.bfloat16, segment_emb=True)
    check(model.cfg == want and want.clip.num_layers == KOSMOS2_TOWER
          and want.num_layers == KOSMOS2_TOWER
          and (args.image_size, args.image_tokens) == (224, KOSMOS2_Q),
          f"kosmos2: config {model.cfg}")
    return ge, args, tok, model


def phase_kosmos2_kernels(fa, pa, g, dev: str = "cuda") -> dict:
    """The kernels of Kosmos-2's path alone, at its shapes, against their
    plain versions: #3 at the tower's Bx257x257x16x64 and the resampler's
    Bx64x321x32x64 (B 8 and 1; relative L2 <= 1e-2) and #4 there (dq, dk,
    dv, grad_close at 1e-2); #5 at the prefill's causal BxPx32x64 (the
    refcoco prompt's P = 75, B 8 and 1; OUT_ATOL / OUT_RTOL, lse
    LSE_ATOL); #13 bf16 at the decoder's pools (page 16, chunk 2, 8 pages
    a run, H32 D64) at B8 and B1 over the decode's lengths, pools
    bit-equal. Each timed (device time back to back and with L2 flushed)
    beside the plain version, sdpa (or sdpa's backward) and the bound.
    Returns {kernel name: {"kosmos2": {...}}} for the kernels line."""
    from unilm_tpu_torch.core.transformer import _scan_pool_geometry

    bf, name, D, P = torch.bfloat16, "kosmos2_kernels", 64, KOSMOS2_P

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    def lib_pair(fn):
        return {"library_ms": device_ms(fn), "library_ms_l2_flushed":
                cold_ms(fn)}

    # ---- #3 and #4: the tower and the resampler -------------------------
    k3, k4 = {}, {}
    for B in KOSMOS2_BATCHES[::-1]:
        for role, (T, S, H) in (("tower", (KOSMOS2_S, KOSMOS2_S, 16)),
                                ("resampler",
                                 (KOSMOS2_Q, KOSMOS2_S + KOSMOS2_Q, 32))):
            key = f"{role} B{B}"
            q, k, v, do = rn(B, T, H, D), rn(B, S, H, D), rn(B, S, H, D), \
                rn(B, T, H, D)
            out = fa.fused_encoder_attention(q, k, v)
            ref = fa.fused_encoder_attention_plain(q, k, v)
            torch.cuda.synchronize()
            e = rel_l2(out, ref)
            check(bool(torch.isfinite(out.float()).all()) and e <= 1e-2,
                  f"{name}: #3 {key} {B}x{T}x{S}x{H}x{D}: rel L2 {e}")
            kern = lambda: fa.fused_encoder_attention(q, k, v)
            r = k3[key] = {
                "shape": f"{B}x{T}x{S}x{H}x{D} bf16, no bias", "rel_l2": e,
                "max_abs_err": float((out.float() - ref.float()).abs().max()),
                "ms": device_ms(kern, only=ENCODER_ONLY),
                "ms_l2_flushed": cold_ms(kern, ENCODER_ONLY),
                "plain_ms": device_ms(lambda: fa.fused_encoder_attention_plain(
                    q, k, v), iters=3),
                **lib_pair(lambda: sdpa(q, k, v)),
                **attn_bound(B * H * T * S, D, 2, q, k, v, out)}
            phase(name, f"#3 {key} {r['shape']}: rel L2 {e:.3g} (bound "
                  f"1e-2); device time {r['ms']:.4f} ms back to back, "
                  f"{r['ms_l2_flushed']:.4f} flushed; sdpa "
                  f"{r['library_ms']:.4f} / {r['library_ms_l2_flushed']:.4f};"
                  f" plain {r['plain_ms']:.4f}; bound {r['bound_ms']:.5f} "
                  f"({r['bound_by']})")
            got = fa.fused_encoder_backward(q, k, v, None, do)
            want = fa.fused_encoder_backward_plain(q, k, v, None, do)
            torch.cuda.synchronize()
            worst_rel, worst_abs = 0.0, 0.0
            for gname, x, rr in zip(("dq", "dk", "dv"), got, want):
                ok, ea, er = grad_close(x, rr, 1e-2)
                check(bool(torch.isfinite(x.float()).all()) and ok,
                      f"{name}: #4 {key} {gname} max|err| {ea} rel L2 {er}")
                worst_rel, worst_abs = max(worst_rel, er), max(worst_abs, ea)
            check(got[3] is None, f"{name}: #4 {key} gave a dbias")
            bwd = lambda: fa.fused_encoder_backward(q, k, v, None, do)
            qg, kg, vg = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            o = sdpa(qg, kg, vg)
            dot = do.transpose(1, 2)
            lib = lambda: torch.autograd.grad(o, (qg, kg, vg), dot,
                                              retain_graph=True)
            r = k4[key] = {
                "shape": f"{B}x{T}x{S}x{H}x{D} bf16, no bias, dq/dk/dv",
                "rel_l2": worst_rel, "max_abs_err": worst_abs,
                "ms": device_ms(bwd, only=ENC_BWD_ONLY),
                "ms_l2_flushed": cold_ms(bwd, ENC_BWD_ONLY),
                "plain_ms": device_ms(lambda: fa.fused_encoder_backward_plain(
                    q, k, v, None, do), iters=3),
                "library": f"sdpa backward ({type(o.grad_fn).__name__})",
                **lib_pair(lib),
                **attn_bound(B * H * T * S, D, 5, q, k, v, do, *got[:3])}
            phase(name, f"#4 {key} {r['shape']}: worst rel L2 "
                  f"{worst_rel:.3g} (bound 1e-2); device time {r['ms']:.4f} "
                  f"ms back to back, {r['ms_l2_flushed']:.4f} flushed; "
                  f"{r['library']} {r['library_ms']:.4f} / "
                  f"{r['library_ms_l2_flushed']:.4f}; plain "
                  f"{r['plain_ms']:.4f}; bound {r['bound_ms']:.5f} "
                  f"({r['bound_by']})")
            del q, k, v, do, out, ref, got, want, o, qg, kg, vg

    # ---- #5: the prefill's causal self-attention ------------------------
    k5, H = {}, 32
    for B in KOSMOS2_BATCHES[::-1]:
        check(fa.onepass_applies(B, H, P, P, D, None, 0),
              f"{name}: #5 does not take B{B}x{P}x{H}x{D}")
        q, k, v = rn(B, P, H, D) * D ** -0.5, rn(B, P, H, D), rn(B, P, H, D)
        five = lambda: fa.flash_forward_onepass(q, k, v, causal=True)
        out, lse = five()
        ref, ref_lse = fa.flash_forward_onepass_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        ok_o, e_o = close(out, ref, OUT_ATOL, OUT_RTOL)
        ok_l, e_l = close(lse, ref_lse, LSE_ATOL, 0.0)
        check(ok_o and ok_l and bool(torch.isfinite(out.float()).all()),
              f"{name}: #5 B{B}x{P}x{H}x{D} causal: out err {e_o}, lse err "
              f"{e_l}")
        r = k5[f"B{B}"] = {
            "shape": f"{B}x{P}x{P}x{H}x{D} causal bf16 (the prefill)",
            "max_abs_err": e_o, "lse_max_abs_err": e_l,
            "ms": device_ms(five, only=ONEPASS_ONLY),
            "ms_l2_flushed": cold_ms(five, ONEPASS_ONLY),
            "plain_ms": device_ms(lambda: fa.flash_forward_onepass_plain(
                q, k, v, causal=True), iters=3),
            **lib_pair(lambda: sdpa(q, k, v, is_causal=True, scale=1.0)),
            **attn_bound(B * H * P * (P + 1) / 2, D, 2, q, k, v, out, lse)}
        phase(name, f"#5 {r['shape']}: out max|err| {e_o:.3g}, lse max|err|"
              f" {e_l:.3g} (tol {OUT_ATOL} abs + {OUT_RTOL} rel, lse "
              f"{LSE_ATOL}); device time {r['ms']:.4f} ms back to back, "
              f"{r['ms_l2_flushed']:.4f} flushed; sdpa {r['library_ms']:.4f} "
              f"/ {r['library_ms_l2_flushed']:.4f}; plain {r['plain_ms']:.4f};"
              f" bound {r['bound_ms']:.5f} ({r['bound_by']})")
        del q, k, v, out, lse, ref, ref_lse

    # ---- #13 bf16 at the decoder's pools --------------------------------
    page, chunk, PP = _scan_pool_geometry(P + KOSMOS2_NEW)
    check((page, chunk, PP) == (16, 2, 8), f"{name}: pool geometry "
          f"{(page, chunk, PP)}")
    lens8 = [P, 79, 80, 81, 95, 96, 97, P + KOSMOS2_NEW - 2]
    k13, worst13 = {}, 0.0
    for lens in (lens8, [P + KOSMOS2_NEW // 2]):
        Bc = len(lens)
        bases = torch.arange(Bc, dtype=torch.int32, device=dev) * PP
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        kp, vp = rn(Bc * PP, page, H * D), rn(Bc * PP, page, H * D)
        q, kn, vn = rn(Bc, 1, H, D), rn(Bc, 1, H, D), rn(Bc, 1, H, D)
        kp2, vp2 = kp.clone(), vp.clone()
        out = pa.run_decode_append_attention(q, kn, vn, kp, vp, bases,
                                             lengths, PP, None, chunk)[0]
        ref = pa.run_decode_append_attention_plain(
            q, kn, vn, kp2, vp2, bases, lengths, PP, None, chunk)[0]
        torch.cuda.synchronize()
        ok, err = close(out, ref, OUT_ATOL, OUT_RTOL)
        check(ok and bool(torch.isfinite(out.float()).all())
              and torch.equal(kp, kp2) and torch.equal(vp, vp2),
              f"{name}: #13 B{Bc} lengths {lens}: out err {err} or pools "
              f"differ")
        worst13 = max(worst13, err)
        # timed over the runs as they stand after the append
        L = max(lens) + 1
        qs = (q[:, 0] * D ** -0.5).contiguous()
        lengths1 = lengths + 1
        alone = lambda: pa.decode_attention(qs, kp, vp, bases, lengths1, PP)
        run = lambda pool: pool.reshape(Bc, PP * page, H, D)[:, :L]
        r = k13[f"B{Bc}"] = {
            "shape": f"B{Bc} lengths {lens} (+1) H{H} D{D} page {page} bf16",
            "max_abs_err": err,
            "ms": device_ms(alone, only=DECODE_ONLY),
            "ms_l2_flushed": cold_ms(alone, DECODE_ONLY),
            "plain_ms": device_ms(
                lambda: pa.run_decode_append_attention_plain(
                    q, kn, vn, kp2, vp2, bases, lengths, PP, None, chunk),
                iters=3),
            **lib_pair(lambda: sdpa(q, run(kp), run(vp))),
            **decode_bound(sum(n + 1 for n in lens), len(lens), H, D, 2,
                           new_rows=False)}
        phase(name, f"#13 {r['shape']}: out max|err| {err:.3g} (tol "
              f"{OUT_ATOL} abs + {OUT_RTOL} rel), pools bit-equal; device "
              f"time {r['ms']:.4f} ms back to back, {r['ms_l2_flushed']:.4f} "
              f"flushed; sdpa over the longest run {r['library_ms']:.4f} / "
              f"{r['library_ms_l2_flushed']:.4f}; plain {r['plain_ms']:.4f}; "
              f"bound {r['bound_ms']:.5f} ({r['bound_by']})")
        del kp, vp, kp2, vp2
    torch.cuda.empty_cache()
    return {"encoder_attention": {"kosmos2": k3},
            "encoder_attention_bwd": {"kosmos2": k4},
            "onepass_attention": {"kosmos2": k5},
            "decode_attention": {"kosmos2": k13}}


def kosmos2_seed_records():
    return [{"image": None, "question": q, "choices": c, "answer": "A",
             "question_type": f"t{i % 2}"}
            for i, (q, c) in enumerate(SEED_QUESTIONS)]


def phase_kosmos2(fa) -> tuple:
    """Kosmos-2 grounded generation through cli/kosmos_ground_eval.py's
    --kosmos2 model and its refcoco prompt (build_prompts with the
    prefix <phrase>a dog</phrase>, byte tokenizer ids), 224x224
    pseudo-images from load_image, at B=1 and B=8, KOSMOS2_NEW greedy
    tokens (</s> banned before them): exactly 25 launches of #3 an encode
    (24 tower layers, the resampler), 24 of #5 a prefill, 24 of #13 a
    decode step and nothing else; the markup through parse_grounded_text,
    printed only (random weights; ids past the byte tokenizer's render
    as off-grid patch indices);
    TTFT (encode + prefill) on the host clock and as device time,
    ms/token, a step's device time by kernel group, the busy share and
    peak memory; against the plain twin: encode_image's features (rel L2
    <= KOSMOS2_FEATURE_REL_L2), the prefill's logits and two decode steps
    teacher-forced on the kernel path's tokens and features (LOGIT_ATOL,
    ARGMAX_AGREE). Then one SEED-Bench scoring forward through
    cli/kosmos_seedbench.py (4 questions x 4 choices from
    pack_candidates): 25 #3 and 24 of #5 or #1 (as onepass_applies
    decides at its length), the mean answer log-probs within
    SEED_LOGP_ATOL of the plain path's and the argmax choice equal where
    the plain path's lead exceeds twice that. Returns (launches, the
    path's numbers)."""
    from unilm_tpu_torch.cli import kosmos_seedbench as sb
    from unilm_tpu_torch.data.grounding import parse_grounded_text
    from unilm_tpu_torch.models.kosmos import make_unigpt_generate_fns

    name = "kosmos2"
    t0 = time.time()
    ge, args, tok, model = kosmos2_model()
    L, Q = KOSMOS2_TOWER, KOSMOS2_Q
    n_params = sum(p.numel() for p in model.parameters())
    phase(name, f"kosmos_ground_eval --kosmos2: {n_params / 1e9:.3f} "
          f"B params, built in {time.time() - t0:.1f} s; byte tokenizer "
          f"({tok.vocab_size} ids)")
    plain = plain_twin(model)
    prefix = tok.encode_grounded(KOSMOS2_PREFIX)
    launches, numbers = {}, {}

    def count_into(got):
        for k, v in got.items():
            if v:
                launches[k] = launches.get(k, 0) + v

    for B in KOSMOS2_BATCHES:
        records = [{"image": None, "expression": "a dog",
                    "box": [0.1, 0.2, 0.6, 0.9], "id": i} for i in range(B)]
        prompts = ge.build_prompts(args, tok, records, [prefix] * B)
        P = prompts[0].shape[1]
        check(P == KOSMOS2_P, f"{name}: prompt of {P} tokens")
        tokens, img_mask, segs, images = (torch.from_numpy(a).cuda()
                                          for a in prompts)
        cache_size = P + KOSMOS2_NEW
        prefill, step = make_unigpt_generate_fns(model, cache_size)
        # ---- the main path, counted --------------------------------------
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = ge.generate_ids(model, tok, prompts, KOSMOS2_NEW,
                              min_new_tokens=KOSMOS2_NEW)
        torch.cuda.synchronize()
        got = counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        S = KOSMOS2_NEW - 1
        want = {"encoder_attention": L + 1, "onepass_attention": L,
                "decode_attention": L * S}
        check(tuple(out.shape) == (B, P + KOSMOS2_NEW)
              and all(got[k] == v for k, v in want.items())
              and sum(got.values()) == sum(want.values()),
              f"{name}: B={B} tokens {tuple(out.shape)}, launches {got} "
              f"(want {want})")
        count_into(got)
        reset_counts()
        with torch.no_grad():
            feats = model.encode_image(images)
            enc = counts()
            reset_counts()
            lg, cache = prefill(tokens, (feats, img_mask, segs))
            pre = counts()
            reset_counts()
            step(out[:, P:P + 1], cache, None)
            one = counts()
        check(enc == {**{k: 0 for k in enc}, "encoder_attention": L + 1}
              and pre == {**{k: 0 for k in pre}, "onepass_attention": L}
              and one == {**{k: 0 for k in one}, "decode_attention": L},
              f"{name}: B={B} encode {enc}, prefill {pre}, step {one}")
        texts = ge.decode_generated(tok, out, P)
        clean, ents = parse_grounded_text(KOSMOS2_PREFIX + texts[0])
        # ---- times --------------------------------------------------------
        def ttft():
            with torch.no_grad():
                f = model.encode_image(images)
                return prefill(tokens, (f, img_mask, segs))

        walls, gens = [], []
        for _ in range(KOSMOS2_TIMED):
            torch.cuda.synchronize()
            t1 = time.time()
            ttft()
            torch.cuda.synchronize()
            walls.append((time.time() - t1) * 1e3)
            t1 = time.time()
            ge.generate_ids(model, tok, prompts, KOSMOS2_NEW,
                            min_new_tokens=KOSMOS2_NEW)
            torch.cuda.synchronize()
            gens.append((time.time() - t1) * 1e3)
        ttft_ms, gen_ms = float(np.median(walls)), float(np.median(gens))
        ttft_dev = device_ms(ttft, iters=3)
        ms_tok = (gen_ms - ttft_ms) / S
        with torch.no_grad():
            lg, cache = prefill(tokens, (feats, img_mask, segs))
        tok1 = out[:, P:P + 1]
        shares, top = profile_steps(lambda: step(tok1, cache, None), 4,
                                    KOSMOS2_GROUPS)
        dev_step = sum(shares.values())
        phase(name, f"B={B}: prompt {P} tokens, {S} decode steps; launches "
              f"#3 {got['encoder_attention']} ({L + 1} an encode), #5 "
              f"{got['onepass_attention']} (the prefill), #13 "
              f"{got['decode_attention']} ({L} a step); markup (printed "
              f"only) {texts[0][:60]!r}... -> {len(ents)} entities, clean "
              f"{clean[:40]!r}")
        phase(name, f"B={B}: TTFT (encode + prefill) {ttft_ms:.2f} ms host "
              f"(median of " + ", ".join(f"{w:.2f}" for w in walls)
              + f"), {ttft_dev:.4f} ms device time; generate {gen_ms:.1f} ms "
              f"-> {ms_tok:.2f} ms/token; a step's device time "
              f"{dev_step:.4f} ms ({100 * dev_step / ms_tok:.1f}% busy): "
              + ", ".join(f"{k} {v:.4f}" for k, v in shares.items())
              + "; other's largest: " + ", ".join(f"{k} {t:.4f}"
                                                  for k, t in top)
              + f"; peak memory {peak:.2f} GiB")
        # ---- kernel path vs plain path -----------------------------------
        @torch.no_grad()
        def teacher(m):
            """m's prefill logits on the kernel path's features, then two
            decode steps on the kernel path's tokens."""
            x, c = m.prefill(tokens, cache_size, feats, img_mask, segs)
            lgs = [x.float()]
            for j in range(2):
                x, c = m.decode_step(out[:, P + j:P + j + 1], c, cache_size)
                lgs.append(x[:, -1].float())
            torch.cuda.synchronize()
            return lgs

        c0 = counts()
        klog = teacher(model)
        c1 = counts()
        plog = teacher(plain)
        with torch.no_grad():
            pfeats = plain.encode_image(images)
        torch.cuda.synchronize()
        check(counts() == c1 and c1 != c0, f"{name}: B={B} the plain path "
              f"launched a kernel, or the kernel path none")
        feat_rel = rel_l2(feats, pfeats)
        feat_err = float((feats.float() - pfeats.float()).abs().max())
        errs = [float((a - b).abs().max()) for a, b in zip(klog, plog)]
        agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
                 for a, b in zip(klog, plog)]
        check(feat_rel <= KOSMOS2_FEATURE_REL_L2 and all(np.isfinite(errs))
              and max(errs) <= LOGIT_ATOL and min(agree) >= ARGMAX_AGREE,
              f"{name}: B={B} kernel vs plain: features rel L2 {feat_rel}, "
              f"logits {errs}, argmax agreement {agree}")
        phase(name, f"B={B} vs the plain path: encode_image features rel L2 "
              f"{feat_rel:.3g} (tol {KOSMOS2_FEATURE_REL_L2}), max|err| "
              f"{feat_err:.4f}; prefill logits [B, {P}, V] and two decode "
              f"steps max|err| " + ", ".join(f"{e:.4f}" for e in errs)
              + f" (tol {LOGIT_ATOL}), argmax agreement "
              + ", ".join(f"{a:.3f}" for a in agree))
        numbers[f"B{B}"] = {
            "prompt_tokens": P, "ttft_ms_host": walls,
            "ttft_device_ms": ttft_dev, "generate_ms_host": gens,
            "ms_per_token": ms_tok, "decode_step_device_ms_by_group": shares,
            "decode_step_device_ms": dev_step, "peak_memory_gib": peak,
            "features_rel_l2": feat_rel, "logits_max_abs_err": errs,
            "argmax_agreement": agree, "entities": len(ents)}
        del cache, feats, pfeats, klog, plog, lg, out
        torch.cuda.empty_cache()

    # ---- one SEED-Bench scoring forward ---------------------------------
    sargs = sb.build_parser().parse_args(["--data", "unused", "--kosmos2"])
    ge.model_config(sargs, tok)  # the preset's image size and queries
    records = kosmos2_seed_records()
    packed = sb.pack_candidates(sargs, tok, records)
    R, T = packed[0].shape
    fwd = ("onepass_attention" if fa.onepass_applies(R, 32, T, T, 64, None, 0)
           else "flash_fwd")
    reset_counts()
    ks = sb.model_scores(sargs, tok, records, model=model)
    torch.cuda.synchronize()
    got = counts()
    want = {"encoder_attention": L + 1, fwd: L}
    check(all(got[k] == v for k, v in want.items())
          and sum(got.values()) == sum(want.values()),
          f"{name}: SEED-Bench forward launches {got} (want {want})")
    count_into(got)
    sb_ms = device_ms(lambda: sb.model_scores(sargs, tok, records,
                                              model=model), iters=3)
    ps = sb.model_scores(sargs, tok, records, model=plain)
    err = float(np.abs(ks - ps).max())
    top2 = np.sort(ps, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * SEED_LOGP_ATOL
    same = ks.argmax(-1) == ps.argmax(-1)
    check(np.isfinite(ks).all() and err <= SEED_LOGP_ATOL
          and bool(same[clear].all()),
          f"{name}: SEED-Bench scores max|err| {err}, argmax kernel "
          f"{ks.argmax(-1)} plain {ps.argmax(-1)} (clear lead {clear})")
    phase(name, f"SEED-Bench: {len(records)} questions x 4 choices = {R} "
          f"rows of {T} tokens in one forward: launches {got} ({fwd} for "
          f"the decoder); mean answer log-prob max|err| {err:.4f} (tol "
          f"{SEED_LOGP_ATOL}), argmax choice kernel {ks.argmax(-1).tolist()}"
          f" plain {ps.argmax(-1).tolist()} (plain lead > "
          f"{2 * SEED_LOGP_ATOL}: {clear.tolist()}); device time "
          f"{sb_ms:.3f} ms")
    numbers["seedbench"] = {"rows": R, "tokens": T, "decoder_kernel": fwd,
                            "scores_max_abs_err": err, "device_ms": sb_ms,
                            "argmax_same": same.tolist()}
    del model, plain
    torch.cuda.empty_cache()
    return launches, {name: numbers}


def write_vl_shard(path: Path, n: int, seed: int) -> None:
    """A laion_obj-style jsonl shard: random captions of 8-80 words with
    one to three grounded phrases (1-2 boxes each); no image files, so
    load_image makes each record's pseudo-image."""
    words = ["a", "dog", "cat", "man", "woman", "red", "car", "on", "the",
             "grass", "with", "tree", "bike", "next", "to", "big", "small"]
    rng = np.random.RandomState(seed)
    with open(path, "w", encoding="utf-8") as f:
        for _ in range(n):
            ws = [words[j] for j in rng.randint(0, len(words),
                                                size=rng.randint(8, 80))]
            starts = np.cumsum([0] + [len(w) + 1 for w in ws])
            objects = []
            for i in sorted(rng.choice(len(ws) - 1, rng.randint(1, 4),
                                       replace=False)):
                boxes = []
                for _ in range(rng.randint(1, 3)):
                    x0, y0 = rng.rand(2) * 0.6
                    boxes.append([x0, y0, x0 + 0.1 + rng.rand() * 0.3,
                                  y0 + 0.1 + rng.rand() * 0.3])
                objects.append({"span": [int(starts[i]),
                                         int(starts[i + 2] - 1)],
                                "boxes": boxes})
            f.write(json.dumps({"caption": " ".join(ws), "image": None,
                                "objects": objects}) + "\n")


def phase_kosmos2_train(fa) -> dict:
    """kosmos2_train: cli/train_gpt.py --vl_data at kosmos2()'s widths
    (ViT-L/14 at 224, 64 latent queries, 24 x 2048 decoder, vocab 65037)
    over a laion_obj shard written to chip_smoke_work/, bf16 compute /
    fp32 params, --remat, --fused_ce, batch 2 x 512 tokens, 3 AdamW steps:
    losses and grad norms finite; exactly 25 #3 and 25 #4 a step (the
    tower's 24 layers and the resampler), 24 #6 and 24 #7, and 48 of the
    decoder's forward (#1: T = 512 is past the one-pass budget; --remat
    runs it again in the backward); step ms, peak memory. Then a 2-layer
    copy (decoder and tower) on the card against its plain twin, on the
    stream's first batch: in float32 the loss, grad norm and per-tensor
    gradient cosines, in bf16 the grad norm and cosines, at the train
    phase's gates; the bf16 loss at KOSMOS2_TEACHER_LOSS_REL, printed
    beside both paths' distance to the float32 loss. Returns (launches,
    the path's numbers)."""
    import shutil

    from unilm_tpu_torch.cli import train_gpt
    from unilm_tpu_torch.ops.fused_ce import chunked_cross_entropy

    name = "kosmos2_train"
    shutil.rmtree(WORK, ignore_errors=True)
    (WORK / "vl").mkdir(parents=True)
    write_vl_shard(WORK / "vl" / "shard0.jsonl", 64, SEED)
    args = train_gpt.build_parser().parse_args([
        "--vl_data", str(WORK / "vl" / "*.jsonl"), "--dim", "2048",
        "--layers", "24", "--heads", "32", "--ffn", "8192", "--vocab",
        str(TRAIN_VOCAB), "--image_tokens", str(KOSMOS2_Q), "--image_size",
        "224", "--tokens_per_sample", "512", "--batch_size", "2", "--remat",
        "--fused_ce", "--ce_chunk", "8192", "--warmup", "1", "--seed",
        str(SEED)])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    tr = train_gpt.build_trainer(args)
    cfg = tr.cfg
    check(cfg.image_tower == "clip" and cfg.clip.num_layers == KOSMOS2_TOWER
          and cfg.clip.embed_dim == 1024 and cfg.latent_query_num == KOSMOS2_Q
          and cfg.dtype == torch.bfloat16, f"{name}: config {cfg}")
    n_params = sum(p.numel() for p in tr.model.parameters())
    phase(name, f"build_trainer --vl_data: {n_params / 1e9:.3f} B params, "
          f"{time.time() - t0:.1f} s")
    steps, losses, times, L = 3, [], [], KOSMOS2_TOWER
    reset_counts()
    first = None
    for i in range(steps):
        batch = tr.next_batch()
        first = batch if first is None else first
        torch.cuda.synchronize()
        t1 = time.time()
        tr.state, m = tr.step_fn(tr.state, batch)
        torch.cuda.synchronize()
        times.append(time.time() - t1)
        losses.append(float(m["loss"]))
        gn = float(m["grad_norm"])
        check(np.isfinite(losses[-1]) and np.isfinite(gn),
              f"{name}: step {i + 1} loss {losses[-1]} grad_norm {gn}")
        phase(name, f"step {i + 1}: loss {losses[-1]:.6f}, grad_norm "
              f"{gn:.4f}, {int(batch['loss_mask'].sum())} text tokens, "
              f"{times[-1] * 1e3:.1f} ms (host clock)")
    got = counts()
    want = {"encoder_attention": (L + 1) * steps,
            "encoder_attention_bwd": (L + 1) * steps,
            "flash_bwd_dq": L * steps, "flash_bwd_dkv": L * steps,
            "flash_fwd": 2 * L * steps}
    check(all(got[k] == v for k, v in want.items())
          and sum(got.values()) == sum(want.values()),
          f"{name}: launches {got} (want {want})")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = float(np.mean(times[1:])) * 1e3
    phase(name, f"launches in {steps} steps: {want}; steps 2-{steps} "
          f"{step_ms:.1f} ms/step, "
          f"{args.batch_size * args.tokens_per_sample / step_ms * 1e3:.0f} "
          f"tokens/s; peak memory {peak:.1f} GiB")
    del tr, m
    torch.cuda.empty_cache()

    # ---- a 2-layer copy against its plain twin on the first batch -------
    from unilm_tpu_torch.models.kosmos import UniGPT

    small_cfg = dataclasses.replace(cfg, num_layers=2, clip=(
        dataclasses.replace(cfg.clip, num_layers=2)))
    sd = UniGPT(small_cfg, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(SEED)).state_dict()

    def twin(dtype, use_flash):
        """The 2-layer copy's weights (float32 params) computing in dtype,
        on the kernels or on the plain path."""
        c = dataclasses.replace(small_cfg, dtype=dtype, use_flash=use_flash,
                                clip=dataclasses.replace(
                                    small_cfg.clip, dtype=dtype,
                                    use_flash=use_flash))
        m = UniGPT(c, device="cuda")
        m.load_state_dict(sd, strict=True, assign=True)
        return m

    def loss_grads(mdl):
        out = mdl(first["tokens"], first["images"][:, 0], first["img_mask"],
                  first["segs"], return_features=True)
        s, n = chunked_cross_entropy(out[:, :-1], mdl.embed_tokens.weight,
                                     first["tokens"][:, 1:],
                                     first["loss_mask"][:, 1:],
                                     chunk=args.ce_chunk)
        loss = s / n
        ps = [p for p in mdl.parameters() if p.requires_grad]
        return float(loss.detach()), torch.autograd.grad(loss, ps)

    names = [n for n, p in twin(torch.float32, False).named_parameters()
             if p.requires_grad]
    # a k_proj bias adds q.b to every key's score of a query, which the
    # softmax cancels: without xPos (the tower's layers, the resampler)
    # its gradient is 0 in exact arithmetic and both paths give rounding
    # noise, whose cosine means nothing; they count in the norm only
    zero = [n for n in names if n.endswith("k_proj.bias")
            and not n.startswith("decoder.")]
    teach = {}
    for label, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        c0 = counts()
        lk, gk = loss_grads(twin(dt, True))
        c1 = counts()
        lp, gp = loss_grads(twin(dt, False))
        torch.cuda.synchronize()
        check(counts() == c1 and c1["encoder_attention_bwd"]
              - c0["encoder_attention_bwd"] == 3
              and c1["flash_bwd_dq"] - c0["flash_bwd_dq"] == 2,
              f"{name} teacher {label}: launch counts {c0} -> {c1}")
        nk = float(torch.sqrt(sum(g.float().pow(2).sum() for g in gk)))
        npl = float(torch.sqrt(sum(g.float().pow(2).sum() for g in gp)))
        cos = {n: float(torch.nn.functional.cosine_similarity(
            a.flatten().float(), b.flatten().float(), dim=0))
            for n, a, b in zip(names, gk, gp) if n not in zero}
        worst = min(cos, key=cos.get)
        teach[label] = {
            "loss_kernel": lk, "loss_plain": lp,
            "loss_rel": abs(lk - lp) / abs(lp),
            "norm_rel": abs(nk - npl) / npl, "min_cos": cos[worst],
            "min_cos_tensor": worst,
            "zero_grad_bias_share": max(float(g.float().norm()) for n, g
                                        in zip(names, gk) if n in zero) / nk}
        del gk, gp
    t32, t16 = teach["fp32"], teach["bf16"]
    ref = t32["loss_plain"]
    phase(name, f"2-layer copy (tower and decoder) vs its plain twin, "
          f"first batch ({int(first['loss_mask'][:, 1:].sum())} text "
          f"targets); float32: loss rel {t32['loss_rel']:.2e} (tol "
          f"{TEACHER_LOSS_REL}), grad norm rel {t32['norm_rel']:.2e} (tol "
          f"{TEACHER_NORM_REL}), min per-tensor cosine {t32['min_cos']:.6f} "
          f"({t32['min_cos_tensor']}, tol {TEACHER_COS}); bf16: grad norm "
          f"rel {t16['norm_rel']:.2e}, min cosine {t16['min_cos']:.5f} "
          f"({t16['min_cos_tensor']}) at the same gates, loss kernel "
          f"{t16['loss_kernel']:.6f} plain {t16['loss_plain']:.6f} (rel "
          f"{t16['loss_rel']:.2e}, tol {KOSMOS2_TEACHER_LOSS_REL}; from "
          f"the float32 plain loss {ref:.6f}: "
          f"kernel {abs(t16['loss_kernel'] - ref) / abs(ref):.2e}, plain "
          f"{abs(t16['loss_plain'] - ref) / abs(ref):.2e}); the "
          f"{len(zero)} non-xPos k_proj biases (exact gradient 0) at most "
          f"{max(t['zero_grad_bias_share'] for t in teach.values()):.2e} of "
          f"the grad norm")
    check(t32["loss_rel"] <= TEACHER_LOSS_REL
          and t16["loss_rel"] <= KOSMOS2_TEACHER_LOSS_REL
          and all(t["norm_rel"] <= TEACHER_NORM_REL
                  and t["min_cos"] >= TEACHER_COS for t in teach.values()),
          f"{name}: teacher check failed")
    del first
    torch.cuda.empty_cache()
    shutil.rmtree(WORK, ignore_errors=True)
    return {k: v for k, v in got.items() if v}, {name: {
        "losses": losses, "step_ms_host": times, "peak_memory_gib": peak,
        "teacher": teach}}


# The BEiT family (beit3, beit2). BEiT-3 base: beit3_base() through the
# registry (768 wide, 12 layers, 12 heads, vocab 64010, 224 px), bf16
# compute / fp32 params, random weights from the seed. The batch of each
# head's forward; questions of 6-40 tokens padded to 40 (the pad id 1),
# so a VQA / VLMo / NLVR2 call attends over 197 + 40 = 237 keys with a
# key-padding mask (#9); captioning's 32 text tokens under the uni-mask
# bias, 229 keys without a mask (#3); the retrieval text tower over the
# 40 padded tokens alone (#9).
BEIT3_BATCH = {"classification": 64, "vqa": 32, "captioning": 32,
               "retrieval": 64, "nlvr2": 16, "vlmo": 32}
BEIT3_QLEN, BEIT3_CAPTION, BEIT3_TIMED = (6, 40), 32, 5
BEIT3_PAD = 1
# beside the BEiT eval gates: each head's bf16 logits, and in place of
# them for retrieval (similarities of ~0.1, whose relative error says
# little) the towers' unit embeddings (encode_image / encode_text), held
# by relative L2 against the plain path's. The max-abs gate on a vocab
# head's logits reads in ulps of |logit| (bf16 spacing 1/32 at 4-8), a
# relative L2 does not. Read on an H100: 0.0024 for classification's
# mean-pooled logits, 0.0125-0.0143 for every head and embedding read
# off the CLS token (its bf16 rounding drifts over 12 layers though #3
# and #9 each stay within 1.5e-3 of their plain versions); a wrong mask
# or bias moves them by tenths.
BEIT3_REL_L2 = 2e-2
# BEiT-2: VQKD() (a ViT-B/16 encoder, a codebook of 8192 x 32) and the
# CLS pretraining model at Beit2PretrainConfig() widths, B=64, 75 of 196
# patches masked by MaskingGenerator; the DALL-E encoder at BEiT's
# tokenizer input of 112 px (14 x 14 ids, the patch grid).
BEIT2_BATCH, BEIT2_STEPS, BEIT2_MASKED, DALLE_PX = 64, 3, 75, 112
# the bf16 VQ-KD ids, kernel path against plain path: argmin near-ties
# among 8192 codes may flip, so at least 90% of the patches agree
VQKD_ID_AGREE = 0.90
# one update_ema=True pass in float32: the codebook and the cluster sizes
# within 1e-4 of the plain path's; a code whose patches differ between
# the paths (an argmin near-tie at the float32 kernel's rounding) is
# counted and reported, and at most 0.1% of the patches may flip
VQKD_EMA_ATOL, VQKD_EMA_FLIPS = 1e-4, 1e-3
# the float32 pass's reconstruction (teacher features) against the plain
# path's, relative L2: the decoder alone on the same quantized input, and
# the whole pass where no id flipped
VQKD_REC_REL_L2 = 1e-4
# the DALL-E encoder on the card against the CPU in float32 (TF32 off),
# two images: logits relative L2, ids agreement
DALLE_REL_L2, DALLE_ID_AGREE = 1e-4, 0.90
BEIT_FAMILY_GROUPS = [("#3", [ENCODER_ONLY]), ("#4", [ENC_BWD_ONLY]),
                      ("#9", ["doc_fwd"]),
                      ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet",
                                  "cublas", "splitK"]),
                      ("layer norm", ["layer_norm", "LayerNorm"])]


def beit3_questions(B: int, rng: np.random.RandomState, vocab: int,
                    dev) -> tuple:
    """Token ids [B, 40] with lengths drawn from BEIT3_QLEN and the pad id
    past them, and the padding mask (True = PAD)."""
    lo, hi = BEIT3_QLEN
    lens = rng.randint(lo, hi + 1, B)
    ids = rng.randint(4, vocab, (B, hi))
    pad = np.arange(hi)[None] >= lens[:, None]
    ids[pad] = BEIT3_PAD
    return (torch.from_numpy(ids).to(dev), torch.from_numpy(pad).to(dev))


def host_ms(fn, iters: int) -> float:
    """Host clock a call, over `iters` calls after one, each call's work
    ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def groups_line(parts: dict, host: float) -> str:
    total = sum(parts.values())
    if total <= 0:
        return "profiler saw no device time: groups not measured"
    return (f"device time {total:.3f} ms of {host:.3f} ms on the host "
            f"({100 * total / host:.0f}% busy): " + ", ".join(
                f"{k} {v:.3f}" for k, v in parts.items()))


def randn(g, *shape, dtype=torch.bfloat16, dev: str = "cuda"):
    """A normal draw from the generator `g`, in `dtype`."""
    return torch.randn(*shape, generator=g, device=dev).to(dtype)


def kernel_timed(kern, plain, lib, only, bound: dict,
                 flushed: bool = False) -> dict:
    """A kernel's device time beside its plain version's, the library
    call's (None without `lib`) and the `bound` (attn_bound,
    flash_bwd_bounds or decode_bound); with `flushed`, the kernel and the
    library call also with L2 flushed."""
    r = {"ms": device_ms(kern, only=only)}
    if flushed:
        r["ms_l2_flushed"] = cold_ms(kern, only)
    r["plain_ms"] = device_ms(plain, iters=3)
    r["library_ms"] = device_ms(lib) if lib else None
    if flushed and lib:
        r["library_ms_l2_flushed"] = cold_ms(lib)
    return {**r, **bound}


def kernel_line(name: str, key: str, r: dict, tol=None) -> None:
    """Print a `kernel_timed` row of the phase `name`."""
    cold = "ms_l2_flushed" in r
    phase(name, f"{key} {r['shape']}: rel L2 {r['rel_l2']:.3g}"
          + (f" (bound {tol})" if tol else "")
          + (f", max|err| {r['max_abs_err']:.3g}" if "max_abs_err" in r
             else "")
          + f"; device time {r['ms']:.4f} ms"
          + (f" back to back, {r['ms_l2_flushed']:.4f} flushed" if cold
             else "")
          + f"; {r['library']}"
          + (f" {r['library_ms']:.4f}" if r["library_ms"] is not None
             else "")
          + (f" / {r['library_ms_l2_flushed']:.4f}"
             if "library_ms_l2_flushed" in r else "")
          + f"; plain {r['plain_ms']:.4f}; bound {r['bound_ms']:.5f} "
          f"({r['bound_by']}, {r['ms'] / r['bound_ms']:.2f}x)")


def phase_beit_family_kernels(fa, da, g, dev: str = "cuda") -> dict:
    """The kernels of the BEiT family's path alone, at each of its shapes,
    against their plain versions (relative L2 <= 1e-2 in bf16, 1e-4 in
    float32; #4 by grad_close at 1e-2): #3 at 64x197x12x64 (BEiT-3's
    vision forwards), at captioning's 32x229x12x64 with the [1,1,229,229]
    uni-mask bias, and at VQ-KD's 64x196x12x64 (no CLS token) in bf16 (the
    ids) and in float32 (the update_ema pass's encoder and decoder); #9 at
    VQA's 32x237x12x64 and at the retrieval text tower's 64x40x12x64, each
    with its questions' key-padding mask; #4 at BEiT-2's 64x197x12x64 with
    the shared [1,12,197,197] bias and its dbias. Each timed (device time
    back to back and with L2 flushed) beside the plain version, sdpa (or
    sdpa's backward) and the bound. Returns {kernel name: {"beit_family":
    {...}}} for the kernels line."""
    from unilm_tpu_torch.models.beit3 import captioning_attn_bias

    bf, name, H, D = torch.bfloat16, "beit_family_kernels", 12, 64

    rn = functools.partial(randn, g, dev=dev)
    timed = functools.partial(kernel_timed, flushed=True)
    line = functools.partial(kernel_line, name)

    k3, k9, k4 = {}, {}, {}
    nv = 197
    for key, B, T, bias, dtype, tol in (
            ("vision", 64, nv, None, bf, 1e-2),
            ("captioning", 32, nv + BEIT3_CAPTION,
             captioning_attn_bias(nv, BEIT3_CAPTION, dev).to(bf), bf, 1e-2),
            ("vqkd", 64, nv - 1, None, bf, 1e-2),
            ("vqkd_fp32", 64, nv - 1, None, torch.float32, 1e-4)):
        q, k, v = (rn(B, T, H, D, dtype=dtype) for _ in range(3))
        out = fa.fused_encoder_attention(q, k, v, bias=bias)
        ref = fa.fused_encoder_attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        e = rel_l2(out, ref)
        check(bool(torch.isfinite(out.float()).all()) and e <= tol,
              f"{name}: #3 {key} rel L2 {e} (bound {tol})")
        fp32 = dtype == torch.float32
        r = k3[key] = {
            "shape": f"{B}x{T}x{T}x{H}x{D} {'fp32' if fp32 else 'bf16'}, "
            + ("no bias" if bias is None else f"bias [1,1,{T},{T}]"),
            "rel_l2": e, "library": "sdpa",
            "max_abs_err": float((out.float() - ref.float()).abs().max()),
            **timed(lambda: fa.fused_encoder_attention(q, k, v, bias=bias),
                    lambda: fa.fused_encoder_attention_plain(q, k, v, bias),
                    lambda: sdpa(q, k, v, attn_mask=bias), ENCODER_ONLY,
                    attn_bound(B * H * T * T, D, 2, q, k, v, out, bias,
                               kind="fp32" if fp32 else "bf16"))}
        line(f"#3 {key}", r, tol)
        del q, k, v, out, ref

    # #9: the joint calls' and the text tower's key-padding masks, from the
    # questions phase_beit3 draws (the same seed, so the same rows)
    _, pad = beit3_questions(max(BEIT3_BATCH.values()),
                             np.random.RandomState(SEED), 64010, dev)
    B = BEIT3_BATCH["vqa"]
    for key, mask in (
            ("vqa", torch.cat([torch.ones(B, nv, dtype=torch.bool,
                                          device=dev), ~pad[:B]], 1)),
            ("text_tower", ~pad[:BEIT3_BATCH["retrieval"]])):
        Bk, T = mask.shape
        q, k, v = rn(Bk, T, H, D), rn(Bk, T, H, D), rn(Bk, T, H, D)
        out = da.doc_attention(q, k, v, None, mask)
        ref = da.doc_attention_plain(q, k, v, None, mask)
        torch.cuda.synchronize()
        e = rel_l2(out, ref)
        check(bool(torch.isfinite(out.float()).all()) and e <= 1e-2,
              f"{name}: #9 {key} rel L2 {e} (bound 1e-2)")
        pairs = float(mask.sum()) * T * H
        r = k9[key] = {
            "shape": f"{Bk}x{T}x{T}x{H}x{D} bf16, key-padding mask "
            f"(questions of {BEIT3_QLEN[0]}-{BEIT3_QLEN[1]} tokens)",
            "rel_l2": e, "library": "sdpa (bool mask)",
            "max_abs_err": float((out.float() - ref.float()).abs().max()),
            **timed(lambda: da.doc_attention(q, k, v, None, mask),
                    lambda: da.doc_attention_plain(q, k, v, None, mask),
                    lambda: sdpa(q, k, v, attn_mask=mask[:, None, None, :]),
                    "doc_fwd", attn_bound(pairs, D, 2, q, k, v, out, mask))}
        line(f"#9 {key}", r, 1e-2)
        del q, k, v, out, ref

    # #4: a BEiT-2 pretraining step's backward, the shared bias's dbias
    B, T = 64, nv
    q, k, v, do = rn(B, T, H, D), rn(B, T, H, D), rn(B, T, H, D), \
        rn(B, T, H, D)
    b = rn(1, H, T, T)
    got = fa.fused_encoder_backward(q, k, v, b, do)
    want = fa.fused_encoder_backward_plain(q, k, v, b, do)
    torch.cuda.synchronize()
    worst_rel, worst_abs = 0.0, 0.0
    for gname, x, rr in zip(("dq", "dk", "dv", "dbias"), got, want):
        ok, ea, er = grad_close(x, rr, 1e-2)
        check(bool(torch.isfinite(x.float()).all()) and ok,
              f"{name}: #4 {gname} max|err| {ea} rel L2 {er}")
        worst_rel, worst_abs = max(worst_rel, er), max(worst_abs, ea)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    bg = b.detach().clone().requires_grad_()
    o = sdpa(qg, kg, vg, attn_mask=bg)
    dot = do.transpose(1, 2)
    r = k4["beit2"] = {
        "shape": f"{B}x{T}x{T}x{H}x{D} bf16, bias [1,{H},{T},{T}], "
        "dq/dk/dv/dbias", "rel_l2": worst_rel, "max_abs_err": worst_abs,
        "library": f"sdpa backward ({type(o.grad_fn).__name__})",
        **timed(lambda: fa.fused_encoder_backward(q, k, v, b, do),
                lambda: fa.fused_encoder_backward_plain(q, k, v, b, do),
                lambda: torch.autograd.grad(o, (qg, kg, vg, bg), dot,
                                            retain_graph=True),
                ENC_BWD_ONLY,
                attn_bound(B * H * T * T, D, 5, q, k, v, do, b, *got))}
    line("#4 beit2", r, 1e-2)
    del q, k, v, do, b, got, want, o, qg, kg, vg, bg
    torch.cuda.empty_cache()
    return {"encoder_attention": {"beit_family": k3},
            "doc_attention": {"beit_family": k9},
            "encoder_attention_bwd": {"beit_family": k4}}


def phase_beit3(fa) -> tuple:
    """BEiT-3 base at full width (beit3_base() through
    models/registry.build, bf16, random weights from the seed), each head
    of models/beit3.py and models/vlmo.py on synthetic images and
    questions: classification (B=64: 12 #3 a forward), VQA (B=32, 237
    tokens with the padding mask: 12 #9), captioning (B=32, 32 text tokens
    under the uni-mask: 12 #3), retrieval (the image tower at B=64: 12 #3;
    the text tower at B=64 over 40 padded tokens: 12 #9), NLVR2 (B=16, two
    joint forwards: 24 #9), VLMo ITM and MLM (B=32: 12 #9 each). Each
    call's launches exactly, nothing else launched; the outputs against
    the plain twin (use_flash=False, the same weights) at the BEiT eval
    gates (max |dlogit| BEIT_LOGIT_ATOL, argmax agreement
    BEIT_TOP1_AGREE) and by relative L2 (BEIT3_REL_L2); retrieval: each
    tower's embeddings by relative L2 (BEIT3_REL_L2), the similarity
    logits at BEIT_LOGIT_ATOL, and the same best text for every image
    whose best leads its second on the plain path by more than twice the
    largest error, in place of argmax agreement; host ms a
    forward and img/s or pairs/s, device time by kernel group. Returns
    (launches, {"beit3": numbers})."""
    from unilm_tpu_torch.models import beit3 as b3
    from unilm_tpu_torch.models import registry
    from unilm_tpu_torch.models import vlmo

    dev = torch.device("cuda")
    name = "beit3"
    cfg, cls_model = registry.build("beit3_base", device=dev,
                                    dtype=torch.bfloat16)
    check((cfg.embed_dim, cfg.num_layers, cfg.num_heads, cfg.vocab_size,
           cfg.img_size) == (768, 12, 12, 64010, 224),
          f"{name}: beit3_base config {cfg}")
    L, nv = cfg.num_layers, cfg.num_vision_tokens
    g = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    Bmax = max(BEIT3_BATCH.values())
    images = torch.randn(Bmax, cfg.img_size, cfg.img_size, 3, generator=g,
                         device=dev)
    images_b = torch.randn(Bmax, cfg.img_size, cfg.img_size, 3, generator=g,
                           device=dev)
    questions = beit3_questions(Bmax, rng, cfg.vocab_size, dev)
    caption = torch.from_numpy(rng.randint(4, cfg.vocab_size,
                                           (Bmax, BEIT3_CAPTION))).to(dev)
    n_params = sum(p.numel() for p in cls_model.parameters())
    phase(name, f"beit3_base: {L} layers, E={cfg.embed_dim}, "
          f"H={cfg.num_heads}, vocab {cfg.vocab_size}, {nv} image tokens, "
          f"questions of {BEIT3_QLEN[0]}-{BEIT3_QLEN[1]} tokens padded to "
          f"{BEIT3_QLEN[1]}, bf16 compute / fp32 params; classification "
          f"model {n_params / 1e6:.1f} M params")

    def twin(model):
        plain = type(model)(dataclasses.replace(cfg, use_flash=False),
                            device=dev).eval()
        plain.load_state_dict(model.state_dict())
        return plain

    launches = {"encoder_attention": 0, "doc_attention": 0}
    nums = {}

    def case(label, model, fn, want, rows, unit, towers=()):
        """fn(model) on both paths: its launches exactly `want`, the
        gates, timing and the device time by group. `towers`: (label,
        fn) of a retrieval model's embeddings, each held by relative L2
        (BEIT3_REL_L2) in place of the logits' relative L2, and the
        similarity logits replace argmax agreement by the best text
        where the plain path's lead is sure."""
        plain = twin(model)
        reset_counts()
        with torch.no_grad():
            out = fn(model)
        torch.cuda.synchronize()
        got = {k: v for k, v in counts().items() if v}
        check(got == want, f"{name} {label}: launches {got}, want {want}")
        for k, v in got.items():
            launches[k] += v
        c0 = counts()
        with torch.no_grad():
            pout = fn(plain)
        torch.cuda.synchronize()
        check(counts() == c0, f"{name} {label}: the plain path launched a "
              "kernel")
        out, pout = out.float(), pout.float()
        err = float((out - pout).abs().max())
        rel = rel_l2(out, pout)
        agree = float((out.argmax(-1) == pout.argmax(-1)).float().mean())
        check(bool(torch.isfinite(out).all()) and err <= BEIT_LOGIT_ATOL
              and (bool(towers) or rel <= BEIT3_REL_L2),
              f"{name} {label}: max |dlogit| {err} (tol {BEIT_LOGIT_ATOL}), "
              f"rel L2 {rel} (tol {BEIT3_REL_L2})")
        gate = f"argmax agreement {agree:.4f} (tol {BEIT_TOP1_AGREE})"
        emb = {}
        for tower, tfn in towers:
            with torch.no_grad():
                te, tp = tfn(model), tfn(plain)
            emb[tower] = rel_l2(te, tp)
            check(bool(torch.isfinite(te).all())
                  and emb[tower] <= BEIT3_REL_L2,
                  f"{name} {label}: {tower} embeddings rel L2 {emb[tower]} "
                  f"(tol {BEIT3_REL_L2})")
        if towers:
            top2 = pout.topk(2, -1).values
            sure = (top2[:, 0] - top2[:, 1]) > 2 * err
            same = out.argmax(-1) == pout.argmax(-1)
            check(bool(same[sure].all()), f"{name} {label}: best text "
                  f"differs where the plain path's lead exceeds 2 x {err}")
            gate = (f"best-text agreement {agree:.4f}, all {int(sure.sum())}"
                    f" rows whose lead exceeds 2 x max|err| agree; embeddings"
                    f" rel L2 " + ", ".join(f"{t} {e:.3g}" for t, e in
                                            emb.items())
                    + f" (tol {BEIT3_REL_L2})")
        else:
            check(agree >= BEIT_TOP1_AGREE, f"{name} {label}: {gate}")
        with torch.no_grad():
            ms = host_ms(lambda: fn(model), BEIT3_TIMED)
            ms_plain = host_ms(lambda: fn(plain), 2)
            parts = profile_steps(lambda: fn(model), 1,
                                  BEIT_FAMILY_GROUPS)[0]
        nums[label] = {"ms": ms, "rate": rows * 1e3 / ms, "unit": unit,
                       "plain_ms": ms_plain, "max_abs_err": err,
                       "rel_l2": rel, "agreement": agree, "launches": got,
                       **({"embeddings_rel_l2": emb} if emb else {}),
                       "device_ms": parts}
        phase(name, f"{label}: launches {got}; max |dlogit| {err:.4f} (tol "
              f"{BEIT_LOGIT_ATOL}, |logits| up to "
              f"{float(pout.abs().max()):.3f}), rel L2 {rel:.3g}"
              f"{'' if towers else f' (tol {BEIT3_REL_L2})'}, {gate}; "
              f"{ms:.2f} ms a "
              f"forward on the host, {rows * 1e3 / ms:.1f} {unit}; plain "
              f"path {ms_plain:.2f} ms; {groups_line(parts, ms)}")
        del plain

    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)
    one = lambda n: {"encoder_attention": n * L} if n else {}

    # classification: the registry's model
    B = BEIT3_BATCH["classification"]
    cls_model.init_weights(gen()).eval()
    case("classification", cls_model, lambda m: m(images[:B]), one(1), B,
         "img/s")
    del cls_model

    B = BEIT3_BATCH["vqa"]
    m = b3.BEiT3ForVisualQuestionAnswering(cfg, device=dev).init_weights(
        gen()).eval()
    case("vqa", m, lambda m: m(images[:B], questions[0][:B],
                               questions[1][:B]),
         {"doc_attention": L}, B, "pairs/s")
    del m

    B = BEIT3_BATCH["captioning"]
    m = b3.BEiT3ForCaptioning(cfg, device=dev).init_weights(gen()).eval()
    case("captioning", m, lambda m: m(images[:B], caption[:B]), one(1), B,
         "pairs/s")
    del m

    B = BEIT3_BATCH["retrieval"]
    m = b3.BEiT3ForRetrieval(cfg, device=dev).init_weights(gen()).eval()
    case("retrieval", m, lambda m: m(images[:B], questions[0][:B],
                                     questions[1][:B]),
         {"encoder_attention": L, "doc_attention": L}, B, "pairs/s",
         towers=(("image", lambda m: m.encode_image(images[:B])),
                 ("text", lambda m: m.encode_text(questions[0][:B],
                                                  questions[1][:B]))))
    with torch.no_grad():
        towers = {"image tower": host_ms(lambda: m.encode_image(images[:B]),
                                         BEIT3_TIMED),
                  "text tower": host_ms(lambda: m.encode_text(
                      questions[0][:B], questions[1][:B]), BEIT3_TIMED)}
    nums["retrieval"]["towers_ms"] = towers
    phase(name, "retrieval towers at B=" + str(B) + ": " + ", ".join(
        f"{k} {v:.2f} ms ({B * 1e3 / v:.1f} a second)"
        for k, v in towers.items()))
    del m

    B = BEIT3_BATCH["nlvr2"]
    m = b3.BEiT3ForVisualReasoning(cfg, device=dev).init_weights(
        gen()).eval()
    case("nlvr2", m, lambda m: m(images[:B], images_b[:B], questions[0][:B],
                                 questions[1][:B]),
         {"doc_attention": 2 * L}, B, "pairs/s")
    del m

    B = BEIT3_BATCH["vlmo"]
    for label, make in (("vlmo_itm", vlmo.VLMoForImageTextMatching),
                        ("vlmo_mlm", vlmo.VLMoForMaskedLM)):
        m = make(cfg, device=dev).init_weights(gen()).eval()
        case(label, m, lambda m: m(images[:B], questions[0][:B],
                                   questions[1][:B]),
             {"doc_attention": L}, B, "pairs/s")
        del m
    torch.cuda.empty_cache()
    return launches, {"beit3": nums}


def phase_beit2(fa) -> tuple:
    """BEiT-2 at full width (random weights from the seed): VQKD() in bf16
    takes the ids of B=64 synthetic images (get_codebook_indices: 12 #3),
    held against the plain path (VQKD_ID_AGREE); one update_ema=True pass
    of the float32 VQKD on the same weights (the encoder and the 3-layer
    decoder: 15 #3), its codebook and cluster sizes against the plain
    path's (VQKD_EMA_ATOL), its reconstruction and the decoder alone on
    one quantized input (VQKD_REC_REL_L2); the DALL-E encoder's ids of the same images at
    112 px (B=64, float32; library convolutions) against the CPU on two
    images; then BEIT2_STEPS steps of BEiT2ForMaskedImageModelingCLS at
    Beit2PretrainConfig() widths in bf16, B=64, 75 of 196 patches masked
    by MaskingGenerator, the VQ-KD ids as targets, the masked CE of both
    heads through runtime.train.make_train_step (12 #3 and 12 #4 a step),
    and a kernel-vs-plain teacher check of one batch at the BEiT
    fine-tune gates. Returns (launches, {"beit2": numbers})."""
    from unilm_tpu_torch.data.masking import MaskingGenerator
    from unilm_tpu_torch.models import beit2 as b2
    from unilm_tpu_torch.models import dalle_vae as dv
    from unilm_tpu_torch.runtime import optim, train

    dev = torch.device("cuda")
    name, B = "beit2", BEIT2_BATCH
    g = torch.Generator(device=dev).manual_seed(SEED)
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)
    nums, launches = {}, {"encoder_attention": 0, "encoder_attention_bwd": 0}

    # ---- VQ-KD ids, bf16 ------------------------------------------------
    vcfg = b2.VQKDConfig(dtype=torch.bfloat16)
    L = vcfg.encoder_layers
    vq = b2.VQKD(vcfg, device=dev).init_weights(gen()).eval()
    plain = b2.VQKD(dataclasses.replace(vcfg, use_flash=False),
                    device=dev).eval()
    plain.load_state_dict(vq.state_dict())
    images = torch.randn(B, vcfg.img_size, vcfg.img_size, 3, generator=g,
                         device=dev)
    N = (vcfg.img_size // vcfg.patch_size) ** 2
    phase(name, f"VQKD(): a {L}-layer E={vcfg.encoder_dim} encoder, a "
          f"{vcfg.decoder_layers}-layer decoder, codebook "
          f"{vcfg.codebook_size} x {vcfg.codebook_dim}; B={B}, {N} patches")
    reset_counts()
    with torch.no_grad():
        ids = vq.get_codebook_indices(images)
    torch.cuda.synchronize()
    got = {k: v for k, v in counts().items() if v}
    check(got == {"encoder_attention": L} and ids.shape == (B, N)
          and int(ids.min()) >= 0 and int(ids.max()) < vcfg.codebook_size,
          f"{name}: VQ-KD ids launches {got}, shape {tuple(ids.shape)}")
    launches["encoder_attention"] += L
    c0 = counts()
    with torch.no_grad():
        pids = plain.get_codebook_indices(images)
    check(counts() == c0, f"{name}: the plain VQ-KD launched a kernel")
    agree = float((ids == pids).float().mean())
    check(agree >= VQKD_ID_AGREE, f"{name}: VQ-KD ids agree on {agree}")
    with torch.no_grad():
        ms = host_ms(lambda: vq.get_codebook_indices(images), BEIT3_TIMED)
        ms_plain = host_ms(lambda: plain.get_codebook_indices(images), 2)
        parts = profile_steps(lambda: vq.get_codebook_indices(images), 1,
                              BEIT_FAMILY_GROUPS)[0]
    nums["vqkd_ids"] = {"ms": ms, "img_s": B * 1e3 / ms, "plain_ms": ms_plain,
                        "agreement": agree, "distinct": int(ids.unique()
                                                            .numel()),
                        "device_ms": parts}
    phase(name, f"VQ-KD ids: {L} #3; agreement with the plain path "
          f"{agree:.4f} (tol {VQKD_ID_AGREE}), {nums['vqkd_ids']['distinct']}"
          f" distinct codes; {ms:.2f} ms a batch on the host "
          f"({B * 1e3 / ms:.1f} img/s), plain {ms_plain:.2f} ms; "
          f"{groups_line(parts, ms)}")
    sd = vq.state_dict()
    del vq, plain

    # ---- one update_ema=True pass, float32 -----------------------------
    f32 = b2.VQKDConfig()
    vq32 = b2.VQKD(f32, device=dev).eval()
    p32 = b2.VQKD(dataclasses.replace(f32, use_flash=False), device=dev).eval()
    vq32.load_state_dict(sd)
    p32.load_state_dict(sd)
    reset_counts()
    with torch.no_grad():
        rec, loss, kid = vq32(images, update_ema=True)
    torch.cuda.synchronize()
    got = {k: v for k, v in counts().items() if v}
    n3 = f32.encoder_layers + f32.decoder_layers
    check(got == {"encoder_attention": n3}, f"{name}: the EMA pass launched "
          f"{got}, want {n3} #3")
    launches["encoder_attention"] += n3
    with torch.no_grad():
        prec, ploss, pid = p32(images, update_ema=True)
    torch.cuda.synchronize()
    flips = kid != pid
    moved = torch.unique(torch.cat([kid[flips], pid[flips]]))
    keep = torch.ones(f32.codebook_size, dtype=torch.bool, device=dev)
    keep[moved] = False
    qk, qp = vq32.quantize, p32.quantize
    e_emb = float((qk.embedding - qp.embedding)[keep].abs().max())
    e_cl = float((qk.cluster_size - qp.cluster_size)[keep].abs().max())
    n_flip = int(flips.sum())
    rec_rel = rel_l2(rec, prec)

    def decode(m, quant):
        h = m.decoder(m.decoder_in(quant))
        return m.decode_task_2(torch.tanh(m.decode_task_1(h)))

    with torch.no_grad():  # the decoder alone, on one quantized input
        quant = p32.encode(images)[0]
        dec = decode(vq32, quant)
        dec_rel = rel_l2(dec, decode(p32, quant))
    check(e_emb <= VQKD_EMA_ATOL and e_cl <= VQKD_EMA_ATOL
          and n_flip <= VQKD_EMA_FLIPS * flips.numel()
          and bool(torch.isfinite(rec).all() and torch.isfinite(dec).all())
          and dec_rel <= VQKD_REC_REL_L2
          and (n_flip > 0 or rec_rel <= VQKD_REC_REL_L2),
          f"{name}: EMA pass codebook max|d| {e_emb}, cluster sizes {e_cl}, "
          f"{n_flip} ids flipped, reconstruction rel L2 {rec_rel}, the "
          f"decoder alone {dec_rel} (tol {VQKD_REC_REL_L2})")
    nums["vqkd_ema"] = {"codebook_max_abs_err": e_emb,
                        "cluster_size_max_abs_err": e_cl,
                        "ids_flipped": n_flip, "codes_excluded":
                        int(moved.numel()), "rec_rel_l2": rec_rel,
                        "decoder_rel_l2": dec_rel,
                        "vq_loss": float(loss), "plain_vq_loss": float(ploss)}
    phase(name, f"float32 update_ema pass ({n3} #3): codebook max|d| "
          f"{e_emb:.3g}, cluster sizes {e_cl:.3g} (tol {VQKD_EMA_ATOL}) "
          f"over {int(keep.sum())} of {f32.codebook_size} codes; {n_flip} "
          f"of {flips.numel()} ids flipped, so {int(moved.numel())} codes "
          f"left out; reconstruction rel L2 {rec_rel:.3g}, the decoder "
          f"alone {dec_rel:.3g} (tol {VQKD_REC_REL_L2}"
          f"{'' if n_flip else ', both'}), vq_loss "
          f"{float(loss):.6f} (plain {float(ploss):.6f})")
    del vq32, p32, rec, prec, sd, quant, dec
    torch.cuda.empty_cache()

    # ---- DALL-E ids -----------------------------------------------------
    dalle = dv.DalleEncoder(device=dev).init_weights(gen()).eval()
    px = torch.nn.functional.interpolate(
        images.permute(0, 3, 1, 2), size=(DALLE_PX, DALLE_PX),
        mode="bilinear", antialias=True).permute(0, 2, 3, 1).sigmoid()
    px = px.contiguous()
    reset_counts()
    with torch.no_grad():
        logits = dalle(px)
    torch.cuda.synchronize()
    check(not any(counts().values()), f"{name}: DALL-E launched {counts()}")
    ids_d = logits.argmax(-1).reshape(B, -1)
    cpu = dv.DalleEncoder().eval()
    cpu.load_state_dict({k: v.cpu() for k, v in dalle.state_dict().items()})
    with torch.no_grad():
        ref = cpu(px[:2].cpu())
    e = rel_l2(logits[:2].cpu(), ref)
    agree_d = float((ids_d[:2].cpu() == ref.argmax(-1).reshape(2, -1))
                    .float().mean())
    check(ids_d.shape == (B, N) and bool(torch.isfinite(logits).all())
          and e <= DALLE_REL_L2 and agree_d >= DALLE_ID_AGREE,
          f"{name}: DALL-E ids {tuple(ids_d.shape)}, card vs CPU rel L2 {e},"
          f" ids agree {agree_d}")
    with torch.no_grad():
        ms = host_ms(lambda: dalle.get_codebook_indices(px), BEIT3_TIMED)
    nums["dalle_ids"] = {"ms": ms, "img_s": B * 1e3 / ms, "rel_l2_cpu": e,
                         "agreement_cpu": agree_d}
    phase(name, f"DalleEncoder() ids at {DALLE_PX} px, B={B}: "
          f"{tuple(ids_d.shape)}, card vs CPU (2 images, float32) rel L2 "
          f"{e:.3g} (tol {DALLE_REL_L2}), ids agree {agree_d:.4f}; "
          f"{ms:.2f} ms a batch ({B * 1e3 / ms:.1f} img/s)")
    del dalle, cpu, logits
    torch.cuda.empty_cache()

    # ---- BEiT-2 CLS pretraining ----------------------------------------
    pcfg = b2.Beit2PretrainConfig(dtype=torch.bfloat16)
    L = pcfg.num_layers

    def pretrain_model(use_flash):
        m = b2.BEiT2ForMaskedImageModelingCLS(
            dataclasses.replace(pcfg, use_flash=use_flash), device=dev)
        return m.train()

    model = pretrain_model(True).init_weights(gen())
    with torch.no_grad():  # random table, so the bias and dbias matter
        model.backbone.rel_pos_bias.relative_position_bias_table.normal_(
            0.0, 0.5, generator=g)
    mgen = MaskingGenerator(pcfg.beit().grid_size,
                            num_masking_patches=BEIT2_MASKED,
                            rng=np.random.default_rng(SEED))
    masks = torch.from_numpy(np.stack([mgen().reshape(-1) for _ in range(B)])
                             ).bool().to(dev)
    n_masked = masks.sum(1)
    check(bool((n_masked <= BEIT2_MASKED).all() and (n_masked > 0).all()),
          f"{name}: masks of {n_masked.tolist()} patches")
    batch = {"x": images, "mask": masks, "y": ids}

    def loss_fn(m, b):
        logits, logits_cls = m(b["x"], b["mask"])
        s1, cnt = train.cross_entropy_loss(logits, b["y"], mask=b["mask"])
        s2, _ = train.cross_entropy_loss(logits_cls, b["y"], mask=b["mask"])
        return (s1 + s2) / cnt, {}

    tx = optim.create_optimizer(list(model.named_parameters()), 1.5e-3,
                                betas=(0.9, 0.98), weight_decay=0.05)
    state = train.TrainState.create(model, tx)
    step = train.make_train_step(loss_fn, tx, clip_grad_norm=3.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hist, times = [], []
    for i in range(BEIT2_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        hist.append((float(m["loss"]), float(m["grad_norm"])))
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    got = {k: v for k, v in counts().items() if v}
    want = {"encoder_attention": L * BEIT2_STEPS,
            "encoder_attention_bwd": L * BEIT2_STEPS}
    check(got == want and all(np.isfinite(x) for h in hist for x in h),
          f"{name}: pretraining launches {got} (want {want}), {hist}")
    for k in want:
        launches[k] += want[k]
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = float(np.mean(times[1:]))
    phase(name, f"BEiT2ForMaskedImageModelingCLS at Beit2PretrainConfig() "
          f"widths (early layer {pcfg.early_layer}, vocab {pcfg.vocab_size}),"
          f" B={B}, {int(n_masked.min())}-{int(n_masked.max())} of {N} "
          f"patches masked (num_masking_patches {BEIT2_MASKED}), VQ-KD ids as "
          "targets: " + ", ".join(
              f"step {i + 1} loss {lo:.4f} grad norm {gn:.3f}"
              for i, (lo, gn) in enumerate(hist))
          + f"; {L} + {L} #3/#4 a step; {ms:.1f} ms/step on the host (steps "
          f"2-{BEIT2_STEPS}, each ended by reading its loss; step 1 "
          f"{times[0]:.1f}), peak memory {peak:.1f} GiB")

    parts = profile_steps(lambda: step(state, batch), 1,
                          BEIT_FAMILY_GROUPS)[0]
    phase(name, f"a step (forward, backward, clip, AdamW): "
          f"{groups_line(parts, ms)}")

    def fwd_bwd(mdl):
        loss, _ = loss_fn(mdl, batch)
        return float(loss.detach()), torch.autograd.grad(
            loss, train.trainable(mdl))

    # ---- teacher check: kernel vs plain path on one batch ---------------
    plain = pretrain_model(False)
    plain.load_state_dict(model.state_dict())
    c0 = counts()
    lk, gk = fwd_bwd(model)
    c1 = counts()
    lp, gp = fwd_bwd(plain)
    torch.cuda.synchronize()
    check(counts() == c1 and c1["encoder_attention_bwd"]
          - c0["encoder_attention_bwd"] == L,
          f"{name} teacher: launch counts {c0} -> {c1} -> {counts()}")
    names = [nm for nm, _ in model.named_parameters()]
    nk, npl = float(optim.global_norm(gk)), float(optim.global_norm(gp))
    cos = {nm: float(torch.nn.functional.cosine_similarity(
        a.flatten().float(), b.flatten().float(), dim=0))
        for nm, a, b in zip(names, gk, gp) if not nm.endswith("k_proj.bias")}
    worst = min(cos, key=cos.get)
    loss_rel, norm_rel = abs(lk - lp) / abs(lp), abs(nk - npl) / npl
    phase(name, f"teacher check, one batch: loss kernel {lk:.6f} plain "
          f"{lp:.6f} (rel {loss_rel:.2e}, tol {BEIT_TEACHER_LOSS_REL}); grad "
          f"norm kernel {nk:.5f} plain {npl:.5f} (rel {norm_rel:.2e}, tol "
          f"{BEIT_TEACHER_NORM_REL}); min per-tensor cosine {cos[worst]:.5f} "
          f"({worst}, tol {BEIT_TEACHER_COS})")
    check(loss_rel <= BEIT_TEACHER_LOSS_REL
          and norm_rel <= BEIT_TEACHER_NORM_REL
          and cos[worst] >= BEIT_TEACHER_COS, f"{name}: teacher check failed")
    nums["pretrain"] = {"ms_step": ms, "step_ms": times, "peak_gib": peak,
                        "losses": hist, "device_ms": parts,
                        "teacher_loss_rel": loss_rel,
                        "teacher_norm_rel": norm_rel,
                        "teacher_min_cos": cos[worst]}
    del model, plain, state, step, gk, gp
    torch.cuda.empty_cache()
    return launches, {"beit2": nums}


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
    # device time (the profiler): the kernel, which writes the row too,
    # and the plain version's kernels
    ms = device_ms(lambda: pa.paged_decode_append_attention(
        q, kn, vn, kp, vp, tables8, L8), only="decode_kernel")
    plain_ms = device_ms(lambda: pa.paged_decode_append_attention_plain(
        q, kn, vn, kp, vp, tables8, L8), iters=10)
    phase("paged_append", f"B8 L2047 H16 D96 scattered, device time: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (both write the "
          f"row)")
    # no torch call reads K/V through a block table (library_ms null)
    bd = decode_bound(B * 2048, B, H, D, 2, new_rows=True)
    phase("paged_append", f"B8 L2047 bound {bd['bound_ms']:.5f} ms "
          f"({bd['bound_by']})")
    return {"name": "paged_append_attention", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/paged_append_attention.cu",
            "replaces": "unilm_tpu/ops/paged_attention.py:213",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, **bd,
            "shape": "B8 L2047 H16 D96 bf16 scattered"}


# The read-only block-table kernel (#11) at the Kosmos-2.5 decoder's width
# (16 heads of 96, pages of 64, as in paged_append): ragged lengths up to
# a 2048-token context, one sequence empty.
PAGED_LENGTHS = [2047, 1800, 1536, 1024, 777, 300, 1, 0]
PAGED_PAGE, PAGED_MP = 64, 32
PAGED_ONLY = "paged_split"  # #11's bf16 walk (paged_split_sm90)


def phase_paged(pa, g) -> dict:
    """Kernel #11 against paged_decode_attention_plain on the card: B=8,
    H=16, D=96, PAGED_LENGTHS over tables drawn from a permutation of the
    pool (pages scatter), pages of 64 and of 16 (two 16-row boxes a tile),
    bf16 and fp32, flat [P, page, H*D] and 4-D [P, page, H, D] pools; the
    L == 0 row must be exactly 0, and two bf16 runs bit-equal (the splits
    merge in split order whichever arrives last). Timed (device time,
    kernel alone) at the ragged lengths and at 8 x 2047, page 64, back to
    back and with L2 flushed; the flushed time is the one held against the
    bound."""
    dev = "cuda"
    B, H, D = 8, 16, 96
    lengths = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
    worst = 0.0
    for page in (PAGED_PAGE, 16):
        MP = PAGED_MP * PAGED_PAGE // page
        P = B * MP
        tables = torch.randperm(P, generator=g, device=dev).reshape(
            B, MP).to(torch.int32)
        for dtype in (torch.bfloat16, torch.float32):
            # bf16: OUT_ATOL / OUT_RTOL (the kernel rounds p against a
            # running max, the twin against the row max); fp32: 1e-5
            # (summation order)
            atol, rtol = (OUT_ATOL, OUT_RTOL) if dtype == torch.bfloat16 \
                else (1e-5, 1e-5)
            rn = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
            q, kp, vp = rn(B, 1, H, D), rn(P, page, H * D), rn(P, page, H * D)
            for flat in (True, False):
                k_, v_ = (kp, vp) if flat else (kp.view(P, page, H, D),
                                                vp.view(P, page, H, D))
                out = pa.paged_decode_attention(q, k_, v_, tables, lengths)
                again = pa.paged_decode_attention(q, k_, v_, tables, lengths)
                ref = pa.paged_decode_attention_plain(q, k_, v_, tables,
                                                      lengths)
                torch.cuda.synchronize()
                ok, err = close(out, ref, atol, rtol)
                desc = (f"page {page} {str(dtype).split('.')[-1]} "
                        f"{'flat' if flat else '4-D'} pool")
                check(ok and bool(torch.isfinite(out.float()).all()),
                      f"paged: {desc}: max|err| {err}")
                check(float(out[B - 1].abs().max()) == 0.0,
                      f"paged: {desc}: the L == 0 row is not 0")
                check(torch.equal(out, again), f"paged: {desc}: two runs "
                      f"differ")
                phase("paged", f"B8 H16 D96 lengths {PAGED_LENGTHS} "
                      f"scattered, {desc}: max|err| {err:.3g} (atol {atol}, "
                      f"rtol {rtol}), L=0 row exactly 0, bit-equal twice")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)

    bf, page, P = torch.bfloat16, PAGED_PAGE, B * PAGED_MP
    tables = torch.randperm(P, generator=g, device=dev).reshape(
        B, PAGED_MP).to(torch.int32)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev).to(bf)
    q, kp, vp = rn(B, 1, H, D), rn(P, page, H * D), rn(P, page, H * D)
    res = {}
    for name, lens in (("ragged", PAGED_LENGTHS), ("8x2047", [2047] * B)):
        L = torch.tensor(lens, dtype=torch.int32, device=dev)
        call = lambda: pa.paged_decode_attention(q, kp, vp, tables, L)
        ms = device_ms(call, only=PAGED_ONLY)
        ms_cold = cold_ms(call, PAGED_ONLY)
        wrapper_ms = cuda_ms(lambda: pa.paged_decode_attention(
            q, kp, vp, tables, L), iters=50)
        plain_ms = device_ms(lambda: pa.paged_decode_attention_plain(
            q, kp, vp, tables, L), iters=10)
        n = sum(lens)
        bd = decode_bound(n, B, H, D, 2, new_rows=False, extra=B * 4,
                          kind="fp32")
        res[name] = (ms, plain_ms, bd, ms_cold)
        phase("paged", f"bf16 {name} (sum L {n}): kernel {ms_cold:.4f} ms "
              f"device time with L2 flushed ({ms_cold / bd['bound_ms']:.2f}x "
              f"the bound), {ms:.4f} ms back to back ({wrapper_ms:.4f} ms a "
              f"wrapper call, CUDA events), plain {plain_ms:.4f} ms; bound "
              f"{bd['bound_ms']:.5f} ms ({bd['bound_by']}); no torch call "
              f"reads a block table")
    ms, plain_ms, bd, ms_cold = res["ragged"]
    return {"name": "paged_attention", "route": "cuda",
            "source": "unilm_tpu_torch/csrc/paged_attention.cu",
            "replaces": "unilm_tpu/ops/paged_attention.py:44",
            "max_abs_err": worst, "ms": ms_cold, "plain_ms": plain_ms,
            "library_ms": None, **bd, "ms_back_to_back": ms,
            "ms_8x2047": res["8x2047"][3],
            "ms_back_to_back_8x2047": res["8x2047"][0],
            "plain_ms_8x2047": res["8x2047"][1],
            "bound_ms_8x2047": res["8x2047"][2]["bound_ms"],
            "shape": f"B8 H16 D96 page64 bf16, lengths {PAGED_LENGTHS}, "
                     f"L2 flushed"}


# The PagePool path at kosmos2_5()'s decoder width: 24 layers, each with its
# own pool of 256 pages of [64, 16, 96] bf16 (2.4 GB in all). Eight prompts
# of PAGED_LENGTHS (the empty one becomes 129 tokens) are appended in
# interleaved 128-token chunks; at step POOL_SWAP two sequences are freed
# and two new ones, with prompts of POOL_NEW_PROMPTS, take their pages.
POOL_LAYERS, POOL_PAGES, POOL_MAX_PAGES = 24, 256, 40
POOL_STEPS, POOL_SWAP, POOL_CHECKED = 64, 32, (0, 32, 63)
POOL_PROMPTS = [L if L else 129 for L in PAGED_LENGTHS]
POOL_FREED, POOL_NEW_PROMPTS = (0, 4), (1000, 500)
# use_kernel=False is the gather, whose scores are bf16 (the JAX
# reference's dot_product_attention): logits up to ~5 carry up to ~0.02 of
# rounding, so outputs differ by up to a few bf16 ulps of the values they
# average. The twin (fp32 scores) is held at OUT_ATOL / OUT_RTOL.
POOL_GATHER_ATOL = 0.05


def pool_prompt(pools, sids, lens, rows):
    """Append each sequence's prompt to every layer's pool in interleaved
    128-token chunks (one chunk of each sequence in turn)."""
    done = dict.fromkeys(sids, 0)
    while any(done[s] < L for s, L in zip(sids, lens)):
        for s, L in zip(sids, lens):
            n = min(128, L - done[s])
            if n <= 0:
                continue
            for pool in pools:
                k, v = rows(n)
                pool.append(s, k, v)
            done[s] += n


def phase_page_pool() -> dict:
    """runtime.paged_kv at Kosmos-2.5 decoder width: POOL_LAYERS pools, 8
    sequences, POOL_STEPS decode steps; each step appends one seeded
    random K/V row per sequence and layer and calls paged_attention (the
    read-only block-table kernel #11) per layer over lengths + 1 tokens.
    Steps POOL_CHECKED are held against use_kernel=False and the plain
    twin; ms/step, a profile of one step, #11's launch count."""
    from torch.profiler import ProfilerActivity, profile

    from unilm_tpu_torch.ops import paged_attention as pa
    from unilm_tpu_torch.runtime import paged_kv as kv

    dev, bf = "cuda", torch.bfloat16
    H, D, page = 16, 96, PAGED_PAGE
    cfg = kv.PagedKVConfig(num_pages=POOL_PAGES, page_size=page,
                           num_heads=H, head_dim=D,
                           max_pages_per_seq=POOL_MAX_PAGES, dtype=bf)
    pools = [kv.PagePool(cfg, device=dev) for _ in range(POOL_LAYERS)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev).to(bf)

    def rows(n):
        kvr = rn(2, n, H, D)
        return kvr[0], kvr[1]

    sids = [f"s{i}" for i in range(len(POOL_PROMPTS))]
    for s in sids:
        for pool in pools:
            pool.create(s)
    pool_prompt(pools, sids, POOL_PROMPTS, rows)
    torch.cuda.synchronize()
    gb = 2 * sum(p.k_pool.numel() * p.k_pool.element_size() for p in pools)
    phase("page_pool", f"{POOL_LAYERS} pools of {tuple(pools[0].k_pool.shape)}"
          f" bf16 ({gb / 1e9:.2f} GB of K+V); prompts {POOL_PROMPTS} in "
          f"128-token chunks: {pools[0].pages_in_use} pages in use, seq 0's "
          f"table starts {pools[0].block_table('s0')[:6].tolist()}")
    groups = [("#11", [PAGED_ONLY, "decode_kernel"]),
              ("index_put", ["index_put", "index_elementwise"]),
              ("copies", ["Memcpy", "memcpy"])]

    def step(keep):
        qkv = rn(POOL_LAYERS, len(sids), 3, H, D)
        for li, pool in enumerate(pools):
            for bi, s in enumerate(sids):
                pool.append(s, qkv[li, bi, 1][None], qkv[li, bi, 2][None])
            tables = torch.from_numpy(np.stack(
                [pool.block_table(s) for s in sids])).to(dev)
            lengths = torch.tensor([pool.length(s) for s in sids],
                                   dtype=torch.int32, device=dev)
            q = qkv[li, :, 0][:, None]
            out = kv.paged_attention(q, pool.k_pool, pool.v_pool, tables,
                                     lengths)
            if keep is not None:
                keep.append((pool, q, tables, lengths, out))

    def hold(i, keep):
        """Step i's outputs against use_kernel=False and the twin, on the
        pools as the step left them."""
        e_gather = e_twin = 0.0
        for pool, q, tables, lengths, out in keep:
            ref = kv.paged_attention(q, pool.k_pool, pool.v_pool, tables,
                                     lengths, use_kernel=False)
            twin = pa.paged_decode_attention_plain(q, pool.k_pool,
                                                   pool.v_pool, tables,
                                                   lengths)
            ok, err = close(out, ref, POOL_GATHER_ATOL, 0.0)
            check(ok and bool(torch.isfinite(out.float()).all()),
                  f"page_pool: step {i}: kernel vs use_kernel=False "
                  f"max|err| {err}")
            e_gather = max(e_gather, err)
            ok, err = close(out, twin, OUT_ATOL, OUT_RTOL)
            check(ok, f"page_pool: step {i}: kernel vs twin max|err| {err}")
            e_twin = max(e_twin, err)
        phase("page_pool", f"step {i}: lengths {keep[0][3].tolist()}, all "
              f"{POOL_LAYERS} layers: kernel vs use_kernel=False max|err| "
              f"{e_gather:.3g} (atol {POOL_GATHER_ATOL}), vs the twin "
              f"{e_twin:.3g}")

    reset_counts()
    times, prof_step = [], POOL_SWAP + (POOL_STEPS - POOL_SWAP) // 4
    for i in range(POOL_STEPS):
        if i == POOL_SWAP:
            for j in POOL_FREED:
                for pool in pools:
                    pool.free(sids[j])
            new = [f"s{len(POOL_PROMPTS) + k}" for k in range(len(POOL_FREED))]
            for s in new:
                for pool in pools:
                    pool.create(s)
            pool_prompt(pools, new, POOL_NEW_PROMPTS, rows)
            for j, s in zip(POOL_FREED, new):
                sids[j] = s
            phase("page_pool", f"step {i}: freed 2 sequences, created "
                  f"{new} with prompts {list(POOL_NEW_PROMPTS)}: tables of "
                  f"{new[0]} start {pools[0].block_table(new[0])[:4].tolist()}"
                  f", {pools[0].pages_in_use} pages in use")
        keep = [] if i in POOL_CHECKED else None
        torch.cuda.synchronize()
        if i == prof_step:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step(None)
                torch.cuda.synchronize()
            continue
        t0 = time.perf_counter()
        step(keep)
        torch.cuda.synchronize()
        if keep is None:
            times.append((time.perf_counter() - t0) * 1e3)
        else:
            hold(i, keep)
    launches = counts()["paged_attention"]
    check(launches == POOL_LAYERS * POOL_STEPS,
          f"page_pool: #11 launched {launches} times, expected "
          f"{POOL_LAYERS} x {POOL_STEPS}")

    step_ms = float(np.mean(times))
    shares = device_time_shares(prof, groups)
    busy = sum(shares.values())
    phase("page_pool", f"{POOL_STEPS} steps x {POOL_LAYERS} layers, 8 "
          f"sequences: {step_ms:.3f} ms/step (host clock, mean of "
          f"{len(times)} unchecked, unprofiled steps; min {min(times):.3f}, "
          f"max {max(times):.3f}); #11 launched {launches} times")
    if busy <= 0:
        phase("page_pool", "profiler saw no device time: split not measured")
    else:
        phase("page_pool", f"profile of step {prof_step}: device time "
              f"{busy:.3f} ms against {step_ms:.3f} ms a step unprofiled "
              f"({100 * busy / step_ms:.1f}% busy, host gaps "
              f"{step_ms - busy:.3f} ms): "
              + ", ".join(f"{k} {v:.3f} ms ({100 * v / busy:.1f}%)"
                          for k, v in shares.items()))
    del pools, prof
    torch.cuda.empty_cache()
    return {"paged_attention": launches}


def phase_fused(fu, g):
    """Kernels #15 (swiglu) and #16 (rotary) through the ops.fused API at
    yoco_base's widths (E=1024, FFN 4096, 16 q heads and 4 kv heads of
    64), bf16 and fp32: swiglu on [1, 4096, 4096] (yoco_long's prompt)
    and [8, 128, 4096] (yoco_chat's prefill); rotary on q [1, 4096, 16, 64]
    and k [1, 4096, 4, 64] with sin/cos from models/yoco.rotary_sin_cos.
    The launches of that run are the path's; each output is held against
    its plain version (and rotary's against models/yoco.apply_rotary).
    Returns (kernel entries, launches)."""
    from unilm_tpu_torch.models import yoco

    dev = "cuda"
    T = YOCO_LONG_PROMPT
    sin, cos = yoco.rotary_sin_cos(torch.arange(T, device=dev), 64)
    inputs = {}
    for dtype in (torch.bfloat16, torch.float32):
        rn = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
        inputs[dtype] = {
            "swiglu": [(rn(1, T, 4096) * 3, rn(1, T, 4096)),
                       (rn(8, 128, 4096) * 3, rn(8, 128, 4096))],
            "rotary": [rn(1, T, 16, 64), rn(1, T, 4, 64)]}

    reset_counts()
    outs = {dtype: {"swiglu": [fu.swiglu(gg, uu) for gg, uu in x["swiglu"]],
                    "rotary": [fu.rotary_apply(xx, sin, cos)
                               for xx in x["rotary"]]}
            for dtype, x in inputs.items()}
    torch.cuda.synchronize()
    launches = {k: v for k, v in counts().items() if k in ("swiglu", "rotary")}
    check(launches == {"swiglu": 4, "rotary": 4},
          f"fused: launches {launches}, expected 4 each")

    err = {"swiglu": 0.0, "rotary": 0.0}
    for dtype, x in inputs.items():
        # fp32: 1e-5 relative (expf and the division may round apart from
        # torch's sigmoid); bf16: one bf16 ulp (2^-7 relative)
        atol, rtol = (1e-6, 1e-5) if dtype == torch.float32 else \
            (1e-6, 2.0 ** -7)
        name = str(dtype).split(".")[-1]
        for (gg, uu), out in zip(x["swiglu"], outs[dtype]["swiglu"]):
            ok, e = close(out, fu.swiglu_plain(gg, uu), atol, rtol)
            check(ok and out.dtype == gg.dtype and out.shape == gg.shape,
                  f"fused: swiglu {name} {tuple(gg.shape)} max|err| {e}")
            phase("fused", f"swiglu {name} {tuple(gg.shape)}: max|err| "
                  f"{e:.3g} (atol {atol}, rtol {rtol:.3g})")
            err["swiglu"] = max(err["swiglu"], e)
        for xx, out in zip(x["rotary"], outs[dtype]["rotary"]):
            ok, e = close(out, fu.rotary_apply_plain(xx, sin, cos), atol,
                          rtol)
            ok2, e2 = close(out, yoco.apply_rotary(xx, sin, cos), atol, rtol)
            check(ok and ok2 and out.dtype == xx.dtype,
                  f"fused: rotary {name} {tuple(xx.shape)} max|err| {e} / "
                  f"vs apply_rotary {e2}")
            same = torch.equal(out, fu.rotary_apply_plain(xx, sin, cos))
            phase("fused", f"rotary {name} {tuple(xx.shape)}: max|err| "
                  f"{e:.3g} vs the plain version (bit-equal: {same}), "
                  f"{e2:.3g} vs models/yoco.apply_rotary")
            err["rotary"] = max(err["rotary"], e)

    bf = inputs[torch.bfloat16]
    (gg, uu), xq = bf["swiglu"][0], bf["rotary"][0]
    F = torch.nn.functional
    sw = dict(
        ms=device_ms(lambda: fu.swiglu(gg, uu), only="swiglu_kernel"),
        ms_l2_flushed=cold_ms(lambda: fu.swiglu(gg, uu), "swiglu_kernel"),
        plain_ms=device_ms(lambda: fu.swiglu_plain(gg, uu)),
        library_ms=device_ms(lambda: F.silu(gg) * uu),
        **roofline(3 * nbytes(gg), 5 * gg.numel(), "fp32"))
    ro = dict(
        ms=device_ms(lambda: fu.rotary_apply(xq, sin, cos),
                     only="rotary_kernel"),
        ms_l2_flushed=cold_ms(lambda: fu.rotary_apply(xq, sin, cos),
                              "rotary_kernel"),
        plain_ms=device_ms(lambda: fu.rotary_apply_plain(xq, sin, cos)),
        library_ms=None,
        **roofline(2 * nbytes(xq) + nbytes(sin, cos), 3 * xq.numel(),
                   "fp32"))
    phase("fused", f"swiglu bf16 {tuple(gg.shape)}: kernel {sw['ms']:.4f} ms "
          f"({sw['ms_l2_flushed']:.4f} ms with L2 flushed), plain "
          f"{sw['plain_ms']:.4f} ms, F.silu(g) * u (two calls) "
          f"{sw['library_ms']:.4f} ms (device time, back to back); bound "
          f"{sw['bound_ms']:.5f} ms ({sw['bound_by']})")
    phase("fused", f"rotary bf16 {tuple(xq.shape)}: kernel {ro['ms']:.4f} ms "
          f"({ro['ms_l2_flushed']:.4f} ms with L2 flushed: back to back, x "
          f"and out stay in the 50 MB L2), plain {ro['plain_ms']:.4f} ms "
          f"(device time), no single torch call; bound "
          f"{ro['bound_ms']:.5f} ms ({ro['bound_by']})")
    kernels = [
        {"name": "swiglu", "route": "cuda",
         "source": "unilm_tpu_torch/csrc/fused.cu",
         "replaces": "unilm_tpu/ops/fused.py:30",
         "max_abs_err": err["swiglu"], **sw,
         "shape": f"{tuple(gg.shape)} bf16"},
        {"name": "rotary", "route": "cuda",
         "source": "unilm_tpu_torch/csrc/fused.cu",
         "replaces": "unilm_tpu/ops/fused.py:64",
         "max_abs_err": err["rotary"], **ro,
         "shape": f"q {tuple(xq.shape)} bf16"}]
    del inputs, outs
    torch.cuda.empty_cache()
    return kernels, launches


def yoco_models():
    """yoco_base in bf16 compute / fp32 params with random weights from the
    seed, and the same weights (shared tensors) on the plain path."""
    from unilm_tpu_torch.models.yoco import YOCO, YOCOConfig

    cfg = YOCOConfig(dtype=torch.bfloat16)
    model = YOCO(cfg, device="cuda").eval()
    model.init_weights(torch.Generator(device="cuda").manual_seed(SEED))
    plain = YOCO(dataclasses.replace(cfg, use_flash=False),
                 device="cuda").eval()
    plain.load_state_dict(model.state_dict(), assign=True)
    return cfg, model, plain


def yoco_generate(model, cache_size: int, prompt, new: int):
    """runtime.generate's greedy search over YOCO's generate functions,
    eos never drawn; returns (tokens, every forward's logits, calls, wall
    seconds on the host clock around a synchronised run)."""
    from unilm_tpu_torch.models.yoco import make_yoco_generate_fns
    from unilm_tpu_torch.runtime.generate import GenerationConfig, generate

    prefill, step = make_yoco_generate_fns(model, cache_size)
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

    gcfg = GenerationConfig(beam_size=1, max_new_tokens=new, eos=NO_EOS,
                            vocab_size=model.cfg.vocab_size)
    torch.cuda.synchronize()
    t0 = time.time()
    toks, lengths = generate(gcfg, pf, st, prompt)
    torch.cuda.synchronize()
    wall = time.time() - t0
    B, P = prompt.shape
    check(tuple(toks.shape) == (B, P + new)
          and bool((lengths == P + new).all()),
          f"yoco: tokens {tuple(toks.shape)}, lengths {lengths.tolist()}")
    check(calls == {"prefill": 1, "step": new - 1}, f"yoco: calls {calls}")
    check(all(bool(torch.isfinite(lg.float()).all()) for lg in logits),
          "yoco: non-finite logits")
    return toks, logits, calls, wall


def yoco_timed(model, cache_size: int, prompt, steps: int):
    """(prefill ms, decode ms/token) from CUDA events around a prefill and
    `steps` argmax decode steps."""
    from unilm_tpu_torch.models.yoco import make_yoco_generate_fns

    pf, st = make_yoco_generate_fns(model, cache_size)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    lg, c = pf(prompt, None)
    ev[1].record()
    tok = lg[:, -1:].argmax(-1)
    ev[2].record()
    for _ in range(steps):
        lg, c = st(tok, c, None)
        tok = lg[:, -1:].argmax(-1)
    ev[3].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3]) / steps


def yoco_teacher(name, plain, cache_size, prompt, toks, klogits, steps):
    """The plain path teacher-forced on the kernel path's tokens: prefill
    logits (last position within LOGIT_ATOL, argmax agreement over every
    position >= ARGMAX_AGREE) and `steps` decode steps' logits (within
    LOGIT_ATOL); no kernel may launch."""
    from unilm_tpu_torch.models.yoco import make_yoco_generate_fns

    pf, st = make_yoco_generate_fns(plain, cache_size)
    c0 = counts()
    P = prompt.shape[1]
    plg, c = pf(prompt, None)
    errs = [float((plg[:, -1].float() - klogits[0][:, -1].float()).abs().max())]
    agree = float((plg.argmax(-1) == klogits[0].argmax(-1)).float().mean())
    all_pos = float((plg.float() - klogits[0].float()).abs().max())
    del plg
    for j in range(steps):
        plg, c = st(toks[:, P + j:P + j + 1], c, None)
        errs.append(float((plg.float() - klogits[j + 1].float()).abs().max()))
    torch.cuda.synchronize()
    check(counts() == c0, f"{name}: the plain path launched a kernel")
    check(max(errs) <= LOGIT_ATOL and agree >= ARGMAX_AGREE,
          f"{name}: kernel vs plain logits max|err| {max(errs)} (tol "
          f"{LOGIT_ATOL}), prefill argmax agreement {agree} (tol "
          f"{ARGMAX_AGREE})")
    phase(name, f"plain path teacher-forced on the kernel path's tokens: "
          f"prefill last-position logits max|err| {errs[0]:.4f}, {steps} "
          f"decode steps max|err| {max(errs[1:]) if steps else 0.0:.4f} (tol "
          f"{LOGIT_ATOL}); prefill argmax agreement {agree:.4f} over "
          f"{prompt.numel()} positions (tol {ARGMAX_AGREE}); prefill logits "
          f"max|err| over every position {all_pos:.4f} (not bounded)")


def phase_yoco_chat(fa) -> dict:
    """yoco_chat: yoco_base serving a short chat turn (8 rows, 128-token
    prompt, 256-slot cache, 128 greedy tokens) through runtime.generate:
    exactly 24 launches of #5 (12 self + 12 cross layers) per forward and
    none of #1 / #2; prefill ms, decode ms/token, tokens/s, busy share,
    peak memory, a device-time profile; the plain path teacher-forced."""
    from torch.profiler import ProfilerActivity, profile

    name = "yoco_chat"
    cfg, model, plain = yoco_models()
    n_params = sum(p.numel() for p in model.parameters())
    L = cfg.self_layers + cfg.cross_layers
    B, P, C, NEW = (YOCO_CHAT_B, YOCO_CHAT_PROMPT, YOCO_CHAT_CACHE,
                    YOCO_CHAT_NEW)
    phase(name, f"yoco_base: {cfg.self_layers} sliding-window (window "
          f"{cfg.window_size}) + {cfg.cross_layers} cross layers, E="
          f"{cfg.dim}, H={cfg.num_heads}, kv heads {cfg.kv_heads}, FFN "
          f"{cfg.ffn_dim}, vocab {cfg.vocab_size}, bf16 compute / fp32 "
          f"params: {n_params / 1e6:.1f} M params; B={B}, {P}-token prompt, "
          f"{C}-slot cache, {NEW} greedy tokens")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    prompt = torch.randint(2, cfg.vocab_size, (B, P), generator=gen,
                           device="cuda")
    yoco_generate(model, C, prompt[:, :8], 4)  # warm-up

    # ---- the main path -------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    toks, klogits, calls, wall = yoco_generate(model, C, prompt, NEW)
    got = counts()
    forwards = calls["prefill"] + calls["step"]
    check(got["onepass_attention"] == L * forwards,
          f"{name}: #5 launches {got['onepass_attention']} != {L} x "
          f"{forwards} forwards")
    check(got["flash_fwd"] == 0 and got["flash_tri"] == 0,
          f"{name}: #1/#2 launched ({got})")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    phase(name, f"generate: {forwards} forwards, #5 launches "
          f"{got['onepass_attention']} ({L} per forward), #1/#2 none; "
          f"{B * NEW} tokens in {wall:.3f} s (host clock) = "
          f"{B * NEW / wall:.1f} tokens/s; peak memory {peak:.2f} GiB")
    launches = {"onepass_attention": got["onepass_attention"]}

    yoco_teacher(name, plain, C, prompt, toks, klogits, YOCO_TEACHER_STEPS)
    del klogits

    # ---- prefill ms and decode ms/token, kernel and plain in turn -------
    steps = NEW - 1
    yoco_timed(model, C, prompt, 4)
    yoco_timed(plain, C, prompt, 4)
    for rnd in range(2):
        for path, m in (("kernel", model), ("plain", plain)):
            pre, tpot = yoco_timed(m, C, prompt, steps)
            phase(name, f"round {rnd} {path} path: prefill {pre:.3f} ms, "
                  f"decode {tpot:.3f} ms/token ({B * 1e3 / tpot:.0f} "
                  f"tokens/s at B={B}, ctx {P}..{P + steps})")

    # ---- device-time profile: one prefill and 16 decode steps; the busy
    # share against the same window's time without the profiler ---------
    groups = [("onepass #5", ["onepass_kernel"]),
              ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet", "cublas",
                          "splitK"])]
    pre, tpot = yoco_timed(model, C, prompt, 16)
    window_ms = pre + 16 * tpot
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yoco_timed(model, C, prompt, 16)
    shares = device_time_shares(prof, groups)
    total = sum(shares.values())
    if total <= 0:
        phase(name, "profiler saw no device time: shares not measured")
    else:
        phase(name, f"profile (prefill + 16 decode steps): device time "
              f"{total:.2f} ms against {window_ms:.2f} ms for the same "
              f"window unprofiled ({100 * total / window_ms:.1f}% busy): "
              + ", ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                          for k, v in shares.items()))
    del model, plain
    torch.cuda.empty_cache()
    return launches


def phase_yoco_long(fa) -> None:
    """yoco_long: yoco_base on one 4096-token prompt in a 4128-slot cache,
    32 greedy tokens: past the one-pass budget, so 24 launches of #1 per
    forward (the self layers with the window) and none of #5; TTFT,
    decode ms/token, the plain path teacher-forced."""
    name = "yoco_long"
    cfg, model, plain = yoco_models()
    L = cfg.self_layers + cfg.cross_layers
    P, C, NEW = YOCO_LONG_PROMPT, YOCO_LONG_CACHE, YOCO_LONG_NEW
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    prompt = torch.randint(2, cfg.vocab_size, (1, P), generator=gen,
                           device="cuda")
    yoco_generate(model, C, prompt[:, :64], 4)  # warm-up

    reset_counts()
    toks, klogits, calls, wall = yoco_generate(model, C, prompt, NEW)
    got = counts()
    forwards = calls["prefill"] + calls["step"]
    check(got["flash_fwd"] == L * forwards and got["onepass_attention"] == 0
          and got["flash_tri"] == 0,
          f"{name}: launches {got} (want #1 {L} x {forwards}, #5 none)")
    phase(name, f"generate B=1, {P}-token prompt, {C}-slot cache, {NEW} "
          f"tokens in {wall:.3f} s (host clock): #1 launches "
          f"{got['flash_fwd']} ({L} per forward), #5 none")
    yoco_teacher(name, plain, C, prompt, toks, klogits, 4)
    del klogits
    steps = NEW - 1
    yoco_timed(model, C, prompt, 2)
    for path, m in (("kernel", model), ("plain", plain)):
        ttft, tpot = yoco_timed(m, C, prompt, steps)
        phase(name, f"{path} path: TTFT (prefill) {ttft:.3f} ms, decode "
              f"{tpot:.3f} ms/token (ctx {P}..{P + steps})")
    del model, plain
    torch.cuda.empty_cache()


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
    n = 4
    shares = decode_step_shares(lambda: step(model_k, pools_k, True), n)
    phase("engine_int8", f"B=8 decode step (kernel path), device time a "
          f"step (mean of {n}): {sum(shares.values()) / n:.4f} ms, of it "
          + ", ".join(f"{k} {v / n:.4f}" for k, v in shares.items()))
    del model_p, pools_p, eng, model_k, pools_k
    torch.cuda.empty_cache()

    # ---- a plain-path engine on the trace's first requests -------------
    eng_p = ServingEngine(cfg, scfg, sd, device=dev, use_kernel=False)
    c0 = counts()
    outs_p, steps_p, wall_p = run_engine(
        eng_p, [trace[0][:ENGINE_PLAIN_REQUESTS]])
    check(counts() == c0, "engine_int8: the plain-path engine launched a "
          "kernel")
    same = [np.mean(np.asarray(outs[k]) == np.asarray(outs_p[k]))
            for k in outs_p]
    first = [next((i for i, (a, b) in enumerate(zip(outs[k], outs_p[k]))
                   if a != b), ENGINE_NEW) for k in outs_p]
    phase("engine_int8", f"plain-path engine, the trace's first "
          f"{ENGINE_PLAIN_REQUESTS} requests: {steps_p} steps in "
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
    out = {name: 0.0 for name, _ in groups}
    out["other"] = 0.0
    for kernel, t in device_kernel_times(prof).items():
        key = next((name for name, subs in groups
                    if any(s in kernel for s in subs)), "other")
        out[key] += t
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
        check(got["flash_bwd_delta"] == per_step * steps,
              f"train_schedules: #8's delta sweep launched "
              f"{got['flash_bwd_delta']} times")
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

        groups = [("flash_tri #2", ["flash_tri_sm90", "flash_tri_fp32"]),
                  ("flash_bwd_fused #8", ["flash_bwd_fused_sm90",
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


def phase_train(fa, layers: int = 24) -> tuple:
    """The 1.3B UniGPT train step at full width through the CLI's
    build_trainer, its profile, train_schedules and train_options on its
    trainer, the kernel-vs-plain teacher check and the small-size CLI
    resume. Returns (the train path's launches, (train_options' launches,
    its numbers))."""
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

    groups = [("flash_fwd #1", ["flash_fwd_sm90", "flash_fwd_fp32"]),
              ("flash_bwd_dq #6", ["flash_bwd_dq_sm90", "flash_bwd_dq_kernel"]),
              ("flash_bwd_dkv #7", ["flash_bwd_dkv_sm90",
                                    "flash_bwd_dkv_kernel"]),
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
    options = phase_train_options(tr, batch, args)
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
    # T = 256 with 4 heads fits the one-pass budget: the forward is #5's
    ran = {k: counts()[k] - c0[k] for k in ("onepass_attention",
                                            "flash_bwd_dq", "flash_bwd_dkv")}
    fwd1 = counts()["flash_fwd"] - c0["flash_fwd"]
    sa, _, ma = CheckpointManager(str(WORK / "a")).restore(4)
    sb, _, mbm = CheckpointManager(str(WORK / "b")).restore(4)
    same = all(torch.equal(sa["model"][k], sb["model"][k])
               for k in sa["model"])
    same_opt = all(torch.equal(a, b) for a, b in zip(
        sa["opt_state"]["mu"] + sa["opt_state"]["nu"],
        sb["opt_state"]["mu"] + sb["opt_state"]["nu"]))
    check(same and same_opt and ma == mbm and all(v > 0 for v in ran.values())
          and fwd1 == 0,
          f"train: CLI resume not bit-equal (params {same}, optimizer "
          f"{same_opt}, loss {ma} vs {mbm}, launches {ran}, flash_fwd {fwd1})")
    phase("train", f"CLI main() 2 layers E=256 on the card: 4 steps straight "
          f"and 2 + resume + 2 end bit-equal (params, optimizer, loss "
          f"{ma['loss']:.6f}); launches {ran}")
    shutil.rmtree(WORK, ignore_errors=True)
    return launches, options


# ---- search: lexically constrained beam search and aggressive decoding
# (runtime/generate.py) at full width. GAD on the Kosmos-2.5 decoder
# (bf16, the slice's 2052-token multimodal prompt): each verify feeds
# [last, draft...] (T = 17) to decode_step, the generic T > 1 path over
# the pool with q_offset = start, kv_len = start + 17; its attention is
# #1 (onepass_applies refuses S = 2560), none of #13 runs. Constrained
# beam 5 on TrOCR-Base (B=32) and on Kosmos-2.5 (B=1), two ordered
# phrases per line.
GAD_BLOCK, GAD_NEW = 16, 64
SEARCH_BEAM, SEARCH_NEW = 5, 32
SEARCH_TROCR_BATCH = 32


def holds_in_order(seq: list, phrases: list, eos: int) -> bool:
    """Every phrase occurs contiguously in seq (up to its eos), each after
    the previous one."""
    if eos in seq:
        seq = seq[:seq.index(eos)]
    pos = 0
    for ph in phrases:
        at = next((i for i in range(pos, len(seq) - len(ph) + 1)
                   if seq[i:i + len(ph)] == ph), None)
        if at is None:
            return False
        pos = at + len(ph)
    return True


def search_phrases(rng: np.random.RandomState, B: int, vocab: int) -> list:
    """Two ordered phrases per line (2 tokens, then 1), ids 4..vocab-1."""
    return [[rng.randint(4, vocab, size=2).tolist(),
             rng.randint(4, vocab, size=1).tolist()] for _ in range(B)]


def forced_scores(pf, st, prompt, aux, best, gcfg) -> torch.Tensor:
    """Each line's best hypothesis best [B, total] teacher-forced through
    (pf, st): the sum of its generated tokens' log-probs (to its eos) over
    the length penalty, as the search scores it. [B] float."""
    P, total = prompt.shape[1], best.shape[1]
    gen = best[:, P:]
    is_eos = gen == gcfg.eos
    first = torch.where(is_eos.any(1), is_eos.float().argmax(1),
                        torch.full_like(is_eos[:, 0], total - P,
                                        dtype=torch.long))
    n_gen = torch.clamp(first + 1, max=total - P)
    sums = torch.zeros(best.shape[0], device=best.device)
    with torch.no_grad():
        lg, c = pf(prompt, aux)
        for j in range(total - P):
            lp = torch.log_softmax(lg[:, -1].float() / gcfg.temperature, -1)
            tok_lp = lp.gather(1, gen[:, j:j + 1])[:, 0]
            sums += torch.where(j < n_gen, tok_lp, 0.0)
            if j + 1 < total - P:
                lg, c = st(gen[:, j:j + 1], c, None)
    return sums / n_gen.float().clamp(min=1.0) ** gcfg.len_penalty


def constrained_case(name, gen_mod, gcfg, pf, st, plain_fns, prompt, aux,
                     phrases, want_prefill, want_step):
    """One constrained search with its gates: launches (the prefill's
    `want_prefill`, each step's `want_step`), every met hypothesis holding
    its phrases in order, the best teacher-forced through the kernel and
    the plain path within BEAM_SCORE_ATOL of its score; then ms a step
    beside plain (unconstrained) beam search on the same inputs."""
    B = prompt.shape[0]
    seen = {"steps": 0}

    def cpf(tok, a):
        out = pf(tok, a)
        seen["prefill"] = counts()
        return out

    def cst(tok, c, a):
        seen["steps"] += 1
        return st(tok, c, a)

    cons = gen_mod.pack_constraints(phrases, pad=gcfg.pad,
                                    device=prompt.device)
    reset_counts()
    toks, scores, met = gen_mod.constrained_beam_generate(
        gcfg, cpf, cst, prompt, *cons, aux=aux)
    torch.cuda.synchronize()
    got, pre, S = counts(), seen["prefill"], seen["steps"]
    want = {k: want_prefill.get(k, 0) + S * want_step.get(k, 0)
            for k in set(want_prefill) | set(want_step)}
    check(S == gcfg.max_new_tokens - 1
          and all(pre[k] == v for k, v in want_prefill.items())
          and sum(pre.values()) == sum(want_prefill.values())
          and all(got[k] == v for k, v in want.items())
          and sum(got.values()) == sum(want.values()),
          f"search {name}: launches {got}, prefill {pre}, {S} steps (want "
          f"{want_prefill} + {want_step} a step)")
    P = prompt.shape[1]
    n_met, bad = 0, []
    for b in range(B):
        for k in range(gcfg.beam_size):
            if bool(met[b, k]):
                n_met += 1
                if not holds_in_order(toks[b, k, P:].tolist(), phrases[b],
                                      gcfg.eos):
                    bad.append((b, k))
    check(not bad and bool(met[:, 0].all()) and bool(torch.isfinite(
        scores[:, 0]).all()), f"search {name}: met hypotheses without "
          f"their phrases {bad[:5]}, best met {met[:, 0].tolist()}")
    c1 = counts()
    s_kernel = forced_scores(pf, st, prompt, aux, toks[:, 0], gcfg)
    c2 = counts()
    s_plain = forced_scores(*plain_fns, prompt, aux, toks[:, 0], gcfg)
    check(counts() == c2 and c2 != c1, f"search {name}: the plain path "
          "launched a kernel, or the kernel path none")
    err_k = float((s_kernel - scores[:, 0]).abs().max())
    err_p = float((s_plain - scores[:, 0]).abs().max())
    check(err_k <= BEAM_SCORE_ATOL and err_p <= BEAM_SCORE_ATOL,
          f"search {name}: teacher-forced best scores off by {err_k} "
          f"(kernel) / {err_p} (plain)")

    def timed(fn):
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            walls.append((time.time() - t0) * 1e3 / (S + 1))
        return min(walls)

    con_ms = timed(lambda: gen_mod.constrained_beam_generate(
        gcfg, pf, st, prompt, *cons, aux=aux))
    gen_mod.beam_generate(gcfg, pf, st, prompt, aux=aux)
    beam_ms = timed(lambda: gen_mod.beam_generate(gcfg, pf, st, prompt,
                                                  aux=aux))
    phase("search", f"{name}: constrained beam {gcfg.beam_size}, B={B}, "
          f"two ordered phrases a line, {S} steps; launches {dict((k, v) for k, v in got.items() if v)} "
          f"(prefill {dict((k, v) for k, v in pre.items() if v)}, then "
          f"{want_step} a step); {n_met} of {B * gcfg.beam_size} hypotheses "
          f"met, each holding its phrases in order; best score "
          f"teacher-forced max|err| kernel {err_k:.4f}, plain {err_p:.4f} "
          f"(tol {BEAM_SCORE_ATOL}); {con_ms:.2f} ms a step (host clock, "
          f"prefill shared out) beside {beam_ms:.2f} for plain beam search")
    return got, {"ms_per_step_host": con_ms, "beam_ms_per_step_host": beam_ms,
                 "hypotheses_met": n_met, "score_err_kernel": err_k,
                 "score_err_plain": err_p}


def gad_run(gen_mod, gcfg, pf, st, prompt, aux, draft_fn, record: bool):
    """aggressive_generate with the verify calls' inputs, starts, logits
    and launch counts recorded (record=True), else timed. Returns (tokens,
    calls, the record, wall s, prefill s)."""
    rec = {"calls": [], "prefill_s": 0.0}

    def rpf(tok, a):
        torch.cuda.synchronize()
        t0 = time.time()
        out = pf(tok, a)
        torch.cuda.synchronize()
        rec["prefill_s"] = time.time() - t0
        return out

    def rst(tok, c, a):
        c0 = counts()
        start = c["step_counter"]["pos"]
        out = st(tok, c, a)
        ran = {k: v - c0[k] for k, v in counts().items() if v != c0[k]}
        rec["calls"].append((tok.clone(), start, out[0][0].float(), ran))
        return out

    torch.cuda.synchronize()
    t0 = time.time()
    toks, calls = gen_mod.aggressive_generate(
        gcfg, rpf, rst if record else st, prompt, draft_fn, aux=aux,
        block_size=GAD_BLOCK)
    torch.cuda.synchronize()
    return toks, calls, rec, time.time() - t0, rec["prefill_s"]


def phase_search(fa) -> tuple:
    """The search phase (see GAD_BLOCK's comment): GAD against greedy at
    full width with two drafts, each verify call's logits held against the
    plain twin teacher-forced (LOGIT_ATOL, ARGMAX_AGREE) and its launches
    exact (24 of #1, none of #13); constrained beam on Kosmos-2.5 (24 #1
    in the prefill, 24 #13 a step) and TrOCR-Base (12 #5 + 12 #3 in the
    prefill, 12 #3 + 12 #13 a step). Returns (launches, numbers)."""
    from unilm_tpu_torch.core.transformer import _scan_pool_geometry
    from unilm_tpu_torch.models.kosmos import (
        UniGPT, kosmos2_5, make_unigpt_generate_fns)
    from unilm_tpu_torch.models.trocr import make_generate_fns
    from unilm_tpu_torch.runtime import generate as gen_mod

    t_phase = time.time()
    dev = "cuda"
    cfg = kosmos2_5(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                    image_tower=None, scan_layers=True)
    L, V = cfg.num_layers, cfg.vocab_size
    model = UniGPT(cfg, device=dev).eval()
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED))
    plain = UniGPT(dataclasses.replace(cfg, use_flash=False), device=dev)
    plain.load_state_dict(model.state_dict(), assign=True)
    plain.eval()
    cache_size = PROMPT + GAD_NEW
    page, _, pp = _scan_pool_geometry(cache_size)
    pf, st = make_unigpt_generate_fns(model, cache_size)
    ppf, pst = make_unigpt_generate_fns(plain, cache_size)
    rng = np.random.RandomState(SEED + 5)
    prompt, aux = make_request(rng, 1, V, cfg.embed_dim, dev)
    launches, numbers = {}, {}

    # ---- greedy: the reference stream and its ms a token ---------------
    gcfg = gen_mod.GenerationConfig(beam_size=1, max_new_tokens=GAD_NEW,
                                    min_new_tokens=GAD_NEW, vocab_size=V)
    greedy, _ = gen_mod.greedy_generate(gcfg, pf, st, prompt, aux)
    torch.cuda.synchronize()
    t0 = time.time()
    pf(prompt, aux)
    torch.cuda.synchronize()
    t1 = time.time()
    greedy2, _ = gen_mod.greedy_generate(gcfg, pf, st, prompt, aux)
    torch.cuda.synchronize()
    greedy_ms = ((time.time() - t1) - (t1 - t0)) * 1e3 / GAD_NEW
    check(torch.equal(greedy, greedy2), "search: two greedy runs differ")
    ref = greedy[0].tolist()

    def corrupted(accepted, need):
        s = len(accepted)
        return np.asarray([(t + 1) % V if (s + i) % 5 == 0 else t
                           for i, t in enumerate(ref[s:s + need])])

    def wrong(accepted, need):
        s = len(accepted)
        return np.asarray([(t + 1) % V for t in ref[s:s + need]])

    P = PROMPT
    for dname, draft in (("corrupted", corrupted), ("wrong", wrong)):
        reset_counts()
        toks, calls, rec, _, _ = gad_run(gen_mod, gcfg, pf, st, prompt, aux,
                                         draft, record=True)
        got = counts()
        verifies = rec["calls"]
        per_call = [r[3] for r in verifies]
        check(calls == len(verifies) + 1
              and all(r.get("flash_fwd", 0) + r.get("onepass_attention", 0)
                      == L and sum(r.values()) == L for r in per_call)
              and got["decode_attention"] == 0
              and got["flash_fwd"] + got["onepass_attention"] == L * calls,
              f"search gad {dname}: {calls} calls, launches {got}, per "
              f"verify {per_call[:3]} (want {L} of #1 or #5, none of #13)")
        for k, v in got.items():
            if v:
                launches[k] = launches.get(k, 0) + v
        # every verify call's logits against the plain twin, teacher-forced
        c0 = counts()
        with torch.no_grad():
            _, pc = ppf(prompt, aux)
            errs, agree = [], []
            for x, start, klg, _ in verifies:
                pc = gen_mod._rewind_cache(pc, start)
                plg, pc = pst(x, pc, None)
                plg = plg[0].float()
                errs.append(float((klg - plg).abs().max()))
                agree.append((klg.argmax(-1) == plg.argmax(-1)).float())
        torch.cuda.synchronize()
        check(counts() == c0, f"search gad {dname}: the plain path launched "
              "a kernel")
        agree = float(torch.cat(agree).mean())
        check(all(np.isfinite(errs)) and max(errs) <= LOGIT_ATOL
              and agree >= ARGMAX_AGREE,
              f"search gad {dname}: verify logits max|err| {max(errs)}, "
              f"argmax agreement {agree}")
        n_new = int((toks[0, P:] != gcfg.pad).sum())
        same = int((toks[0, P:] == greedy[0, P:]).sum())
        _, calls2, _, wall, pre = gad_run(gen_mod, gcfg, pf, st, prompt, aux,
                                          draft, record=False)
        gad_ms = (wall - pre) * 1e3 / GAD_NEW
        per_call_acc = (n_new - 1) / max(calls - 1, 1)
        phase("search", f"GAD {dname} draft (block {GAD_BLOCK}, "
              f"{GAD_NEW} tokens, Kosmos-2.5 bf16, {P}-token prompt, pool "
              f"{pp * page} slots a layer): {calls} model calls (1 prefill + "
              f"{calls - 1} verifies of T <= {GAD_BLOCK + 1}), "
              f"{per_call_acc:.2f} tokens a verify; {same} of {GAD_NEW} "
              f"tokens equal greedy's; launches a verify: {per_call[0]} "
              f"(#1: onepass_applies refuses S {pp * page}), #13 "
              f"{got['decode_attention']}; verify logits vs the plain twin "
              f"max|err| {max(errs):.4f} (tol {LOGIT_ATOL}), argmax "
              f"agreement {agree:.4f}; {gad_ms:.2f} ms a token (host clock, "
              f"prefill {pre * 1e3:.1f} ms left out; {calls2} calls) beside "
              f"greedy's {greedy_ms:.2f}")
        numbers[f"gad_{dname}"] = {
            "model_calls": calls, "tokens_per_verify": per_call_acc,
            "equal_to_greedy": same, "ms_per_token_host": gad_ms,
            "greedy_ms_per_token_host": greedy_ms,
            "verify_logits_max_abs_err": max(errs),
            "verify_argmax_agreement": agree}
        del rec, verifies
        torch.cuda.empty_cache()

    # ---- constrained beam on Kosmos-2.5, B=1 ----------------------------
    ccfg = gen_mod.GenerationConfig(beam_size=SEARCH_BEAM,
                                    max_new_tokens=SEARCH_NEW,
                                    min_new_tokens=SEARCH_NEW, vocab_size=V)
    got, nums = constrained_case(
        "kosmos2_5", gen_mod, ccfg, *make_unigpt_generate_fns(
            model, PROMPT + SEARCH_NEW),
        make_unigpt_generate_fns(plain, PROMPT + SEARCH_NEW), prompt, aux,
        search_phrases(rng, 1, V), {"flash_fwd": L},
        {"decode_attention": L})
    for k, v in got.items():
        if v:
            launches[k] = launches.get(k, 0) + v
    numbers["constrained_kosmos2_5"] = nums
    del model, plain, pf, st, ppf, pst, prompt, aux
    torch.cuda.empty_cache()

    # ---- constrained beam on TrOCR-Base, B=32 ---------------------------
    pipe = trocr_pipeline(False)
    tmodel, tcfg = pipe.model, pipe.model.cfg
    TL, B = tcfg.dec_layers, SEARCH_TROCR_BATCH
    imgs = torch.randn(B, tcfg.img_size, tcfg.img_size, 3, generator=torch.
                       Generator(device=dev).manual_seed(SEED + 6),
                       device=dev).to(torch.bfloat16)
    with torch.no_grad():
        enc = tmodel.encode(imgs)
    tprompt = torch.full((B, 1), pipe.bos, dtype=torch.long, device=dev)
    tplain = trocr_plain(tmodel)
    got, nums = constrained_case(
        "trocr", gen_mod, pipe.gcfg, pipe.prefill, pipe.step,
        make_generate_fns(tplain, pipe.cache_size), tprompt, enc,
        search_phrases(rng, B, tcfg.vocab_size),
        {"encoder_attention": TL, "onepass_attention": TL},
        {"encoder_attention": TL, "decode_attention": TL})
    for k, v in got.items():
        if v:
            launches[k] = launches.get(k, 0) + v
    numbers["constrained_trocr"] = nums
    del pipe, tmodel, tplain, enc, imgs
    torch.cuda.empty_cache()
    phase("search", f"phase time {time.time() - t_phase:.1f} s")
    return launches, {"search": numbers}


# ---- train_options: remat_policy "dots" / "full" / none and train-mode
# dropout at full width (core/transformer.py `remat`, core/layers.py's
# dropout helpers). The UniGPT part runs inside the train phase on its
# trainer (PR 3's 1.3B configuration: 24 layers, E 2048, T 2048, 4
# microbatches of 2); the BEiT-B and LayoutLMv3-B parts after
# layoutlmv3_train.
DROPOUT = 0.1


def grads_teacher(name: str, a: tuple, b: tuple, names: list,
                  bounds: tuple = None, skip: tuple = (),
                  hold: bool = True) -> dict:
    """(loss, grads) a against b: loss and global grad norm relative, the
    minimum per-tensor cosine over the names not ending in one of `skip`
    (a key bias's gradient is zero up to rounding: a key bias shifts every
    score of a row alike), at `bounds` (loss rel, norm rel, cosine; the
    train teacher's by default). With `hold` False the readings come back
    with "ok" and the caller checks them."""
    loss_b, norm_b, cos_b = bounds or (TEACHER_LOSS_REL, TEACHER_NORM_REL,
                                       TEACHER_COS)
    la, ga = a
    lb, gb = b
    na = float(torch.sqrt(sum(g.float().pow(2).sum() for g in ga)))
    nb = float(torch.sqrt(sum(g.float().pow(2).sum() for g in gb)))
    cos = {n: float(torch.nn.functional.cosine_similarity(
        x.flatten().float(), y.flatten().float(), dim=0))
        for n, x, y in zip(names, ga, gb) if not n.endswith(skip)}
    worst = min(cos, key=cos.get)
    loss_rel, norm_rel = abs(la - lb) / abs(lb), abs(na - nb) / nb
    ok = loss_rel <= loss_b and norm_rel <= norm_b and cos[worst] >= cos_b
    check(ok or not hold, f"{LAST_PHASE[0]} {name}: loss rel {loss_rel}, "
          f"grad norm rel {norm_rel}, min cosine {cos[worst]} ({worst})")
    return {"loss_rel": loss_rel, "norm_rel": norm_rel,
            "min_cos": cos[worst], "worst": worst, "ok": ok}


def phase_train_options(tr, batch, args) -> dict:
    """train_options on the train phase's trainer and repeated batch:
    microbatch 0's loss and gradients under "dots" against "full" (the
    teacher's bounds), 2L #1 + L #6 + L #7 each; `timed_steps` under
    none, "full" and "dots" (96 #1/#6/#7 a step without remat, 192 #1 +
    96 #6/#7 with it: the recompute relaunches the forward kernel, as JAX
    recomputes a pallas_call under both policies); then the step's four
    microbatches at dropout 0.1, twice from
    one seed (bit-equal losses and gradients) and once from another
    (different), 96 #1/#6/#7 each. Returns (the launches, the numbers)."""
    from unilm_tpu_torch.models.kosmos import UniGPT
    from unilm_tpu_torch.ops.fused_ce import chunked_cross_entropy
    from unilm_tpu_torch.runtime.train import TrainState

    t_phase = time.time()
    model, cfg = tr.model, tr.cfg
    layers, n_mb = len(model.decoder.layers), args.update_freq
    per_step = layers * n_mb
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    launches = {}

    def variant(**kw):
        m = UniGPT(dataclasses.replace(cfg, **kw), device="cuda")
        m.load_state_dict(model.state_dict(), assign=True)
        return m.train()

    def micro(m, mb, gen=None):
        out = m(mb, return_features=True, generator=gen)
        s, n = chunked_cross_entropy(out[:, :-1], m.embed_tokens.weight,
                                     mb[:, 1:], chunk=args.ce_chunk)
        return s / n

    def loss_grads(m):
        loss = micro(m, batch[0])
        return float(loss.detach()), torch.autograd.grad(
            loss, [p for p in m.parameters() if p.requires_grad])

    def add(got):
        for k, v in got.items():
            if v:
                launches[k] = launches.get(k, 0) + v

    # ---- dots against full, one microbatch, the same parameters ---------
    full = variant(remat=True, remat_policy="full")
    dots = variant(remat=True, remat_policy="dots")
    ran = []
    for m in (full, dots):
        c0 = counts()
        res = loss_grads(m)
        ran.append({k: v - c0[k] for k, v in counts().items() if v != c0[k]})
        add(ran[-1])
        if m is full:
            lg_full = res
    want = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers}
    check(ran[0] == want and ran[1] == want,
          f"train_options: one microbatch launched {ran} (want {want} under "
          "full and dots)")
    t = grads_teacher("dots vs full", res, lg_full, names)
    phase("train_options", f"microbatch 0 (2 x 2048), dots against full: "
          f"loss {res[0]:.6f} / {lg_full[0]:.6f} (rel {t['loss_rel']:.2e}, "
          f"tol {TEACHER_LOSS_REL}), grad norm rel {t['norm_rel']:.2e} (tol "
          f"{TEACHER_NORM_REL}), min per-tensor cosine {t['min_cos']:.6f} "
          f"({t['worst']}, tol {TEACHER_COS}); launches {ran[0]} under both")
    del res, lg_full, full, dots
    torch.cuda.empty_cache()

    # ---- optimizer steps under each policy -------------------------------
    rows = {}
    for pol in ("none", "full", "dots"):
        m = (model if pol == "none"
             else variant(remat=True, remat_policy=pol))
        fwd = per_step * (1 if pol == "none" else 2)
        # the step without remat is profiled in the train phase
        st = timed_steps(
            f"remat {pol}", TrainState(step=tr.state.step, model=m,
                                       opt_state=tr.state.opt_state),
            tr.step_fn, lambda s: batch,
            {"flash_fwd": fwd, "flash_bwd_dq": per_step,
             "flash_bwd_dkv": per_step}, launches, rows, n=2,
            profiled=pol != "none")
        tr.state.step = st.step
        del st, m
        torch.cuda.empty_cache()

    # ---- dropout 0.1: the step's microbatches, seeded -------------------
    drop = variant(dropout=DROPOUT)
    params = [p for p in drop.parameters() if p.requires_grad]

    def accum(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for p in params:
            p.grad = None
        c0 = counts()
        torch.cuda.synchronize()
        t0 = time.time()
        losses = []
        for i in range(n_mb):
            loss = micro(drop, batch[i], gen)
            loss.backward()
            losses.append(loss.detach())
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        ran = {k: v - c0[k] for k, v in counts().items() if v != c0[k]}
        return torch.stack(losses), [p.grad for p in params], ran, wall

    la, ga, ran_a, _ = accum(SEED)
    ga = [g.clone() for g in ga]
    lb, gb, ran_b, wall = accum(SEED)
    same = torch.equal(la, lb) and all(torch.equal(x, y)
                                       for x, y in zip(ga, gb))
    del ga
    lc, gc, ran_c, _ = accum(SEED + 1)
    differ = not torch.equal(la, lc)
    want = {"flash_fwd": per_step, "flash_bwd_dq": per_step,
            "flash_bwd_dkv": per_step}
    for r in (ran_a, ran_b, ran_c):
        add(r)
    check(same and differ and ran_a == ran_b == ran_c == want,
          f"train_options dropout: same seed bit-equal {same}, another seed "
          f"differs {differ}, launches {ran_a} {ran_b} {ran_c} (want {want})")
    phase("train_options", f"dropout {DROPOUT} (residual branches and FFN "
          f"output, JAX's decoder_cfg), the step's {n_mb} microbatches "
          f"forward + backward: two runs from seed {SEED} bit-equal (losses "
          f"{[round(float(x), 6) for x in la]}, every gradient), seed "
          f"{SEED + 1} differs (losses {[round(float(x), 6) for x in lc]}); "
          f"launches {want} each; {wall:.1f} ms (host clock)")
    rows["dropout"] = {"ms_microbatches_host": wall}
    for p in params:
        p.grad = None
    del drop, params, gb, gc
    torch.cuda.empty_cache()
    phase("train_options", f"UniGPT part {time.time() - t_phase:.1f} s")
    return launches, rows


def timed_steps(name: str, state, step_fn, make_batch, want: dict,
                launches: dict, rows: dict, n: int = 3,
                profiled: bool = True):
    """n optimizer steps of step_fn from `state` on make_batch(step), and
    with `profiled` one more under the profiler: the launches exactly
    `want` a step (added to `launches`), the losses finite; ms/step (host
    clock, the mean of steps 2..n), the profiled step's device time and
    the busy share, and peak memory into rows[name]. Returns the state."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, prof = [], None
    for i in range(n + profiled):
        torch.cuda.synchronize()
        t0 = time.time()
        if i < n:
            state, mt = step_fn(state, make_batch(state.step))
        else:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                state, mt = step_fn(state, make_batch(state.step))
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
        check(np.isfinite(float(mt["loss"])),
              f"train_options {name}: step {i + 1} {mt}")
    got = counts()
    for k, v in got.items():
        if v:
            launches[k] = launches.get(k, 0) + v
    steps = n + profiled
    check(all(got[k] == steps * v for k, v in want.items())
          and sum(got.values()) == steps * sum(want.values()),
          f"train_options {name}: launches over {steps} steps {got} (want "
          f"{want} a step)")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    host = float(np.mean(times[1:n]))
    rows[name] = {"ms_per_step_host": host, "peak_gib": peak}
    busy = ""
    if prof is not None:
        dev = sum(device_time_shares(prof, []).values())
        rows[name]["device_ms_per_step"] = dev
        busy = (f"; the profiled step's device time {dev:.1f} ms "
                f"({100 * dev / host:.0f}% of the host step)")
    phase("train_options", f"{name}: {host:.1f} ms/step (host clock, mean "
          f"of steps 2-{n}; step 1 {times[0]:.1f}){busy}; peak memory "
          f"{peak:.2f} GiB; launches a step {want}")
    return state


def phase_train_options_encoders() -> dict:
    """train_options on the encoders, `timed_steps` each: BEiT-B
    (beit_train's configuration, B=256, drop-path 0.1) without remat,
    under remat "dots" (2 x 12 #3 + 12 #4 a step: the recompute relaunches
    #3) and with attention_dropout 0.1 (the plain attention, JAX's route
    for a rate: no #3/#4); LayoutLMv3-B FUNSD (layoutlmv3_train's
    configuration, B=32) at dropout 0.1, residual only (JAX :86): 12 #9 +
    12 #10 a step. Returns (the launches, the numbers)."""
    from unilm_tpu_torch.cli import train_classification as tcl
    from unilm_tpu_torch.models import layoutlmv3 as lm
    from unilm_tpu_torch.models.beit import BeitForImageClassification
    from unilm_tpu_torch.runtime import optim, train

    t_phase = time.time()
    dev = torch.device("cuda")
    launches, rows = {}, {}
    B = BEIT_TRAIN_BATCH
    args = tcl.build_parser().parse_args([
        "--model", "beit_base_patch16_224", "--data_path", "unused",
        "--batch_size", str(B), "--nb_classes", "1000", "--drop_path", "0.1",
        "--ema_decay", "0.9999", "--clip_grad", "3.0", "--seed", str(SEED)])
    items = [(f"synthetic/{i}", i % 1000) for i in range(40 * B)]
    tr = tcl.build_trainer(args, items)
    cfg, L = tr.cfg, tr.cfg.num_layers
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    images = torch.randn(B, cfg.img_size, cfg.img_size, 3, generator=g,
                         device=dev)
    labels = torch.randint(0, 1000, (B,), generator=g, device=dev)

    def variant(**kw):
        m = BeitForImageClassification(dataclasses.replace(cfg, **kw),
                                       device=dev)
        m.load_state_dict(tr.model.state_dict(), assign=True)
        return m.train()

    def beit_steps(name, m, want):
        st = train.TrainState(step=tr.state.step, model=m,
                              opt_state=tr.state.opt_state,
                              ema_params=tr.state.ema_params)
        st = timed_steps(name, st, tr.step_fn,
                         lambda s: tr.make_batch(images, labels, s), want,
                         launches, rows)
        tr.state.step = st.step

    beit_steps("beit_b_none", tr.model,
               {"encoder_attention": L, "encoder_attention_bwd": L})
    beit_steps("beit_b_dots", variant(remat=True, remat_policy="dots"),
               {"encoder_attention": 2 * L, "encoder_attention_bwd": L})
    beit_steps("beit_b_attention_dropout",
               variant(attention_dropout=DROPOUT), {})
    del tr, images, labels
    torch.cuda.empty_cache()

    # ---- LayoutLMv3-B FUNSD at dropout 0.1 ------------------------------
    B, T = LV3_TRAIN_BATCH, 512
    lcfg = lm.layoutlmv3_base(dtype=torch.bfloat16, num_labels=7,
                              dropout=DROPOUT)
    model = lm.LayoutLMv3ForTokenClassification(lcfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED)).train()
    rng0 = np.random.RandomState(0)  # layoutlmv3_train's batch
    ids = rng0.randint(3, lcfg.vocab_size - 1, (B, T))
    xy = rng0.randint(0, 900, (B, T, 2, 2))
    xy.sort(axis=2)
    bbox = xy.transpose(0, 1, 3, 2).reshape(B, T, 4)
    imgs = rng0.rand(B, 224, 224, 3)
    y = rng0.randint(0, 7, (B, T))
    batch = {"ids": torch.from_numpy(ids).to(dev),
             "bbox": torch.from_numpy(bbox).to(dev),
             "imgs": torch.from_numpy(imgs).to(dev, torch.bfloat16),
             "y": torch.from_numpy(y).to(dev)}
    seeds = iter(range(SEED, SEED + 100))

    def loss_fn(m, b):
        gen = torch.Generator(device=dev).manual_seed(next(seeds))
        s, n = train.cross_entropy_loss(
            m(b["ids"], b["bbox"], None, b["imgs"], generator=gen), b["y"])
        return s / n, {}

    tx = optim.AdamW(1e-5, weight_decay=0.01)
    timed_steps("layoutlmv3_b_dropout", train.TrainState.create(model, tx),
                train.make_train_step(loss_fn, tx, clip_grad_norm=1.0),
                lambda s: batch, {"doc_attention": lcfg.num_layers,
                                  "doc_attention_bwd": lcfg.num_layers},
                launches, rows)
    del model, batch
    torch.cuda.empty_cache()
    phase("train_options", f"encoder part {time.time() - t_phase:.1f} s")
    return launches, rows


# Document AI: layoutlm_base, markuplm_base and
# layoutlmv2_base at full width (12 layers, E=768, 12 heads, random weights
# from the seed). Eval at the FUNSD CLI's precision (float32) on B=32
# documents of 512 token slots, some rows padded (LayoutLMv2 adds the 7x7
# visual grid of 224x224 pages: 561 tokens under a dense per-example bias);
# fine-tuning in bf16 / fp32 params at B=16, AdamW lr 1e-5 wd 0.01, clip
# 1.0, 7 labels. Gates: LayoutLMv3's (LV3_EVAL_* on the valid tokens'
# logits, LV3_TEACHER_* on one batch's loss, grad norm and cosines).
DOCAI_MODELS = ("layoutlm_base", "markuplm_base", "layoutlmv2_base")
DOCAI_L, DOCAI_EVAL_B, DOCAI_TRAIN_B, DOCAI_STEPS = 512, 32, 16, 3
DOCAI_LABELS, DOCAI_PAGE, DOCAI_RE_PAIRS = 7, 224, 64
DOCAI_GROUPS = [("#9", ["doc_fwd", "encoder_attn_kernel"]),
                ("#10", ["doc_bwd"]),
                ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet", "cublas",
                            "splitK"]),
                ("bias gather / scatter", ["index", "gather", "scatter"]),
                ("conv backbone", ["conv", "cudnn", "upsample"])]
# TrOCR-Base fine-tuning: B=32 lines of 384x384, 32-64 target tokens (bos,
# text, eos, pads to 64 + 1), label smoothing 0.1, AdamW lr 2e-5 wd 0.01
# (benchmarks/train_mfu.py bench_trocr), clip 1.0; 3 steps at dropout 0
# (the config's) and 3 at DROPOUT; the teacher check at dropout 0 at the
# train phase's bounds (TEACHER_*), the key biases by norm only.
TROCR_TRAIN_B, TROCR_TRAIN_T, TROCR_TRAIN_STEPS = 32, 64, 3
TROCR_TRAIN_GROUPS = [("#3", [ENCODER_ONLY]), ("#4", [ENC_BWD_ONLY]),
                      ("#5", [ONEPASS_ONLY]), ("#6/#7", ["flash_bwd_d"]),
                      ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet",
                                  "cublas", "splitK"])]
SPM_MODEL = Path(__file__).resolve().parent / "tests" / "fixtures" / \
    "tiny_digits.model"
REPRODUCE_CONFIGS = ("trocr_iam", "funsd", "kosmos_ocr", "beit_base_eval",
                     "beit_large_eval")


def docai_batch(name: str, cfg, B: int, rng: np.random.RandomState,
                dev) -> dict:
    """Synthetic documents for `name` on the card: token ids with rows
    padded from a random length (row 0 full), boxes with x0 <= x1 and
    y0 <= y1 on a 1000-unit page (MarkupLM: xpath tag and subscript units),
    LayoutLMv2's normalized pages, labels (-100 on pads), and for
    LayoutLMv2 DOCAI_RE_PAIRS (head, tail) entity starts with 0/1 labels."""
    L = DOCAI_L
    lens = rng.randint(L // 2, L + 1, B)
    lens[0] = L
    valid = np.arange(L)[None] < lens[:, None]
    ids = rng.randint(3, cfg.vocab_size - 1, (B, L))
    ids[~valid] = getattr(cfg, "pad_token_id", 0)
    labels = rng.randint(0, DOCAI_LABELS, (B, L))
    labels[~valid] = -100
    t = lambda a: torch.from_numpy(a).to(dev)
    b = {"ids": t(ids), "mask": t(valid), "labels": t(labels)}
    if name == "markuplm_base":
        b["tags"] = t(rng.randint(0, cfg.max_xpath_tag_units,
                                  (B, L, cfg.max_depth)))
        b["subs"] = t(rng.randint(0, cfg.max_xpath_subs_units,
                                  (B, L, cfg.max_depth)))
    else:
        xs, ys = (np.sort(rng.randint(0, 1000, (B, L, 2)), -1) for _ in "xy")
        b["bbox"] = t(np.stack([xs[..., 0], ys[..., 0], xs[..., 1],
                                ys[..., 1]], -1))
    if name == "layoutlmv2_base":
        b["images"] = t((rng.rand(B, DOCAI_PAGE, DOCAI_PAGE, 3) * 2 - 1)
                        .astype(np.float32))
        b["heads"] = t(rng.randint(0, L // 2, (B, DOCAI_RE_PAIRS)))
        b["tails"] = t(rng.randint(0, L // 2, (B, DOCAI_RE_PAIRS)))
        b["relations"] = t(rng.randint(0, 2, (B, DOCAI_RE_PAIRS)))
    return b


def docai_forward(name: str, model, b: dict):
    """Token logits of the Document AI model on batch b."""
    if name == "markuplm_base":
        return model(b["ids"], b["tags"], b["subs"], b["mask"])
    if name == "layoutlmv2_base":
        return model(b["ids"], b["bbox"], b["mask"], b["images"])
    return model(b["ids"], b["bbox"], b["mask"])


def docai_loss(name: str, model, re_head, b: dict) -> torch.Tensor:
    """Token cross-entropy over the labelled tokens; for LayoutLMv2 plus
    the RE head's cross-entropy over the batch's entity pairs, read from
    the same hidden states."""
    from unilm_tpu_torch.runtime import train

    y = b["labels"]
    if re_head is None:
        logits = docai_forward(name, model, b)
    else:
        seq = model.layoutlmv2(b["ids"], b["bbox"], b["mask"], b["images"])
        logits = model.classifier(seq[:, :DOCAI_L])
    s, n = train.cross_entropy_loss(logits, y.clamp(min=0), mask=y != -100)
    loss = s / n
    if re_head is not None:
        r = re_head(seq, b["heads"], b["tails"])
        rs, rn = train.cross_entropy_loss(r, b["relations"])
        loss = loss + rs / rn
    return loss


def launches_only(got: dict, want: dict, what: str) -> None:
    """Every counter at its `want` value, every other at 0."""
    bad = {k: v for k, v in got.items() if v != want.get(k, 0)}
    check(not bad, f"{LAST_PHASE[0]}: {what}: launches {bad} (want {want} "
          "and no other kernel)")


def phase_docai_kernels(fa, da, g, dev: str = "cuda") -> dict:
    """The kernels of the Document AI and TrOCR fine-tune paths alone at
    the shapes those paths give them, against their plain versions
    (relative L2 1e-2 in bf16, 1e-4 in float32; gradients by grad_close):
    #9 at LayoutLMv2's 32x561 (float32) and 16x561 (bf16) with its dense
    per-example [B, 12, 561, 561] bias and the key-padding mask, and at
    LayoutLM / MarkupLM's 32x512 (float32) and 16x512 (bf16) with the mask
    alone; #10 at the two bf16 shapes (dbias the full bias plane); TrOCR's
    fine-tune step: #4 at the DeiT encoder's 32x578x12x64, #3 and #4 at
    the decoder's cross-attention 32x64 over 578 slots (16 heads of 64),
    #5 at its causal self-attention 32x64x16x64 and #6 / #7 (its backward,
    on #5's out and lse). Each timed as device time beside the plain
    version, sdpa (or sdpa's backward) and the bound. Returns {kernel
    name: {"docai" | "trocr_train": {...}}} for the kernels line."""
    name, bf, f32 = "docai_kernels", torch.bfloat16, torch.float32
    H, D = 12, 64

    rn = functools.partial(randn, g, dev=dev)
    timed = kernel_timed
    line = functools.partial(kernel_line, name)

    def doc_case(B, T, biased, dtype):
        q, k, v, do = (rn(B, T, H, D, dtype=dtype) for _ in range(4))
        mask = torch.arange(T, device=dev)[None] < torch.randint(
            T // 2, T + 1, (B, 1), generator=g, device=dev)
        mask[0] = True
        if biased:  # LayoutLMv2: the text's padding; the visual grid is kept
            mask[:, DOCAI_L:] = True
        b = rn(B, H, T, T, dtype=dtype) * 0.5 if biased else None
        return q, k, v, do, b, mask

    k9, k10, k3, k4, k5, k67 = {}, {}, {}, {}, {}, {}
    visual = (DOCAI_PAGE // 32) ** 2  # the backbone's 7x7 grid
    for key, B, T, biased, dtype in (
            ("layoutlmv2_eval", DOCAI_EVAL_B, DOCAI_L + visual, True, f32),
            ("layoutlmv2_train", DOCAI_TRAIN_B, DOCAI_L + visual, True, bf),
            ("bert_eval", DOCAI_EVAL_B, DOCAI_L, False, f32),
            ("bert_train", DOCAI_TRAIN_B, DOCAI_L, False, bf)):
        q, k, v, do, b, mask = doc_case(B, T, biased, dtype)
        tol = 1e-4 if dtype == f32 else 1e-2
        out = da.doc_attention(q, k, v, b, mask)
        ref = da.doc_attention_plain(q, k, v, b, mask)
        torch.cuda.synchronize()
        e = rel_l2(out, ref)
        check(bool(torch.isfinite(out.float()).all()) and e <= tol,
              f"{name}: #9 {key} rel L2 {e} (bound {tol})")
        am = (doc_sdpa_mask(da, b, mask) if biased
              else mask[:, None, None, :])
        pairs = float(mask.sum()) * T * H
        fp32 = dtype == f32
        desc = (f"{B}x{T}x{T}x{H}x{D} {'fp32' if fp32 else 'bf16'}, "
                + (f"dense bias [{B},{H},{T},{T}] + key-padding mask"
                   if biased else "key-padding mask"))
        r = k9[key] = {
            "shape": desc, "rel_l2": e,
            "max_abs_err": float((out.float() - ref.float()).abs().max()),
            "library": "sdpa (float mask)" if biased else "sdpa (bool mask)",
            **timed(lambda: da.doc_attention(q, k, v, b, mask),
                    lambda: da.doc_attention_plain(q, k, v, b, mask),
                    lambda: sdpa(q, k, v, attn_mask=am), "doc_fwd" if not fp32
                    else "encoder_attn_kernel",
                    attn_bound(pairs, D, 2, q, k, v, out, b, mask,
                               kind="fp32" if fp32 else "bf16"))}
        line(f"#9 {key}", r)
        del out, ref
        if not fp32:
            got = da.doc_backward(q, k, v, b, mask, do)
            want = da.doc_backward_plain(q, k, v, b, mask, do)
            torch.cuda.synchronize()
            worst_rel = worst_abs = 0.0
            for gname, x, rr in zip(("dq", "dk", "dv", "dbias"), got, want):
                if rr is None:
                    continue
                ok, ea, er = grad_close(x, rr, 1e-2)
                check(bool(torch.isfinite(x.float()).all()) and ok,
                      f"{name}: #10 {key} {gname} max|err| {ea} rel L2 {er}")
                worst_rel, worst_abs = max(worst_rel, er), max(worst_abs, ea)
            qg, kg, vg = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            amg = (am.detach().clone().requires_grad_() if biased else am)
            o = sdpa(qg, kg, vg, attn_mask=amg)
            ins = (qg, kg, vg, amg) if biased else (qg, kg, vg)
            r = k10[key] = {
                "shape": desc + ", dq/dk/dv" + ("/dbias" if biased else ""),
                "rel_l2": worst_rel, "max_abs_err": worst_abs,
                "library": f"sdpa backward ({type(o.grad_fn).__name__})",
                **timed(lambda: da.doc_backward(q, k, v, b, mask, do),
                        lambda: da.doc_backward_plain(q, k, v, b, mask, do),
                        lambda: torch.autograd.grad(o, ins, do.transpose(1, 2),
                                                    retain_graph=True),
                        "doc_bwd",
                        attn_bound(pairs, D, 5, q, k, v, do, b, mask, *got))}
            line(f"#10 {key}", r)
            del got, want, o, qg, kg, vg, amg
        del q, k, v, do, b, mask, am
        torch.cuda.empty_cache()

    # TrOCR-Base's fine-tune step: the encoder's backward (its forward has
    # trocr_kernels' row), the decoder's cross- and self-attention
    B, T, S = TROCR_TRAIN_B, TROCR_TRAIN_T, TROCR_S
    for key, T_, Hk in (("encoder", S, 12), ("cross", T, 16)):
        q, do = rn(B, T_, Hk, D), rn(B, T_, Hk, D)
        k, v = rn(B, S, Hk, D), rn(B, S, Hk, D)
        if key == "cross":
            out = fa.fused_encoder_attention(q, k, v)
            ref = fa.fused_encoder_attention_plain(q, k, v)
            torch.cuda.synchronize()
            e = rel_l2(out, ref)
            check(e <= 1e-2, f"{name}: #3 cross rel L2 {e}")
            r = k3[key] = {
                "shape": f"{B}x{T_}x{S}x{Hk}x{D} bf16, no bias", "rel_l2": e,
                "max_abs_err": float((out.float() - ref.float()).abs().max()),
                "library": "sdpa",
                **timed(lambda: fa.fused_encoder_attention(q, k, v),
                        lambda: fa.fused_encoder_attention_plain(q, k, v),
                        lambda: sdpa(q, k, v), ENCODER_ONLY,
                        attn_bound(B * Hk * T_ * S, D, 2, q, k, v, out))}
            line("#3 trocr cross", r)
            del out, ref
        got = fa.fused_encoder_backward(q, k, v, None, do)
        want = fa.fused_encoder_backward_plain(q, k, v, None, do)
        torch.cuda.synchronize()
        worst_rel = worst_abs = 0.0
        for gname, x, rr in zip(("dq", "dk", "dv"), got, want):
            ok, ea, er = grad_close(x, rr, 1e-2)
            check(bool(torch.isfinite(x.float()).all()) and ok,
                  f"{name}: #4 {key} {gname} max|err| {ea} rel L2 {er}")
            worst_rel, worst_abs = max(worst_rel, er), max(worst_abs, ea)
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        o = sdpa(qg, kg, vg)
        r = k4[key] = {
            "shape": f"{B}x{T_}x{S}x{Hk}x{D} bf16, no bias, dq/dk/dv",
            "rel_l2": worst_rel, "max_abs_err": worst_abs,
            "library": f"sdpa backward ({type(o.grad_fn).__name__})",
            **timed(lambda: fa.fused_encoder_backward(q, k, v, None, do),
                    lambda: fa.fused_encoder_backward_plain(q, k, v, None, do),
                    lambda: torch.autograd.grad(o, (qg, kg, vg),
                                                do.transpose(1, 2),
                                                retain_graph=True),
                    ENC_BWD_ONLY,
                    attn_bound(B * Hk * T_ * S, D, 5, q, k, v, do, *got))}
        line(f"#4 trocr {key}", r)
        del q, k, v, do, got, want, o, qg, kg, vg

    # the decoder's causal self-attention (pre-scaled q, as the flash
    # wrappers take it): #5 forward, #6 / #7 on its out and lse
    Hs = 16
    check(fa.onepass_applies(B, Hs, T, T, D, None, 0),
          f"{name}: #5 does not take the self-attention's {B}x{T}x{Hs}x{D}")
    q = rn(B, T, Hs, D) * D ** -0.5
    k, v, do = rn(B, T, Hs, D), rn(B, T, Hs, D), rn(B, T, Hs, D)
    out, lse = fa.flash_forward_onepass(q, k, v, causal=True)
    ref, rlse = fa.flash_forward_onepass_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    e = rel_l2(out, ref)
    check(e <= 1e-2 and float((lse - rlse).abs().max()) <= LSE_ATOL,
          f"{name}: #5 self rel L2 {e}")
    causal_pairs_ = B * Hs * T * (T + 1) / 2
    r = k5["self"] = {
        "shape": f"{B}x{T}x{T}x{Hs}x{D} bf16, causal", "rel_l2": e,
        "max_abs_err": float((out.float() - ref.float()).abs().max()),
        "library": "sdpa (is_causal)",
        **timed(lambda: fa.flash_forward_onepass(q, k, v, causal=True),
                lambda: fa.flash_forward_onepass_plain(q, k, v, causal=True),
                lambda: sdpa(q, k, v, is_causal=True, scale=1.0),
                ONEPASS_ONLY,
                attn_bound(causal_pairs_, D, 2, q, k, v, out, lse))}
    line("#5 trocr self", r)
    got = fa.flash_backward(q, k, v, None, None, 0, None, out, lse, do,
                            causal=True)
    want = fa.flash_backward_plain(q, k, v, None, None, 0, None, out, lse, do,
                                   causal=True)
    torch.cuda.synchronize()
    worst_rel = worst_abs = 0.0
    for gname, x, rr in zip(("dq", "dk", "dv"), got, want):
        ok, ea, er = grad_close(x, rr, 1e-2)
        check(bool(torch.isfinite(x.float()).all()) and ok,
              f"{name}: #6/#7 {gname} max|err| {ea} rel L2 {er}")
        worst_rel, worst_abs = max(worst_rel, er), max(worst_abs, ea)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o = sdpa(qg, kg, vg, is_causal=True, scale=1.0)
    lib = lambda: torch.autograd.grad(o, (qg, kg, vg), do.transpose(1, 2),
                                      retain_graph=True)
    bwd = lambda: fa.flash_backward(q, k, v, None, None, 0, None, out, lse,
                                    do, causal=True)
    plain = lambda: fa.flash_backward_plain(q, k, v, None, None, 0, None,
                                            out, lse, do, causal=True)
    lib_ms, plain_ms = device_ms(lib), device_ms(plain, iters=3)
    # as phase_flash_bwd counts them (flash_bwd_bounds)
    for kname, bd in zip(("flash_bwd_dq", "flash_bwd_dkv"), flash_bwd_bounds(
            causal_pairs_, q, k, v, do, lse, None, *got[:3])):
        r = k67[kname] = {
            "shape": f"{B}x{T}x{T}x{Hs}x{D} bf16, causal, on #5's out/lse",
            "rel_l2": worst_rel, "max_abs_err": worst_abs,
            "library": f"sdpa backward ({type(o.grad_fn).__name__}), the "
            "whole dq/dk/dv", "library_ms": lib_ms, "plain_ms": plain_ms,
            "ms": device_ms(bwd, only=kname), **bd}
        line(f"#{6 if kname.endswith('dq') else 7} trocr self", r)
    del q, k, v, do, out, lse, got, want, o, qg, kg, vg
    torch.cuda.empty_cache()
    return {"doc_attention": {"docai": k9},
            "doc_attention_bwd": {"docai": k10},
            "encoder_attention": {"trocr_train": k3},
            "encoder_attention_bwd": {"trocr_train": k4},
            "onepass_attention": {"trocr_train": k5},
            "flash_bwd_dq": {"trocr_train": {"self": k67["flash_bwd_dq"]}},
            "flash_bwd_dkv": {"trocr_train": {"self": k67["flash_bwd_dkv"]}}}


def phase_docai() -> tuple:
    """LayoutLM, MarkupLM and LayoutLMv2 at full width through
    models/registry.build (random weights from the seed): for each, eval
    at float32 on DOCAI_EVAL_B documents (exactly 12 launches of #9 a
    forward and nothing else; LayoutLMv2 at 561 tokens under its dense
    bias), docs/s, the logits of the valid tokens against the plain path
    (LV3_EVAL_*); MarkupLM's QA head once, the same way; then
    DOCAI_STEPS bf16 fine-tune steps at DOCAI_TRAIN_B through
    runtime.train.make_train_step (LayoutLMv2 with the RE head over
    DOCAI_RE_PAIRS entity pairs in the loss): exactly 12 #9 and 12 #10 a
    step, ms/step, docs/s, peak memory, a step's device time by kernel
    group; before the steps, a teacher check of one batch at the initial
    weights against the plain path (LV3_TEACHER_*, the key biases by norm
    only: the random RE head's first Adam steps swing the loss, so a
    state after them is a chaotic point to compare at). Returns
    (launches, numbers)."""
    from torch.profiler import ProfilerActivity, profile

    from unilm_tpu_torch.models import markuplm as mm
    from unilm_tpu_torch.models import registry
    from unilm_tpu_torch.models.layoutlmv2 import RelationExtractionHead
    from unilm_tpu_torch.runtime import optim, train

    dev = torch.device("cuda")
    launches, nums = {}, {}
    L = DOCAI_L

    def build(name, **kw):
        cfg, m = registry.build(name, device=dev, num_labels=DOCAI_LABELS,
                                **kw)
        return cfg, m.init_weights(torch.Generator(device=dev).manual_seed(
            SEED))

    def add(got):
        for k, v in got.items():
            if v:
                launches[k] = launches.get(k, 0) + v

    for name in DOCAI_MODELS:
        rng = np.random.RandomState(SEED)
        cfg, model = build(name)
        model.eval()
        nl = cfg.num_layers
        b = docai_batch(name, cfg, DOCAI_EVAL_B, rng, dev)
        T = L + (cfg.visual_len if name == "layoutlmv2_base" else 0)
        valid = b["labels"] != -100
        # ---- eval: one forward on the main path, then timed ------------
        reset_counts()
        with torch.no_grad():
            logits = docai_forward(name, model, b)
        torch.cuda.synchronize()
        got = counts()
        launches_only(got, {"doc_attention": nl}, f"{name} eval forward")
        add(got)
        check(logits.shape == (DOCAI_EVAL_B, L, DOCAI_LABELS)
              and logits.dtype == torch.float32
              and bool(torch.isfinite(logits).all()),
              f"docai: {name} logits {logits.shape} {logits.dtype}")
        with torch.no_grad():
            ms = cuda_ms(lambda: docai_forward(name, model, b), iters=3,
                         warmup=1)
        _, plain = build(name, use_flash=False)
        plain.load_state_dict(model.state_dict())
        plain.eval()
        c0 = counts()
        with torch.no_grad():
            plogits = docai_forward(name, plain, b)
            ms_plain = cuda_ms(lambda: docai_forward(name, plain, b),
                               iters=2, warmup=0)
        check(counts() == c0, f"docai: {name} plain path launched a kernel")
        dl = float((logits - plogits).abs()[valid].max())
        agree = float((logits.argmax(-1) == plogits.argmax(-1))[valid]
                      .float().mean())
        phase("docai", f"{name} eval: {nl} layers, E={cfg.hidden_size}, "
              f"{T} tokens{' (512 text + the 7x7 grid, dense bias)' if T > L else ''}"
              f", float32, B={DOCAI_EVAL_B}: {nl} launches of #9 a forward; "
              f"{ms:.2f} ms/batch, {DOCAI_EVAL_B * 1e3 / ms:.1f} docs/s "
              f"(plain path {ms_plain:.2f} ms); kernel vs plain max |dlogit| "
              f"{dl:.2e} (tol {LV3_EVAL_LOGIT_ATOL}), argmax agreement "
              f"{agree:.4f} (tol {LV3_EVAL_AGREE})")
        check(dl <= LV3_EVAL_LOGIT_ATOL and agree >= LV3_EVAL_AGREE,
              f"docai: {name} eval teacher check failed")
        row = {"eval_ms": ms, "eval_docs_per_s": DOCAI_EVAL_B * 1e3 / ms,
               "eval_plain_ms": ms_plain, "eval_max_dlogit": dl}
        del logits, plogits, plain
        if name == "markuplm_base":
            qa = mm.MarkupLMForQuestionAnswering(cfg, device=dev).init_weights(
                torch.Generator(device=dev).manual_seed(SEED)).eval()
            pqa = mm.MarkupLMForQuestionAnswering(
                dataclasses.replace(cfg, use_flash=False), device=dev)
            pqa.load_state_dict(qa.state_dict())
            pqa.eval()
            reset_counts()
            with torch.no_grad():
                se = docai_forward(name, qa, b)
            launches_only(counts(), {"doc_attention": nl}, "markuplm QA")
            add(counts())
            with torch.no_grad():
                pse = docai_forward(name, pqa, b)
            dqa = max(float((x - y).abs()[b["mask"]].max())
                      for x, y in zip(se, pse))
            phase("docai", f"markuplm_base QA forward: (start, end) logits "
                  f"{tuple(se[0].shape)}, {nl} #9; max |dlogit| vs plain "
                  f"{dqa:.2e} (tol {LV3_EVAL_LOGIT_ATOL})")
            check(dqa <= LV3_EVAL_LOGIT_ATOL, "docai: markuplm QA teacher")
            row["qa_max_dlogit"] = dqa
            del qa, pqa, se, pse
        del model
        torch.cuda.empty_cache()

        # ---- fine-tuning, bf16 compute / fp32 params --------------------
        bcfg, model = build(name, dtype=torch.bfloat16)
        model.train()
        re_head = None
        if name == "layoutlmv2_base":
            re_head = RelationExtractionHead(bcfg.hidden_size, 2,
                                             device=dev).init_weights(
                torch.Generator(device=dev).manual_seed(SEED + 1))
            model.re_head = re_head  # trained with the model
        b = docai_batch(name, bcfg, DOCAI_TRAIN_B, rng, dev)
        names = [n for n, p in model.named_parameters() if p.requires_grad]

        def fwd_bwd(m):
            loss = docai_loss(name, m, getattr(m, "re_head", None), b)
            return float(loss.detach()), torch.autograd.grad(
                loss, train.trainable(m))

        # ---- teacher check at the initial weights: kernel vs plain path
        _, plain = build(name, dtype=torch.bfloat16, use_flash=False)
        if re_head is not None:
            plain.re_head = RelationExtractionHead(bcfg.hidden_size, 2,
                                                   device=dev)
        plain.load_state_dict(model.state_dict())
        plain.train()
        c0 = counts()
        lk, gk = fwd_bwd(model)
        c1 = counts()
        lp, gp = fwd_bwd(plain)
        check(counts() == c1 and c1["doc_attention_bwd"]
              - c0["doc_attention_bwd"] == nl,
              f"docai: {name} teacher launches {c0} -> {c1} -> {counts()}")
        t = grads_teacher(f"{name} fine-tune", (lk, gk), (lp, gp), names,
                          (LV3_TEACHER_LOSS_REL, LV3_TEACHER_NORM_REL,
                           LV3_TEACHER_COS), skip=("k_proj.bias",))
        tabs = ""
        if name == "layoutlmv2_base":
            tabs = "; bias tables' cosines " + ", ".join(
                f"{n.split('.')[-1]} " + str(round(float(
                    torch.nn.functional.cosine_similarity(
                        x.flatten().float(), y.flatten().float(), dim=0)), 5))
                for n, x, y in zip(names, gk, gp) if "rel_pos" in n)
        del plain, gk, gp

        # ---- DOCAI_STEPS optimizer steps, the last ones timed ----------
        loss_fn = lambda m, bb: (docai_loss(name, m, getattr(m, "re_head",
                                                             None), bb), {})
        tx = optim.AdamW(1e-5, weight_decay=0.01)
        state = train.TrainState.create(model, tx)
        step = train.make_train_step(loss_fn, tx, clip_grad_norm=1.0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses = []
        for i in range(DOCAI_STEPS):
            if i == 1:
                ev[0].record()
            state, mt = step(state, b)
            losses.append(float(mt["loss"]))
        ev[1].record()
        torch.cuda.synchronize()
        got = counts()
        launches_only(got, {"doc_attention": nl * DOCAI_STEPS,
                            "doc_attention_bwd": nl * DOCAI_STEPS},
                      f"{name} {DOCAI_STEPS} fine-tune steps")
        add(got)
        check(all(np.isfinite(losses)), f"docai: {name} losses {losses}")
        tms = ev[0].elapsed_time(ev[1]) / (DOCAI_STEPS - 1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fwd_bwd(model)
            torch.cuda.synchronize()
        parts = device_time_shares(prof, DOCAI_GROUPS)
        phase("docai", f"{name} fine-tune, bf16, B={DOCAI_TRAIN_B}"
              + (f", RE head over {DOCAI_RE_PAIRS} pairs" if re_head else "")
              + f": losses {', '.join(f'{x:.4f}' for x in losses)}; {nl} #9 + "
              f"{nl} #10 a step; {tms:.2f} ms/step (CUDA events, steps 2-"
              f"{DOCAI_STEPS}), {DOCAI_TRAIN_B * 1e3 / tms:.1f} docs/s, peak "
              f"memory {peak:.2f} GiB; teacher at the initial weights: loss "
              f"rel {t['loss_rel']:.2e} "
              f"(tol {LV3_TEACHER_LOSS_REL}), grad norm rel "
              f"{t['norm_rel']:.2e} (tol {LV3_TEACHER_NORM_REL}), min cosine "
              f"{t['min_cos']:.5f} ({t['worst']}, tol {LV3_TEACHER_COS})"
              + tabs)
        phase("docai", f"{name} fine-tune step (forward + backward) "
              + groups_line(parts, tms))
        row.update({"train_ms": tms, "train_docs_per_s":
                    DOCAI_TRAIN_B * 1e3 / tms, "train_peak_gib": peak,
                    "train_device_ms": parts, **{f"teacher_{k}": v
                                                 for k, v in t.items()}})
        nums[name] = row
        del model, state, step, tx, b
        torch.cuda.empty_cache()
    return launches, {"docai": nums}


def trocr_train_batch(cfg, rng: np.random.RandomState, dev) -> dict:
    """TROCR_TRAIN_B synthetic normalized 384x384 lines and their targets:
    bos, 32-64 text ids, eos, pads up to TROCR_TRAIN_T + 1 tokens."""
    B, T = TROCR_TRAIN_B, TROCR_TRAIN_T
    tokens = np.full((B, T + 1), 1, np.int64)  # pad 1
    for i in range(B):
        n = rng.randint(32, T) if i else T - 1
        tokens[i, 0] = 0
        tokens[i, 1:n + 1] = rng.randint(4, cfg.vocab_size, n)
        tokens[i, n + 1] = 2
    images = (rng.rand(B, cfg.img_size, cfg.img_size, 3) * 2 - 1)
    return {"images": torch.from_numpy(images.astype(np.float32)).to(dev),
            "tokens": torch.from_numpy(tokens).to(dev)}


def phase_trocr_train(arch: str = "trocr_base") -> tuple:
    """TrOCR fine-tuning at full width (`arch`: trocr_base(), or
    trocr_small() with its 8 decoder heads of 32; bf16 compute / fp32
    params, random weights from the seed):
    runtime/train.teacher_forced_loss (label smoothing 0.1, pads masked)
    through runtime.train.make_train_step, AdamW lr 2e-5 wd 0.01, clip
    1.0, on TROCR_TRAIN_B synthetic lines; TROCR_TRAIN_STEPS steps at dropout 0
    and as many at DROPOUT. Exactly E + L #3 (E encoder layers, L decoder
    cross-attentions), E + L #4, L #5 (the causal self-attention), L #6
    and L #7 a step at both rates, each at its head dim (trocr_base: 24,
    24, 12, 12, 12 at D = 64; trocr_small: 18 #3 and 18 #4, 12 of them at
    D = 64 and 6 at D = 32, 6 #5, #6 and #7 at D = 32); attention_dropout
    is 0: every call keeps its kernel; ms/step,
    lines/s, peak memory, a step's device time by group. A teacher check
    of one batch at dropout 0 at the initial weights: the kernel path
    against the bf16 plain path at the train teacher's bounds, every
    tensor's cosine included (the key biases, whose gradient is zero up
    to rounding, by the norm only); printed beside it, the lowest cosines
    to the float32 plain path, also with #6 / #7 given JAX's flash delta
    = rowsum(dO out) from the bf16 out. The late decoder layers'
    self-attention q/k gradients are ~1000x smaller than their v's (the
    random model's near-uniform attention): that delta loses them, #6's
    exact rowsum(p dp) keeps them. After the steps those gradients sit at
    bf16 rounding's noise (printed: the plain path against itself with
    its weights perturbed by 2^-11 disagrees as much as the kernel path
    does), so the check is held at the initial weights, as docai's is.
    Returns (launches, numbers)."""
    from torch.profiler import ProfilerActivity, profile

    from unilm_tpu_torch.models import trocr as trocr_models
    from unilm_tpu_torch.models.trocr import TrOCRModel
    from unilm_tpu_torch.ops import flash_attention as fa
    from unilm_tpu_torch.runtime import optim, train

    dev = torch.device("cuda")
    name = "trocr_train" if arch == "trocr_base" else f"{arch}_train"
    cfg = getattr(trocr_models, arch)(dtype=torch.bfloat16)
    n, E = cfg.dec_layers, cfg.enc_layers
    De, Dd = cfg.enc_dim // cfg.enc_heads, cfg.dec_dim // cfg.dec_heads
    check(n == TROCR_ARCH[arch], f"{name}: {n} decoder layers")
    per_step = {"encoder_attention": E + n, "encoder_attention_bwd": E + n,
                "onepass_attention": n, "flash_bwd_dq": n,
                "flash_bwd_dkv": n}
    # the encoder's E calls at its head dim, the decoder's at its own
    enc = {De: E}
    enc[Dd] = enc.get(Dd, 0) + n
    per_step_d = {"encoder_attention": enc, "encoder_attention_bwd": enc,
                  "onepass_attention": {Dd: n}, "flash_bwd_dq": {Dd: n},
                  "flash_bwd_dkv": {Dd: n}}
    base = TrOCRModel(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    batch = trocr_train_batch(cfg, rng, dev)
    phase(name, f"{arch} fine-tuning: a {E}-layer DeiT/16 of "
          f"{cfg.enc_heads} heads of {De} at {cfg.img_size} ({TROCR_S} "
          f"encoder tokens), the {n}-layer E={cfg.dec_dim} decoder of "
          f"{cfg.dec_heads} heads of {Dd}, vocab {cfg.vocab_size}, bf16 / fp32 "
          f"params, {sum(p.numel() for p in base.parameters()) / 1e6:.1f} M "
          f"params; B={TROCR_TRAIN_B}, targets of 32-{TROCR_TRAIN_T} tokens")
    launches, nums = {}, {}
    for rate in (0.0, DROPOUT):
        model = TrOCRModel(dataclasses.replace(cfg, dropout=rate), device=dev)
        model.load_state_dict(base.state_dict())
        model.train()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        loss_fn = lambda m, b: train.teacher_forced_loss(m, b, gen, 0.1,
                                                         pad=1)
        tx = optim.AdamW(2e-5, weight_decay=0.01)
        state = train.TrainState.create(model, tx)
        step = train.make_train_step(loss_fn, tx, clip_grad_norm=1.0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses = []
        for i in range(TROCR_TRAIN_STEPS):
            if i == 1:
                ev[0].record()
            state, mt = step(state, batch)
            losses.append(float(mt["loss"]))
        ev[1].record()
        torch.cuda.synchronize()
        got, got_d = counts(), by_head_dim()
        launches_only(got, {k: v * TROCR_TRAIN_STEPS
                            for k, v in per_step.items()},
                      f"{TROCR_TRAIN_STEPS} steps at dropout {rate}")
        want_d = {k: {d: c * TROCR_TRAIN_STEPS for d, c in v.items()}
                  for k, v in per_step_d.items()}
        check(got_d == want_d, f"{name}: launches by head dim {got_d} "
              f"(want {want_d})")
        for k, v in got.items():
            if v:
                launches[k] = launches.get(k, 0) + v
        check(all(np.isfinite(losses)), f"{name}: losses {losses}")
        ms = ev[0].elapsed_time(ev[1]) / (TROCR_TRAIN_STEPS - 1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = step(state, batch)
            torch.cuda.synchronize()
        parts = device_time_shares(prof, TROCR_TRAIN_GROUPS)
        phase(name, f"dropout {rate}: losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}; a step launches "
              f"{per_step}; {ms:.2f} ms/step (CUDA events, steps 2-"
              f"{TROCR_TRAIN_STEPS}), {TROCR_TRAIN_B * 1e3 / ms:.1f} lines/s, "
              f"peak memory {peak:.2f} GiB; the profiled step "
              + groups_line(parts, ms))
        nums[f"dropout_{rate}"] = {"ms_per_step": ms, "peak_gib": peak,
                                   "losses": losses, "device_ms": parts}
        del state, step, tx
        if not rate:
            trained = {k: v.detach().clone()
                       for k, v in model.state_dict().items()}
        del model

    # ---- teacher checks, one batch at dropout 0 ---------------------------
    names = [nm for nm, _ in base.named_parameters()]
    held = [i for i, nm in enumerate(names) if not nm.endswith("k_proj.bias")]

    def grads_of(sd, perturb=0.0, **kw):
        m = TrOCRModel(dataclasses.replace(cfg, **kw), device=dev)
        m.load_state_dict(sd)
        if perturb:  # each weight times 1 + perturb N(0, 1): other roundings
            gp = torch.Generator(device=dev).manual_seed(SEED + 1)
            with torch.no_grad():
                for p in m.parameters():
                    p.mul_(1 + perturb * torch.randn(p.shape, generator=gp,
                                                     device=dev))
        m.train()
        loss, _ = train.teacher_forced_loss(m, batch, None, 0.1, pad=1)
        return float(loss.detach()), [g.float() for g in torch.autograd.grad(
            loss, list(m.parameters()))]

    def min_cos(a, b):
        c = {names[i]: float(torch.nn.functional.cosine_similarity(
            a[1][i].flatten(), b[1][i].flatten(), dim=0)) for i in held}
        worst = min(c, key=c.get)
        return f"{c[worst]:.5f} ({worst})"

    # at the initial weights: the kernel path against the bf16 plain path
    # at the train teacher's bounds, every tensor (the key biases by norm)
    init = base.state_dict()
    c0 = counts()
    res_k = grads_of(init)
    c1 = counts()
    res_p = grads_of(init, use_flash=False)
    res_f = grads_of(init, use_flash=False, dtype=torch.float32)
    check(counts() == c1 and all(c1[k] - c0[k] == v
                                 for k, v in per_step.items()),
          f"{name} teacher: launches {c0} -> {c1} -> {counts()}")

    # the same with JAX's flash delta, rowsum(dO out) from the bf16 out:
    # #6 / #7 swapped for their twin given it (printed, not held)
    def jax_delta_backward(*a, want_dbias=True, **kw):
        r = fa.flash_backward_plain(*a, delta=fa._delta(a[7], a[9]), **kw)
        return (*r[:3], r[3] if want_dbias else None)

    kernel_backward, fa.flash_backward = fa.flash_backward, jax_delta_backward
    try:
        res_j = grads_of(init)
    finally:
        fa.flash_backward = kernel_backward
    phase(name, f"initial weights, min per-tensor gradient cosine "
          f"to the float32 plain path: kernel path {min_cos(res_k, res_f)}, "
          f"bf16 plain path {min_cos(res_p, res_f)}; with JAX's delta from "
          f"the bf16 out {min_cos(res_j, res_f)}, to the bf16 plain path "
          f"{min_cos(res_j, res_p)}")
    t = grads_teacher("initial weights", res_k, res_p, names,
                      skip=("k_proj.bias",))
    phase(name, f"teacher check at the initial weights against the "
          f"bf16 plain path: loss rel {t['loss_rel']:.2e} (tol "
          f"{TEACHER_LOSS_REL}), grad norm rel {t['norm_rel']:.2e} (tol "
          f"{TEACHER_NORM_REL}), min cosine {t['min_cos']:.5f} ({t['worst']}, "
          f"tol {TEACHER_COS}) over {len(held)} tensors")
    nums["teacher"] = t
    del res_k, res_p, res_f, res_j

    # after the dropout-0 steps (printed, not held): the late self-attention
    # q/k gradients sit at bf16 rounding's noise, two roundings of the plain
    # path itself (the weights perturbed by 2^-11) disagree as much
    res_k = grads_of(trained)
    res_p = grads_of(trained, use_flash=False)
    res_q = grads_of(trained, perturb=2 ** -11, use_flash=False)
    phase(name, f"after the {TROCR_TRAIN_STEPS + 1} steps at dropout "
          f"0, min per-tensor gradient cosine: kernel path to the bf16 plain "
          f"path {min_cos(res_k, res_p)}; the bf16 plain path to itself with "
          f"the weights perturbed by 2^-11 {min_cos(res_p, res_q)}")
    del res_k, res_p, res_q, trained, init
    del base, batch
    torch.cuda.empty_cache()
    return launches, {name: nums}


def phase_spm() -> dict:
    """cli/trocr_eval.py --spm tests/fixtures/tiny_digits.model on its
    synthetic digit lines (the CLI's full-width TrOCR at 64 px, float32,
    random weights from --seed), beam 5: per batch 12 #3 in the encode,
    12 #5 + 12 #3 in the prefill, 12 #3 + 12 #13 a decode step, exactly;
    CER/WER printed. Then the VLTokenizer's "spm" backend on a grounding
    prompt (its ids printed, the text round-trip checked) and, where the
    sentencepiece package is installed, its ids on the two checked-in
    models against data/spm.py's, the fused-unknown case printed."""
    from unilm_tpu_torch.cli import trocr_eval
    from unilm_tpu_torch.data.spm import SentencePieceModel
    from unilm_tpu_torch.data.vl_loaders import VLTokenizer

    n, B, batches = TROCR_LAYERS, 4, 2
    reset_counts()
    t0 = time.time()
    res = trocr_eval.main(["--synthetic", "--synthetic-n", str(B * batches),
                           "--batch-size", str(B), "--beam", "5",
                           "--max-new-tokens", "16", "--spm", str(SPM_MODEL)])
    torch.cuda.synchronize()
    got = counts()
    steps = got["decode_attention"] // n
    check(got["decode_attention"] == n * steps and steps >= batches
          and got["onepass_attention"] == n * batches
          and got["encoder_attention"] == n * (2 * batches + steps)
          and sum(got.values()) == n * (3 * batches + 2 * steps),
          f"spm: trocr_eval --spm launches {got} ({batches} batches)")
    phase("spm", f"trocr_eval --spm {SPM_MODEL.name} --synthetic, beam 5, "
          f"{batches} batches of {B}: {res} in {time.time() - t0:.1f} s; "
          f"launches {dict((k, v) for k, v in got.items() if v)} ({steps} "
          "decode steps)")
    tok = VLTokenizer(backend="spm", spm_path=str(SPM_MODEL))
    prompt = "<grounding>12 <phrase>340</phrase><object><patch_index_0012>"
    ids = tok.encode_grounded(prompt)
    check(all(0 <= i < tok.vocab_size for i in ids)
          and tok.decode_text(tok.encode_text("12 340")) == "12 340",
          f"spm: VLTokenizer ids {ids}")
    phase("spm", f"VLTokenizer(backend='spm') text vocab {tok.text_vocab}, "
          f"{tok.vocab_size} ids with the markup; {prompt!r} -> {ids}")
    try:
        import sentencepiece
    except ImportError:
        phase("spm", "the sentencepiece package is not installed: no "
              "comparison with it")
        return {k: v for k, v in got.items() if v}
    corpus = ["hello world", "held", "12 340", "0012 34 5", "hello Z",
              "  hello   world  ", "héllo 12", "<s>", "12<pad>"]
    for path in (SPM_MODEL, SPM_MODEL.with_name("tiny_unigram.model")):
        ours = SentencePieceModel.from_file(str(path))
        ref = sentencepiece.SentencePieceProcessor(model_file=str(path))
        rows = [(t, ours.encode(t), ref.encode(t)) for t in corpus]
        same = sum(a == b for _, a, b in rows)
        phase("spm", f"{path.name}: data/spm.py equals sentencepiece "
              f"{sentencepiece.__version__} on {same} of {len(rows)} texts; "
              + "; ".join(f"{t!r}: ours {a} sentencepiece {b}"
                          for t, a, b in rows if a != b or t in ("<s>",
                                                                 "12<pad>")))
    return {k: v for k, v in got.items() if v}


def phase_reproduce_baseline() -> dict:
    """cli/reproduce_baseline.py --smoke on the card for each of
    REPRODUCE_CONFIGS (synthetic fixtures, random weights, the golden
    assertion skipped): each prints a well-formed verdict; the launches
    of the whole run are the path's (the tiny TrOCR and Kosmos-2.5
    configs run the plain path, as their --tiny models set use_flash
    False; FUNSD runs LayoutLMv3-B's #9, the BEiT configs #3)."""
    import contextlib
    import io

    from unilm_tpu_torch.cli import reproduce_baseline as rb

    reset_counts()
    for config in REPRODUCE_CONFIGS:
        c0, t0 = counts(), time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            v = rb.main(["--config", config, "--smoke"])
        torch.cuda.synchronize()
        check(v["config"] == config and v["smoke"] is True
              and isinstance(v["measured"], float)
              and v["golden"] == rb.GOLDEN[config]["value"],
              f"reproduce_baseline: {config} verdict {v}")
        moved = {k: n - c0[k] for k, n in counts().items() if n > c0[k]}
        phase("reproduce_baseline", f"--config {config} --smoke: "
              f"{v['metric']} {v['measured']:.4f} (golden {v['golden']}, "
              f"not asserted) in {time.time() - t0:.1f} s; launches {moved}")
    return {k: v for k, v in counts().items() if v}


# ---- slice 9: X-MoE and the parallel layer ---------------------------------
# moe_train / moe_serve: UniGPT-1.3B's width (E 2048, 32 heads, FFN 8192,
# vocab 65037) with --moe_freq 2 --moe_experts 8, depth cut to 8 layers
# (4 MoE) so that the fp32 params, grads and AdamW state (~1.5 B params,
# ~24 GB) fit beside the activations. ring: 2 x 8192 tokens of 32 heads x
# 64 over 4 chunks of 2048 on the card, then SeqParallelLM at 2 layers.
MOE_LAYERS, MOE_FREQ, MOE_EXPERTS = 8, 2, 8
MOE_SERVE_REQUESTS, MOE_SERVE_PROMPT, MOE_SERVE_NEW = 4, 512, 32
RING_CHUNKS, RING_CHUNK, RING_HEADS, RING_D = 4, 2048, 32, 64
RING_REL_L2 = 1e-2


def one_rank_group() -> None:
    """A one-rank NCCL process group (a TCP store on a free localhost
    port) for the port's mesh, sharding and sequence-parallel entry
    points."""
    import socket

    import torch.distributed as dist

    if not dist.is_initialized():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                rank=0, world_size=1)


def range_device_ms(prof, names) -> dict:
    """Device time (ms) of the kernels launched under each profiler range
    (record_function) of `names`; 0.0 where the trace kept none."""
    out = dict.fromkeys(names, 0.0)
    for ev in prof.key_averages():
        if ev.key in out:
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0.0)
            out[ev.key] += t / 1e3
    return out


def phase_moe_train(fa) -> dict:
    """moe_train: the MoE train step at the 1.3B width (8 layers, 4 MoE,
    8 experts, top-2) through cli/train_gpt.build_trainer with the bench
    configuration (batch 8 = 4 microbatches x 2, fused CE, AdamW), its
    parameters placed by the port's make_mesh / infer_param_shardings /
    shard_parameters on a one-rank NCCL group; 4 steps routed as in
    training (capacity 1.0, the random second-expert policy, drawn from a
    generator seeded per step) with the gate loss at --moe_gate_loss_wt:
    loss and grad norm finite, the loss falling from step 2, moe_overflow
    printed, #1/#6/#7 launched layers x microbatches times a step; ms/step,
    peak memory and a device-time profile of one microbatch (gate,
    dispatch, experts, combine, attention kernels, other); a teacher check
    of one microbatch (eval routing) against the plain path at the train
    phase's bounds."""
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from unilm_tpu_torch.cli import train_gpt
    from unilm_tpu_torch.models.kosmos import UniGPT
    from unilm_tpu_torch.ops.fused_ce import chunked_cross_entropy
    from unilm_tpu_torch.parallel.mesh import make_mesh
    from unilm_tpu_torch.parallel.sharding import (infer_param_shardings,
                                                   shard_parameters)
    from unilm_tpu_torch.runtime.train import (apply_with_moe_aux,
                                               make_train_step)

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    one_rank_group()
    prefix = str(WORK / "corpus")
    write_corpus(prefix, TRAIN_VOCAB, 64, SEED, lead_pad_first=True)
    args = train_gpt.build_parser().parse_args([
        "--data", prefix, "--dim", "2048", "--layers", str(MOE_LAYERS),
        "--heads", "32", "--ffn", "8192", "--vocab", str(TRAIN_VOCAB),
        "--tokens_per_sample", "2048", "--batch_size", "8",
        "--update_freq", "4", "--fused_ce", "--ce_chunk", "8192",
        "--warmup", "1", "--seed", str(SEED), "--moe_freq", str(MOE_FREQ),
        "--moe_experts", str(MOE_EXPERTS)])
    tr = train_gpt.build_trainer(args)
    model, cfg = tr.model, tr.cfg
    mesh = make_mesh({"data": -1})
    placements = infer_param_shardings(model, mesh)
    check(all(all(p.is_replicate() for p in pl)
              for pl in placements.values()),
          "moe_train: a parameter is sharded on a one-rank mesh")
    sync = shard_parameters(model, mesh)
    n_params = sum(p.numel() for p in model.parameters())
    n_moe = sum(1 for layer in model.decoder.layers if hasattr(layer, "moe"))
    batch = tr.next_batch()
    phase("moe_train", f"UniGPT {MOE_LAYERS} layers ({n_moe} MoE, "
          f"{MOE_EXPERTS} experts, top-{cfg.moe_top}, capacity "
          f"{cfg.moe_capacity_factor} / {cfg.moe_eval_capacity_factor}), "
          f"E={cfg.embed_dim}, H={cfg.num_heads}, FFN={cfg.ffn_dim}, vocab "
          f"{cfg.vocab_size}, T=2048, bf16 compute / fp32 params: "
          f"{n_params / 1e9:.3f} B params; batch 8 = 4 microbatches x 2; "
          f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on a "
          "one-rank NCCL group, every placement Replicate")

    wt = args.moe_gate_loss_wt
    gen = torch.Generator(device="cuda")

    def loss_fn(m, mb):
        out, aux, stats = apply_with_moe_aux(m, mb, return_features=True,
                                             generator=gen)
        s, n = chunked_cross_entropy(out[:, :-1], m.embed_tokens.weight,
                                     mb[:, 1:], chunk=args.ce_chunk)
        return s / n + wt * aux, {"ntok": n, **stats}

    step_fn = make_train_step(loss_fn, tr.tx, clip_grad_norm=args.clip_norm,
                              microbatches=args.update_freq, grad_sync=sync)
    steps, losses, times = 4, [], []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for i in range(steps):
        gen.manual_seed(SEED + i)
        torch.cuda.synchronize()
        t0 = time.time()
        tr.state, m = step_fn(tr.state, batch)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        losses.append(float(m["loss"]))
        gn = float(m["grad_norm"])
        check(np.isfinite(losses[-1]) and np.isfinite(gn),
              f"moe_train: step {i + 1} loss {losses[-1]} grad_norm {gn}")
        phase("moe_train", f"step {i + 1}: loss {losses[-1]:.6f}, grad_norm "
              f"{gn:.4f}, moe_overflow {float(m['moe_overflow']):.4f}, "
              f"{times[-1] * 1e3:.1f} ms (host clock)")
    got = counts()
    per_step = MOE_LAYERS * args.update_freq
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(got[name] == per_step * steps,
              f"moe_train: {name} launches {got[name]} != {per_step} x "
              f"{steps}")
    check(all(losses[i + 1] < losses[i] for i in range(1, steps - 1)),
          f"moe_train: loss does not fall from step 2 on: {losses}")
    launches = {k: got[k] for k in ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv")}
    step_s = float(np.mean(times[1:]))
    tokens = args.batch_size * args.tokens_per_sample
    phase("moe_train", f"launches per step: flash_fwd/dq/dkv {per_step} "
          f"each; steps 2-{steps}: {step_s * 1e3:.1f} ms/step, "
          f"{tokens / step_s:.0f} tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # ---- device-time profile of one microbatch (training routing) -------
    mb = batch[0]
    params = [p for p in model.parameters() if p.requires_grad]

    def micro():
        gen.manual_seed(SEED)
        loss, _ = loss_fn(model, mb)
        return torch.autograd.grad(loss, params)

    micro()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        grads = micro()
        torch.cuda.synchronize()
    del grads
    shares = device_time_shares(prof, [
        ("flash #1/#6/#7", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])])
    total = sum(shares.values())
    ranges = range_device_ms(prof, ["moe_gate", "moe_dispatch",
                                    "moe_experts", "moe_combine"])
    if total <= 0:
        phase("moe_train", "profiler saw no device time: shares not "
              "measured")
    else:
        phase("moe_train", f"device time of one microbatch {total:.1f} ms: "
              f"attention kernels {shares['flash #1/#6/#7']:.1f} ms; the "
              "MoE ranges' forward kernels (recompute-free) " + ", ".join(
                  f"{k} {v:.2f} ms" for k, v in ranges.items())
              + f"; other {shares['other'] - sum(ranges.values()):.1f} ms "
              "(the rest less those ranges: cuBLAS products of the dense "
              "layers and of the MoE backward, elementwise, CE)")
    tr.state.opt_state = None  # the teacher check needs the memory
    torch.cuda.empty_cache()

    # ---- teacher check: kernel vs plain path, one sequence, eval routing
    flat = batch.reshape(-1, batch.shape[-1])
    rows = [i for i in range(flat.shape[0]) if int(flat[i, 0]) != PAD]
    row = max(rows, key=lambda i: int((flat[i] == PAD).sum()))
    seq = flat[row:row + 1]
    plain = UniGPT(dataclasses.replace(cfg, use_flash=False, remat=True),
                   device="cuda")
    plain.load_state_dict(model.state_dict(), assign=True)

    def loss_grads(m):
        out, aux, _ = apply_with_moe_aux(m, seq, return_features=True)
        s, n = chunked_cross_entropy(out[:, :-1], m.embed_tokens.weight,
                                     seq[:, 1:], chunk=args.ce_chunk)
        loss = s / n + wt * aux
        ps = [p for p in m.parameters() if p.requires_grad]
        return float(loss.detach()), torch.autograd.grad(loss, ps)

    c0 = counts()
    lk, gk = loss_grads(model)
    c1 = counts()
    lp, gp = loss_grads(plain)
    torch.cuda.synchronize()
    check(counts() == c1 and c1["flash_bwd_dq"] - c0["flash_bwd_dq"]
          == MOE_LAYERS, f"moe_train teacher: launch counts {c0} -> {c1}")
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    nk = float(torch.sqrt(sum(g.float().pow(2).sum() for g in gk)))
    npl = float(torch.sqrt(sum(g.float().pow(2).sum() for g in gp)))
    cos = {n: float(torch.nn.functional.cosine_similarity(
        a.flatten().float(), b.flatten().float(), dim=0))
        for n, a, b in zip(names, gk, gp)}
    worst = min(cos, key=cos.get)
    loss_rel = abs(lk - lp) / abs(lp)
    norm_rel = abs(nk - npl) / npl
    phase("moe_train", f"teacher check, batch row {row} (1 x 2048, eval "
          f"routing): loss kernel {lk:.6f} plain {lp:.6f} (rel "
          f"{loss_rel:.2e}, tol {TEACHER_LOSS_REL}); grad norm kernel "
          f"{nk:.5f} plain {npl:.5f} (rel {norm_rel:.2e}, tol "
          f"{TEACHER_NORM_REL}); min per-tensor cosine {cos[worst]:.5f} "
          f"({worst}, tol {TEACHER_COS})")
    check(loss_rel <= TEACHER_LOSS_REL and norm_rel <= TEACHER_NORM_REL
          and cos[worst] >= TEACHER_COS, "moe_train: teacher check failed")
    del plain, gk, gp, tr, model
    torch.cuda.empty_cache()
    return launches


def moe_serve_model():
    """The MoE UniGPT text decoder at the 1.3B width, 8 layers (4 MoE of 8
    experts), bf16 params and compute, random weights from the seed, as
    (config, state_dict)."""
    from unilm_tpu_torch.models.kosmos import UniGPT, UniGPTConfig

    cfg = UniGPTConfig(vocab_size=TRAIN_VOCAB, embed_dim=2048,
                       num_layers=MOE_LAYERS, num_heads=32, ffn_dim=8192,
                       max_positions=2050, subln=True, xpos_rel_pos=True,
                       moe_freq=MOE_FREQ, moe_experts=MOE_EXPERTS,
                       dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                       image_tower=None)
    model = UniGPT(cfg, device="cuda").eval()
    model.init_weights(torch.Generator(device="cuda").manual_seed(SEED))
    return cfg, model.state_dict()


def phase_moe_serve() -> dict:
    """moe_serve: the serving engine on the MoE decoder (moe_serve_model),
    bf16 pools and weights, then int8 weights (the experts and the router
    stay bf16) with int8 pools: MOE_SERVE_REQUESTS greedy requests of a
    MOE_SERVE_PROMPT-token prompt each; the decode launches counted; then
    4 teacher-forced decode steps at B=4, kernel path against the plain
    path: logits within LOGIT_ATOL on every row, argmax agreement
    ARGMAX_AGREE. The plain path routes each token to the experts the
    kernel path chose (core/moe.py `top2_gating(choice=)`, with its own
    gates): a router's near tie can break apart under the attention's
    rounding and send a token to another expert, a jump that no tolerance
    on rounding covers, so the rows whose own choice would differ are
    counted and printed, and held like the others."""
    from unilm_tpu_torch.runtime.serving import (PagedGPT, ServingConfig,
                                                 ServingEngine)

    dev = "cuda"
    cfg, sd = moe_serve_model()
    L = cfg.num_layers
    rng = np.random.RandomState(SEED + 9)
    prompts = [[int(t) for t in rng.randint(4, cfg.vocab_size,
                                            size=MOE_SERVE_PROMPT)]
               for _ in range(MOE_SERVE_REQUESTS)]
    trace = [[(f"r{i}", p) for i, p in enumerate(prompts)]]
    launches = {}
    n_moe = L // MOE_FREQ
    for name, extra in (("bf16", {}), ("int8", dict(weight_dtype="int8",
                                                   kv_dtype="int8"))):
        scfg = ServingConfig(max_batch=4, page_size=64, chunk_pages=8,
                             max_pages_per_seq=16, num_pages=8 + 4 * 16 + 8,
                             prefill_bucket=64, max_new_tokens=MOE_SERVE_NEW,
                             eos=NO_EOS, **extra)
        eng = ServingEngine(cfg, scfg, sd, device=dev)
        esd = eng.model.state_dict()
        check(esd["decoder.layers.1.moe.experts.fc1.weight"].dtype
              == torch.bfloat16 and esd["decoder.layers.1.moe.gate.weight"]
              .dtype == torch.float32,
              f"moe_serve {name}: expert / router weights not full precision")
        reset_counts()
        outs, steps, wall = run_engine(eng, trace)
        got = counts()
        chunks = eng.stats["prefill_chunks"]
        check(all(len(outs[f"r{i}"]) == MOE_SERVE_NEW
                  for i in range(MOE_SERVE_REQUESTS)),
              f"moe_serve {name}: token counts")
        decode = {k: got[k] for k in ("decode_attention",
                                      "decode_attention_int8",
                                      "paged_append_attention") if got[k]}
        check(sum(decode.values()) == L * steps,
              f"moe_serve {name}: decode launches {decode} != {L} x {steps}")
        if name == "int8":
            want = (L * 4 + (L - n_moe) * 2) * (chunks + steps)
            check(got["int8_matmul"] == want,
                  f"moe_serve int8: int8 matmul launches {got['int8_matmul']}"
                  f" != {want} (the dense projections only)")
            decode["int8_matmul"] = got["int8_matmul"]
        for k, v in decode.items():
            launches[k] = launches.get(k, 0) + v
        phase("moe_serve", f"{name}: {MOE_SERVE_REQUESTS} requests x "
              f"{MOE_SERVE_PROMPT} prompt + {MOE_SERVE_NEW} greedy tokens: "
              f"{chunks} prefill chunks, {steps} decode steps in {wall:.2f} s"
              f" (host clock, {MOE_SERVE_REQUESTS * MOE_SERVE_NEW / wall:.1f}"
              f" tok/s); launches {decode}; first stream "
              f"{outs['r0'][:8]}...")

        # teacher-forced: kernel path against plain path, B=4
        model_k = eng.model
        model_p = PagedGPT(eng.cfg, use_kernel=False, chunk_pages=8,
                           device=dev)
        model_p.load_state_dict(model_k.state_dict(), assign=True)
        model_p.eval()
        B, MP = 4, scfg.max_pages_per_seq
        base = 8 + MP * np.arange(B)
        tables = torch.tensor(base[:, None] + np.arange(MP)[None],
                              device=dev, dtype=torch.int32)
        bases = torch.tensor(base, device=dev, dtype=torch.int32)
        lengths = torch.tensor(MOE_SERVE_PROMPT + 2 * np.arange(B),
                               device=dev, dtype=torch.int32)
        ones = torch.ones(B, dtype=torch.int32, device=dev)
        pools_k = eng.pools
        pools_p = tuple(t.clone() for t in pools_k)
        sp = (lambda pools: pools[2] if len(pools) > 2 else None)
        tok = torch.tensor(rng.randint(4, cfg.vocab_size, size=(B, 1)),
                           device=dev)
        import unilm_tpu_torch.core.moe as moe_mod

        gating = moe_mod.top2_gating
        picks, own = [], []

        def record(logits, cap, top2, uniform):
            picks.append(moe_mod.expert_choice(logits, top2))
            return gating(logits, cap, top2, uniform)

        def replay(logits, cap, top2, uniform):
            # the kernel path's experts, this path's gates
            own.append(moe_mod.expert_choice(logits, top2))
            return gating(logits, cap, top2, uniform,
                          choice=picks[len(own) - 1])

        errs, agree, flipped = [], [], []
        try:
            for j in range(4):
                n0 = len(picks)
                moe_mod.top2_gating = record
                lk = model_k(tok, pools_k[0], pools_k[1], tables,
                             lengths + j, ones, bases=bases,
                             scale_pool=sp(pools_k))[0]
                moe_mod.top2_gating = replay
                lp = model_p(tok, pools_p[0], pools_p[1], tables,
                             lengths + j, ones, scale_pool=sp(pools_p))[0]
                torch.cuda.synchronize()
                check(len(own) == len(picks) == n0 + n_moe,
                      f"moe_serve {name}: {len(picks) - n0} / "
                      f"{len(own) - n0} MoE forwards, not {n_moe}")
                # rows whose token the plain path would, by its own
                # logits, send to another set of experts in some layer
                flip = torch.zeros(B, dtype=torch.bool, device=dev)
                for (a1, a2), (b1, b2) in zip(picks[n0:], own[n0:]):
                    a = torch.stack((a1, a2), -1).sort(-1).values
                    b = torch.stack((b1, b2), -1).sort(-1).values
                    flip |= (a != b).any(-1).reshape(B)
                flipped.append(flip.tolist())
                errs.append((lk.float() - lp.float()).abs().amax(
                    (1, 2)).tolist())
                agree.extend((lk.argmax(-1) == lp.argmax(-1)).flatten()
                             .tolist())
                tok = lk.argmax(-1)
        finally:
            moe_mod.top2_gating = gating
        agree = float(np.mean(agree))
        worst = max(max(es) for es in errs)
        n_flip = sum(map(sum, flipped))
        phase("moe_serve", f"{name}: teacher-forced B4 at ctx ~"
              f"{MOE_SERVE_PROMPT}, kernel vs plain path on the kernel "
              "path's experts: logits max|err| per step and row "
              f"{[[round(e, 4) for e in es] for es in errs]} (|logit| up to "
              f"{float(lp.float().abs().max()):.2f}, std "
              f"{float(lp.float().std()):.3f}), max {worst:.4f} (tol "
              f"{LOGIT_ATOL}); {n_flip} of {4 * B} rows would route a token "
              "to another set of experts by the plain path's own logits; "
              f"argmax agreement {agree:.3f}")
        check(agree >= ARGMAX_AGREE and worst <= LOGIT_ATOL,
              f"moe_serve {name}: logits max|err| {errs}, argmax agreement "
              f"{agree}")
        del eng, model_k, model_p, pools_k, pools_p
        torch.cuda.empty_cache()
    del sd
    torch.cuda.empty_cache()
    return launches


def phase_ring(fa) -> tuple:
    """ring: parallel/ring_attention.py's per-chunk steps on the card, the
    ring of RING_CHUNKS ranks played by a loop here (each rank's q
    chunk against the chunks it holds in turn: the diagonal, then the
    earlier ones; a causal ring skips the later ones): 2 x 8192 tokens, 32
    heads x 64, bf16, causal, a non-contiguous key-padding mask (example 0
    left-padded inside chunk 1, whose first rows see no key of their own
    chunk) and example 1 masking every key. Forward out / lse and the
    backward's dq / dk / dv against #1 and #6/#7 on the whole sequence at
    relative L2 <= RING_REL_L2; the dead example's rows are zeros, not NaN.
    Then #6 / #7 with the ring's delta are timed on one off-diagonal
    chunk, and SeqParallelLM trains 2 steps on a one-rank group at 2
    layers of the 1.3B width through make_train_step. Returns (the
    launches, the chunk's timings for the kernels line)."""
    from unilm_tpu_torch.core.config import TransformerConfig
    from unilm_tpu_torch.parallel import ring_attention as ra
    from unilm_tpu_torch.parallel.long_context import SeqParallelLM
    from unilm_tpu_torch.parallel.mesh import make_mesh
    from unilm_tpu_torch.runtime.optim import AdamW
    from unilm_tpu_torch.runtime.train import TrainState, make_train_step

    dev, bf = "cuda", torch.bfloat16
    P, Tl, H, D = RING_CHUNKS, RING_CHUNK, RING_HEADS, RING_D
    B, T = 2, RING_CHUNKS * RING_CHUNK
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    rn = lambda: torch.randn(B, T, H, D, generator=g, device=dev).to(bf)
    q, k, v, do = rn(), rn(), rn(), rn()
    mask = torch.ones(B, T, dtype=torch.bool, device=dev)
    mask[0, Tl:Tl + 5] = False      # rows Tl..Tl+4 see no key of chunk 1
    mask[0, 3 * Tl + 100] = False
    mask[1] = False                 # an example that masks every key
    scale = D ** -0.5
    qs = (q * scale).contiguous()
    mi = mask.to(torch.int32)
    ch = lambda t, i: t[:, i * Tl:(i + 1) * Tl].contiguous()

    reset_counts()
    outs, lses = [], []
    for r in range(P):  # rank r: its q chunk, k/v chunks r, r-1, ..., 0
        o, lse = ra.chunk_forward(ch(qs, r), ch(k, r), ch(v, r), ch(mi, r),
                                  diagonal=True, causal=True)
        for j in range(r - 1, -1, -1):
            o_c, lse_c = ra.chunk_forward(ch(qs, r), ch(k, j), ch(v, j),
                                          ch(mi, j), diagonal=False,
                                          causal=True)
            o, lse = ra.merge(o, lse, o_c, lse_c)
        outs.append(o)
        lses.append(lse)
    fwd = counts()
    o = torch.cat(outs, 1)
    lse = torch.cat(lses, 2)
    delta = ra.ring_delta(o, do)
    dq = torch.zeros(B, T, H, D, device=dev)
    dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
    for r in range(P):
        for j in range(r, -1, -1):
            sl = slice(r * Tl, (r + 1) * Tl)
            a, b, c = ra.chunk_backward(
                ch(qs, r), ch(k, j), ch(v, j), ch(mi, j),
                lse[:, :, sl].contiguous(), ch(do, r),
                delta[:, :, sl].contiguous(), diagonal=j == r, causal=True)
            dq[:, sl] += a
            dk[:, j * Tl:(j + 1) * Tl] += b
            dv[:, j * Tl:(j + 1) * Tl] += c
    torch.cuda.synchronize()
    got = counts()
    n_chunks = P * (P + 1) // 2
    check(fwd["flash_fwd"] + fwd["onepass_attention"] == n_chunks
          and got["flash_bwd_dq"] == n_chunks
          and got["flash_bwd_dkv"] == n_chunks,
          f"ring: launches {got} (forward {fwd}) != {n_chunks} chunk calls "
          "each")
    launches = {"flash_fwd": fwd["flash_fwd"],
                "flash_bwd_dq": got["flash_bwd_dq"],
                "flash_bwd_dkv": got["flash_bwd_dkv"]}
    if fwd["onepass_attention"]:
        launches["onepass_attention"] = fwd["onepass_attention"]

    # the whole sequence through #1 and #6/#7
    ref_o, ref_lse = fa.flash_forward(qs, k, v, None, mask, causal=True)
    ref = fa.flash_backward(qs, k, v, None, mask, 0, None, ref_o, ref_lse,
                            do, causal=True)
    torch.cuda.synchronize()
    alive = (mi.cumsum(1) > 0)  # [B, T]: a visible valid key
    errs = {"out": rel_l2(o[alive], ref_o[alive]),
            "lse": rel_l2(lse.transpose(1, 2)[alive],
                          ref_lse.transpose(1, 2)[alive])}
    for name, x, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        check(bool(torch.isfinite(x).all()), f"ring: {name} not finite")
        errs[name] = rel_l2(x, r)
    dead = ~alive
    check(bool(torch.isfinite(o).all()) and bool((o[dead] == 0).all())
          and bool((dq[1] == 0).all()) and bool((lse[1] <= -1e29).all()),
          "ring: the dead example is not zeros / NEG_INF")
    check(all(e <= RING_REL_L2 for e in errs.values()),
          f"ring: relative L2 to the whole-sequence kernels {errs} (bound "
          f"{RING_REL_L2})")
    phase("ring", f"{P} chunks of {Tl} (B={B}, H={H}, D={D}, bf16, causal,"
          f" example 0 left-padded inside chunk 1, example 1 all masked): "
          f"{n_chunks} forward and {n_chunks} backward chunk calls ({got}); "
          "relative L2 to #1 / #6 / #7 on the whole sequence "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (bound {RING_REL_L2}); the dead example's rows zero, lse "
          "NEG_INF, no NaN")
    # ---- #6 / #7 with the ring's delta: one off-diagonal chunk (rank 3's
    # q against chunk 2: full visibility, the key-padding mask) timed as
    # device time beside #6's own delta sweep on the same chunk, the plain
    # twin and sdpa's backward (dq, dk, dv)
    sl = slice(3 * Tl, 4 * Tl)
    cq, cdo = ch(qs, 3), ch(do, 3)
    ck, cv, cm = ch(k, 2), ch(v, 2), ch(mi, 2)
    clse, cdelta = lse[:, :, sl].contiguous(), delta[:, :, sl].contiguous()
    given = lambda: fa.flash_backward(cq, ck, cv, None, cm, 0, None, None,
                                      clse, cdo, delta=cdelta)
    own = lambda: fa.flash_backward(cq, ck, cv, None, cm, 0, None, None,
                                    clse, cdo)
    plain = lambda: fa.flash_backward_plain(cq, ck, cv, None, cm, 0, None,
                                            None, clse, cdo, delta=cdelta)
    dev_dq = device_ms(given, only="flash_bwd_dq")
    dev_dkv = device_ms(given, only="flash_bwd_dkv")
    dev_call = device_ms(given)
    dev_own = device_ms(own, only="flash_bwd_dq")
    dev_dq2 = device_ms(given, only="flash_bwd_dq")
    plain_ms = cuda_ms(plain, iters=3)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (cq, ck, cv))
    amask = cm.bool()[:, None, None, :]
    lo = sdpa(qg, kg, vg, attn_mask=amask, scale=1.0)
    dlo = cdo.transpose(1, 2)
    lib = lambda: torch.autograd.grad(lo, (qg, kg, vg), dlo,
                                      retain_graph=True)
    lib_ms = device_ms(lib, iters=5)
    pairs = float(cm.int().sum()) * Tl * H
    bd = attn_bound(pairs, D, 5, cq, ck, cv, cdo, clse, cdelta, cm, cq, ck,
                    cv)
    phase("ring", f"#6 / #7 with the ring's delta, one off-diagonal chunk "
          f"({B}x{Tl} over {Tl} keys, H={H}, D={D}, bf16, the mask): device "
          f"time #6 {dev_dq:.4f} / {dev_dq2:.4f} ms (#6 taking its own "
          f"delta in a first sweep {dev_own:.4f}), #7 {dev_dkv:.4f}, the "
          f"call {dev_call:.4f}; plain twin {plain_ms:.4f} ms (CUDA "
          f"events); sdpa backward {lib_ms:.4f}; bound "
          f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}, the pair's 5 "
          "products)")
    extra = {"flash_bwd_dq": {"ring_chunk": {
        "shape": f"{B}x{Tl}x{Tl}x{H}x{D} bf16, mask, the caller's delta",
        "ms": dev_dq, "ms_own_delta": dev_own, "call_ms": dev_call,
        "plain_ms": plain_ms, "library_ms": lib_ms, **bd}},
        "flash_bwd_dkv": {"ring_chunk": {"ms": dev_dkv}}}
    del q, k, v, do, qs, o, lse, dq, dk, dv, ref_o, ref_lse, ref, outs, lses
    del cq, cdo, ck, cv, cm, clse, cdelta, qg, kg, vg, lo, dlo
    torch.cuda.empty_cache()

    # ---- SeqParallelLM: 2 steps on a one-rank group --------------------
    one_rank_group()
    mesh = make_mesh({"seq": -1})
    cfg = TransformerConfig(vocab_size=TRAIN_VOCAB, embed_dim=2048,
                            num_layers=2, num_heads=32, ffn_dim=8192,
                            max_positions=T, subln=True, xpos_rel_pos=True,
                            dtype=bf)
    lm = SeqParallelLM(cfg, mesh, "seq", device=dev)
    lm.init_weights(torch.Generator(device=dev).manual_seed(SEED))
    toks = torch.from_numpy(np.random.RandomState(SEED).randint(
        4, TRAIN_VOCAB, size=(1, T))).to(dev)
    tx = AdamW(1e-3)
    state = TrainState.create(lm, tx)
    step = make_train_step(lm.loss_fn, tx, clip_grad_norm=1.0, grad_sync=lm)
    reset_counts()
    losses = []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        state, m = step(state, toks)
        torch.cuda.synchronize()
        losses.append(float(m["loss"]))
        check(np.isfinite(losses[-1]) and np.isfinite(float(m["grad_norm"])),
              f"ring: SeqParallelLM step {i + 1} loss {losses[-1]}")
        phase("ring", f"SeqParallelLM step {i + 1} (2 layers, 1 x {T} "
              f"tokens, one-rank seq group): loss {losses[-1]:.5f}, "
              f"grad_norm {float(m['grad_norm']):.4f}, "
              f"{(time.time() - t0) * 1e3:.1f} ms (host clock)")
    got = counts()
    check(got["flash_fwd"] == 2 * 2 and got["flash_bwd_dq"] == 2 * 2
          and got["flash_bwd_dkv"] == 2 * 2,
          f"ring: SeqParallelLM launches {got} != 2 layers x 2 steps")
    check(losses[1] < losses[0], f"ring: SeqParallelLM loss {losses}")
    for k2 in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        launches[k2] += got[k2]
    del lm, state, tx
    torch.cuda.empty_cache()
    return launches, extra


# ---- the registry's last eight architectures and their kin ---------------
# registry_kernels, registry_text, registry_speech: full widths, bf16 (the
# float32 models in float32), random weights from the seed.
REG_E5 = (64, 512, 32)  # batch, slots, shortest of the ragged lengths
REG_INFONCE = (32, 64, 256)  # query / passage pairs, their slots
REG_S2S = (8, 448, 64, 5)  # batch, source, target tokens, beam
REG_NMT = (16, 128, 32, 5)  # batch, source, new tokens, beam
REG_NMT_STEP = 64  # target tokens of the label-smoothed step
REG_RETNET = (4, 2048, 64)  # batch, chunk-parallel tokens, recurrent ones
REG_DIFF = (4, 2048)
REG_AUDIO = (8, 160000)  # 8 x 10 s at 16 kHz: 499 WavLM frames
REG_MEL = (8, 998, 128)  # spectrograms: 62 x 8 = 496 BEATs patches
REG_ASR_T = 64  # SpeechT5 ASR target tokens
REG_TTS = (64, 100)  # TTS text tokens, decoder steps (200 mel frames)
REG_SPEECHLM = (8, 16000, 128)  # 1 s of audio (799 frames), text tokens
REG_KOSMOS = (160000, 64, 16)  # audio samples, text tokens, greedy tokens
REG_CPU_T = 256  # tokens of the float32 card-against-CPU example
# bounds: encoder features (relative L2), the kernel-free paths' one
# float32 example on the card against the CPU (relative L2); decode and
# teacher-forced logits at LOGIT_ATOL / ARGMAX_AGREE, train steps at the
# TEACHER_* bounds
REG_FEAT_REL_L2 = 2e-2
REG_FP32_REL = 1e-4
REGISTRY_GROUPS = [("#3", [ENCODER_ONLY]), ("#4", [ENC_BWD_ONLY]),
                   ("#9", ["doc_fwd"]), ("#10", ["doc_bwd"]),
                   ("#5", [ONEPASS_ONLY]), ("#1", ["flash_fwd"]),
                   ("#13", [DECODE_ONLY]),
                   ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet", "cublas",
                               "splitK"]),
                   ("conv", ["conv", "cudnn", "implicit", "winograd"])]


def ragged_mask(rng, B: int, T: int, lo: int, dev) -> torch.Tensor:
    """[B, T] bool, True on each row's first len in lo..T slots."""
    lens = rng.randint(lo, T + 1, B)
    return torch.from_numpy(np.arange(T)[None] < lens[:, None]).to(dev)


def phase_registry_kernels(fa, da, pa, g, dev: str = "cuda") -> dict:
    """The kernels of the registry slice alone at its new shapes, against
    their plain versions (relative L2 <= 1e-2, #13 at OUT_ATOL /
    OUT_RTOL with the pools bit-equal): #3 at BEATs' 8x496x496x12x64 with
    the T5 bucket bias [1,12,496,496] and at UniLM's train forward
    8x512x512x12x64 with the seq2seq bias [1,1,512,512] (-1e30 where a
    key is hidden, cast to bf16: finite, and every row keeps its source
    keys), #9 at E5's 64x512x512x12x64 with ragged lengths 32-512, #13 at
    UniLM's beam decode (B40 = 8 x 5 beams, page 16, chunk 2, 32 pages a
    run, H12 D64, lengths 448-511). Each timed (device time back to back
    and with L2 flushed) beside the plain version, sdpa and the bound.
    Returns {kernel name: {"registry": {...}}} for the kernels line."""
    from unilm_tpu_torch.core.transformer import _scan_pool_geometry
    from unilm_tpu_torch.models.unilm_s2s import seq2seq_attn_bias

    bf, name, H, D = torch.bfloat16, "registry_kernels", 12, 64
    rn = functools.partial(randn, g, dev=dev)
    timed = functools.partial(kernel_timed, flushed=True)
    line = functools.partial(kernel_line, name)
    Bs, S, Tt, K = REG_S2S
    s2s_bias = seq2seq_attn_bias(S, Tt, dev).to(bf)
    check(bool(torch.isfinite(s2s_bias).all())
          and float(s2s_bias.min()) < -1e29,
          f"{name}: the seq2seq bias in bf16 {float(s2s_bias.min())}")
    k3 = {}
    for key, B, T, bias in (
            ("beats", REG_MEL[0], 496, rn(1, H, 496, 496)),
            ("unilm_train", Bs, S + Tt, s2s_bias)):
        q, k, v = (rn(B, T, H, D) for _ in range(3))
        out = fa.fused_encoder_attention(q, k, v, bias=bias)
        ref = fa.fused_encoder_attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        e = rel_l2(out, ref)
        check(bool(torch.isfinite(out.float()).all()) and e <= 1e-2,
              f"{name}: #3 {key} rel L2 {e} (bound 1e-2)")
        r = k3[key] = {
            "shape": f"{B}x{T}x{T}x{H}x{D} bf16, bias "
            f"[{','.join(map(str, bias.shape))}]",
            "rel_l2": e, "library": "sdpa",
            "max_abs_err": float((out.float() - ref.float()).abs().max()),
            **timed(lambda: fa.fused_encoder_attention(q, k, v, bias=bias),
                    lambda: fa.fused_encoder_attention_plain(q, k, v, bias),
                    lambda: sdpa(q, k, v, attn_mask=bias), ENCODER_ONLY,
                    attn_bound(B * H * T * T, D, 2, q, k, v, out, bias))}
        line(f"#3 {key}", r, 1e-2)
        del q, k, v, out, ref

    B, T, lo = REG_E5
    mask = ragged_mask(np.random.RandomState(SEED), B, T, lo, dev)
    q, k, v = rn(B, T, H, D), rn(B, T, H, D), rn(B, T, H, D)
    out = da.doc_attention(q, k, v, None, mask)
    ref = da.doc_attention_plain(q, k, v, None, mask)
    torch.cuda.synchronize()
    e = rel_l2(out, ref)
    check(bool(torch.isfinite(out.float()).all()) and e <= 1e-2,
          f"{name}: #9 e5 rel L2 {e} (bound 1e-2)")
    k9 = {"e5": {
        "shape": f"{B}x{T}x{T}x{H}x{D} bf16, key-padding mask (lengths "
        f"{lo}-{T})", "rel_l2": e, "library": "sdpa (bool mask)",
        "max_abs_err": float((out.float() - ref.float()).abs().max()),
        **timed(lambda: da.doc_attention(q, k, v, None, mask),
                lambda: da.doc_attention_plain(q, k, v, None, mask),
                lambda: sdpa(q, k, v, attn_mask=mask[:, None, None, :]),
                "doc_fwd", attn_bound(float(mask.sum()) * T * H, D, 2, q, k, v,
                                      out, mask))}}
    line("#9 e5", k9["e5"], 1e-2)
    del q, k, v, out, ref

    page, chunk, PP = _scan_pool_geometry(S + Tt)
    check((page, chunk, PP) == (16, 2, 32), f"{name}: pool geometry "
          f"{(page, chunk, PP)}")
    Bc = Bs * K
    lens = np.random.RandomState(SEED).randint(S, S + Tt, Bc).tolist()
    bases = torch.arange(Bc, dtype=torch.int32, device=dev) * PP
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    kp, vp = rn(Bc * PP, page, H * D), rn(Bc * PP, page, H * D)
    q, kn, vn = rn(Bc, 1, H, D), rn(Bc, 1, H, D), rn(Bc, 1, H, D)
    kp2, vp2 = kp.clone(), vp.clone()
    out = pa.run_decode_append_attention(q, kn, vn, kp, vp, bases, lengths,
                                         PP, None, chunk)[0]
    ref = pa.run_decode_append_attention_plain(q, kn, vn, kp2, vp2, bases,
                                               lengths, PP, None, chunk)[0]
    torch.cuda.synchronize()
    ok, err = close(out, ref, OUT_ATOL, OUT_RTOL)
    check(ok and bool(torch.isfinite(out.float()).all())
          and torch.equal(kp, kp2) and torch.equal(vp, vp2),
          f"{name}: #13 B{Bc}: out err {err} or pools differ")
    L = S + Tt // 2  # the middle of the beam's decode
    lengths = torch.full((Bc,), L, dtype=torch.int32, device=dev)
    qs = (q[:, 0] * D ** -0.5).contiguous()
    alone = lambda: pa.decode_attention(qs, kp, vp, bases, lengths, PP)
    run = lambda pool: pool.reshape(Bc, PP * page, H, D)[:, :L + 1]
    lib = lambda: sdpa(q, run(kp), run(vp))
    k13 = {"unilm_beam": {
        "shape": f"B{Bc} L{L} H{H} D{D} page {page} bf16 (UniLM beam 5 at "
        f"B={Bs})", "max_abs_err": err,
        "ms": device_ms(alone, only=DECODE_ONLY),
        "ms_l2_flushed": cold_ms(alone, DECODE_ONLY),
        "plain_ms": device_ms(lambda: pa.run_decode_append_attention_plain(
            q, kn, vn, kp, vp, bases, lengths, PP, None, chunk), iters=3),
        "library_ms": device_ms(lib), "library_ms_l2_flushed": cold_ms(lib),
        **decode_bound(Bc * (L + 1), Bc, H, D, 2, new_rows=False)}}
    r = k13["unilm_beam"]
    phase(name, f"#13 {r['shape']}: out max|err| {err:.3g} (tol {OUT_ATOL} "
          f"abs + {OUT_RTOL} rel, lengths {min(lens)}-{max(lens)}), pools "
          f"bit-equal; device time {r['ms']:.4f} ms back to back, "
          f"{r['ms_l2_flushed']:.4f} flushed; sdpa over the runs "
          f"{r['library_ms']:.4f} / {r['library_ms_l2_flushed']:.4f}; plain "
          f"{r['plain_ms']:.4f}; bound {r['bound_ms']:.5f} ({r['bound_by']})")
    del kp, vp, kp2, vp2
    torch.cuda.empty_cache()
    return {"encoder_attention": {"registry": k3},
            "doc_attention": {"registry": k9},
            "decode_attention": {"registry": k13}}


def logits_teacher(label: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """Kernel-path logits against the plain path's on the same inputs:
    max |dlogit| <= LOGIT_ATOL and argmax agreement >= ARGMAX_AGREE."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    check(bool(torch.isfinite(got).all()) and err <= LOGIT_ATOL
          and agree >= ARGMAX_AGREE,
          f"{LAST_PHASE[0]} {label}: max |dlogit| {err} (tol {LOGIT_ATOL}), "
          f"argmax agreement {agree} (tol {ARGMAX_AGREE})")
    return {"max_dlogit": err, "argmax_agreement": agree}


def feature_teacher(label: str, got: torch.Tensor,
                    want: torch.Tensor) -> float:
    e = rel_l2(got, want)
    check(bool(torch.isfinite(got.float()).all()) and e <= REG_FEAT_REL_L2,
          f"{LAST_PHASE[0]} {label}: rel L2 {e} (tol {REG_FEAT_REL_L2})")
    return e


def card_vs_cpu(label: str, model, make_cpu, fn) -> float:
    """A kernel-free model's float32 output on the card against the same
    weights on the CPU (`make_cpu()` builds the CPU model): fn(model, dev)
    draws its inputs from a fixed numpy seed. Relative L2 <=
    REG_FP32_REL."""
    cpu = make_cpu()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu.eval()
    with torch.no_grad():
        a = fn(model, torch.device("cuda")).float().cpu()
        b = fn(cpu, torch.device("cpu")).float()
    e = rel_l2(a, b)
    check(bool(torch.isfinite(a).all()) and e <= REG_FP32_REL,
          f"{LAST_PHASE[0]} {label}: float32 card against CPU rel L2 {e} "
          f"(tol {REG_FP32_REL})")
    del cpu
    return e


def counted(fn):
    """fn with its calls counted in `.calls`."""
    def wrapped(*a, **k):
        wrapped.calls += 1
        return fn(*a, **k)
    wrapped.calls = 0
    return wrapped


def phase_registry_text(fa) -> tuple:
    """The registry's text architectures at full width (registry.build,
    bf16 compute / float32 params, random weights from the seed):
    e5_base eval at REG_E5 (12 #9 a forward; embeddings against the plain
    twin by relative L2) and an InfoNCE step at REG_INFONCE (24 #9 + 24
    #10; the teacher at the initial weights in float32, where the loss's
    temperature 0.01 does not magnify bf16 rounding 100-fold); unilm_seq2seq_base's train
    forward over 448 + 64 tokens (12 #3 with the seq2seq bias; logits
    against the plain twin) and beam 5 over 64 tokens from a 448-token
    source at B=8 (12 #3 in the prefill, 12 #13 a step; the best beams
    teacher-forced through both paths); xlmt_base and deltalm_base beam 5
    at B=16 over a 128-token source and one label-smoothed step (no
    kernel: JAX sets use_flash=False there); retnet_base's chunk-parallel
    forward over 2048 tokens at B=4 continued by 64 recurrent tokens
    (against the parallel form over the same tokens); the Diff
    Transformer's 2048-token forward at B=4. The kernel-free models'
    float32 output on one example, card against CPU (REG_FP32_REL).
    Returns (launches, numbers)."""
    from unilm_tpu_torch.models import deltalm, registry, unilm_s2s
    from unilm_tpu_torch.models.retrieval import info_nce_loss
    from unilm_tpu_torch.models.translation import make_generate_fns
    from unilm_tpu_torch.runtime import criterions, optim, train
    from unilm_tpu_torch.runtime import generate as gen

    dev, bf, name = torch.device("cuda"), torch.bfloat16, "registry_text"
    launches, nums = {}, {}
    seeded = lambda: torch.Generator(device=dev).manual_seed(SEED)

    def add(got):
        for k, v in got.items():
            if v:
                launches[k] = launches.get(k, 0) + v

    def build(arch, **kw):
        if arch == "deltalm_base":
            cfg = deltalm.deltalm_base(**kw)
            return cfg, deltalm.DeltaLM(cfg, device=dev).init_weights(
                seeded()).eval()
        cfg, m = registry.build(arch, device=dev, **kw)
        return cfg, m.init_weights(seeded()).eval()

    def twin(arch, model, **kw):
        plain = registry.build(arch, device=dev, use_flash=False, **kw)[1]
        plain.load_state_dict(model.state_dict())
        return plain.eval()

    def cpu_model(arch):
        if arch == "deltalm_base":
            return lambda: deltalm.DeltaLM(deltalm.deltalm_base(),
                                           device="cpu")
        return lambda: registry.build(arch, device="cpu")[1]

    def fwd_bwd(model, loss_fn, batch):
        loss = loss_fn(model, batch)[0]
        return float(loss.detach()), torch.autograd.grad(
            loss, train.trainable(model))

    def one_step(model, loss_fn, batch, want, label):
        """One AdamW step through make_train_step: its launches exactly
        `want`, ms from CUDA events around a second step."""
        tx = optim.AdamW(1e-5, weight_decay=0.01)
        state = train.TrainState.create(model, tx)
        step = train.make_train_step(loss_fn, tx, clip_grad_norm=1.0)
        torch.cuda.synchronize()
        reset_counts()
        state, mt = step(state, batch)
        torch.cuda.synchronize()
        launches_only(counts(), want, label)
        add(counts())
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        state, mt2 = step(state, batch)
        ev[1].record()
        torch.cuda.synchronize()
        losses = [float(mt["loss"]), float(mt2["loss"])]
        check(all(np.isfinite(losses)), f"{name} {label}: losses {losses}")
        del state, step, tx
        return losses, ev[0].elapsed_time(ev[1])

    rng = np.random.RandomState(SEED)

    # ---- e5_base: eval and one InfoNCE step ------------------------------
    cfg, m = build("e5_base", dtype=bf)
    L, V = cfg.num_layers, cfg.vocab_size
    B, T, lo = REG_E5
    mask = ragged_mask(rng, B, T, lo, dev)
    ids = torch.from_numpy(rng.randint(1000, V, (B, T))).to(dev)
    reset_counts()
    with torch.no_grad():
        emb = m(ids, mask)
    torch.cuda.synchronize()
    launches_only(counts(), {"doc_attention": L}, "e5 eval forward")
    add(counts())
    plain = twin("e5_base", m, dtype=bf)
    with torch.no_grad():
        e = feature_teacher("e5 embeddings", emb, plain(ids, mask))
        ms = host_ms(lambda: m(ids, mask), 5)
        ms_plain = host_ms(lambda: plain(ids, mask), 2)
        parts = profile_steps(lambda: m(ids, mask), 1, REGISTRY_GROUPS)[0]
    phase(name, f"e5_base eval B={B} x {T} slots (lengths {lo}-{T}): "
          f"{L} #9 a forward; embeddings rel L2 {e:.3g} against the plain "
          f"path (tol {REG_FEAT_REL_L2}); {ms:.2f} ms a forward, "
          f"{B * 1e3 / ms:.1f} seq/s (plain {ms_plain:.2f} ms); "
          + groups_line(parts, ms))
    nums["e5_eval"] = {"ms": ms, "plain_ms": ms_plain, "rel_l2": e,
                       "device_ms": parts}
    Bq, Tq, Tp = REG_INFONCE
    batch = {"q": torch.from_numpy(rng.randint(1000, V, (Bq, Tq))).to(dev),
             "qm": ragged_mask(rng, Bq, Tq, 8, dev),
             "p": torch.from_numpy(rng.randint(1000, V, (Bq, Tp))).to(dev),
             "pm": ragged_mask(rng, Bq, Tp, 32, dev)}
    nce = lambda mm, b: (info_nce_loss(mm(b["q"], b["qm"]),
                                       mm(b["p"], b["pm"]), 0.01)[0], {})
    del plain
    # the teacher in float32 (#9 / #10's float32 kernels against the plain
    # path): the loss's temperature 0.01 multiplies the embeddings' bf16
    # rounding by 100, past the train bounds on either path's rounding
    _, m32 = build("e5_base")
    plain = twin("e5_base", m32)
    names = [n for n, p in m32.named_parameters() if p.requires_grad]
    c0 = counts()
    lk, gk = fwd_bwd(m32, nce, batch)
    c1 = counts()
    lp, gp = fwd_bwd(plain, nce, batch)
    check(counts() == c1 and c1["doc_attention_bwd"]
          - c0["doc_attention_bwd"] == 2 * L, f"{name}: e5 teacher launches")
    tch = grads_teacher("e5 infonce (float32)", (lk, gk), (lp, gp), names,
                        skip=("k_proj.bias",))
    del plain, m32, gk, gp
    losses, tms = one_step(m, nce, batch, {"doc_attention": 2 * L,
                                           "doc_attention_bwd": 2 * L},
                           "e5 infonce step")
    phase(name, f"e5_base InfoNCE step, {Bq} queries x {Tq} + {Bq} "
          f"passages x {Tp}: {2 * L} #9 + {2 * L} #10; losses "
          f"{losses[0]:.4f}, {losses[1]:.4f}; {tms:.2f} ms/step; float32 "
          f"teacher at the initial weights: loss rel {tch['loss_rel']:.2e}, grad norm "
          f"rel {tch['norm_rel']:.2e}, min cosine {tch['min_cos']:.5f} "
          f"({tch['worst']})")
    nums["e5_infonce"] = {"ms": tms, "losses": losses, **tch}
    del m
    torch.cuda.empty_cache()

    # ---- unilm_seq2seq_base: the train forward and beam 5 ----------------
    Bs, S, Tt, K = REG_S2S
    cfg, m = build("unilm_seq2seq_base", dtype=bf)
    L, V = cfg.num_layers, cfg.vocab_size
    toks = torch.from_numpy(rng.randint(1000, V, (Bs, S + Tt))).to(dev)
    types = torch.where(torch.arange(S + Tt, device=dev) < S, 4, 5
                        ).expand(Bs, -1)
    reset_counts()
    with torch.no_grad():
        logits = m(toks, types, S)
    torch.cuda.synchronize()
    launches_only(counts(), {"encoder_attention": L}, "unilm train forward")
    add(counts())
    plain = twin("unilm_seq2seq_base", m, dtype=bf)
    with torch.no_grad():
        tf = logits_teacher("unilm train forward", logits,
                            plain(toks, types, S))
        ms = host_ms(lambda: m(toks, types, S), 3)
    del logits
    C = S + Tt
    pre, step = unilm_s2s.make_generate_fns(m, C)
    step = counted(step)
    gcfg = gen.GenerationConfig(beam_size=K, max_new_tokens=Tt, eos=NO_EOS,
                                pad=0, vocab_size=V)
    src = toks[:, :S]
    reset_counts()
    t0 = time.perf_counter()
    out, scores = gen.beam_generate(gcfg, pre, step, src)
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    launches_only(counts(), {"encoder_attention": L,
                             "decode_attention": L * step.calls},
                  f"unilm beam ({step.calls} steps)")
    add(counts())
    check(bool(torch.isfinite(scores).all()) and out.shape == (Bs, K, C),
          f"{name}: unilm beam {out.shape}")
    best = out[:, 0]

    def forced(model):  # the best beams teacher-forced, every step's logits
        pf, st = unilm_s2s.make_generate_fns(model, C)
        lg, cache = pf(best[:, :S], None)
        outs = [lg[:, -1:]]
        for i in range(S, C - 1):
            lg, cache = st(best[:, i:i + 1], cache, None)
            outs.append(lg)
        return torch.cat(outs, 1)

    with torch.no_grad():
        bt = logits_teacher("unilm beam (best beams forced)", forced(m),
                            forced(plain))
    phase(name, f"unilm_seq2seq_base: train forward over {S} + {Tt} tokens "
          f"at B={Bs}: {L} #3 (seq2seq bias) a forward, {ms:.2f} ms; logits "
          f"against the plain path {tf}; beam {K} over {Tt} tokens from the "
          f"{S}-token source: {L} #3 + {L} x {step.calls} #13, "
          f"{beam_s * 1e3:.1f} ms ({beam_s * 1e3 / Tt:.2f} ms/token); best "
          f"beams teacher-forced through both paths {bt}")
    nums["unilm_s2s"] = {"train_forward_ms": ms, "beam_ms": beam_s * 1e3,
                         "beam_steps": step.calls, "train_teacher": tf,
                         "beam_teacher": bt}
    del m, plain
    torch.cuda.empty_cache()

    # ---- xlmt_base and deltalm_base: beam 5 and a label-smoothed step ----
    Bn, Sn, new, K = REG_NMT
    for arch in ("xlmt_base", "deltalm_base"):
        cfg, m = build(arch, dtype=bf)
        V = cfg.vocab_size
        src = rng.randint(4, V, (Bn, Sn))
        for i, n in enumerate(rng.randint(Sn // 2, Sn + 1, Bn)):
            src[i, n:] = cfg.pad_id
        src = torch.from_numpy(src).to(dev)
        lang = torch.full((Bn, 1), V - 1, dtype=torch.int64, device=dev)
        pre, step = make_generate_fns(m, 1 + new)
        gcfg = gen.GenerationConfig(beam_size=K, max_new_tokens=new,
                                    eos=NO_EOS, pad=cfg.pad_id, vocab_size=V)
        reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            out, scores = gen.beam_generate(gcfg, pre, step, lang,
                                            m.encode(src))
        torch.cuda.synchronize()
        beam_s = time.perf_counter() - t0
        launches_only(counts(), {}, f"{arch} beam")
        check(bool(torch.isfinite(scores).all()), f"{name}: {arch} scores")
        tgt = torch.from_numpy(rng.randint(4, V, (Bn, REG_NMT_STEP + 1))
                               ).to(dev)
        batch = {"src": src, "tgt": tgt}

        def ls_loss(mm, b):
            s, n = criterions.label_smoothed_nll_loss(
                mm(b["src"], b["tgt"][:, :-1]), b["tgt"][:, 1:], 0.1,
                ignore_index=cfg.pad_id)
            return s / n, {}

        losses, tms = one_step(m, ls_loss, batch, {},
                               f"{arch} label-smoothed step")
        del m
        torch.cuda.empty_cache()
        _, m32 = build(arch)

        def one(model, d):
            r = np.random.RandomState(SEED + 1)
            s = torch.from_numpy(r.randint(4, V, (1, Sn))).to(d)
            p = torch.from_numpy(r.randint(4, V, (1, REG_NMT_STEP))).to(d)
            return model(s, p)

        e32 = card_vs_cpu(arch, m32, cpu_model(arch), one)
        phase(name, f"{arch}: beam {K} at B={Bn} over a {Sn}-token source, "
              f"{new} new tokens: no kernel launched (use_flash=False, as "
              f"JAX), {beam_s * 1e3:.1f} ms; label-smoothed step over "
              f"{REG_NMT_STEP} target tokens: no kernel, losses "
              f"{losses[0]:.4f}, {losses[1]:.4f}, {tms:.2f} ms/step; float32 "
              f"logits card against CPU rel L2 {e32:.2e} (tol {REG_FP32_REL})")
        nums[arch] = {"beam_ms": beam_s * 1e3, "step_ms": tms,
                      "losses": losses, "fp32_card_vs_cpu": e32}
        del m32
        torch.cuda.empty_cache()

    # ---- retnet_base: chunk-parallel, then recurrent ---------------------
    B, T, R = REG_RETNET
    cfg, m = build("retnet_base", dtype=bf)
    V = cfg.vocab_size
    toks = torch.from_numpy(rng.randint(0, V, (B, T + R))).to(dev)
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        _, states = m(toks[:, :T])
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        rec = []
        t0 = time.perf_counter()
        for i in range(T, T + R):
            lg, states = m(toks[:, i:i + 1], states,
                           torch.tensor([i], device=dev), "decode")
            rec.append(lg)
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
    launches_only(counts(), {}, "retnet forward and decode")
    with torch.no_grad():
        full = m(toks)[0][:, T:]
    rt = logits_teacher("retnet recurrent against parallel",
                        torch.cat(rec, 1), full)
    del m, full, rec
    torch.cuda.empty_cache()
    _, m32 = build("retnet_base")
    one = lambda model, d: model(torch.from_numpy(np.random.RandomState(
        SEED + 2).randint(0, V, (1, REG_CPU_T))).to(d))[0]
    e32 = card_vs_cpu("retnet_base", m32, cpu_model("retnet_base"), one)
    phase(name, f"retnet_base B={B}: chunk-parallel forward over {T} tokens "
          f"{fwd_s * 1e3:.1f} ms, then {R} recurrent tokens "
          f"{rec_s * 1e3 / R:.2f} ms/token; no kernel (JAX has none); "
          f"recurrent logits against the parallel form over the same "
          f"tokens {rt}; float32 card against CPU rel L2 {e32:.2e}")
    nums["retnet_base"] = {"forward_ms": fwd_s * 1e3,
                           "recurrent_ms_per_token": rec_s * 1e3 / R,
                           **rt, "fp32_card_vs_cpu": e32}
    del m32
    torch.cuda.empty_cache()

    # ---- diff_transformer_base -------------------------------------------
    B, T = REG_DIFF
    cfg, m = build("diff_transformer_base", dtype=bf)
    V = cfg.vocab_size
    toks = torch.from_numpy(rng.randint(0, V, (B, T))).to(dev)
    reset_counts()
    with torch.no_grad():
        lg = m(toks)
        torch.cuda.synchronize()
        launches_only(counts(), {}, "diff transformer forward")
        check(lg.shape == (B, T, V) and bool(torch.isfinite(lg).all()),
              f"{name}: diff logits {lg.shape}")
        ms = host_ms(lambda: m(toks), 2)
    del m, lg
    torch.cuda.empty_cache()
    _, m32 = build("diff_transformer_base")
    one = lambda model, d: model(torch.from_numpy(np.random.RandomState(
        SEED + 3).randint(0, V, (1, REG_CPU_T))).to(d))
    e32 = card_vs_cpu("diff_transformer_base", m32,
                      cpu_model("diff_transformer_base"), one)
    phase(name, f"diff_transformer_base forward B={B} x {T}: no kernel "
          f"(JAX computes it inline), {ms:.2f} ms, {B * T * 1e3 / ms:.0f} "
          f"tokens/s; float32 card against CPU rel L2 {e32:.2e}")
    nums["diff_transformer_base"] = {"forward_ms": ms,
                                     "fp32_card_vs_cpu": e32}
    del m32
    torch.cuda.empty_cache()
    return launches, {"registry_text": nums}


def phase_registry_speech(fa) -> tuple:
    """The speech models at full width (random weights from the seed):
    wavlm_base on 8 x 10 s of 16 kHz audio (499 frames; float32, as JAX's,
    no kernel; one example card against CPU); BEATs classification and
    tokenizer ids on 8 x 998 x 128 mel (496 patches: 12 #3 with the T5
    bias a forward; features by relative L2 and ids by agreement against
    the plain twin); SpeechT5 asr_forward on the same audio with 64
    target tokens (12 + 6 #3, 6 #5 or #1) and tts_forward over 64 text
    tokens and 100 decoder steps (200 mel frames); one SpeechLM pretrain
    step at REG_SPEECHLM (24 #3 + 24 #4, teacher at the initial weights);
    kosmos2(audio_tower="wavlm") at B=1: 10 s of audio through the tower
    and its resampler (1 #3), a 1 + 64 + 63-token prompt with the 64
    audio latents spliced, prefill (24 #5 or #1) then 16 greedy tokens
    (24 #13 a step), teacher-forced against the plain twin. Returns
    (launches, numbers)."""
    from unilm_tpu_torch.models import beats, kosmos, registry, speechlm
    from unilm_tpu_torch.models import speecht5
    from unilm_tpu_torch.runtime import optim, train
    from unilm_tpu_torch.runtime import generate as gen

    dev, bf, name = torch.device("cuda"), torch.bfloat16, "registry_speech"
    launches, nums = {}, {}
    seeded = lambda: torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.RandomState(SEED)

    def add(got):
        for k, v in got.items():
            if v:
                launches[k] = launches.get(k, 0) + v

    def pair(cls, cfg):
        m = cls(cfg, device=dev).init_weights(seeded()).eval()
        plain = cls(dataclasses.replace(cfg, use_flash=False), device=dev)
        plain.load_state_dict(m.state_dict())
        return m, plain.eval()

    def flash_kernel(B, H, T, D):  # the flash selector's counter name
        return ("onepass_attention" if fa.onepass_applies(B, H, T, T, D,
                                                          None, 0)
                else "flash_fwd")

    B, n = REG_AUDIO
    audio = torch.randn(B, n, generator=seeded(), device=dev)

    # ---- wavlm_base ------------------------------------------------------
    cfg, m = registry.build("wavlm_base", device=dev)
    m.init_weights(seeded()).eval()
    reset_counts()
    with torch.no_grad():
        feats = m(audio)
    torch.cuda.synchronize()
    launches_only(counts(), {}, "wavlm forward")
    frames = feats.shape[1]
    check(feats.shape == (B, 499, cfg.hidden_size)
          and bool(torch.isfinite(feats).all()), f"{name}: wavlm {feats.shape}")
    with torch.no_grad():
        ms = host_ms(lambda: m(audio), 2)
    one = lambda model, d: model(torch.from_numpy(np.random.RandomState(
        SEED + 4).randn(1, n).astype(np.float32)).to(d))
    e32 = card_vs_cpu("wavlm_base", m, lambda: registry.build(
        "wavlm_base", device="cpu")[1], one)
    phase(name, f"wavlm_base on {B} x {n / 16000:.0f} s of audio: {frames} "
          f"frames, float32 (as JAX), no kernel (JAX's plain attention with "
          f"the per-example gated bias); {ms:.2f} ms a batch; one example "
          f"card against CPU rel L2 {e32:.2e} (tol {REG_FP32_REL})")
    nums["wavlm_base"] = {"ms": ms, "frames": frames,
                          "fp32_card_vs_cpu": e32}
    del m, feats
    torch.cuda.empty_cache()

    # ---- BEATs -------------------------------------------------------------
    bcfg = beats.BEATsConfig(dtype=bf)
    L = bcfg.num_layers
    spec = torch.randn(*REG_MEL, generator=seeded(), device=dev)
    m, plain = pair(beats.BEATsForAudioClassification, bcfg)
    reset_counts()
    with torch.no_grad():
        logits = m(spec)
    torch.cuda.synchronize()
    launches_only(counts(), {"encoder_attention": L}, "beats classifier")
    add(counts())
    with torch.no_grad():
        fe = feature_teacher("beats features", m.beats(spec),
                             plain.beats(spec))
        le = rel_l2(logits, plain(spec))
        ms = host_ms(lambda: m(spec), 3)
        parts = profile_steps(lambda: m(spec), 1, REGISTRY_GROUPS)[0]
    del m, plain
    tok, ptok = pair(beats.BEATsTokenizer, bcfg)
    reset_counts()
    with torch.no_grad():
        ids = tok.get_codebook_indices(spec)
    torch.cuda.synchronize()
    launches_only(counts(), {"encoder_attention": L}, "beats tokenizer")
    add(counts())
    with torch.no_grad():
        agree = float((ids == ptok.get_codebook_indices(spec)).float().mean())
        before = tok.quantize.embedding.clone()
        tok(spec, update_ema=True)
        moved = not torch.equal(before, tok.quantize.embedding)
    check(ids.shape == (REG_MEL[0], 496) and agree >= VQKD_ID_AGREE
          and moved, f"{name}: beats ids {ids.shape}, agreement {agree}, "
          f"EMA moved {moved}")
    phase(name, f"BEATs on {REG_MEL[0]} x {REG_MEL[1]} x {REG_MEL[2]} mel "
          f"({ids.shape[1]} patches): {L} #3 (T5 bias) a forward, "
          f"classifier {ms:.2f} ms; encoder features rel L2 {fe:.3g} (tol "
          f"{REG_FEAT_REL_L2}), logits rel L2 {le:.3g}; tokenizer ids "
          f"agreement {agree:.4f} (tol {VQKD_ID_AGREE}), EMA buffers move "
          f"under update_ema; " + groups_line(parts, ms))
    nums["beats"] = {"ms": ms, "features_rel_l2": fe, "id_agreement": agree,
                     "device_ms": parts}
    del tok, ptok
    torch.cuda.empty_cache()

    # ---- SpeechT5 ----------------------------------------------------------
    scfg = speecht5.SpeechT5Config(dtype=bf)
    Le, Ld, H, D = scfg.enc_layers, scfg.dec_layers, scfg.num_heads, 64
    m, plain = pair(speecht5.SpeechT5Model, scfg)
    prev = torch.from_numpy(rng.randint(4, scfg.vocab_size,
                                        (B, REG_ASR_T))).to(dev)
    Tx, Td = REG_TTS
    text = torch.from_numpy(rng.randint(4, scfg.vocab_size, (B, Tx))).to(dev)
    mels = torch.randn(B, Td, scfg.mel_bins * scfg.reduction_factor,
                       generator=seeded(), device=dev)
    reset_counts()
    with torch.no_grad():
        logits = m.asr_forward(audio, prev)
    torch.cuda.synchronize()
    want = {"encoder_attention": Le + Ld,
            flash_kernel(B, H, REG_ASR_T, D): Ld}
    launches_only(counts(), want, "speecht5 asr_forward")
    add(counts())
    reset_counts()
    with torch.no_grad():
        mel_before, mel_after, stop = m.tts_forward(text, mels)
    torch.cuda.synchronize()
    want_tts = {"encoder_attention": Le + Ld, flash_kernel(B, H, Td, D): Ld}
    launches_only(counts(), want_tts, "speecht5 tts_forward")
    add(counts())
    with torch.no_grad():
        at = logits_teacher("speecht5 asr logits", logits,
                            plain.asr_forward(audio, prev))
        te = feature_teacher("speecht5 tts mel", mel_after,
                             plain.tts_forward(text, mels)[1])
        ms_asr = host_ms(lambda: m.asr_forward(audio, prev), 3)
        ms_tts = host_ms(lambda: m.tts_forward(text, mels), 3)
        parts = profile_steps(lambda: m.asr_forward(audio, prev), 1,
                              REGISTRY_GROUPS)[0]
    phase(name, f"SpeechT5 asr_forward on the {B} x 10 s audio, "
          f"{REG_ASR_T} target tokens: launches {want}; logits against the "
          f"plain path {at}; {ms_asr:.2f} ms; tts_forward over {Tx} text "
          f"tokens, {Td} decoder steps ({mel_after.shape[1]} mel frames): "
          f"launches {want_tts}; mel rel L2 {te:.3g}; {ms_tts:.2f} ms; asr "
          + groups_line(parts, ms_asr))
    nums["speecht5"] = {"asr_ms": ms_asr, "tts_ms": ms_tts, "asr": at,
                        "tts_mel_rel_l2": te, "asr_device_ms": parts}
    del m, plain, logits
    torch.cuda.empty_cache()

    # ---- one SpeechLM pretrain step -----------------------------------------
    lcfg = speechlm.SpeechLMConfig(dtype=bf)
    L = lcfg.num_layers
    Bl, nl, Tt = REG_SPEECHLM
    m, plain = pair(speechlm.SpeechLM, lcfg)
    a = torch.randn(Bl, nl, generator=seeded(), device=dev)
    with torch.no_grad():
        Ts = m.feature_extractor(a).shape[1]
    mask = torch.from_numpy(rng.rand(Bl, Ts) < 0.4).to(dev)
    tt = rng.randint(0, lcfg.text_vocab, (Bl, Tt))
    batch = {"audio": a, "mask": mask,
             "units": torch.from_numpy(rng.randint(0, lcfg.unit_vocab,
                                                   (Bl, Ts))).to(dev),
             "text": torch.from_numpy(tt).to(dev),
             "text_targets": torch.from_numpy(np.where(
                 rng.rand(Bl, Tt) < 0.3, tt, -100)).to(dev)}

    def slm_loss(mm, b):
        u, x = mm(b["audio"], b["mask"], b["text"])
        total, parts_ = speechlm.speechlm_pretrain_loss(
            u, b["units"], b["mask"], x, b["text_targets"])
        return total, parts_

    names = [k for k, p in m.named_parameters() if p.requires_grad]

    def fb(mm):
        loss = slm_loss(mm, batch)[0]
        return float(loss.detach()), torch.autograd.grad(
            loss, train.trainable(mm))

    c0 = counts()
    tk_ = fb(m)
    c1 = counts()
    tp_ = fb(plain)
    check(counts() == c1 and c1["encoder_attention_bwd"]
          - c0["encoder_attention_bwd"] == 2 * L,
          f"{name}: speechlm teacher launches")
    tch = grads_teacher("speechlm step", tk_, tp_, names,
                        skip=("k_proj.bias",))
    del plain, tk_, tp_
    tx = optim.AdamW(1e-4, weight_decay=0.01)
    state = train.TrainState.create(m, tx)
    step = train.make_train_step(slm_loss, tx, clip_grad_norm=1.0)
    torch.cuda.synchronize()
    reset_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    state, mt = step(state, batch)
    ev[1].record()
    torch.cuda.synchronize()
    launches_only(counts(), {"encoder_attention": 2 * L,
                             "encoder_attention_bwd": 2 * L},
                  "speechlm pretrain step")
    add(counts())
    loss = float(mt["loss"])
    check(np.isfinite(loss), f"{name}: speechlm loss {loss}")
    tms = ev[0].elapsed_time(ev[1])
    phase(name, f"SpeechLM pretrain step, {Bl} x {nl / 16000:.0f} s of audio "
          f"({Ts} frames, 40% masked) + {Bl} x {Tt} text tokens: {2 * L} #3 + "
          f"{2 * L} #4; loss {loss:.4f}; {tms:.2f} ms (the first step, CUDA "
          f"events); teacher at the initial weights: loss rel "
          f"{tch['loss_rel']:.2e}, grad norm rel {tch['norm_rel']:.2e}, min "
          f"cosine {tch['min_cos']:.5f} ({tch['worst']})")
    nums["speechlm"] = {"step_ms": tms, "loss": loss, "frames": Ts, **tch}
    del m, state, step, tx
    torch.cuda.empty_cache()

    # ---- kosmos2 with the WavLM audio tower -------------------------------
    n, Tt, new = REG_KOSMOS
    kcfg = kosmos.kosmos2(dtype=bf, audio_tower="wavlm")
    nq, L, H, D = (kcfg.audio_latent_query_num, kcfg.num_layers,
                   kcfg.num_heads, kcfg.embed_dim // kcfg.num_heads)
    m, plain = pair(kosmos.UniGPT, kcfg)
    P = 1 + nq + Tt - 1
    prompt = torch.from_numpy(rng.randint(4, 60000, (1, P))).to(dev)
    prompt[:, 0] = 0
    amask = torch.zeros(1, P, dtype=torch.bool, device=dev)
    amask[:, 1:1 + nq] = True
    a1 = audio[:1]
    C = P + new
    gcfg = gen.GenerationConfig(beam_size=1, max_new_tokens=new, eos=NO_EOS,
                                pad=PAD)

    def fns(model, feats):
        def pf(tokens, aux):
            return model.prefill(tokens, C, last_logit_only=True,
                                 aud_features=feats, aud_gpt_input_mask=amask)

        def st(tokens, cache, aux):
            return model.decode_step(tokens, cache, C)
        return pf, counted(st)

    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        feats = m.encode_audio(a1)
        pf, st = fns(m, feats)
        out, _ = gen.greedy_generate(gcfg, pf, st, prompt)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    want = {"encoder_attention": 1, flash_kernel(1, H, P, D): L,
            "decode_attention": L * st.calls}
    launches_only(counts(), want, f"kosmos2 audio ({st.calls} steps)")
    add(counts())

    def forced(model):
        with torch.no_grad():
            pf, stp = fns(model, model.encode_audio(a1))
            lg, cache = pf(prompt, None)
            outs = [lg]
            for i in range(P, C - 1):
                lg, cache = stp(out[:, i:i + 1], cache, None)
                outs.append(lg)
        return torch.cat(outs, 1)

    kt = logits_teacher("kosmos2 audio (generated tokens forced)", forced(m),
                        forced(plain))
    phase(name, f"kosmos2(audio_tower='wavlm') bf16, B=1: 10 s of audio -> "
          f"{nq} latents spliced into a {P}-token prompt, prefill then "
          f"{new} greedy tokens: launches {want}; {gen_s * 1e3:.1f} ms from "
          f"the audio to the last token; generated tokens teacher-forced "
          f"through both paths {kt}")
    nums["kosmos2_audio"] = {"ms": gen_s * 1e3, "steps": st.calls, **kt}
    del m, plain
    torch.cuda.empty_cache()
    return launches, {"registry_speech": nums}


# ---- the detection / segmentation slice --------------------------------
# DiT-B / BEiT-B at full width (768 wide, 12 layers, 12 heads; random
# weights from the seed). rcnn: cascade_dit_base at 800 px (abs positions,
# no bias: 2501 tokens, past #3's 2048, so #1 and #6 / #7), B=2; fcos: the
# dit and layoutlmv3 presets at 512 px (1025 tokens: #3 / #4, the dit
# preset with its per-layer [1, 12, 1025, 1025] bias), B=8; segmentation:
# BEiT-B UperNet at 512 px, ADE20K's 150 classes, B=4.
DET_RCNN = (2, 800)
DET_FCOS = (8, 512)
DET_SEG = (4, 512, 150)
DET_DEV = "cuda"  # where the phases run (a rehearsal on the CPU sets "cpu")
# Teachers, the kernel path against the plain path (use_flash=False) on the
# same weights and inputs, both float32: the trunk's taps at the fp32
# kernels' relative L2 1e-4; eval logits, scores and boxes (relative to the
# image size) at the fp32 eval bound of layoutlmv3_eval (LV3_EVAL_LOGIT_ATOL,
# 4e-5); discrete outputs (kept proposals, classes, pixel argmax) agreeing
# at DET_AGREE; one train batch's loss, grad norm and gradient cosines at
# the layoutlmv3_train bounds (LV3_TEACHER_*). bf16 rcnn eval: the FPN
# features at relative L2 DET_BF16_FEAT_REL (REG_FEAT_REL_L2).
DET_FP32_REL = 1e-4
DET_AGREE = 0.99
DET_BF16_FEAT_REL = 2e-2
# a step's device time by kernel group: the first group whose substrings
# match a kernel's name takes it (cuDNN's implicit-gemm convolutions carry
# "xmma" / "cutlass" too, so "conv" comes before "cuBLAS")
DET_GROUPS = [("#1", ["flash_fwd"]), ("#6", ["flash_bwd_dq"]),
              ("#7", ["flash_bwd_dkv"]), ("#3", [ENCODER_ONLY]),
              ("#4", [ENC_BWD_ONLY]),
              ("conv", ["conv", "cudnn", "implicit", "winograd", "dgrad",
                        "wgrad", "fprop"]),
              ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet", "cublas",
                          "splitK"]),
              ("gather/scatter", ["index", "gather", "scatter"]),
              ("sort/top-k", ["sort", "radix", "topk"])]


def det_args(module, argv: list):
    """The parsed arguments of a detection / segmentation CLI."""
    return module.build_parser().parse_args(argv + ["--device", DET_DEV])


def phase_detection_kernels(fa, g, dev: str = "cuda") -> dict:
    """The slice's kernels alone at its shapes against their plain
    versions, fp32 (relative L2 1e-4) and bf16 (1e-2), gradients by
    grad_close: #1 and #6 / #7 at rcnn's 2x2501x12x64 (non-causal, no mask:
    2501 = 19 x 128 + 69, ragged last tiles), #3 / #4 at fcos's
    8x1025x12x64 with the [1, 12, 1025, 1025] bias (dbias summed over the
    batch) and without. Each timed as device time beside its plain
    version, sdpa (with the float bias; its backward for #4 and #6 / #7)
    and the bound. Returns {kernel name: {"detection": {...}}}."""
    name, H, D = "detection_kernels", 12, 64
    rn = functools.partial(randn, g, dev=dev)
    line = functools.partial(kernel_line, name)
    k1, k67, k3, k4 = {}, {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        kind = "fp32" if dtype == torch.float32 else "bf16"
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        B, S = DET_RCNN[0], (DET_RCNN[1] // 16) ** 2 + 1
        q = rn(B, S, H, D, dtype=dtype) * D ** -0.5
        k, v, do = (rn(B, S, H, D, dtype=dtype) for _ in range(3))
        out, lse = fa.flash_forward(q, k, v)
        ref, rlse = fa.flash_forward_plain(q, k, v)
        torch.cuda.synchronize()
        e, le = rel_l2(out, ref), float((lse - rlse).abs().max())
        check(bool(torch.isfinite(out.float()).all()) and e <= tol
              and le <= LSE_ATOL, f"{name}: #1 {tag} rel L2 {e} (bound "
              f"{tol}), lse max|err| {le}")
        pairs = B * H * S * S
        r = k1[f"rcnn_{tag}"] = {
            "shape": f"{B}x{S}x{S}x{H}x{D} {tag}, non-causal, no mask",
            "rel_l2": e, "library": "sdpa",
            "max_abs_err": float((out.float() - ref.float()).abs().max()),
            **kernel_timed(lambda: fa.flash_forward(q, k, v),
                           lambda: fa.flash_forward_plain(q, k, v),
                           lambda: sdpa(q, k, v, scale=1.0), "flash_fwd",
                           attn_bound(pairs, D, 2, q, k, v, out, lse,
                                      kind=kind))}
        line(f"#1 rcnn {tag}", r, tol)
        got = fa.flash_backward(q, k, v, None, None, 0, None, out, lse, do)
        want = fa.flash_backward_plain(q, k, v, None, None, 0, None, out,
                                       lse, do)
        torch.cuda.synchronize()
        worst_rel = worst_abs = 0.0
        for gname, x, rr in zip(("dq", "dk", "dv"), got, want):
            ok, ea, er = grad_close(x, rr, tol)
            check(bool(torch.isfinite(x.float()).all()) and ok,
                  f"{name}: #6/#7 {tag} {gname} max|err| {ea} rel L2 {er}")
            worst_rel, worst_abs = max(worst_rel, er), max(worst_abs, ea)
        qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
        o = sdpa(qg, kg, vg, scale=1.0)
        lib = lambda: torch.autograd.grad(o, (qg, kg, vg), do.transpose(1, 2),
                                          retain_graph=True)
        bwd = lambda: fa.flash_backward(q, k, v, None, None, 0, None, out,
                                        lse, do)
        lib_ms = device_ms(lib)
        plain_ms = device_ms(lambda: fa.flash_backward_plain(
            q, k, v, None, None, 0, None, out, lse, do), iters=3)
        # phase_flash_bwd's counts (flash_bwd_bounds)
        for kname, bd in zip(("flash_bwd_dq", "flash_bwd_dkv"),
                             flash_bwd_bounds(pairs, q, k, v, do, lse, None,
                                              *got[:3], kind=kind)):
            r = k67.setdefault(kname, {})[f"rcnn_{tag}"] = {
                "shape": f"{B}x{S}x{S}x{H}x{D} {tag}, non-causal, on #1's "
                "out/lse", "rel_l2": worst_rel, "max_abs_err": worst_abs,
                "library": f"sdpa backward ({type(o.grad_fn).__name__}), "
                "the whole dq/dk/dv", "library_ms": lib_ms,
                "plain_ms": plain_ms, "ms": device_ms(bwd, only=kname),
                **bd}
            line(f"#{6 if kname.endswith('dq') else 7} rcnn {tag}", r, tol)
        del q, k, v, do, out, lse, ref, rlse, got, want, o, qg, kg, vg

        B, S = DET_FCOS[0], (DET_FCOS[1] // 16) ** 2 + 1
        for key, bias in (("fcos_bias", rn(1, H, S, S, dtype=dtype)),
                          ("layoutlmv3", None)):
            q, k, v, do = (rn(B, S, H, D, dtype=dtype) for _ in range(4))
            out = fa.fused_encoder_attention(q, k, v, bias=bias)
            ref = fa.fused_encoder_attention_plain(q, k, v, bias)
            torch.cuda.synchronize()
            e = rel_l2(out, ref)
            check(bool(torch.isfinite(out.float()).all()) and e <= tol,
                  f"{name}: #3 {key} {tag} rel L2 {e} (bound {tol})")
            desc = (f"{B}x{S}x{S}x{H}x{D} {tag}, "
                    + ("bias [1,12,1025,1025]" if bias is not None
                       else "no bias"))
            pairs = B * H * S * S
            r = k3[f"{key}_{tag}"] = {
                "shape": desc, "rel_l2": e, "library": "sdpa"
                + (" (float bias)" if bias is not None else ""),
                "max_abs_err": float((out.float() - ref.float()).abs().max()),
                **kernel_timed(
                    lambda: fa.fused_encoder_attention(q, k, v, bias=bias),
                    lambda: fa.fused_encoder_attention_plain(q, k, v, bias),
                    lambda: sdpa(q, k, v, attn_mask=bias), ENCODER_ONLY,
                    attn_bound(pairs, D, 2, q, k, v, out, bias, kind=kind))}
            line(f"#3 {key} {tag}", r, tol)
            got = fa.fused_encoder_backward(q, k, v, bias, do)
            want = fa.fused_encoder_backward_plain(q, k, v, bias, do)
            torch.cuda.synchronize()
            worst_rel = worst_abs = 0.0
            for gname, x, rr in zip(("dq", "dk", "dv", "dbias"), got, want):
                if rr is None:
                    continue
                ok, ea, er = grad_close(x, rr, tol)
                check(bool(torch.isfinite(x.float()).all()) and ok,
                      f"{name}: #4 {key} {tag} {gname} max|err| {ea} rel L2 "
                      f"{er}")
                worst_rel, worst_abs = max(worst_rel, er), max(worst_abs, ea)
            ins = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            bg = None if bias is None else bias.detach().clone(
                ).requires_grad_()
            o = sdpa(*ins, attn_mask=bg)
            ins = ins + ([bg] if bg is not None else [])
            r = k4[f"{key}_{tag}"] = {
                "shape": desc + ", dq/dk/dv" + ("/dbias" if bias is not None
                                                else ""),
                "rel_l2": worst_rel, "max_abs_err": worst_abs,
                "library": f"sdpa backward ({type(o.grad_fn).__name__})",
                **kernel_timed(
                    lambda: fa.fused_encoder_backward(q, k, v, bias, do),
                    lambda: fa.fused_encoder_backward_plain(q, k, v, bias,
                                                            do),
                    lambda: torch.autograd.grad(o, ins, do.transpose(1, 2),
                                                retain_graph=True),
                    ENC_BWD_ONLY,
                    attn_bound(pairs, D, 5, q, k, v, do, bias, *got,
                               kind=kind))}
            line(f"#4 {key} {tag}", r, tol)
            del q, k, v, do, out, ref, got, want, o, ins, bg
        torch.cuda.empty_cache()
    return {"flash_fwd": {"detection": k1},
            "flash_bwd_dq": {"detection": k67["flash_bwd_dq"]},
            "flash_bwd_dkv": {"detection": k67["flash_bwd_dkv"]},
            "encoder_attention": {"detection": k3},
            "encoder_attention_bwd": {"detection": k4}}


def det_plain(model, cls, cfg_of):
    """The same weights (shared, assign=True) on the plain path: the
    model's config with the trunk's use_flash=False."""
    cfg = cfg_of(model.cfg)
    plain = cls(cfg, device=DET_DEV).eval()
    plain.load_state_dict(model.state_dict(), strict=True, assign=True)
    return plain


def det_grads(model, loss_fn) -> tuple:
    """(loss, [grad] over the trainable parameters, names) of loss_fn(model)
    by torch.autograd.grad (parameters a plain twin shares keep no .grad);
    a parameter the loss does not reach has a zero gradient."""
    names, params = zip(*[(n, p) for n, p in model.named_parameters()
                          if p.requires_grad])
    loss = loss_fn(model)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if gr is None else gr
             for p, gr in zip(params, grads)]
    return float(loss.detach()), grads, list(names)


def det_train_teacher(label: str, model, plain, loss_fn) -> dict:
    """One batch's loss and gradients, kernel path against plain path, at
    the layoutlmv3_train bounds (key biases by the norm only; parameters
    the loss does not reach on either path, as rcnn's mask head without
    gt masks, are left out of the cosines and counted)."""
    lk, gk, names = det_grads(model, loss_fn)
    lp, gp, _ = det_grads(plain, loss_fn)
    reached = [i for i, (a, b) in enumerate(zip(gk, gp))
               if bool(a.any()) or bool(b.any())]
    r = grads_teacher(label, (lk, [gk[i] for i in reached]),
                      (lp, [gp[i] for i in reached]),
                      [names[i] for i in reached],
                      (LV3_TEACHER_LOSS_REL, LV3_TEACHER_NORM_REL,
                       LV3_TEACHER_COS), skip=("k_proj.bias",))
    r["unreached"] = len(names) - len(reached)
    return r


def det_profile(fn, label: str) -> str:
    """fn() once under the profiler: its device time by DET_GROUPS beside
    its host time (one synchronised call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    host = (time.time() - t0) * 1e3
    parts = device_time_shares(prof, DET_GROUPS)
    return f"{label}: " + groups_line(parts, host), parts, host


def det_match(a: dict, b: dict, img: int) -> dict:
    """Greedy match of two sets of detections of one image (boxes, scores,
    classes over the valid slots): a pair has the same class and IoU >=
    0.99. Returns the matched fraction of each side and the matched pairs'
    max |dscore| and max |dbox| / img."""
    from unilm_tpu_torch.models.rcnn import box_iou

    iou = box_iou(a["boxes"], b["boxes"])
    iou = torch.where(a["classes"][:, None] == b["classes"][None, :], iou,
                      0.0)
    pairs, used = [], set()
    for i in torch.argsort(-a["scores"]).tolist():
        row = iou[i].clone()
        if used:
            row[list(used)] = 0.0
        j = int(row.argmax()) if row.numel() else -1
        if j >= 0 and float(row[j]) >= 0.99:
            pairs.append((i, j))
            used.add(j)
    n = len(pairs)
    ia = torch.tensor([p[0] for p in pairs], dtype=torch.long)
    ib = torch.tensor([p[1] for p in pairs], dtype=torch.long)
    ds = float((a["scores"][ia] - b["scores"][ib]).abs().max()) if n else 0.0
    db = (float((a["boxes"][ia] - b["boxes"][ib]).abs().max()) / img
          if n else 0.0)
    return {"matched_a": n / max(len(a["scores"]), 1),
            "matched_b": n / max(len(b["scores"]), 1),
            "max_dscore": ds, "max_dbox_rel": db, "pairs": n}


def det_valid(out: dict, i: int) -> dict:
    m = out["valid"][i]
    return {k: out[k][i][m].float().cpu() if k != "classes"
            else out[k][i][m].cpu() for k in ("boxes", "scores", "classes")}


def synthetic_d2_state_dict(cfg, seed: int, dev: str = "cuda") -> dict:
    """A detectron2-layout Cascade/Mask R-CNN state dict of cfg's shapes
    (the layout convert/detection.py reads; tests/test_rcnn.py's
    build_synthetic_sd, drawn on the card): N(0, 0.02^2) weights, norm
    and BN scales 1 + N(0, 0.02^2), BN running variances 1 + U(0, 0.5)."""
    E, C, F = cfg.beit.embed_dim, cfg.fpn_channels, cfg.beit.ffn_dim
    A, ncls, fc = cfg.num_anchors, cfg.num_classes, cfg.fc_dim
    ps, r = cfg.beit.patch_size, cfg.pooler_resolution
    g = torch.Generator(device=dev).manual_seed(seed)

    def t(*shape):
        return torch.randn(*shape, generator=g, device=dev) * 0.02

    sd, V = {}, "backbone.bottom_up.backbone"
    sd[f"{V}.cls_token"] = t(1, 1, E)
    sd[f"{V}.pos_embed"] = t(1, cfg.beit.num_patches + 1, E)
    sd[f"{V}.patch_embed.proj.weight"] = t(E, 3, ps, ps)
    sd[f"{V}.patch_embed.proj.bias"] = t(E)
    for i in range(cfg.beit.num_layers):
        p = f"{V}.blocks.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{p}.{n}.weight"] = 1.0 + t(E)
            sd[f"{p}.{n}.bias"] = t(E)
        sd[f"{p}.attn.qkv.weight"] = t(3 * E, E)
        sd[f"{p}.attn.q_bias"], sd[f"{p}.attn.v_bias"] = t(E), t(E)
        sd[f"{p}.attn.proj.weight"], sd[f"{p}.attn.proj.bias"] = t(E, E), t(E)
        sd[f"{p}.mlp.fc1.weight"], sd[f"{p}.mlp.fc1.bias"] = t(F, E), t(F)
        sd[f"{p}.mlp.fc2.weight"], sd[f"{p}.mlp.fc2.bias"] = t(E, F), t(E)
        sd[f"{p}.gamma_1"], sd[f"{p}.gamma_2"] = t(E), t(E)
    for n in ("fpn1.0", "fpn1.3", "fpn2.0"):
        sd[f"{V}.{n}.weight"], sd[f"{V}.{n}.bias"] = t(E, E, 2, 2), t(E)
    sd[f"{V}.fpn1.1.weight"], sd[f"{V}.fpn1.1.bias"] = 1.0 + t(E), t(E)
    sd[f"{V}.fpn1.1.running_mean"] = t(E)
    sd[f"{V}.fpn1.1.running_var"] = 1.0 + 0.5 * torch.rand(
        E, generator=g, device=dev)
    for lvl in range(2, 6):
        sd[f"backbone.fpn_lateral{lvl}.weight"] = t(C, E, 1, 1)
        sd[f"backbone.fpn_lateral{lvl}.bias"] = t(C)
        sd[f"backbone.fpn_output{lvl}.weight"] = t(C, C, 3, 3)
        sd[f"backbone.fpn_output{lvl}.bias"] = t(C)
    R = "proposal_generator.rpn_head"
    for n, o, k in (("conv", C, 3), ("objectness_logits", A, 1),
                    ("anchor_deltas", 4 * A, 1)):
        sd[f"{R}.{n}.weight"], sd[f"{R}.{n}.bias"] = t(o, C, k, k), t(o)
    for k in range(len(cfg.cascade_ious)):
        h, p = f"roi_heads.box_head.{k}", f"roi_heads.box_predictor.{k}"
        sd[f"{h}.fc1.weight"], sd[f"{h}.fc1.bias"] = t(fc, C * r * r), t(fc)
        sd[f"{h}.fc2.weight"], sd[f"{h}.fc2.bias"] = t(fc, fc), t(fc)
        sd[f"{p}.cls_score.weight"] = t(ncls + 1, fc)
        sd[f"{p}.cls_score.bias"] = t(ncls + 1)
        sd[f"{p}.bbox_pred.weight"], sd[f"{p}.bbox_pred.bias"] = t(4, fc), t(4)
    M = "roi_heads.mask_head"
    for i in range(1, 5):
        sd[f"{M}.mask_fcn{i}.weight"] = t(C, C, 3, 3)
        sd[f"{M}.mask_fcn{i}.bias"] = t(C)
    sd[f"{M}.deconv.weight"], sd[f"{M}.deconv.bias"] = t(C, C, 2, 2), t(C)
    sd[f"{M}.predictor.weight"] = t(ncls, C, 1, 1)
    sd[f"{M}.predictor.bias"] = t(ncls)
    return sd


def rcnn_stage_times(model, x) -> tuple:
    """Each part of one eval forward, composed part by part as
    CascadeRCNN.forward composes them and timed alone: ({part: device
    time}, {part: CUDA events}) in ms. The parts: the trunk
    (DetectionViT), the FPN, RPN + NMS (propose), the three stages'
    RoIAlign and box heads, the post-processing NMS, the mask RoIAlign and
    the mask head. device_ms sums the kernels a trace kept (CUPTI can lose
    every record of a kernel name, so a part may read low); the CUDA
    events span the part's kernels and the idle gaps between them (an
    upper bound)."""
    from unilm_tpu_torch.models.rcnn import apply_deltas, clip_boxes

    cfg = model.cfg
    out, events = {}, {}

    def part(key, fn):
        out[key] = out.get(key, 0.0) + device_ms(fn, iters=3)
        events[key] = events.get(key, 0.0) + cuda_ms(fn, iters=3, warmup=1)
        return fn()

    with torch.no_grad():
        c = part("trunk", lambda: model.vit(x))
        feats = part("fpn", lambda: model.fpn(c))
        boxes, sc = part("rpn+nms", lambda: model.propose(feats))
        B, P = boxes.shape[:2]
        probs = []
        for k in range(len(cfg.cascade_ious)):
            pooled = part("roialign", lambda: model.pool(
                feats, boxes, cfg.pooler_resolution))
            flat = pooled.reshape(B * P, *pooled.shape[2:])
            cls, dlt = part("box heads", lambda: getattr(
                model, f"box_predictor_{k}")(getattr(
                    model, f"box_head_{k}")(flat)))
            probs.append(torch.softmax(cls.reshape(B, P, -1), -1))
            boxes = clip_boxes(apply_deltas(
                dlt.reshape(B, P, 4), boxes, cfg.cascade_weights[k]),
                (cfg.img_size, cfg.img_size))
        scores = torch.where(torch.isfinite(sc)[..., None],
                             (sum(probs) / len(probs))[..., :-1], 0.0)
        db, _, dc, _ = part("postprocess nms",
                            lambda: model.postprocess(boxes, scores))
        pooled = part("mask roialign", lambda: model.pool(
            feats, db, cfg.mask_pooler_resolution))
        part("mask head", lambda: model.mask_head(
            pooled.reshape(B * dc.shape[1], *pooled.shape[2:])))
    return out, events


def phase_rcnn() -> tuple:
    """Cascade/Mask R-CNN at cascade_dit_base(img_size=800, num_classes=5)
    with mask_on: the port's convert_rcnn on a synthetic detectron2 state
    dict of full width (a strict load); eval at B=2 in float32 (exactly 12
    #1 a forward and nothing else; images/s, proposals/s, the NMS sweeps,
    each part's device time) against the plain path (taps, kept proposals,
    matched detections' scores and boxes, masks); the same in bf16 (the
    trunk bf16, #1's wgmma body; the FPN features against the plain path);
    then cli/train_detection.main --head rcnn --synthetic --img-size 800
    --batch-size 2 --steps 2 --eval (exactly 12 #1 + 12 #6 + 12 #7 a step,
    12 #1 an eval batch); one train batch's loss and gradients against the
    plain path; ms/step and a step's device time by group."""
    from unilm_tpu_torch.cli import train_detection as cli
    from unilm_tpu_torch.convert.detection import convert_rcnn
    from unilm_tpu_torch.data.detection import (pad_batch,
                                                synthetic_detection_dataset)
    from unilm_tpu_torch.models import rcnn

    name = "rcnn"
    B, img = DET_RCNN
    cfg = rcnn.cascade_dit_base(img_size=img, num_classes=5)
    t0 = time.time()
    sd = synthetic_d2_state_dict(cfg, SEED, DET_DEV)
    model = rcnn.CascadeRCNN(cfg, device=DET_DEV).eval()
    model.load_state_dict(convert_rcnn(sd, cfg), strict=True)
    del sd
    n_params = sum(p.numel() for p in model.parameters())
    phase(name, f"cascade_dit_base({img} px, 5 classes, mask_on): "
          f"{n_params / 1e6:.1f} M params from a synthetic detectron2 state "
          f"dict through convert_rcnn (strict load) in {time.time() - t0:.1f} s")
    data = synthetic_detection_dataset(B, img_size=img, num_classes=5,
                                       seed=SEED)
    x = torch.from_numpy(pad_batch(data)["images"]).to(DET_DEV)
    as_plain = lambda c: dataclasses.replace(
        c, beit=dataclasses.replace(c.beit, use_flash=False))
    plain = det_plain(model, rcnn.CascadeRCNN, as_plain)
    def as_bf16(flash):
        return lambda c: dataclasses.replace(c, beit=dataclasses.replace(
            c.beit, dtype=torch.bfloat16, use_flash=flash))

    nums = {}
    for tag, m, pm in (
            ("fp32", model, plain),
            ("bf16", det_plain(model, rcnn.CascadeRCNN, as_bf16(True)),
             det_plain(model, rcnn.CascadeRCNN, as_bf16(False)))):
        with torch.no_grad():
            m(x)  # warm
            torch.cuda.synchronize()
            reset_counts()
            rcnn.reset_nms_stats()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.time()
            out = m(x)
            torch.cuda.synchronize()
            host = (time.time() - t1) * 1e3
            got = counts()
            sweeps = dict(rcnn.NMS_STATS)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            launches_only(got, {"flash_fwd": 12}, f"{tag} eval forward")
            ref = pm(x)
            P = out["proposals"].shape[1]
            live = torch.isfinite(out["proposal_scores"])
            # kept proposals: a kernel-path proposal agrees where the plain
            # path kept a box within IoU 0.999 of it
            agree = []
            for i in range(B):
                a = out["proposals"][i][live[i]]
                bref = ref["proposals"][i][torch.isfinite(
                    ref["proposal_scores"][i])]
                iou = rcnn.box_iou(a, bref)
                agree.append(float((iou.max(1).values >= 0.999).float().mean()))
            kept = min(agree)
            r = {"ms_eval_host": host, "img_per_s": B / host * 1e3,
                 "proposals_per_s": B * P / host * 1e3,
                 "nms_calls": sweeps["calls"], "nms_sweeps": sweeps["sweeps"],
                 "nms_max_sweeps": sweeps["max_sweeps"], "peak_gib": peak,
                 "kept_proposals_agree": kept}
            if tag == "fp32":
                taps = [rel_l2(a, b) for a, b in zip(m.vit.taps(x),
                                                     pm.vit.taps(x))]
                check(max(taps) <= DET_FP32_REL,
                      f"{name}: fp32 taps rel L2 {taps} (bound {DET_FP32_REL})")
                match = [det_match(det_valid(out, i), det_valid(ref, i), img)
                         for i in range(B)]
                ma = min(min(mm["matched_a"], mm["matched_b"]) for mm in match)
                ds = max(mm["max_dscore"] for mm in match)
                db = max(mm["max_dbox_rel"] for mm in match)
                cls_agree = float((out["classes"] == ref["classes"]).float().mean())
                mask_err = float((out["masks"] - ref["masks"]).abs().max())
                check(kept >= DET_AGREE and ma >= DET_AGREE
                      and ds <= LV3_EVAL_LOGIT_ATOL
                      and db <= LV3_EVAL_LOGIT_ATOL,
                      f"{name}: fp32 teacher: kept proposals {kept}, matched "
                      f"detections {ma} (bound {DET_AGREE}), max |dscore| "
                      f"{ds}, max |dbox| / img {db} (bound "
                      f"{LV3_EVAL_LOGIT_ATOL})")
                r.update(taps_rel_l2=max(taps), matched=ma, max_dscore=ds,
                         max_dbox_rel=db, classes_agree_by_slot=cls_agree,
                         masks_max_err=mask_err,
                         detections=int(out["valid"].sum()))
                msg = (f"taps rel L2 {max(taps):.3g} (bound {DET_FP32_REL}); "
                       f"matched detections {ma:.4f} of "
                       f"{int(out['valid'].sum())}, max |dscore| {ds:.3g}, "
                       f"max |dbox| / {img} px {db:.3g} (bound "
                       f"{LV3_EVAL_LOGIT_ATOL}); classes slot by slot "
                       f"{cls_agree:.4f}; masks max|err| {mask_err:.3g}")
            else:
                fk, fp = m.features(x), pm.features(x)
                e = max(rel_l2(fk[k], fp[k]) for k in fk)
                check(e <= DET_BF16_FEAT_REL,
                      f"{name}: bf16 FPN features rel L2 {e} (bound "
                      f"{DET_BF16_FEAT_REL})")
                r["features_rel_l2"] = e
                msg = (f"FPN features rel L2 {e:.3g} (bound "
                       f"{DET_BF16_FEAT_REL})")
            plain_host = host_ms(lambda: pm(x), 2)
            r["ms_eval_plain_host"] = plain_host
        nums[tag] = r
        phase(name, f"eval {tag} B={B}: {host:.1f} ms (host clock; plain "
              f"path {plain_host:.1f}), {r['img_per_s']:.2f} img/s, "
              f"{r['proposals_per_s']:.0f} proposals/s ({P} a image); "
              f"launches {got}; NMS {sweeps['calls']} calls, "
              f"{sweeps['sweeps']} sweeps (most in one call "
              f"{sweeps['max_sweeps']}); kept proposals agree {kept:.4f}; "
              f"{msg}; peak {peak:.2f} GiB")
        del out, ref
    parts, events = rcnn_stage_times(model, x)
    nums["fp32"].update(part_device_ms=parts, part_event_ms=events)
    phase(name, "eval fp32 by part, device time / CUDA events (ms): "
          + ", ".join(f"{k} {v:.2f} / {events[k]:.2f}"
                      for k, v in parts.items()))
    del plain, x
    torch.cuda.empty_cache()

    argv = ["--head", "rcnn", "--synthetic", "--img-size", str(img),
            "--batch-size", str(B), "--steps", "2", "--eval"]
    reset_counts()
    rcnn.reset_nms_stats()
    t1 = time.time()
    _, res = cli.main(argv + ["--device", DET_DEV])
    wall = time.time() - t1
    got = counts()
    n_eval = -(-max(8, 64 // 4) // B)
    launches_only(got, {"flash_fwd": 12 * (2 + n_eval), "flash_bwd_dq": 24,
                        "flash_bwd_dkv": 24}, "train_detection --head rcnn")
    check(all(np.isfinite(v) for v in res.values()),
          f"{name}: eval metrics {res}")
    nums["cli"] = {"s": wall, "nms": dict(rcnn.NMS_STATS), **res}
    phase(name, f"cli.train_detection.main({' '.join(argv)}): {wall:.1f} s, "
          f"launches {got} (12 #1 + 12 #6 + 12 #7 a step, 12 #1 for each of "
          f"{n_eval} eval batches); NMS {rcnn.NMS_STATS}; mAP "
          f"{res['mAP']:.4f}")
    launches = got

    tr = cli.build_trainer(det_args(cli, argv))
    batch = next(iter(cli.batches(tr.train_data, B, max_boxes=64)))
    batch = {**cli.to_device(batch, tr.device), "step": 0}
    plain = det_plain(tr.model, rcnn.CascadeRCNN, as_plain)
    lf = cli.make_loss_fn(det_args(cli, argv), tr.cfg, tr.device)
    loss_fn = lambda m: lf(m, batch)[0]
    teach = det_train_teacher("train fp32", tr.model, plain, loss_fn)
    del plain
    torch.cuda.empty_cache()
    nums["train_teacher"] = teach
    state = tr.state
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t1 = time.time()
        state, mt = tr.step(state, {**batch, "step": i})
        torch.cuda.synchronize()
        times.append((time.time() - t1) * 1e3)
        check(np.isfinite(float(mt["loss"])), f"{name}: step {i} {mt}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    line, parts, host = det_profile(lambda: tr.step(state, {**batch, "step": 3}),
                                    "a profiled step")
    nums["train"] = {"ms_per_step_host": float(np.mean(times[1:])),
                     "peak_gib": peak, "device_ms_by_group": parts}
    phase(name, f"train fp32 B={B}: {np.mean(times[1:]):.1f} ms/step (host "
          f"clock, steps 2-3; step 1 {times[0]:.1f}), peak {peak:.2f} GiB; "
          f"teacher loss rel {teach['loss_rel']:.3g}, grad norm rel "
          f"{teach['norm_rel']:.3g}, min cosine {teach['min_cos']:.6f} "
          f"({teach['worst']}); {line}")
    del tr, state
    torch.cuda.empty_cache()
    return launches, {"rcnn": nums}


def phase_fcos() -> tuple:
    """cli/train_detection.main --head fcos --synthetic --img-size 512
    --batch-size 8 --steps 3 --eval, with --preset dit (per-layer rel-pos
    bias: exactly 12 #3 + 12 #4 a step, 12 #3 an eval batch) and
    --preset layoutlmv3 (no bias: the same counts); for each preset one
    batch's eval logits against the plain path (LV3_EVAL_LOGIT_ATOL), the
    decoded detections matched (DET_AGREE), one train batch's loss and
    gradients against the plain path, ms/step, img/s, peak memory and a
    step's device time by group."""
    from unilm_tpu_torch.cli import train_detection as cli
    from unilm_tpu_torch.models import detection_head as dh

    name = "fcos"
    B, img = DET_FCOS
    launches, nums = {}, {}
    for preset in ("dit", "layoutlmv3"):
        argv = ["--head", "fcos", "--preset", preset, "--synthetic",
                "--img-size", str(img), "--batch-size", str(B), "--steps",
                "3", "--eval"]
        reset_counts()
        t1 = time.time()
        _, res = cli.main(argv + ["--device", DET_DEV])
        wall = time.time() - t1
        got = counts()
        n_eval = -(-max(8, 64 // 4) // B)
        launches_only(got, {"encoder_attention": 12 * (3 + n_eval),
                            "encoder_attention_bwd": 36},
                      f"train_detection --preset {preset}")
        check(all(np.isfinite(v) for v in res.values()),
              f"{name}: eval metrics {res}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        phase(name, f"cli.train_detection.main({' '.join(argv)}): "
              f"{wall:.1f} s, launches {got}; mAP {res['mAP']:.4f}")

        tr = cli.build_trainer(det_args(cli, argv))
        batch = next(iter(cli.batches(tr.train_data, B, max_boxes=64)))
        batch = cli.to_device(batch, tr.device)
        as_plain = lambda c: dataclasses.replace(c, backbone=dataclasses.replace(
            c.backbone, beit=dataclasses.replace(c.backbone.beit,
                                                 use_flash=False)))
        plain = det_plain(tr.model, dh.FCOSDetector, as_plain)
        tr.model.eval()
        with torch.no_grad():
            ok_, op_ = tr.model(batch["images"]), plain(batch["images"])
            err = max(float((ok_[k] - op_[k]).abs().max())
                      for k in ("logits", "ctr"))
            rreg = rel_l2(ok_["reg"], op_["reg"])
            dk = dh.decode_detections(ok_, img_size=float(img))
            dp = dh.decode_detections(op_, img_size=float(img))
        keys = ("boxes", "scores", "classes", "valid")
        dk, dp = dict(zip(keys, dk)), dict(zip(keys, dp))
        match = [det_match(det_valid(dk, i), det_valid(dp, i), img)
                 for i in range(B)]
        ma = min(min(mm["matched_a"], mm["matched_b"]) for mm in match)
        check(err <= LV3_EVAL_LOGIT_ATOL and rreg <= DET_FP32_REL
              and ma >= DET_AGREE,
              f"{name} {preset}: logits / centerness max|err| {err} (bound "
              f"{LV3_EVAL_LOGIT_ATOL}), reg rel L2 {rreg}, matched "
              f"detections {ma} (bound {DET_AGREE})")
        tr.model.train()
        teach = det_train_teacher(f"{preset} train", tr.model, plain,
                                  lambda m: cli.fcos_loss(
                                      m(batch["images"]), batch["boxes"],
                                      batch["labels"], batch["valid"],
                                      tr.cfg)[0])
        del plain, ok_, op_
        host_eval = host_ms(lambda: cli.infer(tr.model, batch["images"],
                                              "fcos", img), 3)
        state = tr.state
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(3):
            torch.cuda.synchronize()
            t1 = time.time()
            state, mt = tr.step(state, batch)
            torch.cuda.synchronize()
            times.append((time.time() - t1) * 1e3)
            check(np.isfinite(float(mt["loss"])), f"{name}: step {i} {mt}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        line, parts, _ = det_profile(lambda: tr.step(state, batch),
                                     "a profiled step")
        ms = float(np.mean(times[1:]))
        nums[f"fcos_{preset}"] = {
            "ms_per_step_host": ms, "img_per_s_train": B / ms * 1e3,
            "ms_eval_host": host_eval, "img_per_s_eval": B / host_eval * 1e3,
            "peak_gib": peak, "logits_max_err": err, "reg_rel_l2": rreg,
            "matched": ma, "teacher": teach, "device_ms_by_group": parts,
            "mAP_synthetic": res["mAP"]}
        phase(name, f"{preset} B={B}: eval {host_eval:.1f} ms/batch "
              f"({B / host_eval * 1e3:.1f} img/s); logits max|err| {err:.3g}"
              f" (bound {LV3_EVAL_LOGIT_ATOL}), reg rel L2 {rreg:.3g}, "
              f"matched detections {ma:.4f}; train {ms:.1f} ms/step "
              f"({B / ms * 1e3:.1f} img/s; step 1 {times[0]:.1f}), peak "
              f"{peak:.2f} GiB; teacher loss rel {teach['loss_rel']:.3g}, "
              f"grad norm rel {teach['norm_rel']:.3g}, min cosine "
              f"{teach['min_cos']:.6f} ({teach['worst']}); {line}")
        del tr, state, batch
        torch.cuda.empty_cache()
    return launches, nums


def phase_segmentation() -> tuple:
    """cli/train_segmentation.main --synthetic --img-size 512 --num-classes
    150 --batch-size 4 --steps 3 --eval (BEiT-B UperNet, per-layer bias:
    exactly 12 #3 + 12 #4 a step, 12 #3 an eval batch); one batch's logits
    against the plain path (LV3_EVAL_LOGIT_ATOL) and its pixel argmax
    (DET_AGREE), one train batch's loss and gradients against the plain
    path; ms/step, img/s, peak memory, a step's device time by group."""
    from unilm_tpu_torch.cli import train_segmentation as cli
    from unilm_tpu_torch.models import segmentation as seg

    name = "segmentation"
    B, img, ncls = DET_SEG
    argv = ["--synthetic", "--img-size", str(img), "--num-classes",
            str(ncls), "--batch-size", str(B), "--steps", "3", "--eval"]
    reset_counts()
    t1 = time.time()
    _, res = cli.main(argv + ["--device", DET_DEV])
    wall = time.time() - t1
    got = counts()
    n_eval = -(-max(8, 32 // 4) // B)
    launches_only(got, {"encoder_attention": 12 * (3 + n_eval),
                        "encoder_attention_bwd": 36}, "train_segmentation")
    check(all(np.isfinite(v) for v in res.values()),
          f"{name}: eval metrics {res}")
    phase(name, f"cli.train_segmentation.main({' '.join(argv)}): {wall:.1f}"
          f" s, launches {got}; mIoU {res['mIoU']:.4f}")

    tr = cli.build_trainer(det_args(cli, argv))
    imgs, labs = tr.train
    batch = {"images": torch.from_numpy(np.stack(imgs[:B])).to(DET_DEV),
             "labels": torch.from_numpy(np.stack(labs[:B])).to(DET_DEV)}
    as_plain = lambda c: dataclasses.replace(
        c, beit=dataclasses.replace(c.beit, use_flash=False))
    plain = det_plain(tr.model, seg.BeitForSemanticSegmentation, as_plain)
    tr.model.eval()
    with torch.no_grad():
        lk, lp = tr.model(batch["images"]), plain(batch["images"])
        err = float((lk - lp).abs().max())
        agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    check(err <= LV3_EVAL_LOGIT_ATOL and agree >= DET_AGREE,
          f"{name}: logits max|err| {err} (bound {LV3_EVAL_LOGIT_ATOL}), "
          f"pixel argmax agreement {agree} (bound {DET_AGREE})")
    del lk, lp
    tr.model.train()

    def loss_fn(m):
        logits, aux = m(batch["images"], return_aux=True)
        return seg.segmentation_loss(logits, batch["labels"], aux)[0]

    teach = det_train_teacher("train", tr.model, plain, loss_fn)
    del plain
    host_eval = host_ms(lambda: cli.predict(tr.model, imgs[:B], B,
                                            tr.device), 3)
    state = tr.state
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t1 = time.time()
        state, mt = tr.step(state, batch)
        torch.cuda.synchronize()
        times.append((time.time() - t1) * 1e3)
        check(np.isfinite(float(mt["loss"])), f"{name}: step {i} {mt}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    line, parts, _ = det_profile(lambda: tr.step(state, batch),
                                 "a profiled step")
    ms = float(np.mean(times[1:]))
    nums = {"ms_per_step_host": ms, "img_per_s_train": B / ms * 1e3,
            "ms_eval_host": host_eval, "img_per_s_eval": B / host_eval * 1e3,
            "peak_gib": peak, "logits_max_err": err, "argmax_agree": agree,
            "teacher": teach, "device_ms_by_group": parts,
            "mIoU_synthetic": res["mIoU"]}
    phase(name, f"B={B}: eval {host_eval:.1f} ms/batch "
          f"({B / host_eval * 1e3:.1f} img/s); logits max|err| {err:.3g} "
          f"(bound {LV3_EVAL_LOGIT_ATOL}), pixel argmax agreement "
          f"{agree:.5f}; train {ms:.1f} ms/step ({B / ms * 1e3:.1f} img/s; "
          f"step 1 {times[0]:.1f}), peak {peak:.2f} GiB; teacher loss rel "
          f"{teach['loss_rel']:.3g}, grad norm rel {teach['norm_rel']:.3g},"
          f" min cosine {teach['min_cos']:.6f} ({teach['worst']}); {line}")
    del tr, state, batch
    torch.cuda.empty_cache()
    return got, {"segmentation": nums}


# ---- the last slice: LatentLM, TextDiffuser-2, MiniLM distillation, DPO
# and the einsum ops -----------------------------------------------------------

LAST_DEV = "cuda"  # where the phases run (a rehearsal on the CPU sets "cpu")
# latentlm: LatentLMConfig() in bf16 and SigmaVAEConfig(): B images of PX px
# encode to 16 x 16 = 256 latents each, the slots after a text prefix of a
# T-token sequence; DDIM over LATENT_DDIM steps.
LATENT_B, LATENT_PX, LATENT_T, LATENT_PREFIX = 4, 128, 1024, 128
LATENT_DDIM = 20
# textdiffuser2: the defaults of LayoutPlannerConfig / TextDiffuserConfig;
# a prompt of <= 96 tokens, 160 new tokens, a 20-step render at B=1 and a
# diffusion_loss step at B=16
TD2_CAPTION = ("a neon sign over a night market that reads OPEN LATE 24/7 "
               "with noodles 5 dollars")
TD2_NEW, TD2_RENDER, TD2_TRAIN_B = 160, 20, 16
# distill: a BERT-base teacher (e5_base) and MiniLM-L6-H384's published
# student (384 x 6, FFN 1536, 12 heads of 32); B rows of 64-512 tokens
# under a key-padding mask, 48 relation heads
DISTILL_B, DISTILL_T, DISTILL_MIN, DISTILL_HEADS = 32, 512, 64, 48
# dpo: kosmos2's UniGPT decoder text-only at its registry width, B pairs
# of T tokens (the first half a shared prompt, the second the response)
DPO_PAIRS, DPO_T = 2, 512
# misc_ops: LongNet's geometric segments at T = 8192 (16 heads of 64); a
# ReSA decode step over a 32k-token cache (32 heads of 128, blocks of 64,
# the top 16); DynamicConv at fairseq's LightConv WMT shape (1024 wide, 16
# heads, kernel 31) over 8 x 512 tokens
MISC_DILATED = (1, 8192, 16, 64, (2048, 4096, 8192), (1, 2, 4))
MISC_RESA = (1, 32768, 32, 128, 64, 16)
MISC_DYNCONV = (8, 512, 1024, 16, 31)
# Bounds, set before the first run. Kernel path against the plain path in
# the same dtype: the train teacher's (TEACHER_*) for LatentLM's bf16 step,
# layoutlmv3_train's (LV3_TEACHER_*) for the student's; against float32:
# logits at LOGIT_ATOL / ARGMAX_AGREE, the whole gradient's cosine >=
# LAST_FP32_COS. The same float32 call on the card against the CPU (TF32
# off), relative L2: LAST_CPU_REL (DDIM, the VAE, the UNet's render, the
# three ops). Float32 planner logits, the prefill's and every decode
# step's, LAST_FP32_LOGIT; greedy tokens agree >= TD2_AGREE. DPO, bf16
# against the bf16 plain path: the per-token log-probs of the responses
# at DPO_TOKEN_ATOL (the logits agree within LOGIT_ATOL, and a
# log-softmax entry moves by at most twice its logit's error); the loss
# at DPO_LOSS_ATOL (a pair's loss moves by at most beta = 0.1 times the
# error of its margin, four 256-token sums whose bf16 rounding moved
# each by up to 0.54 nats at the initial weights (log-probs rel 1.89e-4
# of ~2840 in the first run on an H100 80GB HBM3 at 700 W): 0.22 at
# worst, ~0.05 with independent signs); the gradients at the train
# teacher's per-tensor bounds (TEACHER_NORM_REL, TEACHER_COS).
LAST_FP32_COS = 0.99
LAST_CPU_REL = 1e-3
LAST_FP32_LOGIT = 1e-3
TD2_AGREE = 0.90
DPO_TOKEN_ATOL = 2 * LOGIT_ATOL
DPO_LOSS_ATOL = 0.1
# A leaf whose gradient is zero to rounding on both paths (its norm at
# most ZERO_GRAD_SHARE of that path's whole gradient norm: a parameter the
# loss does not reach, or a key bias whose gradient the attention softmax
# cancels) has no direction to compare: it is left out of the teacher
# and counted (its share of the norm is below any bound). The rounding
# of such a key bias was at most 9.04e-7 of the norm in kosmos2_train's
# bf16 and float32 teachers (on an H100 80GB HBM3 at 700 W).
ZERO_GRAD_SHARE = 1e-5
LAST_GROUPS = [("#1", ["flash_fwd"]), ("#6", ["flash_bwd_dq"]),
               ("#7", ["flash_bwd_dkv"]), ("#5", [ONEPASS_ONLY]),
               ("#9", ["doc_fwd"]), ("#10", ["doc_bwd"]),
               ("conv", ["conv", "cudnn", "implicit", "winograd", "dgrad",
                         "wgrad", "fprop"]),
               ("cuBLAS", ["gemm", "xmma", "cutlass", "nvjet", "cublas",
                           "splitK"])]


def leaf_teacher(name: str, a: tuple, b: tuple, names: list,
                 bounds: tuple, hold: bool = True) -> dict:
    """grads_teacher over the leaves whose gradient is not zero to rounding
    (ZERO_GRAD_SHARE) on both paths; the left-out leaves' count and
    largest share and the held leaves' smallest share come back too."""
    (la, ga), (lb, gb) = a, b
    na = float(torch.sqrt(sum(g.float().pow(2).sum() for g in ga)))
    nb = float(torch.sqrt(sum(g.float().pow(2).sum() for g in gb)))
    share = [max(float(x.float().norm()) / na, float(y.float().norm()) / nb)
             for x, y in zip(ga, gb)]
    held = [i for i, s in enumerate(share) if s > ZERO_GRAD_SHARE]
    out = [s for s in share if s <= ZERO_GRAD_SHARE]
    r = grads_teacher(name, (la, [ga[i] for i in held]),
                      (lb, [gb[i] for i in held]), [names[i] for i in held],
                      bounds, hold=hold)
    r.update(left_out=len(out), left_out_max_share=max(out, default=0.0),
             held_min_share=min(share[i] for i in held))
    return r


def last_sync() -> None:
    if LAST_DEV == "cuda":
        torch.cuda.synchronize()


def last_host_ms(fn) -> tuple:
    """(fn()'s result, its host ms), the call ended by a synchronize."""
    last_sync()
    t0 = time.perf_counter()
    out = fn()
    last_sync()
    return out, (time.perf_counter() - t0) * 1e3


def last_profile(fn, label: str, host: float) -> tuple:
    """fn() once under the profiler: (line, its device time by
    LAST_GROUPS), the busy share against `host`, the unprofiled call's
    host ms (a profiled call's host time carries the profiler's own)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        last_sync()
    parts = device_time_shares(prof, LAST_GROUPS)
    return f"{label}: " + groups_line(parts, host), parts


def cosine_all(a: list, b: list) -> float:
    """The cosine of two gradients, every tensor flattened into one."""
    x = torch.cat([g.flatten().float() for g in a])
    y = torch.cat([g.flatten().float() for g in b])
    return float(torch.nn.functional.cosine_similarity(x, y, dim=0))


def cpu_rel(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """The card's float32 result against the CPU's: rel L2 <= LAST_CPU_REL."""
    e = rel_l2(got.float().cpu(), want.float().cpu())
    check(bool(torch.isfinite(got).all()) and e <= LAST_CPU_REL,
          f"{LAST_PHASE[0]} {label}: card against CPU rel L2 {e} (tol "
          f"{LAST_CPU_REL})")
    return e


def latentlm_batch(cfg, vae, g, dev) -> dict:
    """LATENT_B random images through the VAE into [B, Q, latent] latents
    at slots LATENT_PREFIX.. of LATENT_T-token rows; the diffusion draws."""
    images = torch.rand(LATENT_B, LATENT_PX, LATENT_PX, 3, generator=g,
                        device=dev)
    with torch.no_grad():
        grid = vae.encode(images)
    B, h, w, ld = grid.shape
    Q = h * w
    mask = torch.zeros(B, LATENT_T, dtype=torch.bool, device=dev)
    mask[:, LATENT_PREFIX:LATENT_PREFIX + Q] = True
    return {"grid": (h, w), "latents": grid.reshape(B, Q, ld), "mask": mask,
            "tokens": torch.randint(4, cfg.vocab_size, (B, LATENT_T),
                                    generator=g, device=dev),
            "t": torch.rand((B, Q), generator=g, device=dev),
            "noise": torch.randn((B, Q, ld), generator=g, device=dev)}


def latentlm_loss(model, b: dict):
    """(CE on the text targets + the diffusion loss, metrics)."""
    logits, dl = model(b["tokens"], b["latents"], b["mask"], t=b["t"],
                       noise=b["noise"])
    B, T, V = logits.shape
    nll = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, V), b["tokens"][:, 1:].reshape(-1),
        reduction="none").view(B, T - 1)
    text = (~b["mask"][:, 1:]).float()
    ce = (nll * text).sum() / text.sum()
    return ce + dl, {"ce": ce.detach(), "diffusion": dl.detach()}


def phase_latentlm() -> tuple:
    """LatentLM at LatentLMConfig()'s width (768 x 12 layers, 12 heads, FFN
    2048, vocab 32000, latents of 16; bf16 compute / float32 params) with
    SigmaVAEConfig()'s VAE (64/128/256 channels, float32), random weights
    from the seed: LATENT_B images of LATENT_PX px encode to 256 latents
    each, spliced at slots of LATENT_T-token rows; one AdamW step
    (runtime.train.make_train_step, clip 1.0) on the text CE + the
    diffusion loss; then the backbone's hidden states condition
    `sample_latent` (LATENT_DDIM DDIM steps, one latent per slot) and the
    VAE decodes the grids. Exactly 12 #1 + 12 #6 + 12 #7 a step and 12 #1
    the backbone. Teachers, at the initial weights with the same draws:
    the bf16 plain path at the train teacher's bounds; the float32 plain
    path's logits and whole gradient; DDIM and the VAE's decode against
    the CPU in float32 (the same condition rows and z; relative, as DDIM's
    first step divides by sqrt(ᾱ(1)) ~ 4.4e-8). Returns (launches,
    numbers)."""
    import copy

    from unilm_tpu_torch.models import latentlm as ll
    from unilm_tpu_torch.runtime import optim, train

    dev = torch.device(LAST_DEV)
    g = torch.Generator(device=dev).manual_seed(SEED)
    vae = ll.SigmaVAE(ll.SigmaVAEConfig(), dev).init_weights(g)
    cfg = ll.LatentLMConfig(dtype=torch.bfloat16)
    L = cfg.num_layers
    model = ll.LatentLM(cfg, dev).init_weights(g)
    b = latentlm_batch(cfg, vae, g, dev)
    Q = b["latents"].shape[1]
    phase("latentlm", f"LatentLMConfig(): {cfg.embed_dim} x {L} layers, "
          f"{cfg.num_heads} heads, vocab {cfg.vocab_size}, bf16 / float32 "
          f"params, {sum(p.numel() for p in model.parameters()) / 1e6:.1f} "
          f"M params; the VAE at {LATENT_PX} px gives {Q} latents of "
          f"{cfg.latent_dim} an image; B={LATENT_B}, T={LATENT_T}, slots "
          f"{LATENT_PREFIX}..{LATENT_PREFIX + Q - 1}")

    # teachers at the initial weights: the kernel path, the bf16 plain path
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def twin(**kw):
        m = ll.LatentLM(dataclasses.replace(cfg, use_flash=False, **kw), dev)
        m.load_state_dict(init)
        return m

    lk, gk, names = det_grads(model, lambda m: latentlm_loss(m, b)[0])
    plain = twin()
    lp, gp, _ = det_grads(plain, lambda m: latentlm_loss(m, b)[0])
    tb = grads_teacher("bf16 plain path", (lk, gk), (lp, gp), names)
    del plain, gp
    plain32 = twin(dtype=torch.float32)
    l32, g32, _ = det_grads(plain32, lambda m: latentlm_loss(m, b)[0])
    cos32 = cosine_all(gk, g32)
    with torch.no_grad():
        lt = logits_teacher("float32 plain path logits",
                            model(b["tokens"], b["latents"], b["mask"],
                                  t=b["t"], noise=b["noise"])[0],
                            plain32(b["tokens"], b["latents"], b["mask"],
                                    t=b["t"], noise=b["noise"])[0])
    check(cos32 >= LAST_FP32_COS, f"latentlm: whole-gradient cosine to the "
          f"float32 plain path {cos32} (tol {LAST_FP32_COS})")
    phase("latentlm", f"initial weights, kernel path against the bf16 plain "
          f"path: loss rel {tb['loss_rel']:.2e}, grad norm rel "
          f"{tb['norm_rel']:.2e}, min cosine {tb['min_cos']:.5f} "
          f"({tb['worst']}); against float32: loss {lk:.5f} / {l32:.5f}, "
          f"max |dlogit| {lt['max_dlogit']:.4f}, argmax agreement "
          f"{lt['argmax_agreement']:.4f}, whole-gradient cosine {cos32:.6f}")
    del plain32, gk, g32

    # the main path: a step, the backbone, DDIM, the VAE's decode
    tx = optim.AdamW(1e-4)
    state = train.TrainState.create(model, tx)
    step = train.make_train_step(latentlm_loss, tx, clip_grad_norm=1.0)
    reset_counts()
    (state, met), step_ms = last_host_ms(lambda: step(state, b))
    got_step = counts()
    with torch.no_grad():
        h, bb_ms = last_host_ms(lambda: model.backbone(
            b["tokens"], b["latents"], b["mask"]))
    got = counts()
    launches_only(got_step, {"flash_fwd": L, "flash_bwd_dq": L,
                             "flash_bwd_dkv": L}, "the train step")
    launches_only(got, {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                        "flash_bwd_dkv": L}, "the step and the backbone")
    cond = h[:, LATENT_PREFIX - 1:LATENT_PREFIX - 1 + Q].reshape(
        -1, cfg.embed_dim)
    z0 = torch.randn((cond.shape[0], cfg.latent_dim), generator=g,
                     device=dev)
    zs, ddim_ms = last_host_ms(lambda: model.sample_latent(
        cond, steps=LATENT_DDIM, z=z0))
    grid = zs.reshape(LATENT_B, *b["grid"], cfg.latent_dim)
    with torch.no_grad():
        img, dec_ms = last_host_ms(lambda: vae.decode(grid))
    check(img.shape == (LATENT_B, LATENT_PX, LATENT_PX, 3)
          and bool(torch.isfinite(img).all()) and np.isfinite(
              float(met["loss"])), f"latentlm: decoded {tuple(img.shape)}, "
          f"loss {float(met['loss'])}")
    head = copy.deepcopy(model.diffusion_head).cpu()
    z_cpu = ll.ddim_latents(head, cond.float().cpu(), z0.cpu(), LATENT_DDIM)
    e_ddim = cpu_rel("DDIM", zs, z_cpu)
    with torch.no_grad():
        e_vae = cpu_rel("the VAE's decode", img,
                        copy.deepcopy(vae).cpu().decode(grid.cpu()))
    line, parts = last_profile(lambda: step(state, b), "a step", step_ms)
    nums = {"loss": float(met["loss"]), "ce": float(met["ce"]),
            "diffusion": float(met["diffusion"]), "step_ms": step_ms,
            "backbone_ms": bb_ms, "ddim_ms": ddim_ms, "decode_ms": dec_ms,
            "ddim_rel_l2_cpu": e_ddim, "vae_rel_l2_cpu": e_vae,
            "latent_abs_max": float(zs.abs().max()), "device_ms": parts,
            "teacher_bf16": tb,
            "teacher_fp32": {**lt, "loss": l32, "cos": cos32}}
    phase("latentlm", f"step: loss {nums['loss']:.4f} (CE {nums['ce']:.4f} + "
          f"diffusion {nums['diffusion']:.4f}), {step_ms:.1f} ms on the host; "
          f"launches {got_step}; the backbone {bb_ms:.1f} ms; DDIM "
          f"{LATENT_DDIM} steps over {cond.shape[0]} slots {ddim_ms:.1f} ms, "
          f"max |z| {nums['latent_abs_max']:.3g} (ᾱ(1) amplification, the "
          f"reference's), rel L2 to the CPU {e_ddim:.2e}; the VAE's decode "
          f"{dec_ms:.1f} ms, rel L2 {e_vae:.2e}; " + line)
    del state, step, model, vae, b, h, cond
    if LAST_DEV == "cuda":
        torch.cuda.empty_cache()
    return got, {"latentlm": nums}


def td2_masks(td, rng, B: int, size: int) -> torch.Tensor:
    """B character masks of one to three random words in random boxes."""
    out = []
    for _ in range(B):
        boxes = []
        for _ in range(rng.randint(1, 4)):
            x0, y0 = rng.randint(0, size // 2, 2)
            w = "".join(rng.choice(list("abcdefgh0123"), rng.randint(2, 7)))
            boxes.append((w, (x0, y0, min(size, x0 + rng.randint(12, 40)),
                              min(size, y0 + rng.randint(6, 16)))))
        out.append(td.render_char_mask(boxes, size))
    return torch.from_numpy(np.stack(out))


def planner_replay(model, toks: torch.Tensor, n: int,
                   steps: int) -> torch.Tensor:
    """The planner's prefill over toks[:, :n] and `steps` one-token decode
    steps fed toks[:, n:n + steps], in plan_tokens' cache (n + TD2_NEW
    slots): each call's last logits, [B, 1 + steps, V]."""
    size = n + TD2_NEW
    lg, cache = model.prefill(toks[:, :n], size)
    out = [lg[:, -1]]
    for i in range(steps):
        lg, cache = model.decode_step(toks[:, n + i:n + i + 1], cache, size)
        out.append(lg[:, -1])
    return torch.stack(out, 1)


def phase_textdiffuser2() -> tuple:
    """TextDiffuser-2 at the defaults of LayoutPlannerConfig (256 wide, 4
    layers, 4 heads, float32) and TextDiffuserConfig (64 px, base 64,
    mults 1/2/4, float32), random weights from the seed, through
    `TextDiffuser2Pipeline`: one `diffusion_loss` AdamW step at
    B=TD2_TRAIN_B (the UNet launches no kernel: every counter stays 0);
    the greedy plan of TD2_CAPTION (its prompt <= 96 tokens, TD2_NEW new
    tokens or up to EOS); a TD2_RENDER-step render at
    B=1. The plan's prefill takes #5 (4 launches, `onepass_applies`) and
    each one-token decode step the decode kernel over the paged cache
    (#13's float32 pools, 4 launches), exactly. Teachers: the plain path's
    greedy tokens (agreement >= TD2_AGREE), its teacher-forced logits over
    the plan (argmax 99%) and its prefill's and decode steps' logits on
    the plan's tokens (`planner_replay`), both at LAST_FP32_LOGIT; the
    render against the same render on the CPU (the UNet
    copied, the same z; relative L2). Returns (launches, numbers)."""
    import copy

    from unilm_tpu_torch.models import textdiffuser as td
    from unilm_tpu_torch.models import textdiffuser2 as td2
    from unilm_tpu_torch.runtime import optim, train

    dev = torch.device(LAST_DEV)
    g = torch.Generator(device=dev).manual_seed(SEED)
    pcfg, ucfg = td2.LayoutPlannerConfig(), td.TextDiffuserConfig()
    planner = td2.LayoutPlannerLM(pcfg, dev).init_weights(g).eval()
    unet = td.TextDiffuserUNet(ucfg, dev).init_weights(g)
    pipe = td2.TextDiffuser2Pipeline(planner, unet, max_new_tokens=TD2_NEW)
    phase("textdiffuser2", f"planner {pcfg.embed_dim} x {pcfg.num_layers} "
          f"layers, {pcfg.num_heads} heads, vocab {pcfg.vocab_size}; UNet "
          f"{ucfg.img_size} px, base {ucfg.base_channels}, mults "
          f"{ucfg.channel_mults}, "
          f"{sum(p.numel() for p in unet.parameters()) / 1e6:.2f} M params")

    # the UNet's diffusion_loss step (before the render: `out` starts at 0)
    rng = np.random.RandomState(SEED)
    batch = {"images": torch.rand(TD2_TRAIN_B, ucfg.img_size, ucfg.img_size,
                                  3, generator=g, device=dev) * 2 - 1,
             "mask": td2_masks(td, rng, TD2_TRAIN_B, ucfg.img_size).to(dev)}
    tx = optim.AdamW(1e-4)
    state = train.TrainState.create(unet, tx)
    step = train.make_train_step(lambda m, bt: td.diffusion_loss(
        m, bt["images"], bt["mask"], g), tx)
    reset_counts()
    (state, met), first_ms = last_host_ms(lambda: step(state, batch))
    (state, met2), step_ms = last_host_ms(lambda: step(state, batch))
    launches_only(counts(), {}, "two UNet steps")
    check(float(unet.out.weight.detach().abs().max()) > 0
          and np.isfinite(float(met2["loss"])), "textdiffuser2: the step")

    # the greedy plan: 4 #5 a planner call
    planner.decode_step = counted(planner.decode_step)
    reset_counts()
    (toks, n), plan_ms = last_host_ms(lambda: pipe.plan_tokens(TD2_CAPTION))
    got = counts()
    calls = planner.decode_step.calls
    launches_only(got, {"onepass_attention": pcfg.num_layers,
                        "decode_attention": pcfg.num_layers * calls},
                  f"the plan (a prefill and {calls} decode steps)")
    layout = pipe.vocab.decode_layout(toks[0, n:].tolist())
    # the plain path's plan and the teacher-forced logits
    plain = td2.LayoutPlannerLM(dataclasses.replace(pcfg, use_flash=False),
                                dev).eval()
    plain.load_state_dict(planner.state_dict())
    ptoks, _ = dataclasses.replace(pipe, planner=plain).plan_tokens(
        TD2_CAPTION)
    agree = float((toks[0, n:] == ptoks[0, n:]).float().mean())
    with torch.no_grad():
        kl_, pl_ = planner(toks), plain(toks)
    err = float((kl_ - pl_).abs().max())
    arg = float((kl_.argmax(-1) == pl_.argmax(-1)).float().mean())
    # the prefill and every decode step again on the plan's tokens, on
    # both paths: the steps' logits
    err_dec = float((planner_replay(planner, toks, n, calls)
                     - planner_replay(plain, toks, n, calls)).abs().max())
    check(agree >= TD2_AGREE and max(err, err_dec) <= LAST_FP32_LOGIT
          and arg >= 0.99,
          f"textdiffuser2: greedy agreement {agree} (tol {TD2_AGREE}), "
          f"teacher-forced max |dlogit| {err}, the prefill's and "
          f"{calls} decode steps' {err_dec} (tol {LAST_FP32_LOGIT}), "
          f"argmax {arg}")

    # the render (the plan's layout; a fixed one if the random planner
    # planned none): card against the CPU
    lay = layout or [("open late", (8, 8, 120, 40))]
    z = torch.randn(1, ucfg.img_size, ucfg.img_size, 3, generator=g,
                    device=dev)
    reset_counts()
    img, render_ms = last_host_ms(lambda: pipe.render(lay, steps=TD2_RENDER,
                                                      z=z))
    launches_only(counts(), {}, "the render")
    mask = torch.from_numpy(td.render_char_mask(
        td2.layout_to_pixel_boxes(lay, ucfg.img_size), ucfg.img_size))[None]
    e_render = cpu_rel("the render", img, td.ddim_sample(
        copy.deepcopy(unet).cpu(), mask, steps=TD2_RENDER, z=z.cpu()))
    line, parts = last_profile(lambda: step(state, batch), "a UNet step",
                               step_ms)
    nums = {"decode_steps": calls, "prompt_tokens": n, "plan_ms": plan_ms,
            "ms_per_token": plan_ms / (1 + calls), "greedy_agreement": agree,
            "teacher_max_dlogit": err, "decode_max_dlogit": err_dec,
            "teacher_argmax": arg,
            "layout_lines": len(layout), "render_ms": render_ms,
            "render_rel_l2_cpu": e_render, "train_first_ms": first_ms,
            "train_step_ms": step_ms, "train_device_ms": parts,
            "losses": [float(met["loss"]), float(met2["loss"])]}
    phase("textdiffuser2", f"UNet steps at B={TD2_TRAIN_B}: losses "
          f"{nums['losses'][0]:.4f}, {nums['losses'][1]:.4f}, {step_ms:.1f} "
          f"ms (the first {first_ms:.1f}); plan: {n} prompt tokens, "
          f"{calls} decode steps, {plan_ms:.1f} ms "
          f"({nums['ms_per_token']:.2f} ms a token), launches {got}, "
          f"{len(layout)} layout lines; plain path: greedy agreement "
          f"{agree:.4f}, teacher-forced max |dlogit| {err:.2e}, the "
          f"prefill's and decode steps' {err_dec:.2e}, argmax "
          f"{arg:.4f}; render {TD2_RENDER} steps {render_ms:.1f} ms, rel L2 "
          f"to the CPU {e_render:.2e}; " + line)
    del state, step, pipe, planner, plain, unet
    return got, {"textdiffuser2": nums}


def phase_distill() -> tuple:
    """MiniLM v2 relation distillation at full width: the port's e5_base
    encoder (BERT-base, 768 x 12, 12 heads of 64) teaching MiniLM-L6-H384's
    published student (384 x 6, FFN 1536, 12 heads of 32), both bf16 /
    float32 params,
    random weights from the seed; DISTILL_B rows of DISTILL_MIN-DISTILL_T
    tokens under a key-padding mask. One student AdamW step on
    `minilm_v2_loss` over the last layers' q/k/v (DISTILL_HEADS relation
    heads), captured by core/attention.py `capture_qkv`, the teacher under
    no_grad: exactly 18 #9 (12 teacher at D = 64, 6 student at D = 32)
    and 5 #10 a step, all at D = 32 (the last student layer's attention
    output does not reach the loss, so its backward runs none). The same
    forwards with the capture off launch the same kernels at the same head
    dims (both tallies printed). Teacher: the plain path's loss and
    student gradients at layoutlmv3_train's bounds (`leaf_teacher`: the
    leaves zero to rounding left out, the last layer's key bias held).
    Returns (launches, numbers)."""
    from unilm_tpu_torch.core.attention import capture_qkv
    from unilm_tpu_torch.models.retrieval import (EmbeddingModel,
                                                  TextEncoderConfig)
    from unilm_tpu_torch.runtime import distill, optim, train

    dev = torch.device(LAST_DEV)
    g = torch.Generator(device=dev).manual_seed(SEED)
    tcfg = TextEncoderConfig(dtype=torch.bfloat16)
    scfg = TextEncoderConfig(hidden_size=384, num_layers=6, num_heads=12,
                             ffn_dim=1536, dtype=torch.bfloat16)
    teacher = EmbeddingModel(tcfg, dev).init_weights(g).eval()
    student = EmbeddingModel(scfg, dev).init_weights(g)
    phase("distill", f"teacher {tcfg.hidden_size} x {tcfg.num_layers} "
          f"layers, {tcfg.num_heads} heads; student {scfg.hidden_size} x "
          f"{scfg.num_layers} layers, {scfg.num_heads} heads of "
          f"{scfg.hidden_size // scfg.num_heads}; bf16 / float32 params; "
          f"{DISTILL_HEADS} relation heads")
    rng = np.random.RandomState(SEED)
    mask = ragged_mask(rng, DISTILL_B, DISTILL_T, DISTILL_MIN, dev)
    ids = torch.randint(1000, tcfg.vocab_size, (DISTILL_B, DISTILL_T),
                        generator=g, device=dev)
    b = {"ids": ids, "mask": mask}

    def last_qkv(model, bt):
        with capture_qkv(model) as rec:
            model.encoder(bt["ids"], bt["mask"])
        return distill.collect_qkv(rec)[-1]

    def make_loss(tm):
        def loss_fn(m, bt):
            with torch.no_grad():
                tq = last_qkv(tm, bt)
            loss = distill.minilm_v2_loss(tq, last_qkv(m, bt),
                                          DISTILL_HEADS, bt["mask"])
            return loss, {}
        return loss_fn

    per_step = {"doc_attention": tcfg.num_layers + scfg.num_layers,
                "doc_attention_bwd": scfg.num_layers - 1}
    d_t = tcfg.hidden_size // tcfg.num_heads
    d_s = scfg.hidden_size // scfg.num_heads
    by_d = {"doc_attention": {d_s: scfg.num_layers, d_t: tcfg.num_layers},
            "doc_attention_bwd": {d_s: scfg.num_layers - 1}}
    check((d_t, d_s) == (64, D32), f"distill: head dims {d_t}, {d_s}")
    # capture on and off: the same forward kernels at the same head dims
    with torch.no_grad():
        reset_counts()
        last_qkv(teacher, b)
        last_qkv(student, b)
        on = counts(), by_head_dim()
        reset_counts()
        teacher.encoder(ids, mask)
        student.encoder(ids, mask)
        off = counts(), by_head_dim()
    check(on == off and on[1] == {"doc_attention": by_d["doc_attention"]},
          f"distill: capture on {on}, off {off}")
    # teacher check at the initial weights
    init = {k: v.detach().clone() for k, v in student.state_dict().items()}

    def plain_of(cfg, sd):
        m = EmbeddingModel(dataclasses.replace(cfg, use_flash=False), dev)
        m.load_state_dict(sd)
        return m

    tplain = plain_of(tcfg, teacher.state_dict()).eval()
    lk, gk, names = det_grads(student, lambda m: make_loss(teacher)(m, b)[0])
    lp, gp, _ = det_grads(plain_of(scfg, init),
                          lambda m: make_loss(tplain)(m, b)[0])
    # the last layer's attention output, FFN and norms do not reach the
    # loss, and the key biases of the layers before it shift every score
    # of a softmax row alike: zero to rounding on both paths, left out.
    # The last layer's key bias is held: the K-K relation's softmax over
    # k_i . k_j is not shift-invariant in it
    tt = leaf_teacher("the plain path", (lk, gk), (lp, gp), names,
                      (LV3_TEACHER_LOSS_REL, LV3_TEACHER_NORM_REL,
                       LV3_TEACHER_COS))
    last_kb = f"encoder.layers.{scfg.num_layers - 1}.self_attn.k_proj.bias"
    kb = [i for i, n in enumerate(names) if n.endswith(last_kb)]
    tt["last_key_bias_cos"] = float(torch.nn.functional.cosine_similarity(
        gk[kb[0]].flatten().float(), gp[kb[0]].flatten().float(), dim=0))
    check(len(kb) == 1 and tt["last_key_bias_cos"] >= LV3_TEACHER_COS,
          f"distill: the last layer's key bias {kb}, cosine "
          f"{tt['last_key_bias_cos']}")
    del tplain, gk, gp
    # the main path: one student step
    tx = optim.AdamW(1e-4)
    state = train.TrainState.create(student, tx)
    step = train.make_train_step(make_loss(teacher), tx, clip_grad_norm=1.0)
    reset_counts()
    (state, met), step_ms = last_host_ms(lambda: step(state, b))
    got, got_d = counts(), by_head_dim()
    launches_only(got, per_step, "a distillation step")
    check(got_d == by_d, f"distill: a step's launches by head dim {got_d} "
          f"(want {by_d})")
    check(np.isfinite(float(met["loss"])) and float(met["loss"]) > 0,
          f"distill: loss {float(met['loss'])}")
    line, parts = last_profile(lambda: step(state, b), "a step", step_ms)
    nums = {"loss": float(met["loss"]), "step_ms": step_ms,
            "tokens": int(mask.sum()), "capture_on": on[0],
            "capture_off": off[0], "by_head_dim": got_d, "teacher": tt,
            "device_ms": parts}
    phase("distill", f"e5_base -> 384 x 6 student, B={DISTILL_B} rows of "
          f"{DISTILL_MIN}-{DISTILL_T} tokens ({nums['tokens']} valid); "
          f"forward launches with the capture {on}, without {off}; initial "
          f"weights against the plain path: loss rel {tt['loss_rel']:.2e}, "
          f"grad norm rel {tt['norm_rel']:.2e}, min cosine "
          f"{tt['min_cos']:.5f} ({tt['worst']}) over "
          f"{len(names) - tt['left_out']} tensors, the last layer's key "
          f"bias {tt['last_key_bias_cos']:.5f}, {tt['left_out']} zero to "
          f"rounding left out (largest share "
          f"{tt['left_out_max_share']:.2e}, smallest held "
          f"{tt['held_min_share']:.2e}); step: loss "
          f"{nums['loss']:.5f}, {step_ms:.1f} ms, launches {got}, by head "
          f"dim {got_d}; " + line)
    del state, step, teacher, student
    return got, {"distill": nums}


def phase_dpo() -> tuple:
    """DPO on kosmos2's UniGPT decoder, text only, at its registry width
    (2048 x 24 layers, 32 heads, FFN 8192, vocab 65037; bf16 compute):
    the policy with float32 params and AdamW states, the reference another
    random model of that shape (seed SEED + 1) with bf16 params, so that
    the rewards are not 0 and the loss not log 2 at the initial weights;
    DPO_PAIRS chosen / rejected pairs of DPO_T tokens (a shared prompt,
    then each response) in one batch. `sequence_log_probs` over the
    responses on both models (the reference under no_grad), the sigmoid
    `dpo_loss` (beta 0.1), one AdamW step on the policy: exactly 48 #1
    (24 policy, 24 reference) and 24 #6 + 24 #7 a step. Teacher at the
    initial weights, the bf16 plain path on the same inputs: both models'
    per-token log-probs (DPO_TOKEN_ATOL), the loss (DPO_LOSS_ATOL), the
    policy gradient per tensor (`leaf_teacher` at TEACHER_NORM_REL,
    TEACHER_COS), every reading in one check. Returns (launches,
    numbers)."""
    from unilm_tpu_torch.models.kosmos import UniGPT, kosmos2
    from unilm_tpu_torch.runtime import optim, preference, train

    dev = torch.device(LAST_DEV)
    g = torch.Generator(device=dev).manual_seed(SEED)
    cfg = kosmos2(image_tower=None, dtype=torch.bfloat16)
    L = cfg.num_layers
    policy = UniGPT(cfg, device=dev)
    policy.init_weights(g)
    rcfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    reference = UniGPT(rcfg, device=dev).eval()
    reference.load_state_dict(UniGPT(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(SEED + 1)).state_dict())
    B, T, P = 2 * DPO_PAIRS, DPO_T, DPO_T // 2
    prompt = torch.randint(4, cfg.vocab_size, (DPO_PAIRS, P), generator=g,
                           device=dev)
    resp = torch.randint(4, cfg.vocab_size, (B, T - P), generator=g,
                         device=dev)
    tokens = torch.cat([prompt.repeat(2, 1), resp], dim=1)
    loss_mask = torch.zeros(B, T - 1, dtype=torch.bool, device=dev)
    loss_mask[:, P - 1:] = True  # the targets P.. are the responses
    phase("dpo", f"kosmos2 text decoder {cfg.embed_dim} x {L} layers, vocab "
          f"{cfg.vocab_size}, {sum(p.numel() for p in policy.parameters()) / 1e9:.2f} "
          f"B params; {DPO_PAIRS} pairs x {T} tokens ({T - P} response)")

    def logps(m):
        return preference.sequence_log_probs(m(tokens), tokens, loss_mask)

    def token_logps(m):
        """[B, T - P] log-probs of the response targets."""
        lp = torch.log_softmax(m(tokens)[:, :-1].float(), dim=-1)
        return torch.gather(lp, -1, tokens[:, 1:, None])[:, P - 1:, 0]

    def make_loss(ref):
        def loss_fn(m, bt):
            with torch.no_grad():
                r = logps(ref)
            p = logps(m)
            loss, cr, rr = preference.dpo_loss(p[:DPO_PAIRS], p[DPO_PAIRS:],
                                               r[:DPO_PAIRS], r[DPO_PAIRS:],
                                               beta=0.1)
            return loss, {"chosen_reward": cr.mean(),
                          "rejected_reward": rr.mean(), "logp": p.detach()}
        return loss_fn

    # teacher check at the initial weights
    def plain_of(model, c):
        m = UniGPT(dataclasses.replace(c, use_flash=False), device=dev)
        m.load_state_dict(model.state_dict(), assign=True)
        return m

    ref_plain = plain_of(reference, rcfg).eval()
    pol_plain = plain_of(policy, cfg)
    with torch.no_grad():
        tk = torch.stack([token_logps(policy), token_logps(reference)])
        tp = torch.stack([token_logps(pol_plain), token_logps(ref_plain)])
    rw = 0.1 * (tp[0] - tp[1]).sum(-1)  # the plain path's rewards
    e_tok = float((tk - tp).abs().max())
    spread = float(tp.std())
    lk, gk, names = det_grads(policy, lambda m: make_loss(reference)(m, 0)[0])
    lp, gp, _ = det_grads(pol_plain, lambda m: make_loss(ref_plain)(m, 0)[0])
    tt = leaf_teacher("the plain path", (lk, gk), (lp, gp), names,
                      (float("inf"), TEACHER_NORM_REL, TEACHER_COS),
                      hold=False)
    teach = (f"per-token log-probs max |d| {e_tok:.4f} (tol "
             f"{DPO_TOKEN_ATOL}; their spread over tokens {spread:.3f}), "
             f"loss {lk:.6f} / {lp:.6f} (tol {DPO_LOSS_ATOL}; log 2 = "
             f"{np.log(2):.6f}), rewards chosen {float(rw[:DPO_PAIRS].mean()):.4f}"
             f" rejected {float(rw[DPO_PAIRS:].mean()):.4f}; gradients: norm rel "
             f"{tt['norm_rel']:.2e} (tol {TEACHER_NORM_REL}), min per-tensor "
             f"cosine {tt['min_cos']:.5f} ({tt['worst']}, tol {TEACHER_COS})"
             f" over {len(names) - tt['left_out']} tensors, "
             f"{tt['left_out']} zero to rounding left out (largest share "
             f"{tt['left_out_max_share']:.2e})")
    check(e_tok <= DPO_TOKEN_ATOL and abs(lk - lp) <= DPO_LOSS_ATOL
          and tt["ok"], f"dpo: teacher check failed: {teach}")
    del ref_plain, pol_plain, gk, gp, tk, tp
    # the main path: one policy step
    tx = optim.AdamW(1e-6)
    state = train.TrainState.create(policy, tx)
    step = train.make_train_step(make_loss(reference), tx,
                                 clip_grad_norm=1.0)
    if LAST_DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (state, met), step_ms = last_host_ms(lambda: step(state, 0))
    got = counts()
    launches_only(got, {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                        "flash_bwd_dkv": L}, "a DPO step")
    check(np.isfinite(float(met["loss"])), f"dpo: loss {float(met['loss'])}")
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if LAST_DEV == "cuda" else 0.0)
    line, parts = last_profile(lambda: step(state, 0), "a step", step_ms)
    nums = {"loss": float(met["loss"]), "step_ms": step_ms, "peak_gib": peak,
            "token_logp_max_abs": e_tok, "token_logp_spread": spread,
            "loss_kernel": lk, "loss_plain": lp, "teacher": tt,
            "device_ms": parts,
            "chosen_reward": float(met["chosen_reward"]),
            "rejected_reward": float(met["rejected_reward"])}
    phase("dpo", f"initial weights against the plain path: {teach}; step: "
          f"loss {nums['loss']:.6f}, {step_ms:.1f} ms, peak "
          f"memory {peak:.2f} GiB, launches {got}; " + line)
    del state, step, policy, reference
    if LAST_DEV == "cuda":
        torch.cuda.empty_cache()
    return got, {"dpo": nums}


def phase_misc_ops() -> dict:
    """The three ops JAX writes as XLA einsums (no Pallas kernel, so no
    port kernel): LongNet's `dilated_attention` at MISC_DILATED, a ReSA
    `resa_decode_step` over MISC_RESA's cache (a rectify step and a sparse
    one), `DynamicConvLayer` at MISC_DYNCONV; float32 on the card against
    the same call on the CPU (relative L2, LAST_CPU_REL), every kernel
    counter at 0, the card's time of each (device time)."""
    from unilm_tpu_torch.core.layers import init_weights_
    from unilm_tpu_torch.ops import dilated_attention as dil
    from unilm_tpu_torch.ops import dynamic_conv as dyn
    from unilm_tpu_torch.ops import sparse_attention as sa

    dev = torch.device(LAST_DEV)
    g = torch.Generator().manual_seed(SEED)
    B, T, H, D, segs, rates = MISC_DILATED
    q, k, v = (torch.randn(B, T, H, D, generator=g) * 0.5 for _ in range(3))
    dq, dk, dv = (x.to(dev) for x in (q, k, v))

    def dilated(a, b, c):
        return dil.dilated_attention(a, b, c, segment_lengths=segs,
                                     dilation_rates=rates)

    Bq, S, Hr, Dr, bs, topk = MISC_RESA
    rcfg = sa.ReSAConfig(block_size=bs, topk_blocks=topk)
    rq = torch.randn(Bq, 1, Hr, Dr, generator=g)
    rk, rv = (torch.randn(Bq, S, Hr, Dr, generator=g) for _ in range(2))
    summ = sa.block_key_summary(rk, bs)
    kv_len = S - 37
    rdev = [x.to(dev) for x in (rq, rk, rv, summ)]
    Bc, Tc, C, Hc, K = MISC_DYNCONV
    layer = dyn.DynamicConvLayer(C, K, Hc)
    init_weights_(layer, g)
    xc = torch.randn(Bc, Tc, C, generator=g)
    layer_dev = dyn.DynamicConvLayer(C, K, Hc, device=dev)
    layer_dev.load_state_dict(layer.state_dict())
    cases = [("dilated_attention", lambda: dilated(dq, dk, dv),
              lambda: dilated(q, k, v)),
             ("resa rectify step", lambda: sa.resa_decode_step(
                 *rdev[:3], rdev[3], kv_len, 0, rcfg),
              lambda: sa.resa_decode_step(rq, rk, rv, summ, kv_len, 0,
                                          rcfg)),
             ("resa sparse step", lambda: sa.resa_decode_step(
                 *rdev[:3], rdev[3], kv_len, 1, rcfg),
              lambda: sa.resa_decode_step(rq, rk, rv, summ, kv_len, 1,
                                          rcfg)),
             ("dynamic_conv layer", lambda: layer_dev(xc.to(dev)),
              lambda: layer(xc))]
    nums = {}
    reset_counts()
    with torch.no_grad():
        for name, card, cpu in cases:
            e = cpu_rel(name, card(), cpu())
            ms = device_ms(card, iters=5) if LAST_DEV == "cuda" else 0.0
            nums[name] = {"rel_l2_cpu": e, "device_ms": ms}
            phase("misc_ops", f"{name}: rel L2 to the CPU {e:.2e}; device "
                  f"time {ms:.4f} ms")
    launches_only(counts(), {}, "the einsum ops")
    return {"misc_ops": nums}


# ---- head_dim 32: MiniLM-L6-H384's student and TrOCR-Small's decoder -------

# The D = 32 shapes of the two paths: the distill student
# (B rows of 64-512 tokens, 12 heads), TrOCR-Small's decoder (8 heads;
# beam 5 at B = 32; its fine-tune step's 64-token targets over the 578
# encoder tokens); #1, #2, #8 at the train shape's sequence, 64 heads of 32;
# #11 / #12 at the page_pool / paged_append geometry, 16 heads of 32.
D32 = 32
D32_DOC = (32, 512, 12, 64)        # B, T = S, H, shortest row
D32_TROCR = (32, 8, 64)            # B, H, fine-tune target tokens
D32_FLASH = (2, 2048, 64)          # B, T = S, H
# the relative L2 bound of the *_kernels phases, by the inputs' dtype
KERNEL_REL_L2 = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


@dataclasses.dataclass
class KernelCase:
    """One kernel call held against its plain version: `run()` and
    `plain()` give outputs held pairwise as `how` says (see `held`);
    `rows(got)`, where set, the timed rows: each a KernelRow."""
    label: str
    shape: str
    run: object
    plain: object
    how: tuple
    rows: object = None


@dataclasses.dataclass
class KernelRow:
    """A timed kernel: `call` (its `only` kernels' device time), `plain`
    and `lib` (None where no library call computes it) on the same
    inputs, its bound, and where it goes in the kernels line (`kernel`,
    under "d32", `key`)."""
    kernel: str
    key: str
    label: str
    call: object
    only: str
    plain: object
    lib: object
    library: str
    bound: dict
    flushed: bool = False


def held(label: str, checks) -> dict:
    """Hold each (got, want, how): "rel" by grad_close at the dtype's
    KERNEL_REL_L2, "out" within OUT_ATOL + OUT_RTOL |want|, "lse" within
    LSE_ATOL, "equal" bit-equal; each got finite. Returns the worst rel L2
    and max|err| of the "rel" and "out" outputs (and of the lse)."""
    r = {"rel_l2": 0.0, "max_abs_err": 0.0}
    for i, (x, ref, how) in enumerate(checks):
        if how == "equal":
            ok, ea, er = torch.equal(x, ref), 0.0, 0.0
        elif how == "rel":
            ok, ea, er = grad_close(x, ref, KERNEL_REL_L2[x.dtype])
        else:
            atol, rtol = (LSE_ATOL, 0.0) if how == "lse" else (OUT_ATOL,
                                                              OUT_RTOL)
            (ok, ea), er = close(x, ref, atol, rtol), rel_l2(x, ref)
        check(ok and bool(torch.isfinite(x.float()).all()),
              f"{label}: output {i} ({how}) max|err| {ea}, rel L2 {er}")
        key = "lse_max_abs_err" if how == "lse" else "max_abs_err"
        r[key] = max(r.get(key, 0.0), ea)
        if how != "lse":
            r["rel_l2"] = max(r["rel_l2"], er)
    return r


def d32_cases(fa, da, pa, g, dev: str):
    """The KernelCases of d32_kernels, in order: each kernel on inputs of
    its own, but #6 / #7 on #5's and #8 on #1's (their out and lse)."""
    from unilm_tpu_torch.core.transformer import _scan_pool_geometry

    bf, f32, D = torch.bfloat16, torch.float32, D32
    rn = functools.partial(randn, g, dev=dev)
    tag = lambda dt: "bf16" if dt == bf else "fp32"

    def sdpa_bwd(q, k, v, do, **kw):
        """sdpa's dq, dk, dv on the same rows, and its backend's name."""
        qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
        o = sdpa(qg, kg, vg, **kw)
        return (lambda: torch.autograd.grad(o, (qg, kg, vg),
                                            do.transpose(1, 2),
                                            retain_graph=True),
                f"sdpa backward ({type(o.grad_fn).__name__})")

    # ---- #9 / #10: the distill student -----------------------------------
    B, T, H, lo = D32_DOC
    mask = ragged_mask(np.random.RandomState(SEED), B, T, lo, dev)
    pairs = float(mask.sum()) * T * H
    for dt in (bf, f32):
        q, k, v, do = (rn(B, T, H, D, dtype=dt) for _ in range(4))
        shape = f"{B}x{T}x{T}x{H}x{D} {tag(dt)}, key-padding mask ({lo}-{T})"
        fwd = lambda: da.doc_attention(q, k, v, None, mask)
        fwd_plain = lambda: da.doc_attention_plain(q, k, v, None, mask)
        yield KernelCase(
            "#9 student", shape, lambda: (fwd(),), lambda: (fwd_plain(),),
            ("rel",), dt == bf and (lambda got: [KernelRow(
                "doc_attention", "distill_student", "#9 student", fwd,
                "doc_fwd", fwd_plain,
                lambda: sdpa(q, k, v, attn_mask=mask[:, None, None]),
                "sdpa (bool mask)",
                attn_bound(pairs, D, 2, q, k, v, got[0], mask))]))
        bwd = lambda: da.doc_backward(q, k, v, None, mask, do)[:3]
        bwd_plain = lambda: da.doc_backward_plain(q, k, v, None, mask,
                                                  do)[:3]

        def rows10(got):
            lib, library = sdpa_bwd(q, k, v, do, attn_mask=mask[:, None, None])
            return [KernelRow("doc_attention_bwd", "distill_student",
                              "#10 student", bwd, "doc_bwd", bwd_plain, lib,
                              library, attn_bound(pairs, D, 5, q, k, v, do,
                                                  mask, *got))]
        yield KernelCase("#10 student", shape + ", dq/dk/dv", bwd, bwd_plain,
                         ("rel",) * 3, dt == bf and rows10)

    # ---- #3 / #4: TrOCR-Small's cross-attention -------------------------
    B, H, Tt = D32_TROCR
    S = TROCR_S
    for key, T_, dt in (("folded", TROCR_BEAM, bf), ("prefill", 1, bf),
                        ("finetune", Tt, bf), ("finetune", Tt, f32)):
        q, k, v = rn(B, T_, H, D, dtype=dt), rn(B, S, H, D, dtype=dt), \
            rn(B, S, H, D, dtype=dt)
        shape = f"{B}x{T_}x{S}x{H}x{D} {tag(dt)}, no bias"
        fwd = lambda: fa.fused_encoder_attention(q, k, v)
        fwd_plain = lambda: fa.fused_encoder_attention_plain(q, k, v)
        yield KernelCase(
            f"#3 {key}", shape, lambda: (fwd(),), lambda: (fwd_plain(),),
            ("rel",), dt == bf and (lambda got: [KernelRow(
                "encoder_attention", key, f"#3 {key}", fwd, ENCODER_ONLY,
                fwd_plain, lambda: sdpa(q, k, v), "sdpa",
                attn_bound(B * H * T_ * S, D, 2, q, k, v, got[0]))]))
        if key != "finetune":
            continue
        do = rn(B, T_, H, D, dtype=dt)
        bwd = lambda: fa.fused_encoder_backward(q, k, v, None, do)[:3]
        bwd_plain = lambda: fa.fused_encoder_backward_plain(q, k, v, None,
                                                            do)[:3]

        def rows4(got):
            lib, library = sdpa_bwd(q, k, v, do)
            return [KernelRow("encoder_attention_bwd", key, f"#4 {key}", bwd,
                              ENC_BWD_ONLY, bwd_plain, lib, library,
                              attn_bound(B * H * T_ * S, D, 5, q, k, v, do,
                                         *got))]
        yield KernelCase("#4 finetune", shape + ", dq/dk/dv", bwd, bwd_plain,
                         ("rel",) * 3, dt == bf and rows4)

    # ---- #5, then #6 / #7 on the fine-tune's out and lse -----------------
    kw = dict(causal=True, window=0)
    for key, T_, dt in (("prefill", 1, bf), ("finetune", Tt, bf),
                        ("finetune", Tt, f32)):
        check(fa.onepass_applies(B, H, T_, T_, D, None, 0),
              f"d32_kernels: #5 does not take {B}x{T_}x{T_}x{H}x{D}")
        q = rn(B, T_, H, D, dtype=dt) * D ** -0.5
        k, v, do = (rn(B, T_, H, D, dtype=dt) for _ in range(3))
        pairs = B * H * T_ * (T_ + 1) / 2
        shape = f"{B}x{T_}x{T_}x{H}x{D} causal {tag(dt)}"
        fwd = lambda: fa.flash_forward_onepass(q, k, v, None, None, 0, None,
                                               **kw)
        fwd_plain = lambda: fa.flash_forward_onepass_plain(
            q, k, v, None, None, 0, None, **kw)
        yield KernelCase(
            f"#5 {key}", shape, fwd, fwd_plain, ("rel", "lse"),
            dt == bf and (lambda got: [KernelRow(
                "onepass_attention", key, f"#5 {key}", fwd, ONEPASS_ONLY,
                fwd_plain, lambda: sdpa(q, k, v, is_causal=True, scale=1.0),
                "sdpa is_causal", attn_bound(pairs, D, 2, q, k, v, *got))]))
        if key != "finetune":
            continue
        o, lse = fwd()
        bwd = lambda: fa.flash_backward(q, k, v, None, None, 0, None, o, lse,
                                        do, **kw)[:3]
        bwd_plain = lambda: fa.flash_backward_plain(
            q, k, v, None, None, 0, None, o, lse, do, **kw)[:3]

        def rows67(got):
            lib, library = sdpa_bwd(q, k, v, do, is_causal=True, scale=1.0)
            return [KernelRow(kname, key, f"{label} finetune", bwd, kname,
                              bwd_plain, lib, library + ", dq+dk+dv", bd)
                    for kname, label, bd in zip(
                        ("flash_bwd_dq", "flash_bwd_dkv"), ("#6", "#7"),
                        flash_bwd_bounds(pairs, q, k, v, do, lse, None,
                                         *got))]
        yield KernelCase("#6 / #7 finetune", shape + " on #5's out and lse, "
                         "dq/dk/dv", bwd, bwd_plain, ("rel",) * 3,
                         dt == bf and rows67)

    # ---- #13: the beam step's pools, bf16, int8 and fp32 -----------------
    page, chunk, PP = _scan_pool_geometry(2 + TROCR_NEW)
    Bc, L = TROCR_BEAM * B, 32
    bases = torch.arange(Bc, dtype=torch.int32, device=dev) * PP
    for kind in ("bf16", "int8", "fp32"):
        dt = f32 if kind == "fp32" else bf
        sp = None
        if kind == "int8":
            kp, vp = (torch.randint(-127, 128, (Bc * PP, page, H * D),
                                    generator=g, device=dev,
                                    dtype=torch.int8) for _ in range(2))
            sp = (torch.rand(Bc * PP // chunk, 8, chunk * page, generator=g,
                             device=dev) * 0.02 + 1e-3)
        else:
            kp, vp = (rn(Bc * PP, page, H * D, dtype=dt) for _ in range(2))
        q, kn, vn = (rn(Bc, 1, H, D, dtype=dt) for _ in range(3))
        qs = (q[:, 0] * D ** -0.5).contiguous()
        for ls in ((TROCR_LENGTHS * 20)[:Bc], [L] * Bc):
            lengths = torch.tensor(ls, dtype=torch.int32, device=dev)
            k2, v2 = kp.clone(), vp.clone()
            s2 = None if sp is None else sp.clone()
            pools = lambda *p: tuple(x for x in p if x is not None)
            shape = (f"B{Bc} L{max(ls)} H{H} D{D} page {page} chunk {chunk} "
                     f"{kind}" + ("" if ls[0] == L else
                                  f", lengths {sorted(set(ls))}"))
            plain = lambda: pa.run_decode_append_attention_plain(
                q, kn, vn, k2, v2, bases, lengths, PP, None, chunk,
                scale_pool=s2)
            rows = None
            if ls[0] == L and kind == "bf16":
                run = lambda pool: pool.reshape(Bc, PP * page, H, D)[:, :L + 1]
                rows = lambda got: [KernelRow(
                    "decode_attention", "trocr_small_step", "#13 bf16",
                    lambda: pa.decode_attention(qs, kp, vp, bases, lengths,
                                                PP),
                    DECODE_ONLY, plain, lambda: sdpa(q, run(kp), run(vp)),
                    "sdpa over the runs",
                    decode_bound(Bc * (L + 1), Bc, H, D, 2, new_rows=False),
                    flushed=True)]
            elif ls[0] == L and kind == "int8":
                kn0, vn0 = kn[:, 0].contiguous(), vn[:, 0].contiguous()
                rows = lambda got: [KernelRow(
                    "decode_attention_int8", "trocr_small_step", "#13 int8",
                    lambda: pa.decode_attention_int8(
                        qs, kp, vp, bases, lengths, sp, kn0, vn0, PP, chunk),
                    DECODE_ONLY, plain, None, "no library call",
                    decode_bound(Bc * L, Bc, H, D, 1, new_rows=True,
                                 extra=Bc * -(-L // (chunk * page)) * 8
                                 * chunk * page * 4), flushed=True)]
            yield KernelCase(
                "#13", shape,
                lambda: pools(pa.run_decode_append_attention(
                    q, kn, vn, kp, vp, bases, lengths, PP, None, chunk,
                    scale_pool=sp)[0], kp, vp, sp),
                lambda: pools(plain()[0], k2, v2, s2),
                ("out", "equal", "equal", "equal"), rows)

    # ---- off the paths: #1, #2, #8 at 2x2048x64x32 causal + kpm ----------
    B, T, H = D32_FLASH
    mask = torch.ones(B, T, dtype=torch.bool, device=dev)
    mask[1, :3] = False
    pairs = causal_pairs(mask, H)
    for dt in (bf, f32):
        q = rn(B, T, H, D, dtype=dt) * D ** -0.5
        k, v, do = (rn(B, T, H, D, dtype=dt) for _ in range(3))
        shape = f"{B}x{T}x{T}x{H}x{D} causal + kpm {tag(dt)}"
        lib = lambda: sdpa(q, k, v, is_causal=True, scale=1.0)
        for kname, label, only, fwd, fwd_plain in (
                ("flash_fwd", "#1", "flash_fwd",
                 lambda: fa.flash_forward(q, k, v, None, mask, 0, None, **kw),
                 lambda: fa.flash_forward_plain(q, k, v, None, mask, 0, None,
                                                **kw)),
                ("flash_tri", "#2", "flash_tri",
                 lambda: fa.flash_forward_tri(q, k, v, None, mask),
                 lambda: fa.flash_forward_tri_plain(q, k, v, None, mask))):
            yield KernelCase(
                label, shape, fwd, fwd_plain, ("rel", "lse"),
                dt == bf and (lambda got, kname=kname, label=label, only=only,
                              fwd=fwd, fwd_plain=fwd_plain: [KernelRow(
                    kname, "off_path", label, fwd, only, fwd_plain, lib,
                    "sdpa is_causal (no kpm)",
                    attn_bound(pairs, D, 2, q, k, v, mask, *got))]))
        o, lse = fa.flash_forward(q, k, v, None, mask, 0, None, **kw)
        bwd = lambda: fa.flash_backward_fused(q, k, v, mask, 0, None, o, lse,
                                              do, **kw)
        bwd_plain = lambda: fa.flash_backward_fused_plain(
            q, k, v, mask, 0, None, o, lse, do, **kw)

        def rows8(got):
            lib8, library = sdpa_bwd(q, k, v, do, is_causal=True, scale=1.0)
            return [KernelRow("flash_bwd_fused", "off_path", "#8", bwd,
                              "flash_bwd_fused", bwd_plain, lib8,
                              library + " is_causal, dq+dk+dv",
                              attn_bound(pairs, D, 5, q, k, v, do, lse, lse,
                                         mask.int(), *got))]
        yield KernelCase("#8", shape + " on #1's out and lse, dq/dk/dv", bwd,
                         bwd_plain, ("rel",) * 3, dt == bf and rows8)

    # ---- off the paths: #11 and #12, 16 heads of 32 ----------------------
    H, Bp, MP, pg = 16, len(PAGED_LENGTHS), PAGED_MP, PAGED_PAGE
    P = 1 + Bp * MP
    n_tok = sum(min(n, MP * pg) for n in PAGED_LENGTHS)
    for dt in (bf, f32):
        perm = torch.randperm(P - 1, generator=g, device=dev)[:Bp * MP] + 1
        tables = perm.reshape(Bp, MP).to(torch.int32).contiguous()
        kp, vp = rn(P, pg, H * D, dtype=dt), rn(P, pg, H * D, dtype=dt)
        q, kn, vn = (rn(Bp, 1, H, D, dtype=dt) for _ in range(3))
        lengths = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
        eleven = lambda: (pa.paged_decode_attention(q, kp, vp, tables,
                                                    lengths),)
        eleven_plain = lambda: (pa.paged_decode_attention_plain(
            q, kp, vp, tables, lengths),)
        yield KernelCase(
            "#11", f"B{Bp} H{H} D{D} page {pg} {tag(dt)}, lengths "
            f"{PAGED_LENGTHS[0]}..{PAGED_LENGTHS[-1]}, scattered", eleven,
            eleven_plain, ("out",), dt == bf and (lambda got: [KernelRow(
                "paged_attention", "off_path", "#11", eleven, PAGED_ONLY,
                eleven_plain, None, "no library call reads a block table",
                decode_bound(n_tok, Bp, H, D, 2, new_rows=False,
                             extra=Bp * 4, kind="fp32"), flushed=True)]))
        L12 = torch.full((Bp,), 2047, dtype=torch.int32, device=dev)
        k2, v2 = kp.clone(), vp.clone()
        twelve = lambda: pa.paged_decode_append_attention(q, kn, vn, kp, vp,
                                                          tables, L12)
        twelve_plain = lambda: pa.paged_decode_append_attention_plain(
            q, kn, vn, k2, v2, tables, L12)
        yield KernelCase(
            "#12", f"B{Bp} L2047 H{H} D{D} page {pg} {tag(dt)}, scattered, "
            "row write included", twelve, twelve_plain,
            ("out", "equal", "equal"), dt == bf and (lambda got: [KernelRow(
                "paged_append_attention", "off_path", "#12", twelve,
                "decode_kernel", twelve_plain, None,
                "no library call reads a block table",
                decode_bound(Bp * 2048, Bp, H, D, 2, new_rows=True))]))


def phase_d32_kernels(fa, da, pa, g, dev: str = "cuda") -> dict:
    """Every attention launcher at head_dim 32 against its plain version,
    bf16 and fp32 (d32_cases: relative L2 <= KERNEL_REL_L2; decode outputs
    within OUT_ATOL / OUT_RTOL with the pools bit-equal), at the shapes
    the D = 32 paths give them: #9 / #10 at the distill student's
    32x512x12x32 with a key-padding mask (lengths 64-512); #3 at
    TrOCR-Small's folded decode 32x5x578x8x32, its prefill 32x1x578 and its
    fine-tune 32x64x578; #4 at the fine-tune's 32x64x578x8x32; #5 at the
    prefill's 32x1x1x8x32 (the walk) and the fine-tune's causal
    32x64x64x8x32 (the wgmma rows); #6 / #7 there on #5's out and lse;
    #13 bf16 and int8 (and fp32 pools) at the beam step's B160 L32 H8,
    page 16, chunk 2; off the paths, #1 / #2 / #8 at 2x2048x64x32 causal
    with a key-padding mask, #11 at B8 H16 pages of 64 with PAGED_LENGTHS,
    #12 at B8 L2047 H16. Every launch must take its D = 32 instantiation
    (CudaKernel.by_head_dim). The bf16 cases timed (device time) beside
    the plain version, the library call and the bound (attn_bound,
    flash_bwd_bounds, decode_bound: as the per-kernel phases count them).
    Returns {kernel name: {"d32": {key: row}}}."""
    name, out = "d32_kernels", {}
    reset_counts()
    for c in d32_cases(fa, da, pa, g, dev):
        got, want = c.run(), c.plain()
        torch.cuda.synchronize()
        tol = (f"{OUT_ATOL} abs + {OUT_RTOL} rel" if c.how[0] == "out"
               else KERNEL_REL_L2[got[0].dtype])
        e = held(f"{name}: {c.label} {c.shape}", zip(got, want, c.how))
        rows = c.rows(got) if c.rows else []
        if not rows:
            phase(name, f"{c.label} {c.shape}: rel L2 {e['rel_l2']:.3g}, "
                  f"max|err| {e['max_abs_err']:.3g} (bound {tol})"
                  + (", pools bit-equal" if "equal" in c.how else "") + " ok")
        for row in rows:
            r = {"shape": c.shape, **e, "library": row.library,
                 **kernel_timed(row.call, row.plain, row.lib, row.only,
                                row.bound, row.flushed)}
            kernel_line(name, row.label, r, tol)
            out.setdefault(row.kernel, {}).setdefault("d32", {})[row.key] = r
        del c, got, want, rows
    dims = by_head_dim()
    check(all(set(d) == {D32} for d in dims.values()) and len(dims) == 15,
          f"{name}: launches by head dim {dims}")
    phase(name, "launches by head dim: " + ", ".join(
        f"{k} {d}" for k, d in dims.items()))
    torch.cuda.empty_cache()
    return out


def register_kernels() -> tuple:
    """Every launcher under its counter's name in KERNELS; returns the
    kernel modules (da, fa, fu, pa, qm)."""
    from unilm_tpu_torch.ops import doc_attention as da
    from unilm_tpu_torch.ops import flash_attention as fa
    from unilm_tpu_torch.ops import fused as fu
    from unilm_tpu_torch.ops import paged_attention as pa
    from unilm_tpu_torch.ops import quant as qm

    KERNELS.update({"flash_fwd": fa.KERNEL,
                    "onepass_attention": fa.ONEPASS_KERNEL,
                    "flash_tri": fa.TRI_KERNEL,
                    "encoder_attention": fa.ENCODER_KERNEL,
                    "decode_attention": pa.KERNEL,
                    "decode_attention_int8": pa.KERNEL_INT8,
                    "int8_matmul": qm.KERNEL,
                    "paged_append_attention": pa.APPEND_KERNEL,
                    "flash_bwd_dq": fa.BWD_KERNEL_DQ,
                    "flash_bwd_dkv": fa.BWD_KERNEL_DKV,
                    "flash_bwd_fused": fa.FUSED_BWD_KERNEL,
                    "flash_bwd_delta": fa.BWD_KERNEL_DELTA,
                    "encoder_attention_bwd": fa.ENCODER_BWD_KERNEL,
                    "doc_attention": da.FWD_KERNEL,
                    "doc_attention_bwd": da.BWD_KERNEL,
                    "paged_attention": pa.PAGED_KERNEL,
                    "swiglu": fu.SWIGLU_KERNEL,
                    "rotary": fu.ROTARY_KERNEL})
    return da, fa, fu, pa, qm


def main() -> int:
    smi = phase_device()
    da, fa, fu, pa, qm = register_kernels()
    phase_build()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = [phase_flash(fa, g), phase_onepass(fa, g),
               phase_flash_tri(fa, g),
               *phase_flash_bwd(fa, g), phase_flash_bwd_fused(fa, g),
               phase_encoder_attn(fa, g), phase_encoder_bwd(fa, g),
               phase_doc_attn(da, g), phase_doc_bwd(da, g),
               phase_decode(pa, g), phase_decode_int8(pa, g),
               phase_int8_matmul(qm, g), phase_paged_append(pa, g),
               phase_paged(pa, g)]
    d32_extra = phase_d32_kernels(
        fa, da, pa, torch.Generator(device="cuda").manual_seed(SEED))
    by_path = {}  # kernel -> {main path: launches}

    def add(path, got):
        for k, v in got.items():
            by_path.setdefault(k, {})[path] = v

    fused_kernels, got = phase_fused(fu, g)
    kernels += fused_kernels
    add("fused", got)
    add("slice", phase_slice(fa, pa))
    add("beit_eval", phase_beit_eval(fa))
    add("beit_train", phase_beit_train(fa))
    add("layoutlmv3_eval", phase_layoutlmv3_eval())
    add("layoutlmv3_train", phase_layoutlmv3_train())
    got, options = phase_train_options_encoders()
    add("train_options", got)
    docai_extra = phase_docai_kernels(fa, da, g)
    got, docai_nums = phase_docai()
    add("docai", got)
    add("ttft", phase_ttft(fa))
    got, line4 = phase_decode_int8_bs1(qm, pa, g)
    add("decode_int8_bs1", got)
    got, infer = phase_kosmos_infer(qm)
    add("kosmos_infer", got)
    trocr_extra = phase_trocr_kernels(fa, pa, qm, g)
    got, trocr_bf16 = phase_trocr(qm, int8=False)
    add("trocr", got)
    got, trocr_int8 = phase_trocr(qm, int8=True)
    add("trocr_int8", got)
    got, trocr_train_nums = phase_trocr_train()
    add("trocr_train", got)
    got, trocr_small = phase_trocr(qm, int8=False, arch="trocr_small")
    add("trocr_small", got)
    got, trocr_small_int8 = phase_trocr(qm, int8=True, arch="trocr_small")
    add("trocr_small_int8", got)
    got, trocr_small_train = phase_trocr_train("trocr_small")
    add("trocr_small_train", got)
    add("spm", phase_spm())
    got, search_nums = phase_search(fa)
    add("search", got)
    kosmos2_extra = phase_kosmos2_kernels(fa, pa, g)
    got, kosmos2_nums = phase_kosmos2(fa)
    add("kosmos2", got)
    got, kosmos2_train_nums = phase_kosmos2_train(fa)
    add("kosmos2_train", got)
    beit_family_extra = phase_beit_family_kernels(
        fa, da, torch.Generator(device="cuda").manual_seed(SEED))
    got, beit3_nums = phase_beit3(fa)
    add("beit3", got)
    got, beit2_nums = phase_beit2(fa)
    add("beit2", got)
    add("reproduce_baseline", phase_reproduce_baseline())
    registry_extra = phase_registry_kernels(
        fa, da, pa, torch.Generator(device="cuda").manual_seed(SEED))
    got, registry_text_nums = phase_registry_text(fa)
    add("registry_text", got)
    got, registry_speech_nums = phase_registry_speech(fa)
    add("registry_speech", got)
    detection_extra = phase_detection_kernels(
        fa, torch.Generator(device="cuda").manual_seed(SEED))
    got, rcnn_nums = phase_rcnn()
    add("rcnn", got)
    got, fcos_nums = phase_fcos()
    add("fcos", got)
    got, seg_nums = phase_segmentation()
    add("segmentation", got)
    last_nums = {}
    for name, fn in (("latentlm", phase_latentlm),
                     ("textdiffuser2", phase_textdiffuser2),
                     ("distill", phase_distill), ("dpo", phase_dpo)):
        got, more = fn()
        add(name, got)
        last_nums.update(more)
    last_nums.update(phase_misc_ops())
    add("yoco_chat", phase_yoco_chat(fa))
    phase_yoco_long(fa)
    cfg, sd = engine_model()
    add("engine_int8", phase_engine_int8(cfg, sd))
    add("engine_bf16_prefix", phase_engine_bf16_prefix(cfg, sd))
    del cfg, sd
    torch.cuda.empty_cache()
    add("page_pool", phase_page_pool())
    got, (got_options, unigpt_options) = phase_train(fa)
    add("train", got)
    add("train_options", got_options)
    options.update(unigpt_options)
    add("moe_train", phase_moe_train(fa))
    add("moe_serve", phase_moe_serve())
    got, ring_extra = phase_ring(fa)
    add("ring", got)
    import shutil

    import torch.distributed as dist

    dist.destroy_process_group()
    shutil.rmtree(WORK, ignore_errors=True)
    for kern in kernels:
        paths = by_path.get(kern["name"], {})
        kern["launches"] = sum(paths.values())
        kern["launches_by_path"] = paths
        kern.update(line4.get(kern["name"], {}))
        kern.update(trocr_extra.get(kern["name"], {}))
        kern.update(kosmos2_extra.get(kern["name"], {}))
        kern.update(beit_family_extra.get(kern["name"], {}))
        kern.update(docai_extra.get(kern["name"], {}))
        kern.update(ring_extra.get(kern["name"], {}))
        kern.update(registry_extra.get(kern["name"], {}))
        kern.update(detection_extra.get(kern["name"], {}))
        kern.update(d32_extra.get(kern["name"], {}))
        check(kern["launches"] > 0, f"{kern['name']} never launched")
    print(json.dumps({"paths": {"decode_int8_bs1": line4["line4"],
                                **infer, **trocr_bf16, **trocr_int8,
                                **kosmos2_nums, **kosmos2_train_nums,
                                **beit3_nums, **beit2_nums, **search_nums,
                                "train_options": options, **docai_nums,
                                **trocr_train_nums, **trocr_small,
                                **trocr_small_int8, **trocr_small_train,
                                **registry_text_nums,
                                **registry_speech_nums, **rcnn_nums,
                                **fcos_nums, **seg_nums, **last_nums}}),
          flush=True)
    phase("profiler", f"{len(PROFILER_MISSES)} device_ms calls fell back "
          f"to CUDA events: {PROFILER_MISSES}; {len(PROFILER_LOST)} traces "
          f"lost kernel records (each timed by the mean of those kept): "
          f"{PROFILER_LOST}")
    phase("total", f"{time.time() - T0:.1f} s from the start, the kernels' "
          "build included")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
