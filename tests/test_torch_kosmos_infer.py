"""Port parity for cli/kosmos_infer.py and convert/kosmos.py on the CPU:
one synthesised fairseq Kosmos-2.5 checkpoint at the CLI's --tiny widths
(the layout of tests/test_kosmos_converter.py's end-to-end test) and one
image go through unilm_tpu_torch.cli.kosmos_infer and
unilm_tpu.cli.kosmos_infer; the generated ids must be identical.

tiktoken is hidden from both CLIs (the JAX CLI would fetch cl100k_base),
so both print the ids. Under --int8 the JAX CLI's predicate also
quantizes the Pix2Struct tower and its encode_image raises (pinned
below); for the comparison its quantize_dense_tree is restricted to the
text decoder, which is what the port quantizes. Tolerances: ids
identical; the converted trees leaf for leaf equal; logits 1e-4 (fp32).
"""

import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.cli import kosmos_infer as jcli
from unilm_tpu.convert import kosmos as jconv
from unilm_tpu.models import kosmos as jk
from unilm_tpu.ops import quant as jq
from unilm_tpu_torch.cli import kosmos_infer as tcli
from unilm_tpu_torch.convert import kosmos as tconv
from unilm_tpu_torch.convert.from_jax import load_flax_params
from unilm_tpu_torch.models import kosmos as tk
from unilm_tpu_torch.ops import quant as tq

torch.set_num_threads(1)

IDS = ["--image_id", "5", "--image_end_id", "6", "--ocr_id", "7",
       "--md_id", "8"]
LOGIT_ATOL = 1e-4


def _fairseq_sd(seed=1):
    """A fairseq Kosmos-2.5 state dict at the CLI's --tiny widths."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    E, L, FFN, V = 64, 2, 128, 2048
    sd, dp = {}, "gpt_model.decoder."
    sd[dp + "embed_tokens.weight"] = r(V, E)
    sd[dp + "segment_emb.weight"] = r(2, E)
    for i in range(L):
        p = f"{dp}layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[p + f"self_attn.{n}.weight"] = r(E, E)
            sd[p + f"self_attn.{n}.bias"] = r(E)
        for n, d in (("self_attn.inner_attn_ln", E),
                     ("self_attn_layer_norm", E), ("final_layer_norm", E),
                     ("ffn.ffn_layernorm", FFN)):
            sd[p + n + ".weight"] = 1.0 + r(d)
            sd[p + n + ".bias"] = r(d)
        sd[p + "ffn.fc1.weight"] = r(FFN, E)
        sd[p + "ffn.fc1.bias"] = r(FFN)
        sd[p + "ffn.fc2.weight"] = r(E, FFN)
        sd[p + "ffn.fc2.bias"] = r(E)
    sd[dp + "layer_norm.weight"] = 1.0 + r(E)
    sd[dp + "layer_norm.bias"] = r(E)
    ip = "img_model."
    sd[ip + "embeddings.patch_projection.weight"] = r(32, 768)
    sd[ip + "embeddings.patch_projection.bias"] = r(32)
    sd[ip + "embeddings.row_embedder.weight"] = r(4096, 32)
    sd[ip + "embeddings.column_embedder.weight"] = r(4096, 32)
    lp = ip + "encoder.layer.0."
    for n, shape in (("attention.query", (32, 32)),
                     ("attention.key", (32, 32)),
                     ("attention.value", (32, 32)),
                     ("attention.output", (32, 32)),
                     ("mlp.wi_0", (64, 32)), ("mlp.wi_1", (64, 32)),
                     ("mlp.wo", (32, 64))):
        sd[lp + n + ".weight"] = r(*shape)
    sd[lp + "pre_attention_layer_norm.weight"] = 1.0 + r(32)
    sd[lp + "pre_mlp_layer_norm.weight"] = 1.0 + r(32)
    sd[ip + "layernorm.weight"] = 1.0 + r(32)
    sd["img_connector.dense.weight"] = r(E, 32)
    sd["img_connector.dense.bias"] = r(E)
    sd["img_connector.latent_query"] = r(8, E)
    for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
        sd[f"img_connector.x_attn.{n}.weight"] = r(E, E)
        sd[f"img_connector.x_attn.{n}.bias"] = r(E)
    return sd


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("kosmos_cli")
    ckpt = d / "kosmos_tiny.pt"
    torch.save({"model": _fairseq_sd()}, ckpt)
    img = d / "doc.png"
    Image.fromarray((np.random.RandomState(0).rand(48, 64, 3) * 255)
                    .astype(np.uint8)).save(img)
    return str(ckpt), str(img)


def _argv(files, *flags):
    ckpt, img = files
    return ["--image", img, "--task", "ocr", "--checkpoint", ckpt, "--tiny",
            "--fp32", "--max_new_tokens", "5", "--max_patches", "16",
            "--num_image_tokens", "8", *IDS, *flags]


def _jax_args(argv):
    """The JAX CLI's argparse namespace (its parser lives inside main)."""
    p = argparse.ArgumentParser()
    for name in ("--image", "--task", "--checkpoint"):
        p.add_argument(name, default="")
    for name, default in (("--max_new_tokens", 1024), ("--beam", 1),
                          ("--max_patches", 4096),
                          ("--num_image_tokens", 2048), ("--image_id", 0),
                          ("--image_end_id", 0), ("--ocr_id", 0),
                          ("--md_id", 0)):
        p.add_argument(name, type=int, default=default)
    for name in ("--int8", "--no_scan", "--fp32", "--tiny"):
        p.add_argument(name, action="store_true")
    args = p.parse_args(argv)
    args.bf16 = True
    return args


def _decoder_only(monkeypatch):
    """Restrict the JAX quantize_dense_tree to the text decoder (the
    port's predicate), leaving the JAX package's files untouched."""
    orig = jq.quantize_dense_tree
    monkeypatch.setattr(jq, "quantize_dense_tree", lambda params, predicate=None:
                        orig(params, predicate=lambda p: predicate(p)
                             and tq.is_decoder_projection(p)))


@pytest.mark.parametrize("flags", [["--beam", "1"], ["--beam", "3"],
                                   ["--int8"], ["--int8", "--beam", "3"],
                                   ["--int8", "--no_scan"]],
                         ids=["beam1", "beam3", "int8", "int8_beam3",
                              "int8_no_scan"])
def test_cli_ids_match_jax(files, flags, monkeypatch):
    monkeypatch.setitem(sys.modules, "tiktoken", None)
    argv = _argv(files, *flags)
    if "--int8" in flags:
        _decoder_only(monkeypatch)
    want = jcli.build_pipeline(_jax_args(argv))(files[1]).split()
    pipe = tcli.build_pipeline(tcli.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    got = pipe(files[1]).split()
    assert got == want
    assert len(got) == 5  # random weights draw no eos in 5 tokens
    cfg = pipe.model.cfg
    assert cfg.quant_weights == ("--int8" in flags)
    assert cfg.kv_cache_dtype == ("int8" if flags[-1] != "--no_scan"
                                  and "--int8" in flags else "model")


def test_cli_int8_jax_fault_and_main(files, monkeypatch, capsys):
    """The JAX CLI's own --int8 quantizes the tower and fails in
    encode_image; the port's main() runs it (ocr records of id text: none)
    and prints; without --device cpu on this host it raises."""
    monkeypatch.setitem(sys.modules, "tiktoken", None)
    argv = _argv(files, "--int8")
    infer = jcli.build_pipeline(_jax_args(argv))
    with pytest.raises(Exception, match="kernel"):
        infer(files[1])
    tcli.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out.count("WARNING") == 0
    md = argv[:]
    md[md.index("ocr")] = "md"
    tcli.main(md + ["--device", "cpu"])
    printed = capsys.readouterr().out.split()
    assert len(printed) == 5 and all(t.isdigit() for t in printed)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            tcli.main(argv)


def test_infer_patches_is_the_image_path_without_pil(files, monkeypatch):
    """infer_patches on the patches the image path makes gives its ids;
    generate() exposes the beams and their scores."""
    monkeypatch.setitem(sys.modules, "tiktoken", None)
    from PIL import Image

    from unilm_tpu_torch.data.transforms import pix2struct_patches, to_numpy

    pipe = tcli.build_pipeline(tcli.build_parser().parse_args(
        _argv(files, "--beam", "2", "--device", "cpu")))
    patches = pix2struct_patches(to_numpy(Image.open(files[1])),
                                 max_patches=16)
    ids = pipe.infer_patches(patches)
    assert " ".join(map(str, ids)) == pipe(files[1])
    toks, scores = pipe.generate(torch.from_numpy(patches))
    assert toks.shape == (1, 2, pipe.tokens.shape[1] + 5)
    assert scores.shape == (1, 2) and bool(scores[0, 0] >= scores[0, 1])


def test_prompt_and_postprocess_match_jax():
    for task_id in (7, 8):
        for a, b in zip(tcli.build_prompt("md", 8, 5, 6, task_id),
                        jcli.build_prompt("md", 8, 5, 6, task_id)):
            np.testing.assert_array_equal(a, b)
    text = ("<bbox><x_1><y_2><x_30><y_40></bbox> hello \n"
            "<bbox><x_5><y_6><x_7><y_8></bbox>world<md>")
    assert tcli.postprocess_ocr(text) == jcli.postprocess_ocr(text)
    assert len(tcli.postprocess_ocr(text)) == 2


def test_detokenize_without_cl100k_prints_ids(monkeypatch, tmp_path):
    """Without cl100k_base in tiktoken's cache the CLI prints the ids (it
    never fetches the file)."""
    monkeypatch.setenv("TIKTOKEN_CACHE_DIR", str(tmp_path))
    assert tcli._cl100k() is None
    assert tcli.detokenize([10, 11, 2]) == "10 11 2"
    monkeypatch.setitem(sys.modules, "tiktoken", None)
    assert tcli.detokenize([4]) == "4"


def test_converter_matches_jax():
    """convert_unigpt of the port and of JAX on one fairseq state dict:
    the same tree leaf for leaf, and the same train-forward logits with the
    image through the tower and the resampler."""
    sd = _fairseq_sd(seed=3)
    pcfg = dict(hidden_size=32, num_layers=1, num_heads=2, d_ff=64, d_kv=16,
                patch_dim=768, max_rows=4096, use_flash=False)
    kw = dict(embed_dim=64, num_layers=2, num_heads=4, ffn_dim=128,
              vocab_size=2048, max_positions=4096 + 64, latent_query_num=8,
              use_flash=False)
    jcfg = jk.kosmos2_5(pix2struct=jk.Pix2StructVisionConfig(**pcfg), **kw)
    tcfg = tk.kosmos2_5(pix2struct=tk.Pix2StructVisionConfig(**pcfg), **kw)
    want = jax.device_get(jconv.convert_unigpt(sd, jcfg))
    got = tconv.convert_unigpt(sd, tcfg)
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (path, a), (_, b) in zip(wl, gl):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    assert "img_model" in got and "img_connector" in got

    tm = tk.UniGPT(tcfg).eval()
    load_flax_params(tm, got)
    jm = jk.UniGPT(jcfg)
    ids, mask, segs = tcli.build_prompt("ocr", 8, 5, 6, 7)
    rng = np.random.RandomState(4)
    patches = np.zeros((1, 16, 770), np.float32)
    patches[0, :12, 0] = np.repeat(np.arange(3), 4) + 1
    patches[0, :12, 1] = np.tile(np.arange(4), 3) + 1
    patches[0, :12, 2:] = rng.randn(12, 768)
    lj = jm.apply({"params": want}, jnp.asarray(ids)[None],
                  jnp.asarray(patches), jnp.asarray(mask)[None],
                  jnp.asarray(segs)[None])
    with torch.no_grad():
        lt = tm(torch.from_numpy(ids)[None].long(), torch.from_numpy(patches),
                torch.from_numpy(mask)[None], torch.from_numpy(segs)[None].long())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_ATOL,
                               rtol=0)
    # the open_clip tower (Kosmos-2): the same decoder and connector with
    # img_model.visual.* tensors (packed in_proj) in place of Pix2Struct's
    g = torch.Generator().manual_seed(5)
    r = lambda *shape: torch.randn(*shape, generator=g) * 0.02
    csd = {k: v for k, v in sd.items() if not k.startswith("img_model.")}
    vp, E = "img_model.visual.", 32
    csd.update({vp + "conv1.weight": r(E, 3, 14, 14),
                vp + "class_embedding": r(E),
                vp + "positional_embedding": r(5, E)})
    for n in ("ln_pre", "ln_post", "transformer.resblocks.0.ln_1",
              "transformer.resblocks.0.ln_2"):
        csd[f"{vp}{n}.weight"], csd[f"{vp}{n}.bias"] = 1.0 + r(E), r(E)
    blk = vp + "transformer.resblocks.0."
    csd[blk + "attn.in_proj_weight"] = r(3 * E, E)
    csd[blk + "attn.in_proj_bias"] = r(3 * E)
    for n, (o, i) in (("attn.out_proj", (E, E)), ("mlp.c_fc", (64, E)),
                      ("mlp.c_proj", (E, 64))):
        csd[f"{blk}{n}.weight"], csd[f"{blk}{n}.bias"] = r(o, i), r(o)
    ccfg = dict(img_size=28, patch_size=14, embed_dim=E, num_layers=1,
                num_heads=2, ffn_dim=64, use_flash=False)
    jc = jk.kosmos2(clip=jk.ClipVisionConfig(**ccfg), segment_emb=True,
                    **kw)
    tc = tk.kosmos2(clip=tk.ClipVisionConfig(**ccfg), segment_emb=True,
                    **kw)
    want = jax.device_get(jconv.convert_unigpt(csd, jc))
    got = tconv.convert_unigpt(csd, tc)
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (path, a), (_, b) in zip(wl, gl):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    assert set(got["img_model"]) == {"conv1", "class_embedding",
                                     "positional_embedding", "ln_pre",
                                     "ln_post", "transformer"}
    load_flax_params(tk.UniGPT(tc).eval(), got)
