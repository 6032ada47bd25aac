"""Port parity for Kosmos-2's data side on the CPU: data/grounding.py,
data/vl_loaders.py (VLTokenizer, insert_grounding_markup, load_image,
assemble_sample, laion_obj_stream, interleaved_stream, vl_batch_stream)
and the iterators they run on (SelectManyIterator,
BufferedShuffleIterator), against unilm_tpu.

Both tokenizers are pinned to the byte backend (the JAX tokenizer's
"auto" would fetch cl100k_base). Shards, captions, boxes and images are
made from numpy with a seed. Everything compares exactly: ids, strings,
pixels, sample and batch arrays, and iterator states (through JSON, as a
checkpoint stores them).
"""

import json
import os
import sys

import numpy as np
import pytest

from unilm_tpu.data import grounding as jg
from unilm_tpu.data import iterators as jit
from unilm_tpu.data import vl_loaders as jv
from unilm_tpu_torch.data import grounding as tg
from unilm_tpu_torch.data import iterators as tit
from unilm_tpu_torch.data import vl_loaders as tv

WORDS = ["a", "dog", "cat", "man", "red", "car", "on", "the", "grass",
         "tree", "near", "big", "héllo", "日本"]


def _caption(rng, n):
    ws = [WORDS[i] for i in rng.randint(0, len(WORDS), size=n)]
    return " ".join(ws), np.cumsum([0] + [len(w) + 1 for w in ws])


def _laion_records(seed, n):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        cap, starts = _caption(rng, rng.randint(3, 30))
        k = len(starts) - 1
        objs = []
        for j in sorted(rng.choice(k, min(k, rng.randint(0, 3)),
                                   replace=False)):
            boxes = []
            for _ in range(rng.randint(1, 3)):
                (x0, x1), (y0, y1) = sorted(rng.rand(2)), sorted(rng.rand(2))
                boxes.append([x0, y0, x1, y1])
            objs.append({"span": [int(starts[j]), int(starts[j + 1] - 1)],
                         "boxes": boxes})
        if i == 2:  # an overlapping span, skipped by both
            objs.append({"span": [0, 3], "boxes": [[0.1, 0.1, 0.2, 0.2]]})
        out.append({"caption": cap, "image": None if i % 3 else f"img{i}.png",
                    "objects": objs})
    return out


def _interleaved_records(seed, n):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        segs = []
        for j in range(rng.randint(1, 5)):
            if rng.rand() < 0.4:
                segs.append({"image": f"d{i}_{j}.png"})
            else:
                segs.append({"text": _caption(rng, rng.randint(1, 12))[0]})
        out.append({"segments": segs})
    return out


def _write(path, records):
    path.write_text("\n".join(json.dumps(r) for r in records) + "\n")
    return str(path)


def _toks(q=32):
    return (jv.VLTokenizer(q, backend="bytes"),
            tv.VLTokenizer(q, backend="bytes"))


@pytest.mark.parametrize("q", [32, 16])
def test_tokenizer_ids_and_markup_match_jax(q):
    jt, tt = _toks(q)
    assert (tt.text_vocab, tt.loc_base, tt.vocab_size) == (
        jt.text_vocab, jt.loc_base, jt.vocab_size)
    assert tt.special_to_id == jt.special_to_id and tt.text_vocab == 256
    rng = np.random.RandomState(q)
    for rec in _laion_records(q, 8):
        text = tv.insert_grounding_markup(rec["caption"], rec["objects"], q)
        assert text == jv.insert_grounding_markup(rec["caption"],
                                                  rec["objects"], q)
        ids = tt.encode_grounded(text)
        assert ids == jt.encode_grounded(text)
        assert tt.decode(ids) == jt.decode(ids) == text
        assert tt.encode_text(rec["caption"]) == jt.encode_text(rec["caption"])
    for _ in range(20):
        box = tuple(sorted(rng.rand(2))) + tuple(sorted(rng.rand(2)))
        box = (box[0], box[2], box[1], box[3])
        assert tg.box_to_patch_indices(box, q) == jg.box_to_patch_indices(
            box, q)
        assert tg.box_tokens(box, q) == jg.box_tokens(box, q)
        ul, lr = tg.box_to_patch_indices(box, q)
        assert tg.patch_indices_to_box(ul, lr, q) == jg.patch_indices_to_box(
            ul, lr, q)
    text = ("<grounding>two <phrase>dogs</phrase><object><patch_index_0012>"
            "<patch_index_0300></delimiter_of_multi_objects/>"
            "<patch_index_0001>"
            "<patch_index_0033></object> and <phrase>x</phrase><object>"
            "</object>  end")
    assert tg.parse_grounded_text(text, q) == jg.parse_grounded_text(text, q)


def test_tokenizer_backends(monkeypatch, tmp_path):
    """"auto" takes cl100k_base only from tiktoken's cache (never a
    download): with an empty cache, or tiktoken hidden, it is the byte
    backend; "tiktoken" then raises. "spm" (or "auto" with an spm_path)
    reads the sentencepiece model through data/spm.py, with JAX's ids."""
    monkeypatch.setenv("TIKTOKEN_CACHE_DIR", str(tmp_path))
    assert tv.cl100k_if_cached() is None
    assert tv.VLTokenizer().text_vocab == 256
    with pytest.raises(RuntimeError, match="not in its cache"):
        tv.VLTokenizer(backend="tiktoken")
    monkeypatch.setitem(sys.modules, "tiktoken", None)
    assert tv.VLTokenizer().text_vocab == 256
    model = os.path.join(os.path.dirname(__file__), "fixtures",
                         "tiny_digits.model")
    want = jv.VLTokenizer(backend="spm", spm_path=model)
    text = "<grounding>12 <phrase>340</phrase><object><patch_index_0012>"
    for tok in (tv.VLTokenizer(backend="spm", spm_path=model),
                tv.VLTokenizer(spm_path=model)):
        assert (tok.text_vocab, tok.vocab_size) == (want.text_vocab,
                                                    want.vocab_size)
        ids = tok.encode_grounded(text)
        assert ids == want.encode_grounded(text)
        assert tok.decode_text(tok.encode_text("12 340")) == "12 340"
    with pytest.raises(ValueError, match="spm_path"):
        tv.VLTokenizer(backend="spm")


def test_load_image_matches_jax(tmp_path):
    from PIL import Image

    arr = (np.random.RandomState(0).rand(20, 30, 3) * 255).astype(np.uint8)
    Image.fromarray(arr).save(tmp_path / "a.png")
    for args in (("a.png", str(tmp_path), 16), (str(tmp_path / "a.png"), "",
                                                 24),
                 ("missing.png", str(tmp_path), 16), (None, "", 8, "key")):
        got, want = tv.load_image(*args), jv.load_image(*args)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_assemble_sample_matches_jax():
    jt, tt = _toks()
    rng = np.random.RandomState(1)
    img = lambda: rng.rand(8, 8, 3).astype(np.float32)
    cases = [
        [("image", img()), ("text", list(range(10, 40)))],
        [("text", [5, 6]), ("image", img()), ("text", [7] * 50),
         ("image", img())],  # a second image past max_images: skipped
        [("image", img()), ("text", [9] * 200)],  # text cut at T
        [("image", img())],  # no text: None
        [("text", [1, 2, 3])],  # no image: None
        [("text", [3] * 60), ("image", img()), ("text", [4])],  # no room
    ]
    for max_images in (1, 2):
        spec_j = jv.VLSampleSpec(tokens_per_sample=64, image_tokens=6,
                                 image_size=8, max_images=max_images)
        spec_t = tv.VLSampleSpec(tokens_per_sample=64, image_tokens=6,
                                 image_size=8, max_images=max_images)
        for segs in cases:
            want = jv.assemble_sample(jt, spec_j, segs)
            got = tv.assemble_sample(tt, spec_t, segs)
            if want is None:
                assert got is None
                continue
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _streams(kind, shards, tok_j, tok_t, T=96):
    kw = dict(tokens_per_sample=T, image_tokens=8, image_size=8)
    maker_j = jv.laion_obj_stream if kind == "laion" else jv.interleaved_stream
    maker_t = tv.laion_obj_stream if kind == "laion" else tv.interleaved_stream
    mi = 1 if kind == "laion" else 2
    js = jv.vl_batch_stream(maker_j(shards, tok_j, jv.VLSampleSpec(
        max_images=mi, **kw), seed=3, shuffle_buffer=5), 3)
    ts = tv.vl_batch_stream(maker_t(shards, tok_t, tv.VLSampleSpec(
        max_images=mi, **kw), seed=3, shuffle_buffer=5), 3)
    return js, ts


def _same_batch(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind", ["laion", "interleaved"])
def test_vl_streams_and_resume_match_jax(kind, tmp_path):
    """Batches equal JAX's across two shards and several epochs; the
    state after each batch equals JAX's, survives JSON, and a fresh
    stream set to it continues exactly."""
    recs = (_laion_records if kind == "laion" else _interleaved_records)
    shards = [_write(tmp_path / "s0.jsonl", recs(10, 7)),
              _write(tmp_path / "s1.jsonl", recs(11, 5))]
    jt, tt = _toks()
    js, ts = _streams(kind, shards, jt, tt)
    states = []
    for _ in range(9):
        _same_batch(next(ts), next(js))
        st = json.loads(json.dumps(ts.getstate()))
        assert st == json.loads(json.dumps(js.getstate()))
        states.append(st)
    tail = [next(ts) for _ in range(3)]
    for i in (0, 4, 8):
        _, fresh = _streams(kind, shards, jt, tt)
        fresh.setstate(states[i])
        ahead = [next(fresh) for _ in range(8 - i + 3)]
        for a, b in zip(ahead[8 - i:], tail):
            _same_batch(a, b)


def test_select_many_and_buffered_shuffle_match_jax():
    """The two iterators alone: the same items and states as JAX's, and a
    resume from every position continues exactly."""
    def pair(mod):
        src = mod.InfinitePermutationSourceIterator(list(range(6)), seed=4)
        many = mod.SelectManyIterator(src, lambda i: [i] * (i % 3))
        return mod.BufferedShuffleIterator(many, 4, seed=5)

    a, b = pair(tit), pair(jit)
    states, items = [], []
    for _ in range(25):
        states.append(json.loads(json.dumps(a.getstate())))
        assert states[-1] == json.loads(json.dumps(b.getstate()))
        items.append(next(a))
        assert items[-1] == next(b)
    for i in range(0, 25, 3):
        c = pair(tit)
        c.setstate(states[i])
        assert [next(c) for _ in range(25 - i)] == items[i:]
