"""Port parity for the host data modules and the math scorer, against
unilm_tpu on the same inputs: data/bpe.py (and HF `tokenizers` on a
vocabulary trained offline, as tests/test_bpe.py), data/instructgen.py
(MathScale / GLAN with tests/test_mathscale_glan.py's scripted clients),
data/vocab_adapt.py (AdaLM), data/webdataset.py (on the port's
data/iterators.py) and scoring_math.py. Every output is compared for
equality (ids, records, vocabularies, batches, judgements); embeddings
at 0 (the same numpy code)."""

import io

import numpy as np
import pytest

from test_mathscale_glan import (SEEDS, scripted_glan_client,
                                 scripted_math_client)
from test_vocab_adapt import DOMAIN_DOCS
from unilm_tpu import scoring_math as jsm
from unilm_tpu.data import bpe as jbpe
from unilm_tpu.data import instructgen as jig
from unilm_tpu.data import vocab_adapt as jva
from unilm_tpu.data import webdataset as jwd
from unilm_tpu_torch import scoring_math as tsm
from unilm_tpu_torch.data import bpe as tbpe
from unilm_tpu_torch.data import instructgen as tig
from unilm_tpu_torch.data import iterators as tit
from unilm_tpu_torch.data import vocab_adapt as tva
from unilm_tpu_torch.data import webdataset as twd

tokenizers = pytest.importorskip("tokenizers")

SAMPLES = [
    "The quick brown fox jumps over the lazy dog.",
    "TOTAL: $12.50 (incl. VAT)",
    "naive cafe",
    "hello   world\nnew line",
    "don't you've we'll they'd I'm",
    "mixed123numbers and CamelCase tokens!!!",
]


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bpe")
    corpus = d / "corpus.txt"
    corpus.write_text("\n".join(SAMPLES * 30) + "\nsome more filler text\n")
    tok = tokenizers.ByteLevelBPETokenizer()
    tok.train([str(corpus)], vocab_size=600, min_frequency=1,
              special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"])
    tok.save_model(str(d))
    return d, tok


def test_bpe_matches_jax_and_hf_tokenizers(bpe_dir):
    d, hf = bpe_dir
    ours = tbpe.ByteLevelBPE.from_pretrained_dir(str(d))
    ref = jbpe.ByteLevelBPE.from_pretrained_dir(str(d))
    for text in SAMPLES + ["unseen zebra querying", " leading space", ""]:
        got = ours.encode(text)
        assert got == ref.encode(text) == hf.encode(text).ids, text
        assert ours.decode(got) == text
    rt, rj = (m.RobertaTokenizer.from_pretrained_dir(str(d))
              for m in (tbpe, jbpe))
    assert (rt.bos, rt.pad, rt.eos, rt.unk) == (rj.bos, rj.pad, rj.eos,
                                                rj.unk)
    for words in (["TOTAL:", "$12.50"], ["naive", "cafe", "!!!"]):
        assert rt.encode_words(words) == rj.encode_words(words)
    ids = rt.encode("hello world")
    assert ids == rj.encode("hello world")
    assert rt.decode(ids) == rj.decode(ids) == "hello world"


def test_instructgen_matches_jax():
    ext = tig.extract_concepts(scripted_math_client, list(SEEDS))
    assert ext == jig.extract_concepts(scripted_math_client, list(SEEDS))
    gt, gj = tig.ConceptGraph.build(ext), jig.ConceptGraph.build(ext)
    assert gt.freq == gj.freq and gt.kind == gj.kind
    rt, rj = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(20):
        assert gt.sample_concepts(rt) == gj.sample_concepts(rj)
    for seed in (1, 2):
        assert (tig.mathscale_generate(scripted_math_client, list(SEEDS),
                                       n=4, seed=seed)
                == jig.mathscale_generate(scripted_math_client, list(SEEDS),
                                          n=4, seed=seed))
    kw = dict(n_per_session=1, subjects_per_discipline=2, seed=3)
    recs = tig.glan_generate(scripted_glan_client, **kw)
    assert len(recs) == 8
    assert recs == jig.glan_generate(scripted_glan_client, **kw)


def test_vocab_adapt_matches_jax():
    counts = tva.corpus_word_counts(DOMAIN_DOCS)
    assert counts == jva.corpus_word_counts(DOMAIN_DOCS)
    vocab = tva.build_wordpiece_vocab(counts, target_size=60)
    assert vocab == jva.build_wordpiece_vocab(counts, target_size=60)
    text = "angiogenesis inhibits xenograft growth qzx"
    assert (tva.WordPieceTokenizer(vocab).encode(text)
            == jva.WordPieceTokenizer(vocab).encode(text))
    chars = sorted({c for d in DOMAIN_DOCS for c in d if c != " "})
    base = (list(tva.RESERVED) + chars + ["##" + c for c in chars]
            + ["the", "in", "and"])
    assert (tva.corpus_log_prob(DOMAIN_DOCS, vocab)
            == jva.corpus_log_prob(DOMAIN_DOCS, vocab))
    kw = dict(interval=40, threshold=0.005, max_rounds=4, num_iterations=2)
    merged = tva.vocab_extend(DOMAIN_DOCS, base, **kw)
    assert merged == jva.vocab_extend(DOMAIN_DOCS, base, **kw)
    assert merged[:len(base)] == base
    emb = np.random.default_rng(0).normal(size=(len(base), 8)).astype(
        np.float32)
    np.testing.assert_array_equal(tva.extend_embeddings(emb, base, merged),
                                  jva.extend_embeddings(emb, base, merged))


def _shards(tmp_path, n_shards=2, per=4, img=16):
    from PIL import Image

    paths, k = [], 0
    for si in range(n_shards):
        samples = []
        for _ in range(per):
            buf = io.BytesIO()
            Image.fromarray(np.full((img, img, 3), (k * 37) % 255, np.uint8)
                            ).save(buf, format="PNG")
            samples.append({"__key__": f"{k:06d}", "png": buf.getvalue(),
                            "cls": str(k % 16).encode()})
            k += 1
        samples.append({"__key__": f"meta{si}", "json": b"{}"})
        p = tmp_path / f"shard_{si}.tar"
        twd.write_tar_shard(str(p), samples)
        paths.append(str(p))
    return paths


def test_webdataset_matches_jax_and_resumes(tmp_path):
    paths = _shards(tmp_path)
    assert twd.read_tar_shard(paths[0]) == jwd.read_tar_shard(paths[0])
    ours = twd.classification_batches(
        twd.webdataset_stream(paths, image_size=8, seed=0, shuffle_buffer=4),
        4)
    ref = jwd.classification_batches(
        jwd.webdataset_stream(paths, image_size=8, seed=0, shuffle_buffer=4),
        4)
    assert isinstance(ours, tit.CheckpointableIterator)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a["images"].shape == (4, 8, 8, 3)
        assert a["images"].dtype == np.float32
        np.testing.assert_array_equal(a["images"], b["images"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
    state = ours.getstate()
    want = [next(ours)["labels"] for _ in range(3)]
    ours.setstate(state)
    for w in want:
        np.testing.assert_array_equal(next(ours)["labels"], w)
    finite = twd.webdataset_stream(paths[:1], image_size=8, infinite=False,
                                   shuffle_buffer=1)
    assert [s["__key__"] for s in finite] == [
        "000000", "000001", "000002", "000003", "meta0"]


def test_scoring_math_matches_jax():
    texts = [r"so \boxed{\frac{1}{2}} done", r"\boxed{a} and \boxed{{b}+c}",
             "nothing", "we get 7 then 13 total", "the answer is x+1.",
             "the solution is y=2x", r"thus \boxed{42}.",
             "|a|^2-|b|^2 works out to -1", r"\boxed{0.5}"]
    for s in texts:
        assert tsm.extract_boxed(s) == jsm.extract_boxed(s)
        for num in (True, False):
            assert tsm.extract_answer(s, num) == jsm.extract_answer(s, num)
    answers = [r"\tfrac{1}{2}", "0.5", "3/4", r"\frac12", "x = 7",
               r"90^{\circ}", "1,234", r"\sqrt3", r"5 \text{ cm}",
               "((3)/(4))", "-1", "42.0", "41"]
    for a in answers:
        assert tsm.normalize_math_answer(a) == jsm.normalize_math_answer(a)
        for b in answers[:4] + ["42"]:
            assert tsm.answers_equiv(a, b) == jsm.answers_equiv(a, b)
    for comp, ans in zip(texts, ["1/2", "a", "0", "13", "x+1", "y=2x", "42",
                                 "-1", r"\frac{1}{2}"]):
        assert tsm.math_is_correct(comp, ans) == jsm.math_is_correct(comp,
                                                                     ans)
    records = [{"question": "q1", "answer": "4", "data_topic": "gsm8k"},
               {"question": "q2", "answer": "9", "data_topic": "gsm8k"},
               {"question": "q3", "answer": r"\frac{1}{2}",
                "data_topic": "math"}]
    comps = ["the answer is 4", "the answer is 8", r"\boxed{0.5}"]
    assert tsm.mwpbench_eval(records, comps) == jsm.mwpbench_eval(records,
                                                                  comps)
    assert tsm.PROMPT_TEMPLATES == jsm.PROMPT_TEMPLATES
