"""Port parity for the native sentencepiece reader (data/spm.py):
unilm_tpu_torch against unilm_tpu, id for id and string for string.

Both checked-in fixtures (tests/fixtures/tiny_unigram.model,
tiny_digits.model) and models written here (BPE, byte fallback, an NFKC
normalizer) encode a mixed corpus (ASCII, whitespace runs, digits,
accented, CJK and emoji text, uncovered characters) to the same ids in
both packages, and decode those ids, and random id sequences, to the same
text. The reference's two faults (ROADMAP Queue 3) are pinned: the NFKC
stand-in for `precompiled_charsmap` is kept, the control-id lookup of a
fused unknown run is not. Everything is exact.
"""

import os
import random

import pytest

from unilm_tpu.data import spm as jspm
from unilm_tpu_torch.data import spm as tspm

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CORPUS = [
    "hello world", "held", "  hello   world  ", "hello Z", "worldworld",
    "12 340", "0012 34 5", "1234567890", "", " ", "\t\n", "héllo wörld",
    "日本語 hello", "🙂 12", "ﬁne Ｈello", "a  b\tc", "x" * 50, "<x>",
]


def _pieces(kind):
    """A vocabulary over 'a'-'h' and the space mark with random merges;
    BYTE pieces for byte fallback."""
    rng = random.Random(0)
    P = jspm
    pieces = [("<unk>", 0.0, P.UNKNOWN), ("<s>", 0.0, P.CONTROL),
              ("</s>", 0.0, P.CONTROL), ("<pad>", 0.0, P.CONTROL)]
    pieces += [(c, rng.uniform(-10, -8), P.NORMAL) for c in "abcdefgh" + P.WS]
    seen = {p for p, _, _ in pieces}
    while len(pieces) < 60:
        cand = "".join(rng.choice("abcdefgh") for _ in range(rng.randint(2, 4)))
        cand = (P.WS + cand) if rng.random() < 0.3 else cand
        if cand not in seen:
            seen.add(cand)
            pieces.append((cand, rng.uniform(-7, -1), P.NORMAL))
    if kind == "bytes":
        pieces += [(f"<0x{b:02X}>", 0.0, P.BYTE) for b in range(256)]
    return pieces


def _proto(kind):
    kw = dict(model_type=2 if kind == "bpe" else 1,
              byte_fallback=kind == "bytes",
              normalizer_name="nmt_nfkc" if kind == "nfkc" else "identity",
              pad_id=3)
    want = jspm.build_model_proto(_pieces(kind), **kw)
    assert tspm.build_model_proto(_pieces(kind), **kw) == want
    return want


def _models(source):
    """(port model, JAX model) from a fixture file or a written proto."""
    if source.endswith(".model"):
        path = os.path.join(FIXTURES, source)
        return (tspm.SentencePieceModel.from_file(path),
                jspm.SentencePieceModel.from_file(path))
    data = _proto(source)
    return (tspm.SentencePieceModel.from_bytes(data),
            jspm.SentencePieceModel.from_bytes(data))


SOURCES = ["tiny_unigram.model", "tiny_digits.model", "bpe", "bytes", "nfkc"]


@pytest.mark.parametrize("source", SOURCES)
def test_encode_decode_match_jax(source):
    tm, jm = _models(source)
    for f in ("vocab_size", "model_type", "unk_id", "bos_id", "eos_id",
              "pad_id", "add_dummy_prefix", "escape_ws", "nfkc",
              "byte_fallback"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert tm.pieces == jm.pieces
    rng = random.Random(1)
    texts = CORPUS + ["".join(rng.choice("abcdefgh12 Zé") for _ in
                              range(rng.randint(1, 30))) for _ in range(40)]
    for text in texts:
        ids = tm.encode(text)
        assert tm.encode_pieces(text) == jm.encode_pieces(text), text
        assert ids == jm.encode(text), text
        assert tm.decode(ids) == jm.decode(ids), text
    for _ in range(30):
        ids = [rng.randrange(tm.vocab_size) for _ in range(rng.randint(0, 12))]
        assert tm.decode(ids) == jm.decode(ids), ids


@pytest.mark.parametrize("source", ["tiny_digits.model", "bytes"])
def test_spm_tokenizer_matches_jax(source):
    tm, jm = _models(source)
    tt, jt = tspm.SpmTokenizer(tm), jspm.SpmTokenizer(jm)
    assert (tt.bos, tt.eos, tt.pad, tt.unk, tt.vocab_size) == (
        jt.bos, jt.eos, jt.pad, jt.unk, jt.vocab_size)
    for text in ("12 340", "héllo 12", ""):
        ids = tt.encode(text)
        assert ids == jt.encode(text)
        framed = [tt.bos] + ids + [tt.eos, tt.pad, tt.pad]
        assert tt.decode(framed) == jt.decode(framed)


def test_fused_unknown_run_is_unk():
    """Reference fault (ROADMAP Queue 3, spm encode): JAX looks a fused
    unknown run up in the whole piece table, so text spelled like a
    control piece that the vocabulary does not cover encodes as the
    control id. The port, as sentencepiece does, matches only scored
    pieces: the run is one unk, or its bytes under byte fallback."""
    tm, jm = _models("tiny_digits.model")
    bos = tm.piece_to_id("<s>")
    assert jm.encode("<s>") == [tm.piece_to_id("▁"), bos]  # the fault
    assert tm.encode("<s>") == [tm.piece_to_id("▁"), tm.unk_id]
    assert tm.encode("12<pad>") != jm.encode("12<pad>")
    assert tm.unk_id in tm.encode("12<pad>")
    tb, jb = _models("bytes")
    ids = tb.encode("ab<s>")
    assert tb.decode(ids) == "ab<s>"  # every uncovered byte round-trips
    assert tb.piece_to_id("<s>") not in ids
    assert tb.piece_to_id("<s>") in jb.encode("ab<s>")


def test_nfkc_stands_in_for_the_charsmap():
    """Reference fault kept (ROADMAP Queue 3, spm normalizer): a spec named
    *nfkc* gets unicodedata's NFKC and any `precompiled_charsmap` is
    ignored, in both packages; an identity spec normalizes nothing."""
    text = "ﬁne Ｈello ①"
    tm, jm = _models("nfkc")
    assert tm._normalize(text) == jm._normalize(text) == "▁fine▁Hello▁1"
    assert tm.encode(text) == jm.encode(text)
    ti, _ = _models("bytes")
    assert ti._normalize(text) == "▁ﬁne▁Ｈello▁①"
    # a NormalizerSpec with a charsmap (field 2): read past, not applied
    data = _proto("nfkc")
    blob = b"\x05\x00\x00\x00charsmap-bytes"
    spec = (tspm._field(1, 2, tspm._varint(8) + b"nmt_nfkc")
            + tspm._field(2, 2, tspm._varint(len(blob)) + blob))
    with_map = data + tspm._field(3, 2, tspm._varint(len(spec)) + spec)
    for cls in (tspm.SentencePieceModel, jspm.SentencePieceModel):
        m = cls.from_bytes(with_map)
        assert m.nfkc and m._normalize(text) == "▁fine▁Hello▁1"
