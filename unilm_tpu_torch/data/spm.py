"""Native sentencepiece: a pure-Python `.model` reader with unigram and
BPE encoding (a copy of unilm_tpu/data/spm.py: `_walk` :41,
`SentencePieceModel` :89, `SpmTokenizer` :311, `build_model_proto` :372).

TrOCR's reference text side is the `unilm3-cased` sentencepiece model and
Kosmos-2's language-model loader is sentencepiece-based; no sentencepiece
package is needed here. The reader walks the serialized `ModelProto`'s
protobuf wire format for the three messages it needs (the pieces, the
trainer spec, the normalizer spec) and implements both inference
algorithms:

- UNIGRAM: Viterbi segmentation maximizing the sum of piece log-probs
  (sentencepiece's default);
- BPE: greedy merging of the best-scoring adjacent pair (sentencepiece
  writes the merge rank into the piece score);

with the standard pre-normalization (optional NFKC, whitespace escaped to
U+2581, add_dummy_prefix) and byte fallback for uncovered characters.
On the same model and text the ids and the decoded text equal the JAX
package's (tests/test_torch_spm.py), apart from one case below.

Two faults of the reference (ROADMAP Queue 3), one kept and one not:

- The normalizer's `precompiled_charsmap` is not interpreted: a spec whose
  name holds "nfkc" gets unicodedata's NFKC, any other none. Kept as in
  the reference, and pinned by a test: the two agree on ASCII and on
  standard text, which covers the OCR and grounding vocabularies.
- The reference looks up a fused unknown surface in the piece table, so
  an uncovered run spelled like a control or unknown piece (`<s>` where
  no piece covers its characters) encodes as that control id. The port
  looks up only NORMAL and USER_DEFINED pieces, as sentencepiece does: such
  a run becomes unk (or its bytes under byte fallback). A test pins both.
"""

from __future__ import annotations

import struct
import unicodedata
from typing import Dict, Iterable, List, Optional, Tuple

WS = "▁"  # ▁

# SentencePiece.Type enum (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


def _walk(buf: bytes, pos: int = 0, end: Optional[int] = None):
    """Yield (field_number, wire_type, value) over a protobuf buffer.
    value: int for varint(0)/fixed(5,1), bytes for length-delimited(2)."""
    end = len(buf) if end is None else end
    while pos < end:
        key = 0
        shift = 0
        while True:
            b = buf[pos]
            pos += 1
            key |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        field, wt = key >> 3, key & 7
        if wt == 0:  # varint
            val = 0
            shift = 0
            while True:
                b = buf[pos]
                pos += 1
                val |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wt, val
        elif wt == 2:  # length-delimited
            ln = 0
            shift = 0
            while True:
                b = buf[pos]
                pos += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wt, buf[pos:pos + ln]
            pos += ln
        elif wt == 5:  # fixed32
            yield field, wt, struct.unpack("<I", buf[pos:pos + 4])[0]
            pos += 4
        elif wt == 1:  # fixed64
            yield field, wt, struct.unpack("<Q", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt} (field {field})")


class SentencePieceModel:
    """Loaded spm model: pieces + scores + special ids + normalizer flags."""

    def __init__(self, pieces: List[Tuple[str, float, int]],
                 model_type: int = 1, unk_id: int = 0, bos_id: int = 1,
                 eos_id: int = 2, pad_id: int = -1,
                 add_dummy_prefix: bool = True, escape_ws: bool = True,
                 nfkc: bool = False, byte_fallback: Optional[bool] = None):
        self.pieces = pieces
        self.model_type = model_type  # 1=unigram, 2=bpe
        self.unk_id, self.bos_id, self.eos_id, self.pad_id = (
            unk_id, bos_id, eos_id, pad_id)
        self.add_dummy_prefix = add_dummy_prefix
        self.escape_ws = escape_ws
        self.nfkc = nfkc
        self._p2i: Dict[str, int] = {}
        self._scores: Dict[str, float] = {}
        self._byte_ids: Dict[int, int] = {}
        self.max_piece_len = 1
        for i, (p, score, typ) in enumerate(pieces):
            if p not in self._p2i:
                self._p2i[p] = i
            if typ in (NORMAL, USER_DEFINED):
                self._scores[p] = score
                self.max_piece_len = max(self.max_piece_len, len(p))
            elif typ == BYTE and len(p) == 6 and p.startswith("<0x"):
                self._byte_ids[int(p[3:5], 16)] = i
        self.byte_fallback = (bool(self._byte_ids) if byte_fallback is None
                              else byte_fallback)
        # unigram unknown-char penalty (spm: min_score - 10)
        self._min_score = min(self._scores.values()) if self._scores else 0.0

    # ---------------------------------------------------------------- #
    @classmethod
    def from_file(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    @classmethod
    def from_bytes(cls, data: bytes) -> "SentencePieceModel":
        pieces = []
        kw = {}
        for field, wt, val in _walk(data):
            if field == 1 and wt == 2:  # SentencePiece
                piece, score, typ = "", 0.0, NORMAL
                for f2, w2, v2 in _walk(val):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", struct.pack("<I", v2))[0]
                    elif f2 == 3:
                        typ = v2
                pieces.append((piece, score, typ))
            elif field == 2 and wt == 2:  # TrainerSpec
                for f2, w2, v2 in _walk(val):
                    if f2 == 3:
                        kw["model_type"] = v2
                    elif f2 == 35:  # byte_fallback
                        kw["byte_fallback"] = bool(v2)
                    elif f2 == 40:
                        kw["unk_id"] = _signed(v2)
                    elif f2 == 41:
                        kw["bos_id"] = _signed(v2)
                    elif f2 == 42:
                        kw["eos_id"] = _signed(v2)
                    elif f2 == 43:
                        kw["pad_id"] = _signed(v2)
            elif field == 3 and wt == 2:  # NormalizerSpec
                for f2, w2, v2 in _walk(val):
                    if f2 == 1:
                        kw["nfkc"] = b"nfkc" in v2.lower()
                    elif f2 == 3:
                        kw["add_dummy_prefix"] = bool(v2)
                    elif f2 == 5:
                        kw["escape_ws"] = bool(v2)
        return cls(pieces, **kw)

    # ---------------------------------------------------------------- #
    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    def piece_to_id(self, piece: str) -> int:
        return self._p2i.get(piece, self.unk_id)

    def id_to_piece(self, idx: int) -> str:
        return self.pieces[idx][0]

    # ---------------------------------------------------------------- #
    def _normalize(self, text: str) -> str:
        if self.nfkc:
            text = unicodedata.normalize("NFKC", text)
        # remove_extra_whitespaces default: collapse runs, strip ends
        text = " ".join(text.split())
        if self.add_dummy_prefix and text:
            text = " " + text
        if self.escape_ws:
            text = text.replace(" ", WS)
        return text

    def _encode_unigram(self, text: str) -> List[str]:
        """Viterbi over piece log-probs (spm unigram inference)."""
        n = len(text)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, str]]] = [None] * (n + 1)
        best[0] = 0.0
        unk_score = self._min_score - 10.0
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            # single uncovered char: unk (or byte-fallback, resolved later)
            j = i + 1
            cand = text[i:j]
            sc = self._scores.get(cand)
            base = best[i] + (sc if sc is not None else unk_score)
            if base > best[j]:
                best[j], back[j] = base, (i, cand)
            for j in range(i + 2, min(n, i + self.max_piece_len) + 1):
                cand = text[i:j]
                sc = self._scores.get(cand)
                if sc is None:
                    continue
                if best[i] + sc > best[j]:
                    best[j], back[j] = best[i] + sc, (i, cand)
        out: List[str] = []
        pos = n
        while pos > 0:
            i, piece = back[pos]
            out.append(piece)
            pos = i
        out.reverse()
        # sentencepiece merges ADJACENT unknown lattice pieces into one
        # surface (unigram_model.cc; verified against HF tokenizers' rust
        # Unigram port, tests/test_spm_oracle.py): 'xyz' with no coverage
        # is ONE unk piece, not three
        fused: List[str] = []
        prev_unk = False
        for p in out:
            unk = p not in self._scores
            if unk and prev_unk:
                fused[-1] += p
            else:
                fused.append(p)
            prev_unk = unk
        return fused

    def _encode_bpe(self, text: str) -> List[str]:
        """Greedy adjacent-pair merging by piece score (spm BPE inference:
        the training writes merge priority into the scores)."""
        symbols = list(text)
        while len(symbols) > 1:
            best_score, best_i = None, -1
            for i in range(len(symbols) - 1):
                cand = symbols[i] + symbols[i + 1]
                sc = self._scores.get(cand)
                if sc is not None and (best_score is None or sc > best_score):
                    best_score, best_i = sc, i
            if best_i < 0:
                break
            symbols[best_i:best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        return symbols

    def encode_pieces(self, text: str) -> List[str]:
        text = self._normalize(text)
        if not text:
            return []
        if self.model_type == 2:
            return self._encode_bpe(text)
        return self._encode_unigram(text)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in self.encode_pieces(text):
            # only a scored piece is a vocabulary hit: a fused unknown run
            # spelled like a control piece is still unknown (module
            # docstring; the reference takes the control id)
            idx = self._p2i.get(piece) if piece in self._scores else None
            if idx is not None:
                ids.append(idx)
            elif self.byte_fallback:
                for b in piece.encode("utf-8"):
                    ids.append(self._byte_ids.get(b, self.unk_id))
            else:
                ids.append(self.unk_id)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        out: List[str] = []
        byte_run: List[int] = []

        def flush():
            if byte_run:
                out.append(bytes(byte_run).decode("utf-8", errors="replace"))
                byte_run.clear()

        for idx in ids:
            piece, _, typ = self.pieces[idx]
            if typ == BYTE:
                byte_run.append(int(piece[3:5], 16))
                continue
            flush()
            if typ == CONTROL:
                continue
            if typ == UNKNOWN:
                # sentencepiece renders unk as its surface (default ' ⁇ ')
                out.append(" ⁇ ")
                continue
            out.append(piece)
        flush()
        text = "".join(out)
        if self.escape_ws:
            text = text.replace(WS, " ")
        if self.add_dummy_prefix and text.startswith(" "):
            # strip exactly the one dummy-prefix space (not all leading ws:
            # byte-decoded leading whitespace must survive)
            text = text[1:]
        return text


def _signed(v: int) -> int:
    """Protobuf int32 varints encode negatives as 64-bit two's complement."""
    return v - (1 << 64) if v >= (1 << 63) else v


class SpmTokenizer:
    """bos/eos/pad-style tokenizer adapter over SentencePieceModel.

    The interface the OCR and LM pipelines consume (that of
    data/trocr_datasets.CharTokenizer): `.bos/.eos/.pad/.vocab_size`,
    `encode(text) -> ids` (no specials), `decode(ids) -> text` (specials
    stripped): TrOCR's `unilm3-cased` text path and Kosmos-2's
    SpmLmLoader without a sentencepiece package.

    When the model declares no pad (pad_id=-1, the spm default), `pad`
    falls back to `unk`; decode() strips bos/eos/pad, so in that case unk
    ids are stripped too rather than rendered as ' ⁇ '.
    """

    def __init__(self, model: "SentencePieceModel"):
        self.spm = model
        self.bos = model.bos_id
        self.eos = model.eos_id
        self.pad = model.pad_id if model.pad_id >= 0 else model.unk_id
        self.unk = model.unk_id
        self.vocab_size = model.vocab_size

    @classmethod
    def from_file(cls, path: str) -> "SpmTokenizer":
        return cls(SentencePieceModel.from_file(path))

    def encode(self, text: str) -> List[int]:
        return self.spm.encode(text)

    def decode(self, ids: Iterable[int]) -> str:
        keep = [int(i) for i in ids
                if int(i) not in (self.bos, self.eos, self.pad)]
        return self.spm.decode(keep)


# ---------------------------------------------------------------------- #
# Minimal writer (fixtures and tests: builds a valid ModelProto)
# ---------------------------------------------------------------------- #


def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wt: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wt) + payload


def build_model_proto(pieces: List[Tuple[str, float, int]],
                      model_type: int = 1, unk_id: int = 0, bos_id: int = 1,
                      eos_id: int = 2, pad_id: int = -1,
                      normalizer_name: str = "identity",
                      add_dummy_prefix: bool = True,
                      escape_ws: bool = True,
                      byte_fallback: bool = False) -> bytes:
    """Serialize a ModelProto the reader (and the sentencepiece runtime)
    can load: test fixtures without a sentencepiece package."""
    out = bytearray()
    for piece, score, typ in pieces:
        body = (_field(1, 2, _varint(len(piece.encode())) + piece.encode())
                + _field(2, 5, struct.pack("<f", score))
                + _field(3, 0, _varint(typ)))
        out += _field(1, 2, _varint(len(body)) + body)
    ts = (_field(3, 0, _varint(model_type))
          + _field(35, 0, _varint(int(byte_fallback)))
          + _field(40, 0, _varint(unk_id)) + _field(41, 0, _varint(bos_id))
          + _field(42, 0, _varint(eos_id)) + _field(43, 0, _varint(pad_id)))
    out += _field(2, 2, _varint(len(ts)) + ts)
    nm = normalizer_name.encode()
    ns = (_field(1, 2, _varint(len(nm)) + nm)
          + _field(3, 0, _varint(int(add_dummy_prefix)))
          + _field(5, 0, _varint(int(escape_ws))))
    out += _field(3, 2, _varint(len(ns)) + ns)
    return bytes(out)
