"""Native byte-level BPE tokenizer (RoBERTa/GPT-2 family).

Capability-equivalent of the reference's tokenizer dependency surface:
LayoutLMv3's RoBERTa tokenizer subclass (layoutlmv3/layoutlmft/models/
layoutlmv3/tokenization_layoutlmv3.py), TrOCR's GPT-2 BPE target side,
and fairseq's GPT2BPE encoder — WITHOUT requiring the transformers
runtime: loads standard `vocab.json` + `merges.txt` files and implements
the byte-level pre-tokenizer + merge loop + byte decoder from scratch.

Verified against HF tokenizers in tests (same files -> same ids).

The port's copy of unilm_tpu/data/bpe.py
(pure Python: the port imports nothing of the JAX package), held
against it by the CPU tests.
"""

from __future__ import annotations

import functools
import json
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte->unicode map: printable bytes map to
    themselves, the rest shift into 256+ codepoints."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


# GPT-2 pre-tokenization pattern (contractions, letter/number/other runs,
# leading-space attachment)
_PAT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+",
    re.UNICODE,
)


class ByteLevelBPE:
    """vocab.json + merges.txt byte-level BPE encoder/decoder."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, List[str]] = {}

    # ------------------------------------------------------------------ #
    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str) -> "ByteLevelBPE":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_file, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        return cls(vocab, merges)

    @classmethod
    def from_pretrained_dir(cls, path: str) -> "ByteLevelBPE":
        import os

        return cls.from_files(
            os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt")
        )

    # ------------------------------------------------------------------ #
    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            out: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        res = list(word)
        self._cache[token] = res
        return res

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _PAT.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(mapped))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids if int(i) in self.decoder)
        data = bytes(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace")


class RobertaTokenizer:
    """RoBERTa-style wrapper: byte-level BPE + <s>/</s>/<pad>/<unk>/<mask>
    specials with the standard id layout (the LayoutLMv3 tokenizer is this
    class with bbox plumbing handled by the caller, tokenization_layoutlmv3).
    """

    def __init__(self, bpe: ByteLevelBPE,
                 specials: Optional[Dict[str, int]] = None):
        self.bpe = bpe
        sp = specials or {}
        self.bos = sp.get("<s>", bpe.encoder.get("<s>", 0))
        self.pad = sp.get("<pad>", bpe.encoder.get("<pad>", 1))
        self.eos = sp.get("</s>", bpe.encoder.get("</s>", 2))
        self.unk = sp.get("<unk>", bpe.encoder.get("<unk>", 3))
        self.mask = sp.get("<mask>", bpe.encoder.get("<mask>"))
        self.vocab_size = max(bpe.encoder.values()) + 1

    @classmethod
    def from_pretrained_dir(cls, path: str) -> "RobertaTokenizer":
        return cls(ByteLevelBPE.from_pretrained_dir(path))

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self.bpe.encode(text)
        return [self.bos] + ids + [self.eos] if add_special_tokens else ids

    def encode_words(
        self, words: Sequence[str], add_special_tokens: bool = True
    ) -> Tuple[List[int], List[int]]:
        """Pre-split words (FUNSD-style) -> (ids, word_ids aligning each
        subword to its source word; specials get -1). Words after the first
        get the RoBERTa add_prefix_space treatment."""
        ids: List[int] = [self.bos] if add_special_tokens else []
        wids: List[int] = [-1] if add_special_tokens else []
        for wi, w in enumerate(words):
            piece = self.bpe.encode(" " + w)  # add_prefix_space=True (run_funsd_cord)
            ids.extend(piece)
            wids.extend([wi] * len(piece))
        if add_special_tokens:
            ids.append(self.eos)
            wids.append(-1)
        return ids, wids

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        sp = {self.bos, self.eos, self.pad, self.unk}
        if self.mask is not None:
            sp.add(self.mask)
        ids = [i for i in ids if not (skip_special_tokens and int(i) in sp)]
        return self.bpe.decode(ids)
