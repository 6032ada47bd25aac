"""fairseq-style Dictionary, the part the train CLI uses (port of
unilm_tpu/data/dictionary.py): symbol -> id with <s>, <pad>, </s>, <unk>
at 0-3, `dict.txt` loading and line encoding."""

from __future__ import annotations

import numpy as np


class Dictionary:
    def __init__(self):
        self.symbols = []
        self.indices = {}
        self.bos_index = self.add_symbol("<s>")
        self.pad_index = self.add_symbol("<pad>")
        self.eos_index = self.add_symbol("</s>")
        self.unk_index = self.add_symbol("<unk>")

    def __len__(self):
        return len(self.symbols)

    def eos(self):
        return self.eos_index

    def add_symbol(self, word: str) -> int:
        if word not in self.indices:
            self.indices[word] = len(self.symbols)
            self.symbols.append(word)
        return self.indices[word]

    def encode_line(self, line: str) -> np.ndarray:
        """The ids of the line's words (unknown words -> <unk>) and </s>."""
        ids = [self.indices.get(w, self.unk_index) for w in line.split()]
        return np.asarray(ids + [self.eos_index], dtype=np.int64)

    @classmethod
    def load(cls, path: str) -> "Dictionary":
        """fairseq dict.txt: '<symbol> <count>' per line (the count is not
        kept); a line without a count is one symbol."""
        d = cls()
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip().rsplit(" ", 1)
                if len(parts) == 2 or parts[0]:
                    d.add_symbol(parts[0])
        return d
