"""Dictionary encoding for string columns (host-side; a copy of the JAX
package's ``repro/data/dictionary.py``, numpy only).

The table engine has no string type; Arrow's standard answer is
dictionary encoding — string columns become int32 ids + a host-side
vocabulary.  This is the boundary where the HPTMT table engine meets raw
data.
"""
from __future__ import annotations

import numpy as np


class Dictionary:
    def __init__(self):
        self.vocab: dict[str, int] = {}
        self.items: list[str] = []

    def encode(self, values) -> np.ndarray:
        out = np.empty(len(values), np.int32)
        for i, v in enumerate(values):
            v = str(v)
            idx = self.vocab.get(v)
            if idx is None:
                idx = len(self.items)
                self.vocab[v] = idx
                self.items.append(v)
            out[i] = idx
        return out

    def decode(self, ids) -> list[str]:
        return [self.items[int(i)] for i in ids]
