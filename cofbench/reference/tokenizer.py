"""A frozen copy of the deterministic word-hash tokenizer that the program
falls back to without the umT5 vocabulary files: pad 0, eos 1, each
lower-cased word hashed (blake2s, 4 bytes) into [2, vocab)."""

from __future__ import annotations

import hashlib

import numpy as np


def tokenize(text: str, max_length: int, vocab: int):
    """(ids [1, max_length] int64, mask [1, max_length] int64)."""
    toks = [2 + int.from_bytes(hashlib.blake2s(w.encode(), digest_size=4)
                               .digest(), "big") % (vocab - 2)
            for w in text.lower().split()]
    toks = toks[:max_length - 1] + [1]
    ids = np.zeros((1, max_length), np.int64)
    mask = np.zeros((1, max_length), np.int64)
    ids[0, :len(toks)] = toks
    mask[0, :len(toks)] = 1
    return ids, mask
