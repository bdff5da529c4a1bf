"""The word-hashing tokenizer: lowercase, alphanumeric runs, each word
hashed by 64-bit FNV-1a into ``[5, vocab_size)``, encoded as ``[CLS] w1 ...
wn [SEP]``, truncated with a closing ``[SEP]`` and zero-padded to
``max_length``."""

from __future__ import annotations

import re

import numpy as np

PAD_ID, UNK_ID, CLS_ID, SEP_ID, MASK_ID = 0, 1, 2, 3, 4
NUM_SPECIAL = 5
_WORD_RE = re.compile(r"[a-z0-9]+")


def fnv1a(word: str) -> int:
    h = 0xCBF29CE484222325
    for b in word.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def encode(text, max_length: int, vocab_size: int) -> np.ndarray:
    """One text as [max_length] int32 token ids."""
    words = _WORD_RE.findall((text or "").lower())
    ids = [CLS_ID] + [NUM_SPECIAL + fnv1a(w) % (vocab_size - NUM_SPECIAL) for w in words]
    ids.append(SEP_ID)
    if len(ids) > max_length:
        ids = ids[: max_length - 1] + [SEP_ID]
    out = np.zeros(max_length, dtype=np.int32)
    out[: len(ids)] = ids
    return out
