"""Host-side tokenizer.

The reference tokenizes with a HuggingFace BERT-style tokenizer loaded from a
checkpoint directory that is not in the repo (reference:
model/NodeEmbedding.py:104, fine_tune_ours.py:166). This environment has zero
egress, so we ship a self-contained deterministic hashing tokenizer with the
same call surface: pad-to-max-length input_ids / token_type_ids /
attention_mask (reference: util_amazon_filtered.py:19-21).

Special ids are kept below 5 so that the reference's MLM masking rule
``input_ids >= 5 are maskable`` (reference: pretrain_filtered_amazon.py:34)
carries over unchanged.
"""

from __future__ import annotations

import re
from typing import List, Sequence

import numpy as np

PAD_ID = 0
UNK_ID = 1
CLS_ID = 2
SEP_ID = 3
MASK_ID = 4
NUM_SPECIAL = 5

_WORD_RE = re.compile(r"[a-z0-9]+")


def _fnv1a(word: str) -> int:
    """Stable 64-bit FNV-1a hash (no Python hash randomization)."""
    h = 0xCBF29CE484222325
    for b in word.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class HashTokenizer:
    """Deterministic word-hashing tokenizer.

    Lowercases, splits on alphanumeric runs, hashes each word into
    ``[NUM_SPECIAL, vocab_size)``. Encodes as ``[CLS] w1 ... wn [SEP]``,
    truncated then padded to ``max_length`` -- mirroring the HF
    ``padding='max_length', truncation=True`` call in the reference
    (util_amazon_filtered.py:19-21, 120-121, 151-152, 224).
    """

    def __init__(self, vocab_size: int = 30522):
        assert vocab_size > NUM_SPECIAL
        self.vocab_size = vocab_size
        self.mask_token_id = MASK_ID
        self.pad_token_id = PAD_ID

    def _word_id(self, word: str) -> int:
        return NUM_SPECIAL + _fnv1a(word) % (self.vocab_size - NUM_SPECIAL)

    def encode_one(self, text: str, max_length: int) -> np.ndarray:
        if text is None:
            text = ""
        words = _WORD_RE.findall(text.lower())
        ids = [CLS_ID] + [self._word_id(w) for w in words] + [SEP_ID]
        ids = ids[: max_length - 1] + [SEP_ID] if len(ids) > max_length else ids
        ids = ids[:max_length]
        out = np.zeros(max_length, dtype=np.int32)
        out[: len(ids)] = ids
        return out

    def __call__(self, texts: Sequence[str], max_length: int):
        """Returns dict of [len(texts), max_length] int32 arrays. Uses the
        C++ batch tokenizer (native/levenshtein.cpp tokenize_batch) when
        available -- this loop is the corpus-prep hot path (the reference's
        CPU bottleneck, SURVEY.md §3.1)."""
        from sessionsimilaritysearch_tpu_torch import native

        clean = [t if t is not None else "" for t in texts]
        input_ids = native.tokenize_batch(clean, max_length, self.vocab_size)
        if input_ids is None:
            input_ids = np.stack(
                [self.encode_one(t, max_length) for t in clean]
            )
        attention_mask = (input_ids != PAD_ID).astype(np.int32)
        token_type_ids = np.zeros_like(input_ids)
        return {
            "input_ids": input_ids,
            "token_type_ids": token_type_ids,
            "attention_mask": attention_mask,
        }


def get_tokenizer(vocab_size: int = 30522, hf_path: str | None = None):
    """Returns the offline hashing tokenizer, or an HF tokenizer wrapper when
    a local checkpoint path is given and loadable."""
    if hf_path:
        try:
            from transformers import AutoTokenizer  # local cache only

            tok = AutoTokenizer.from_pretrained(hf_path)

            class _HFWrap:
                vocab_size = tok.vocab_size
                mask_token_id = tok.mask_token_id or MASK_ID
                pad_token_id = tok.pad_token_id or PAD_ID

                def __call__(self, texts, max_length):
                    texts = [t if t is not None else "" for t in texts]
                    out = tok(
                        list(texts),
                        padding="max_length",
                        max_length=max_length,
                        truncation=True,
                        return_tensors="np",
                    )
                    return {
                        "input_ids": out["input_ids"].astype(np.int32),
                        "token_type_ids": out.get(
                            "token_type_ids",
                            np.zeros_like(out["input_ids"]),
                        ).astype(np.int32),
                        "attention_mask": out["attention_mask"].astype(np.int32),
                    }

            return _HFWrap()
        except Exception:
            pass
    return HashTokenizer(vocab_size)
