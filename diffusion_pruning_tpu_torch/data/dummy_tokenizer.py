"""Deterministic hash tokenizer for smoke/CI runs without local checkpoints.

Real runs load the HF tokenizers from the local model directories; when those
are absent every CLI falls back to this so the full control flow stays
executable end-to-end (tiny random models + synthetic text).
"""
from __future__ import annotations

import hashlib
from typing import Dict, List

import numpy as np


class DummyTokenizer:
    def __init__(self, vocab_size: int = 128, max_length: int = 77,
                 pad_id: int = 0):
        self.vocab_size = vocab_size
        self.model_max_length = max_length
        self.pad_id = pad_id

    def _ids(self, text: str, max_length: int) -> List[int]:
        ids = []
        for w in str(text).split()[: max_length]:
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            ids.append(2 + h % (self.vocab_size - 2))
        return ids

    def __call__(self, texts, max_length=None, padding="max_length",
                 truncation=True, return_tensors="np"):
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        ids = np.full((len(texts), max_length), self.pad_id, np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            row = self._ids(t, max_length)
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1

        class Enc(dict):
            input_ids = ids
            attention_mask = mask

        e = Enc(input_ids=ids, attention_mask=mask)
        return e
