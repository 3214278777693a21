"""Tokenizers: a self-contained toy tokenizer and HF tokenizer loading.

Port of internvideo_tpu/data/tokenizer.py, with the same ids. The toy
tokenizer is a deterministic whitespace / byte-fallback vocabulary with
BERT-style special ids, for tests and smoke runs. Real runs load a local HF
tokenizer directory through `transformers` (offline), imported inside
`load_hf_tokenizer`.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np


class ToyTokenizer:
    """Whitespace tokenizer with byte fallback; BERT-style specials."""

    def __init__(self, vocab: Optional[Sequence[str]] = None, max_vocab=4096):
        self.pad_token_id = 0
        self.cls_token_id = 101
        self.sep_token_id = 102
        self.mask_token_id = 103
        self._word_to_id: dict[str, int] = {}
        self._base = 200  # words start here; 104..199 are the byte buckets
        self.max_vocab = max_vocab
        for w in vocab or []:
            self._intern(w)

    @property
    def vocab_size(self) -> int:
        return self.max_vocab

    def _intern(self, w: str) -> int:
        if w not in self._word_to_id:
            nid = self._base + len(self._word_to_id)
            if nid >= self.max_vocab:
                return 104 + (hash(w) % 96)  # byte-fallback bucket
            self._word_to_id[w] = nid
        return self._word_to_id[w]

    def encode(self, text: str, max_length: int = 32) -> np.ndarray:
        words = re.findall(r"\w+|[^\w\s]", text.lower())
        ids = [self.cls_token_id] + [self._intern(w) for w in words]
        ids = ids[: max_length - 1] + [self.sep_token_id]
        ids = ids + [self.pad_token_id] * (max_length - len(ids))
        return np.asarray(ids, np.int32)

    def __call__(self, texts: Sequence[str], max_length: int = 32) -> dict:
        ids = np.stack([self.encode(t, max_length) for t in texts])
        mask = (ids != self.pad_token_id).astype(np.int32)
        return {"input_ids": ids, "attention_mask": mask}


def load_hf_tokenizer(path: str):
    """Load a local HF tokenizer directory (offline); returns a callable
    like ToyTokenizer.__call__, with the tokenizer as `.tokenizer`."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(path, local_files_only=True)

    def call(texts, max_length=77):
        out = tok(list(texts), padding="max_length", truncation=True,
                  max_length=max_length, return_tensors="np")
        return {"input_ids": out["input_ids"].astype(np.int32),
                "attention_mask": out["attention_mask"].astype(np.int32)}

    call.tokenizer = tok
    return call
