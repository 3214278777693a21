"""CLIP byte-level BPE tokenizer (ViCLIP text tokenization).

Port of internvideo_tpu/data/clip_bpe.py, with the same ids: the byte ->
printable-unicode remap, text cleaning (lowercase, whitespace collapse,
html unescape, ftfy where installed), the CLIP word regex, greedy
lowest-rank pair merging with ``</w>`` end-of-word markers, and
``tokenize()`` (sot / eot wrap, zero-pad to 77, truncate keeping eot).

The merge table is data, not code: ``bpe_path`` names the standard
``bpe_simple_vocab_16e6.txt.gz`` of the public CLIP implementations, which
this repository does not ship. The `regex` module (for the \\p{L} / \\p{N}
classes) is needed by the constructor only.
"""

from __future__ import annotations

import gzip
import html
from functools import lru_cache
from typing import List, Sequence, Union

import numpy as np

try:  # regex (not re): the CLIP pattern uses \p{L}/\p{N} classes
    import regex as _re
except ImportError:  # pragma: no cover
    _re = None

try:  # ftfy is optional; on clean text fix_text is the identity
    import ftfy as _ftfy
except ImportError:
    _ftfy = None

_WORD_PATTERN = (
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
    r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
)
_NUM_MERGES = 49152 - 256 - 2  # merge rows used from the vocab file


@lru_cache()
def byte_to_printable() -> dict:
    """Bijection byte -> printable unicode char (GPT-2/CLIP standard).

    Printable latin bytes map to themselves; the remaining 68 bytes
    (whitespace/control) are displaced above U+0100 so BPE never sees
    characters it would treat as separators.
    """
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    table = {b: chr(b) for b in keep}
    bump = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + bump)
            bump += 1
    return table


def clean_text(text: str) -> str:
    if _ftfy is not None:
        text = _ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip()


class ClipBpeTokenizer:
    """Byte-level BPE with the CLIP vocabulary layout.

    Vocabulary order (id space): 256 printable byte chars, their 256
    ``</w>`` word-final variants, the 48,894 merge products, then
    ``<|startoftext|>`` / ``<|endoftext|>`` — 49,408 ids total.
    """

    def __init__(self, bpe_path: str):
        if _re is None:
            raise ImportError("ClipBpeTokenizer requires the 'regex' module")
        self._byte_enc = byte_to_printable()
        self._byte_dec = {c: b for b, c in self._byte_enc.items()}

        rows = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = [tuple(r.split()) for r in rows[1:_NUM_MERGES + 1]]
        chars = list(self._byte_enc.values())
        tokens = (
            chars
            + [c + "</w>" for c in chars]
            + ["".join(m) for m in merges]
            + ["<|startoftext|>", "<|endoftext|>"]
        )
        self.encoder = {t: i for i, t in enumerate(tokens)}
        self.decoder = {i: t for t, i in self.encoder.items()}
        self._rank = {m: i for i, m in enumerate(merges)}
        self._pat = _re.compile(_WORD_PATTERN, _re.IGNORECASE)
        self._cache: dict = {}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot_id(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot_id(self) -> int:
        return self.encoder["<|endoftext|>"]

    # -- BPE core ----------------------------------------------------------

    def _merge_once(self, parts: List[str]) -> bool:
        """Merge every occurrence of the lowest-rank adjacent pair.

        Returns False when no adjacent pair is in the merge table.
        """
        best_rank, best_pair = None, None
        for pair in zip(parts[:-1], parts[1:]):
            r = self._rank.get(pair)
            if r is not None and (best_rank is None or r < best_rank):
                best_rank, best_pair = r, pair
        if best_pair is None:
            return False
        merged: List[str] = []
        i = 0
        while i < len(parts):
            if (
                i + 1 < len(parts)
                and (parts[i], parts[i + 1]) == best_pair
            ):
                merged.append(parts[i] + parts[i + 1])
                i += 2
            else:
                merged.append(parts[i])
                i += 1
        parts[:] = merged
        return True

    def _bpe(self, word: str) -> List[str]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1 and self._merge_once(parts):
            pass
        self._cache[word] = parts
        return parts

    # -- public API ---------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in self._pat.findall(clean_text(text).lower()):
            if word in ("<|startoftext|>", "<|endoftext|>"):
                # literal special tokens map to their single id (the
                # reference pre-seeds its BPE cache with them)
                ids.append(self.encoder[word])
                continue
            mapped = "".join(self._byte_enc[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(mapped))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytes(self._byte_dec[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(
        self,
        texts: Union[str, Sequence[str]],
        context_length: int = 77,
        truncate: bool = True,
    ) -> np.ndarray:
        """(B, context_length) int32, zero-padded — viclip_text.py:124."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot_id] + self.encode(t) + [self.eot_id]
            if len(ids) > context_length:
                if not truncate:
                    raise ValueError(
                        f"input {t!r} is longer than {context_length} tokens"
                    )
                ids = ids[:context_length]
                ids[-1] = self.eot_id
            out[i, : len(ids)] = ids
        return out

    def __call__(self, texts: Sequence[str], max_length: int = 77) -> dict:
        """Dataset-facing adapter: ids + mask (pads are zeros past eot)."""
        ids = self.tokenize(texts, context_length=max_length)
        mask = np.zeros_like(ids)
        for i, row in enumerate(ids):
            n = int(np.argmax(row == self.eot_id)) + 1 if (
                row == self.eot_id).any() else max_length
            mask[i, :n] = 1
        return {"input_ids": ids, "attention_mask": mask}
