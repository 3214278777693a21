"""Generation-based video QA evaluation (lmms-eval adapter equivalent).

Port of internvideo_tpu/eval/videoqa.py, a copy (the JAX module imports no
JAX; the port imports nothing of the JAX package).

The reference drives MLLM benchmarks (VideoMME, MVBench, ...) through
lmms-eval shell scripts (InternVideo3_eval/scripts/eval_*.sh). The adapter
surface needed from the framework is: (prompt tokens, video) -> generated
answer ids. This module provides that plus the two standard scorers:
exact-match / substring accuracy for open-ended QA and first-letter option
matching for MCQ benchmarks.
"""

from __future__ import annotations

import re
import string
from typing import Callable, Iterable, Optional, Sequence


def normalize_answer(s: str) -> str:
    s = s.lower().strip()
    s = re.sub(rf"[{re.escape(string.punctuation)}]", "", s)
    articles = {"a", "an", "the"}
    return " ".join(w for w in s.split() if w not in articles)


def exact_match(pred: str, golds: Sequence[str]) -> bool:
    p = normalize_answer(pred)
    return any(p == normalize_answer(g) for g in golds)


def substring_match(pred: str, golds: Sequence[str]) -> bool:
    p = normalize_answer(pred)
    return any(normalize_answer(g) in p for g in golds)


def mcq_option(pred: str, options: Sequence[str] = "ABCD") -> Optional[str]:
    """Extract the chosen option letter from a generated answer
    (lmms-eval's MCQ post-processing: first standalone option letter)."""
    m = re.search(rf"\b([{''.join(options)}])\b", pred.strip().upper())
    return m.group(1) if m else None


def evaluate_videoqa(
    generate_answer: Callable,  # (batch) -> list[str] decoded answers
    data: Iterable[dict],  # {"prompt_ids"/"video"/..., "answers": list[str],
    #                        optional "option": "A".."D" for MCQ}
    *,
    matcher: str = "substring",  # exact | substring | mcq
) -> dict:
    match_fn = {"exact": exact_match, "substring": substring_match}.get(matcher)
    correct, total = 0, 0
    for batch in data:
        preds = generate_answer(batch)
        if matcher == "mcq":
            for pred, gold in zip(preds, batch["option"]):
                correct += int(mcq_option(pred) == gold.upper())
                total += 1
        else:
            for pred, golds in zip(preds, batch["answers"]):
                correct += int(match_fn(pred, golds))
                total += 1
    return {"accuracy": 100.0 * correct / max(total, 1), "num": total}
