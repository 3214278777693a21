"""MLLM MCQ benchmark driver (VideoMME / MVBench-class suites).

Port of internvideo_tpu/eval/mllm_benchmark.py, a copy but for sharding:
`shard_hosts=True` in one process is the plain path (JAX's allgather over
one host is the identity), and with more than one torch.distributed
process it raises, as host sharding waits for the distributed port
(ROADMAP queue 1, item 8).

Mirrors the reference's eval scripts
(InternVideo3_eval/scripts/eval_videommev2.py and the lmms-eval shell
suite): build the MCQ prompt (with optional subtitles), generate, parse
the option letter, shard items across processes, aggregate accuracy
overall and per category.

The generation backend is any callable (prompt, video_path) -> text —
wire `models/generation.generate` + a tokenizer + the tokenize-fn's frame
sampling (data/mllm_tokenize.py) for the real model, or a stub for tests.
"""

from __future__ import annotations

import collections
import json
import os
import re
from typing import Callable, Iterable, Optional, Sequence

# eval_videommev2.py:18-23 — the prompt templates, verbatim semantics
MCQ_PROMPT = (
    "Select the best answer to the following multiple-choice question "
    "based on the video.\n"
    "Question: {question}\nOptions:\n{options}\n"
    "Answer with the option letter only."
)

MCQ_PROMPT_WITH_SUB = (
    "Select the best answer to the following multiple-choice question "
    "based on the video. "
    "The subtitles of the video are also provided below.\n"
    "Subtitles:\n{subtitles}\n\n"
    "Question: {question}\nOptions:\n{options}\n"
    "Answer with the option letter only."
)


def build_mcq_prompt(
    question: str,
    options: Sequence[str],
    subtitles: Optional[str] = None,
) -> str:
    opts = "\n".join(options)
    if subtitles:
        return MCQ_PROMPT_WITH_SUB.format(
            subtitles=subtitles, question=question, options=opts
        )
    return MCQ_PROMPT.format(question=question, options=opts)


def parse_option_letter(text: str, letters: str = "ABCDEFGH") -> str:
    """Reference parse_answer (eval_videommev2.py:42-53): leading letter,
    'answer is X' patterns, then first character. One deviation: the
    reference's optional answer-prefix makes its regex match stray vowels
    inside words ("The ..." -> E); here the explicit prefix is required
    before falling back to a standalone letter."""
    text = text.strip()
    m = re.match(rf"^([{letters}])\b", text.upper())
    if m:
        return m.group(1)
    m = re.search(
        rf"(?:answer is|answer:)\s*\(?([{letters}])\b", text, re.IGNORECASE
    )
    if m:
        return m.group(1).upper()
    m = re.search(rf"\b([{letters}])\b", text.upper())
    if m:
        return m.group(1)
    return text[0].upper() if text else ""


def load_benchmark_items(path: str) -> list[dict]:
    """Items from jsonl / json-list / parquet. Expected fields per item:
    question, options (list of 'A. ...' strings), answer (letter), and
    optionally video (path), category/duration, subtitles."""
    if path.endswith(".parquet"):
        import pandas as pd

        return pd.read_parquet(path).to_dict("records")
    with open(path) as f:
        if path.endswith(".jsonl"):
            return [json.loads(line) for line in f if line.strip()]
        return json.load(f)


def process_count() -> int:
    """torch.distributed's world size, 1 outside a process group."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def run_mcq_benchmark(
    items: Iterable[dict],
    generate_fn: Callable[[str, Optional[str]], str],
    *,
    category_key: Optional[str] = "category",
    use_subtitles: bool = False,
    shard_hosts: bool = False,
    predictions_path: Optional[str] = None,
) -> dict:
    """-> {"overall": acc%, "n": N, "per_category": {...}}.

    In JAX, shard_hosts makes each process evaluate its row stride and
    merge the partial counts with a host allgather (the reference shards by
    rank the same way, eval_videommev2.py:34-39); here one process takes
    every row, and more than one raises."""
    if process_count() > 1 and (shard_hosts or predictions_path):
        raise NotImplementedError(
            "MCQ benchmark rows sharded across processes are not ported yet "
            "(ROADMAP queue 1, item 8)")
    items = list(items)
    idx = range(len(items))

    counts = collections.Counter()
    correct = collections.Counter()
    preds = []
    for i in idx:
        it = items[i]
        prompt = build_mcq_prompt(
            it["question"], it["options"],
            it.get("subtitles") if use_subtitles else None,
        )
        out = generate_fn(prompt, it.get("video"))
        pred = parse_option_letter(out)
        cat = str(it.get(category_key, "all")) if category_key else "all"
        counts[cat] += 1
        correct[cat] += int(pred == str(it["answer"]).strip().upper())
        preds.append({"index": i, "pred": pred, "answer": it["answer"]})

    if predictions_path:
        os.makedirs(os.path.dirname(predictions_path) or ".", exist_ok=True)
        with open(predictions_path, "w") as f:
            for p in preds:
                f.write(json.dumps(p) + "\n")

    total = sum(counts.values())
    result = {
        "overall": 100.0 * sum(correct.values()) / max(total, 1),
        "n": total,
        "per_category": {
            c: 100.0 * correct[c] / counts[c] for c in sorted(counts)
        },
    }
    return result
