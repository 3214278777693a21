"""Temporal grounding (moment retrieval) evaluation.

Port of internvideo_tpu/eval/grounding.py, a copy but for the per-rank
results file: with more than one torch.distributed process it raises, as
host sharding waits for the distributed port (ROADMAP queue 1, item 8).

Mirrors the reference's Charades-STA-class grounding eval
(InternVideo3_eval/scripts/eval_grounding.py:47-188 span parsing + IoU,
calc_grounding_metrics.py: mIoU / R@{0.3,0.5,0.7} over deduped
(video_id, query_idx) results). The model answers a "when does X happen"
query with a time span in seconds; metrics are span-IoU recall rates.
"""

from __future__ import annotations

import json
import re
from typing import Callable, Iterable, Optional, Tuple


def parse_time_span(text: str) -> Tuple[Optional[float], Optional[float]]:
    """First two numbers in the response = (start, end) seconds
    (eval_grounding.py:47-52)."""
    numbers = re.findall(r"[\d]+\.?\d*", text)
    if len(numbers) >= 2:
        return float(numbers[0]), float(numbers[1])
    return None, None


def span_iou(pred: Tuple[float, float], gt: Tuple[float, float]) -> float:
    """1-D temporal IoU (eval_grounding.py:172-179); 0 for degenerate or
    unparsable predictions."""
    ps, pe = pred
    gs, ge = gt
    if ps is None or pe is None:
        return 0.0
    ps, pe = min(ps, pe), max(ps, pe)
    inter = max(0.0, min(pe, ge) - max(ps, gs))
    union = max(pe, ge) - min(ps, gs)
    return inter / union if union > 0 else 0.0


def grounding_metrics(ious: Iterable[float]) -> dict:
    """calc_grounding_metrics.py aggregate: mIoU + recall at 0.3/0.5/0.7."""
    ious = list(ious)
    n = max(len(ious), 1)
    return {
        "n": len(ious),
        "mIoU": sum(ious) / n,
        "R@0.3": 100.0 * sum(i >= 0.3 for i in ious) / n,
        "R@0.5": 100.0 * sum(i >= 0.5 for i in ious) / n,
        "R@0.7": 100.0 * sum(i >= 0.7 for i in ious) / n,
    }


def run_grounding_eval(
    queries: Iterable[dict],  # {"video", "query", "span": (s, e), ...}
    generate_fn: Callable[[str, Optional[str]], str],
    *,
    prompt_template: str = (
        "Find the moment when '{query}' happens in the video. Answer with "
        "the start and end time in seconds."
    ),
    results_path: Optional[str] = None,
) -> dict:
    """Drive the model over grounding queries and aggregate metrics.
    Results optionally stream to jsonl (the reference's per-rank files)."""
    ious = []
    records = []
    by_cat: dict = {}
    for i, q in enumerate(queries):
        response = generate_fn(
            prompt_template.format(query=q["query"]), q.get("video")
        )
        pred = parse_time_span(response)
        iou = span_iou(pred, tuple(q["span"]))
        ious.append(iou)
        if "category" in q:  # calc_timelens_metrics.py per-source splits
            by_cat.setdefault(str(q["category"]), []).append(iou)
        records.append({
            "video_id": q.get("video", ""), "query_idx": i,
            "pred": pred, "gt": list(q["span"]), "iou": round(iou, 4),
        })
    if results_path:
        import os

        from internvideo_tpu_torch.eval.mllm_benchmark import process_count

        if process_count() > 1:  # JAX writes per-rank files here
            raise NotImplementedError(
                "per-rank grounding results across processes are not ported yet "
                "(ROADMAP queue 1, item 8)")
        os.makedirs(os.path.dirname(results_path) or ".", exist_ok=True)
        with open(results_path, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    out = grounding_metrics(ious)
    if by_cat:
        out["per_category"] = {
            c: grounding_metrics(v) for c, v in sorted(by_cat.items())
        }
    return out
