"""Tiny CPU-runnable temporal grounding eval for the PyTorch port: the
queries and the canned generate function of tests/test_mllm_benchmark.py's
grounding case (an exact span, a near one, an unparsable answer).

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/eval_grounding_tiny.py --device cpu
"""

from internvideo_tpu_torch.cli.eval import EvalRunConfig

ANSWERS = {"a.mp4": "2.0 to 8.0", "b.mp4": "0 4.4", "c.mp4": "maybe never"}


def _data():
    queries = [{"video": "a.mp4", "query": "x", "span": (2.0, 8.0)},
               {"video": "b.mp4", "query": "y", "span": (0.0, 4.0)},
               {"video": "c.mp4", "query": "z", "span": (5.0, 9.0)}]
    return queries, lambda prompt, video: ANSWERS[video]


config = EvalRunConfig(task="grounding", data=_data)
