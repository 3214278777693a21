"""Tiny CPU-runnable MCQ benchmark eval for the PyTorch port: the items and
the oracle generate function of tests/test_mllm_benchmark.py (12 items in
two categories; even items answered "The answer is X", odd ones garbage).

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/eval_mcq_benchmark_tiny.py --device cpu
"""

import numpy as np

from internvideo_tpu_torch.cli.eval import EvalRunConfig


def _data():
    rng = np.random.default_rng(0)
    items = [{"question": f"q{i}", "options": [f"{letter}. opt" for letter in "ABCD"],
              "answer": "ABCD"[int(rng.integers(0, 4))],
              "category": "short" if i % 2 == 0 else "long", "video": f"v{i}.mp4"}
             for i in range(12)]

    def generate(prompt, video):
        i = int(video[1:-4])
        return f"The answer is {items[i]['answer']}" if i % 2 == 0 else "Z unknowable"

    return items, generate


config = EvalRunConfig(task="mcq_benchmark", data=_data)
