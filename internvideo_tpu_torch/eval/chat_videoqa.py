"""Seeded video QA data and the generate function for a VideoChat.

The repository holds no tokenizer and no real weights, so the video QA
configs (configs/torch/chat_videoqa_*.py) drive the chat model with
synthetic inputs: clips drawn from a fixed seed at the model's frame count
and size (no resize, so cv2 is never needed), fixed prompt ids, and a fixed
id -> word table that turns the generated ids into the answer text that
eval/videoqa.py scores. `generate_answer(batch)` is models/generation.py's
`generate` (greedy, dense latent cache) on the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

# the id -> word table: id i reads as ANSWER_WORDS[i % len(ANSWER_WORDS)]
ANSWER_WORDS = (
    "yes", "no", "red", "blue", "green", "dog", "cat", "car", "man", "woman",
    "running", "cooking", "swimming", "one", "two", "three", "left", "right",
    "indoor", "outdoor", "ball", "table", "door", "water", "tree", "phone",
    "sitting", "walking", "playing", "eating", "reading", "dancing",
)


def decode_ids(ids) -> str:
    return " ".join(ANSWER_WORDS[int(i) % len(ANSWER_WORDS)] for i in ids)


def chat_videoqa_data(model, *, clips: int, batch_size: int, prompt_len: int,
                      new_tokens: int, seed: int = 0):
    """-> (generate_answer, batches) for cli/eval.py's videoqa task.

    `model` is a VideoChat; each batch holds `batch_size` clips (B, T, H,
    W, 3) fp32 at the model's frames and size, prompt ids (B, prompt_len)
    in [1, vocab) and one gold answer word per clip."""
    cfg = model.config
    v = cfg.vision
    rng = np.random.default_rng(seed)
    prompt = rng.integers(1, cfg.llm.vocab_size, (1, prompt_len)).astype(np.int64)
    batches = []
    for start in range(0, clips, batch_size):
        b = min(batch_size, clips - start)
        batches.append({
            "video": rng.standard_normal((b, v.num_frames, v.img_size, v.img_size, 3),
                                         np.float32),
            "prompt_ids": np.repeat(prompt, b, axis=0),
            "answers": [[ANSWER_WORDS[int(i)]] for i in rng.integers(0, len(ANSWER_WORDS), b)],
        })

    def generate_answer(batch) -> list[str]:
        from internvideo_tpu_torch.models.generation import generate

        dev = model.device
        ids = generate(model, torch.as_tensor(batch["prompt_ids"], device=dev),
                       video=torch.as_tensor(batch["video"], device=dev),
                       max_new_tokens=new_tokens)
        return [decode_ids(row) for row in ids.tolist()]

    return generate_answer, batches
