"""Tiny CPU-runnable open-set recognition eval (OpenMax smoke).

The PyTorch port's copy of configs/eval_openset_tiny.py: the same
seeded data and options; nothing here imports the JAX package.

Known classes are tight gaussian clusters; unknown test samples sit far
from every class mean, so Weibull recalibration should route them to the
unknown bucket.

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/eval_openset_tiny.py --device cpu
"""

import numpy as np

from internvideo_tpu_torch.cli.eval import EvalRunConfig

_C, _D = 3, 8


def _logits(f, means):
    # positive activation vectors (OpenMax's operating regime): high for
    # the nearest class, moderate for the rest — never negative
    return np.clip(
        30.0 - np.linalg.norm(f[:, None] - means[None], axis=-1), 0.0, None
    ).astype(np.float32)


def _synthetic():
    rng = np.random.default_rng(0)
    means = rng.normal(size=(_C, _D)) * 4.0

    def sample(c, n, spread=0.3):
        return means[c] + rng.normal(size=(n, _D)) * spread

    tr_f = np.concatenate([sample(c, 40) for c in range(_C)]).astype(np.float32)
    tr_y = np.repeat(np.arange(_C), 40)

    te_known = np.concatenate([sample(c, 10) for c in range(_C)])
    # unknowns: moderate distance (~12-18) from every class mean, so their
    # activations stay positive but their Weibull outlier scores saturate
    direction = rng.normal(size=_D)
    direction /= np.linalg.norm(direction)
    te_unknown = (
        means.mean(0) + 14.0 * direction
        + rng.normal(size=(15, _D)) * 0.3
    )
    te_f = np.concatenate([te_known, te_unknown]).astype(np.float32)
    te_y = np.concatenate([np.repeat(np.arange(_C), 10), -np.ones(15)])
    return (
        tr_f, tr_y.astype(np.int32), _logits(tr_f, means),
        te_f, _logits(te_f, means), te_y.astype(np.int32),
    )


config = EvalRunConfig(
    task="openset",
    data=_synthetic,
    options={"tail_size": 10, "alpha": 2},
)
