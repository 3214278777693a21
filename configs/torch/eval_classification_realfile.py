"""Multi-view classification eval over a REAL video file.

Drives the production action-recognition eval path on the reference
repo's actual asset: csv annotation -> CsvVideoDataset.eval_views
(deterministic sparse multi-view decode through data/video.py) ->
encoder -> final_test softmax ensemble (the reference's
engine_for_finetuning final_test + merge flow). Random weights ->
chance-level accuracy; the point is the executed real-media pipeline.

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/eval_classification_realfile.py --device cpu

PyTorch port: mirrors configs/eval_classification_realfile.py field for field, its data
made by the port's data modules. The asset is read from the reference
checkout that IVT_REFERENCE_ROOT names; without it the config writes its
own seeded `.npy` clip, as the JAX config does.
"""

import os
import tempfile

import numpy as np

from internvideo_tpu_torch.cli.eval import EvalRunConfig
from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config

# the reference repository's checkout, if one is named
REFERENCE_ROOT = os.environ.get("IVT_REFERENCE_ROOT", "")
REAL_MP4 = os.path.join(REFERENCE_ROOT, "Data/InternVid/example1.mp4")


def _views():
    from internvideo_tpu_torch.data.datasets import CsvVideoDataset

    tmp = tempfile.mkdtemp(prefix="ivt_realcls_")
    media = REAL_MP4
    if not os.path.exists(media):  # runnable without the asset
        media = os.path.join(tmp, "clip.npy")
        np.save(media, (np.random.default_rng(0).random(
            (40, 64, 80, 3)) * 255).astype(np.uint8))
    anno = os.path.join(tmp, "anno.csv")
    with open(anno, "w") as f:
        for label in range(3):  # same clip under 3 labels = 3 "videos"
            f.write(f"{media},{label}\n")
    ds = CsvVideoDataset(
        anno, num_frames=4, img_size=56, train=False,
    )
    return list(ds.eval_views(batch_size=4, num_clips=2))


config = EvalRunConfig(
    task="classification",
    model=InternVideo2Config(
        embed_dim=32, depth=1, num_heads=2, mlp_ratio=2.0,
        patch_size=14, img_size=56, num_frames=4, tubelet_size=1,
        clip_embed_dim=16, num_classes=3, attn_impl="xla",
    ),
    data=_views,
)
