"""ActionFormer at its published THUMOS14 I3D setting (PyTorch port).

github.com/happyharrycn/actionformer_release, configs/thumos_i3d.yaml and
the defaults of libs/core/config.py it inherits:

  * input_dim 2048 (two-stream I3D features, feat_stride 4), 20 classes,
    max_seq_len 2304;
  * backbone_arch (2, 2, 5): 2 embedding convs, 2 stem transformer blocks,
    5 downsampling blocks -> num_blocks 2, num_levels 6 (strides 1-32);
  * embd_dim / fpn_dim / head_dim 512, n_head 4 -> head dim 128,
    head_num_layers 3, center_sample_radius 1.5;
  * regression_range ((0, 4), (4, 8), (8, 16), (16, 32), (32, 64),
    (64, 10000));
  * n_mha_win_size 19: the reference's local window is the 19 keys with
    |i - j| <= 9. The port's `window` (as the JAX package's, flash_attention.py
    :57-60) keeps |i - j| < window, so 19 keys is window 10;
  * float32, the recipe's and the config's default.

The recipe trains with batch_size 2 and AdamW (learning_rate 1e-4,
weight_decay 0.05), which `TRAIN` records for the scripts that train it
(chip_smoke.py's phase 68).

    python -c "from internvideo_tpu_torch.core.config import load_config; \
print(load_config('configs/torch/actionformer_thumos.py'))"
"""

from internvideo_tpu_torch.models.actionformer import ActionFormerConfig

config = ActionFormerConfig(
    in_dim=2048,
    embed_dim=512,
    num_heads=4,
    num_levels=6,
    num_blocks=2,
    window=10,
    head_layers=3,
    num_classes=20,
    max_seq_len=2304,
    center_sample_radius=1.5,
    regression_ranges=((0, 4), (4, 8), (8, 16), (16, 32), (32, 64), (64, 10000)),
    dtype="float32",
)

TRAIN = dict(batch_size=2, lr=1e-4, weight_decay=0.05)
