"""The STAL ROI action head at AVA width (PyTorch port).

`STALConfig()` uncut: SlowFast's 2304 feature channels, a 512-wide MLP,
the 80 AVA classes (14 pose-movement under a softmax focal loss, 49
object-manipulation and 17 person-interaction under sigmoid focal
losses), 7 x 7 ROIAlign3D. The one setting changed is `spatial_scale`:
boxes are in pixels of the 256-pixel crop and the feature map has stride
16 (alphaction's POOLER_SCALE 0.0625), so 1/16.

`VOLUME` is the feature volume a batch brings, chosen for this repository
(no AVA frames or backbone are in it): B 8 clips of T 8 feature frames on
a 16 x 16 grid (a 256-pixel crop at stride 16), and up to 16 person boxes
a clip, padded with a validity mask.

    python -c "from internvideo_tpu_torch.core.config import load_config; \
print(load_config('configs/torch/stal_ava.py'))"
"""

from internvideo_tpu_torch.models.stal import STALConfig

config = STALConfig(spatial_scale=1.0 / 16)

VOLUME = dict(batch=8, frames=8, grid=16, stride=16, crop=256, max_boxes=16)
