"""The port's prober (utils/prober.py) vs the JAX package's: the port's
dumps of an InternVideo2 and JAX's of the same weights compare clean
through `compare_dumps` (tensors and the stats-only manifests), with the
same dump layout.
"""

import dataclasses
import glob
import json

import jax
import numpy as np
import torch
from flax import linen as fnn

from internvideo_tpu.utils import prober as jprober
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.utils import prober


def test_prober_dumps_compare_with_jax(tmp_path):
    from internvideo_tpu.models.internvideo2 import InternVideo2 as JInternVideo2
    from internvideo_tpu.models.internvideo2 import make_config as jmake
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2, make_config

    kw = dict(embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0, patch_size=14, img_size=28,
              num_frames=2, clip_embed_dim=16, num_classes=4, attn_pool_num_heads=2)
    jm = JInternVideo2(jmake("1B", **kw, attn_impl="xla"))
    video = np.random.default_rng(0).standard_normal((2, 2, 28, 28, 3)).astype(np.float32)
    params = jax.tree.map(np.asarray, fnn.unbox(jax.jit(jm.init)(jax.random.key(0), video)))
    tm = InternVideo2(make_config("1B", **kw, attn_impl="plain"), device="cpu",
                      generator=torch.Generator().manual_seed(0)).eval()
    tm.load_state_dict(params_from_jax(params), strict=True)
    pats = [r"^blocks_\d+$", r"^patch_embed$"]
    jcfg = jprober.ProberConfig(str(tmp_path / "jax"), steps=(3,), filter_patterns=pats)
    tcfg = prober.ProberConfig(str(tmp_path / "torch"), steps=(3,), filter_patterns=pats)
    jprober.Prober(jcfg).capture(jm, params, video, step=3)
    with torch.no_grad():
        out = prober.Prober(tcfg).capture(tm, torch.from_numpy(video), step=3)
    assert out.logits.shape == (2, 4)
    tdump = prober.load_dump(tcfg.dump_dir, 3)
    assert sorted(tdump) == ["blocks_0/__call__", "blocks_1/__call__", "patch_embed/__call__"]
    report = prober.compare_dumps(jcfg.dump_dir, tcfg.dump_dir, step=3, rtol=1e-3)
    assert report["__missing__"] == []
    assert all(report[k]["ok"] for k in tdump), report
    assert jprober.compare_dumps(tcfg.dump_dir, jcfg.dump_dir, step=3, rtol=1e-3)["__missing__"] \
        == []
    # the stats-only fallback reads the port's manifest as JAX's does
    stats = dataclasses.replace(tcfg, dump_dir=str(tmp_path / "stats"), save_tensors=False)
    with torch.no_grad():
        prober.Prober(stats).capture(tm, torch.from_numpy(video), step=3)
    assert not glob.glob(str(tmp_path / "stats" / "step_000003" / "*.npz"))
    report = prober.compare_dumps(jcfg.dump_dir, stats.dump_dir, step=3, rtol=1e-3)
    assert report["stats_only"] and all(report[k]["ok"] for k in tdump)
    manifest = prober.load_manifest(stats.dump_dir, 3)
    assert {e["path"] for e in manifest} == set(tdump)
    assert json.dumps(manifest)  # plain JSON records
    assert not prober.Prober(tcfg).should_capture(2)
