"""The VideoMLLM of the PyTorch port vs the JAX package: the placeholder
scatter, and the forward with a video (tower, mergers, deepstack residuals),
3D mRoPE positions and packed segment ids on the same weights
(`params_from_jax`, strict) and the same packed rows (tests/
torch_mllm_pair.py), fp32.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internvideo_tpu.models.mllm import scatter_visual as jax_scatter_visual
from internvideo_tpu_torch.models.mllm import VideoMLLM, scatter_visual
from torch_mllm_pair import configs, mllm_pair, packed_batches, torch_batch


def test_scatter_visual_matches_jax():
    rng = np.random.default_rng(0)
    text = rng.standard_normal((2, 9, 4)).astype(np.float32)
    vis = rng.standard_normal((2, 3, 4)).astype(np.float32)
    mask = np.zeros((2, 9), bool)
    mask[0, [1, 4, 5]] = True
    mask[1, [0, 2]] = True  # fewer placeholders than visual rows: row 2 unused
    want = jax_scatter_visual(jnp.asarray(text), jnp.asarray(vis), jnp.asarray(mask))
    got = scatter_visual(*(torch.from_numpy(x) for x in (text, vis, mask)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def pair():
    return mllm_pair()


def test_forward_with_video_mrope_and_segments_matches_jax(pair):
    jcfg, jm, params, tcfg, tm = pair
    batch = next(packed_batches(2, seed=1))
    seg = batch["segment_ids"]
    assert (seg == -1).any() and seg.max() >= 2  # pads and several samples a row
    assert (batch["input_ids"] == tcfg.video_token_id).sum(1).tolist() == [8, 8]
    assert not (batch["position_ids"][0] == batch["position_ids"][1]).all()  # mRoPE grids
    want = jm.apply({"params": params}, batch["input_ids"], batch["video"],
                    position_ids=batch["position_ids"], segment_ids=seg)
    tb = torch_batch(batch)
    out = tm(tb["input_ids"], tb["video"], position_ids=tb["position_ids"],
             segment_ids=tb["segment_ids"])
    np.testing.assert_allclose(out.hidden.detach().numpy(), np.asarray(want.hidden),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(want.logits),
                               atol=2e-4, rtol=2e-4)
    # the video, its deepstack taps and the segments each change the output
    for kw in (dict(video=None), dict(segment_ids=None)):
        args = {"video": tb["video"], "segment_ids": tb["segment_ids"], **kw}
        other = tm(tb["input_ids"], args["video"], position_ids=tb["position_ids"],
                   segment_ids=args["segment_ids"])
        assert (other.logits - out.logits).abs().max() > 1e-3, kw
    no_taps = tm.encode_video(tb["video"])
    assert len(no_taps[1]) == 2 and no_taps[0].shape == (2, 8, 48)


def test_serving_surfaces_raise():
    _, tcfg = configs()
    model = VideoMLLM(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    for call in (lambda: model.prefill(None, None, None), lambda: model.decode_step(None),
                 lambda: model.prefill_paged(None), lambda: model.decode_step_paged(None),
                 lambda: model.init_cache(1, 8)):
        with pytest.raises(NotImplementedError, match="multimodal serving"):
            call()
    hico = VideoMLLM(dataclasses.replace(tcfg, hico_tokens_per_frame=2), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="multimodal serving"):
        hico.encode_video(torch.zeros(1, 4, 32, 32, 3))
