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
from internvideo_tpu_torch.models.generation import generate
from internvideo_tpu_torch.models.llm_gqa import GQAConfig
from internvideo_tpu_torch.models.mllm import VideoMLLM, scatter_visual
from internvideo_tpu_torch.serve import ServingEngine
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
    """The serving surfaces are ported (test_torch_mllm_serving.py); what
    still raises is what JAX refuses too: the paged path with a dense-GQA
    text model, explicit positions on the paged path, and the engine on a
    dense-GQA model."""
    _, tcfg = configs()
    gqa = GQAConfig(vocab_size=256, hidden_size=48, num_layers=1, num_heads=4, num_kv_heads=2,
                    intermediate_size=96, mrope_section=(2, 2, 2))
    model = VideoMLLM(dataclasses.replace(tcfg, text=gqa), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([[5, 251, 251, 251, 251, 7]])
    video = torch.zeros(1, 2, 32, 32, 3)
    with pytest.raises(ValueError, match="dense-GQA"):
        model.prefill_paged(ids, video, [], torch.zeros((1, 2), dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="dense-GQA"):
        generate(model, ids, video=video, max_new_tokens=2, paged=True)
    with pytest.raises(ValueError, match="dense-GQA"):
        ServingEngine(model)
    mla = VideoMLLM(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="position_ids"):
        generate(mla, ids, video=video, max_new_tokens=2, paged=True,
                 position_ids=torch.zeros((3, 1, 6), dtype=torch.long))
    assert generate(model, ids, video=video, max_new_tokens=2).shape == (1, 2)
