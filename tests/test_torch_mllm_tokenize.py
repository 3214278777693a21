"""The port's MLLM tokenize function, media loading and jsonl -> packed SFT
batches vs the JAX package, at tests/test_mllm_tokenize.py's widths.

Same jsonl rows and seeded uint8 `.npy` clips through both packages: the
frame / pixel budgets (`sample_frames`, `video_smart_resize`,
`calculate_timestamps`) and `MLLMTokenizeFunction`'s items (ids, shifted
labels, 3-D mRoPE positions, media plans; fixed and free grids, several
videos, given timestamps, truncation) are identical; `load_media` and the
bilinear resize agree to 1e-6 (the same numpy ops: bit-identical); the
batches of `mllm_sft_batches` (with and without a batch size, a text-only
row, a malformed row skipped, a media root) are identical. Then one SFT
step of the port on such a batch against JAX's SFT loss_fn on the same
weights, fp32: loss within 1e-5 relative, every gradient within 5e-4;
and the `data.jsonl` CLI run of configs/torch/sft_jsonl_tiny.py on the CPU.
"""

import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import internvideo_tpu.train.engines.sft as jsft
import internvideo_tpu_torch.train.engines.sft as tsft
from internvideo_tpu.data import mllm_tokenize as jtok
from internvideo_tpu.models.llm import LLMConfig as JLLMConfig
from internvideo_tpu.models.mllm import MLLMConfig as JMLLMConfig
from internvideo_tpu.models.mllm import VideoMLLM as JVideoMLLM
from internvideo_tpu.models.vision_tower import VisionTowerConfig as JVisionTowerConfig
from internvideo_tpu.nn.mla import MLAConfig as JMLAConfig
from internvideo_tpu_torch.cli import train as cli
from internvideo_tpu_torch.core.config import load_config
from internvideo_tpu_torch.data import mllm_tokenize as ttok
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.models.mllm import VideoMLLM

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(ROOT, "configs", "torch", "sft_jsonl_tiny.py")
IDS = dict(image_token_id=250, video_token_id=251, vision_start_token_id=247,
           vision_end_token_id=248, im_start_token_id=245, im_end_token_id=246, pad_token_id=0)
MARK = "<VIDEO_CONTEXT>"


def _encode(text):
    return [1 + (ord(c) % 200) for c in text]


def _cfgs(**kw):
    base = dict(patch_size=8, temporal_patch_size=2, spatial_merge_size=2, fps=2.0,
                min_frames=4, max_frames=16, video_min_total_pixels=4 * 32 * 32,
                video_max_total_pixels=16 * 32 * 32, **IDS, **kw)
    return jtok.MLLMTokenizeConfig(**base), ttok.MLLMTokenizeConfig(**base)


def _video(path="", n=20, h=64, w=48, **kw):
    return {"path": path, "width": w, "height": h, "origin_fps": 10.0,
            "origin_video_length": n, **kw}


def _sample(path="", n_videos=1):
    return {"messages": [{"role": "user", "content": f"what happens {MARK} here?"},
                         {"role": "assistant", "content": "a cat jumps"}],
            "videos": [_video(path)] * n_videos}


def test_budgets_match_jax():
    for total, fps, num in ((900, 30.0, None), (6, 30.0, None), (64, 30.0, 16), (20, 10.0, 5)):
        for mn, mx in ((4, 16), (2, 768)):
            np.testing.assert_array_equal(
                ttok.sample_frames(total, fps, num_frames=num, min_frames=mn, max_frames=mx),
                jtok.sample_frames(total, fps, num_frames=num, min_frames=mn, max_frames=mx))
    for args in ((64, 640, 480), (2, 32, 32), (16, 224, 224), (8, 1080, 1920), (3, 40, 41)):
        for kw in (dict(factor=16, min_pixels=4 * 16 * 16, max_pixels=64 * 32 * 32),
                   dict(factor=16, min_pixels=2 * 64 * 64, max_pixels=2 ** 30), {}):
            try:
                want = jtok.video_smart_resize(*args, **kw)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)[:20]):
                    ttok.video_smart_resize(*args, **kw)
                continue
            assert ttok.video_smart_resize(*args, **kw) == want
    for idx, ts in (([0, 10, 20, 30], None), ([0, 10, 20], None), ([1, 5, 9], [0.1, 0.5, 0.9])):
        assert ttok.calculate_timestamps(idx, 10.0, timestamps=None if ts is None else list(ts)) \
            == jtok.calculate_timestamps(idx, 10.0, timestamps=None if ts is None else list(ts))


def _items_equal(got, want):
    for name in ("input_ids", "labels", "position_ids"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert [dataclasses.asdict(p) for p in got.media] == [dataclasses.asdict(p) for p in want.media]


SAMPLES = {
    "one video": _sample(),
    "two videos": _sample(n_videos=2) | {"messages": [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": f"{MARK} then {MARK}?"},
        {"role": "assistant", "content": "both jump"}]},
    "timestamps": {"messages": _sample()["messages"],
                   "videos": [_video(n=7, frames_timestamp=[0.5 * i for i in range(7)])]},
    "text only": {"messages": [{"role": "pretrain", "content": "plain text, no video"},
                               {"role": "assistant", "content": "ok"}]},
}


@pytest.mark.parametrize("grid", [(2, 4, 4), None])
@pytest.mark.parametrize("name", list(SAMPLES))
def test_tokenize_function_matches_jax(name, grid):
    jcfg, tcfg = _cfgs(fixed_grid=grid)
    sample = SAMPLES[name]
    want = jtok.MLLMTokenizeFunction(_encode, jcfg)(json.loads(json.dumps(sample)))
    got = ttok.MLLMTokenizeFunction(_encode, tcfg)(json.loads(json.dumps(sample)))
    _items_equal(got, want)
    if sample.get("videos"):
        plan = got.media[0]
        assert plan.num_llm_tokens == int((got.input_ids == IDS["video_token_id"]).sum()) // len(
            got.media)


def test_tokenize_truncation_and_no_timestamps_match_jax():
    n = len(jtok.MLLMTokenizeFunction(_encode, _cfgs(fixed_grid=(2, 4, 4))[0])(_sample()).input_ids)
    for max_length in (n - 3, 20):  # past every vision run; inside one
        jcfg, tcfg = _cfgs(fixed_grid=(2, 4, 4), max_length=max_length)
        try:
            want = jtok.MLLMTokenizeFunction(_encode, jcfg)(_sample())
        except ValueError:
            with pytest.raises(ValueError, match="cut a vision run"):
                ttok.MLLMTokenizeFunction(_encode, tcfg)(_sample())
            continue
        _items_equal(ttok.MLLMTokenizeFunction(_encode, tcfg)(_sample()), want)
    jcfg, tcfg = _cfgs(fixed_grid=(2, 4, 4), add_timestamps=False)
    _items_equal(ttok.MLLMTokenizeFunction(_encode, tcfg)(_sample()),
                 jtok.MLLMTokenizeFunction(_encode, jcfg)(_sample()))
    with pytest.raises(AssertionError, match="markers consumed"):
        ttok.MLLMTokenizeFunction(_encode, tcfg)(_sample() | {"videos": [_video()] * 2})


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clips") / "clip.npy")
    np.save(path, np.random.default_rng(0).integers(0, 255, (20, 64, 48, 3), dtype=np.uint8))
    return path


def test_load_media_and_resize_match_jax(clip):
    jcfg, tcfg = _cfgs(fixed_grid=(2, 4, 4))
    for grid_cfgs in ((jcfg, tcfg), _cfgs()):
        jplan = jtok.MLLMTokenizeFunction(_encode, grid_cfgs[0]).plan_video(_video(clip))
        tplan = ttok.MLLMTokenizeFunction(_encode, grid_cfgs[1]).plan_video(_video(clip))
        want, got = jtok.load_media(jplan), ttok.load_media(tplan)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-6
    frames = np.random.default_rng(1).integers(0, 256, (3, 17, 29, 3), dtype=np.uint8)
    for rh, rw in ((32, 32), (17, 29), (40, 8)):
        np.testing.assert_allclose(ttok._bilinear_resize_batch(frames, rh, rw),
                                   jtok._bilinear_resize_batch(frames, rh, rw), rtol=0, atol=1e-6)


def _write_jsonl(tmp_path, clip):
    rows = [_sample(path="clip.npy") for _ in range(3)]
    rows.append(SAMPLES["text only"])
    rows.append({"messages": [{"role": "user", "content": f"{MARK}"}], "videos": []})  # bad
    path = tmp_path / "data.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path), os.path.dirname(clip)


@pytest.mark.parametrize("batch_size", [None, 2])
def test_mllm_sft_batches_match_jax(tmp_path, clip, batch_size):
    path, media_root = _write_jsonl(tmp_path, clip)
    jcfg, tcfg = _cfgs(fixed_grid=(2, 4, 4))
    kw = dict(pack_max_length=96, media_root=media_root, batch_size=batch_size)
    want = jtok.mllm_sft_batches(path, jtok.MLLMTokenizeFunction(_encode, jcfg), **kw)
    got = ttok.mllm_sft_batches(path, ttok.MLLMTokenizeFunction(_encode, tcfg), **kw)
    for _ in range(3):
        g, w = next(got), next(want)
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert np.abs(g[k] - w[k]).max() <= (1e-6 if k == "video" else 0), k
    assert g["position_ids"].shape[0] == 3 and g["video"].shape[1:] == (4, 32, 32, 3)
    finite = ttok.mllm_sft_batches(path, ttok.MLLMTokenizeFunction(_encode, tcfg), loop=False,
                                   **kw)
    rows = [r for b in finite for r in b["video"]]
    # 3 video rows, and the text sample in a row of its own with a zero clip
    assert len(rows) == 4 and sum(not r.any() for r in rows) == 1


# -- one SFT step against JAX's loss_fn ----------------------------------------------------

def _loss_fn(module, *args):
    """The engine's own loss_fn, taken from its make_sft_step."""
    orig = module.make_accum_step
    module.make_accum_step = lambda loss_fn, grad_accum=1: loss_fn
    try:
        return module.make_sft_step(*args)
    finally:
        module.make_accum_step = orig


def test_sft_step_on_a_jsonl_batch_matches_jax(tmp_path, clip):
    path, media_root = _write_jsonl(tmp_path, clip)
    run = load_config(CONFIG)
    tcfg = run.model
    jtcfg = jtok.MLLMTokenizeConfig(**dataclasses.asdict(run.data["tokenize"]))
    batch = next(jtok.mllm_sft_batches(path, jtok.MLLMTokenizeFunction(_encode, jtcfg),
                                       pack_max_length=96, media_root=media_root))
    jcfg = JMLLMConfig(
        vision=JVisionTowerConfig(**{f.name: getattr(tcfg.vision, f.name)
                                     for f in dataclasses.fields(JVisionTowerConfig)
                                     if f.name != "attn_impl"}, attn_impl="xla"),
        text=JLLMConfig(**{f.name: getattr(tcfg.text, f.name)
                           for f in dataclasses.fields(JLLMConfig)
                           if f.name not in ("attn_impl", "mla")},
                        mla=JMLAConfig(**dataclasses.asdict(tcfg.text.mla)), attn_impl="xla"),
        **{k: getattr(tcfg, k) for k in ("image_token_id", "video_token_id",
                                         "vision_start_token_id", "vision_end_token_id")})
    jm = JVideoMLLM(jcfg)
    params = fnn.unbox(jm.init(jax.random.key(0), batch["input_ids"], batch["video"],
                               position_ids=batch["position_ids"],
                               segment_ids=batch["segment_ids"]))["params"]
    params = jax.tree.map(np.asarray, params)
    params["language_model"]["lm_head"]["kernel"] = params["language_model"]["lm_head"][
        "kernel"] * 25  # logits well above the tolerances
    jloss_fn = _loss_fn(jsft, jm, jsft.SFTConfig(ce_chunk_size=run.engine.ce_chunk_size))
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch), jax.random.key(1))

    model = VideoMLLM(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params, tcfg), strict=True)
    loss, aux = _loss_fn(tsft, run.engine)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    loss.backward()
    assert int(aux["tokens"]) == int(jaux["tokens"]) > 0
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        grad = got[name].grad
        grad = torch.zeros_like(got[name]) if grad is None else grad
        np.testing.assert_allclose(grad.numpy(), g.numpy(), atol=5e-4, rtol=0, err_msg=name)
    # the placeholders equal the tower's tokens a clip
    assert int((batch["input_ids"][0] == tcfg.video_token_id).sum()) == 8


def test_cli_sft_on_a_jsonl_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["--config", CONFIG, "--device", "cpu"]) == 0
    steps = [ln for ln in buf.getvalue().splitlines() if ln.startswith("step:")]
    assert len(steps) == 3
    for line in steps:
        fields = dict(f.split(": ") for f in line.split("  "))
        assert np.isfinite(float(fields["loss"])) and np.isfinite(float(fields["grad_norm"]))
        assert int(fields["tokens"]) > 0
