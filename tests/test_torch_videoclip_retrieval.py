"""VideoCLIP stage 2 and its retrieval eval in the PyTorch port vs the JAX
package, on the CPU, at configs/eval_retrieval_tiny.py's widths and data.

One JAX `VideoCLIP` is initialised (all branches) and its tower / rerank
functions jitted once per module, as internvideo_tpu/cli/eval.py:71-129
builds them; its params go through `params_from_jax` into the port's
`VideoCLIP`. Held: the forward's outputs (max-abs 1e-5), and
`retrieval_evaluation` with the rerank, without it and with DSL (the score
matrices max-abs 1e-4, the same top-k index sets, identical `itm_eval`
dicts), `itm_eval` on fixed matrices, and the port's CLI end to end.
"""

import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax.linen import unbox

import internvideo_tpu_torch.models.videoclip as tvc
from internvideo_tpu.eval import retrieval as jret
from internvideo_tpu.models.videoclip import VideoCLIP as JaxVideoCLIP
from internvideo_tpu_torch.cli import eval as cli
from internvideo_tpu_torch.core.config import load_config
from internvideo_tpu_torch.eval import retrieval as tret
from internvideo_tpu_torch.models.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
JAX_CFG = "configs/eval_retrieval_tiny.py"
TORCH_CFG = "configs/torch/eval_retrieval_tiny.py"


@pytest.fixture(scope="module")
def pair():
    jrun = load_config(str(ROOT / JAX_CFG))
    run = load_config(str(ROOT / TORCH_CFG))
    videos, texts, gt_v, gt_t = run.data()
    jmodel = JaxVideoCLIP(jrun.model)
    params = jax.jit(lambda v, i, m: jmodel.init(jax.random.key(0), v, i, m,
                                                 init_all_branches=True))(
        videos["video"][:1], texts["input_ids"][:1], texts["attention_mask"][:1])
    params = jax.tree.map(np.asarray, jax.device_get(unbox(params)))
    model = tvc.VideoCLIP(run.model, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params, run.model), strict=True)
    model.eval()

    @jax.jit
    def encode_video(batch):
        out = jmodel.apply(params, batch["video"], method="encode_vision")
        return out[0], jmodel.apply(params, out[1], method=lambda m, x: m.vision_proj(x))

    @jax.jit
    def encode_text(batch):
        tokens, pooled = jmodel.apply(params, batch["input_ids"], batch["attention_mask"],
                                      method="encode_text")
        return tokens, jmodel.apply(params, pooled, method=lambda m, x: m.text_proj(x))

    @jax.jit
    def rerank(vis_embeds, txt_embeds, txt_mask):
        fused = jmodel.apply(params, txt_embeds, txt_mask, vis_embeds, method="fusion")
        logits = jmodel.apply(params, fused.pooled, method="itm_logits")
        return logits[:, 1] - logits[:, 0]

    jax_fns = dict(encode_video=encode_video, encode_text=encode_text, rerank=rerank,
                   forward=jax.jit(lambda v, i, m: jmodel.apply(params, v, i, m)))
    return dict(model=model, jax=jax_fns, run=run, data=(videos, texts, gt_v, gt_t))


def _torch_fns(model):
    @torch.no_grad()
    def encode_video(batch):
        tokens, pooled, _, _ = model.encode_vision(torch.from_numpy(batch["video"]))
        return tokens, model.vision_proj(pooled)

    @torch.no_grad()
    def encode_text(batch):
        tokens, pooled = model.encode_text(torch.from_numpy(batch["input_ids"]),
                                           torch.from_numpy(batch["attention_mask"]))
        return tokens, model.text_proj(pooled)

    @torch.no_grad()
    def rerank(vis_embeds, txt_embeds, txt_mask):
        fused = model.fusion(txt_embeds, torch.from_numpy(txt_mask), vis_embeds)
        logits = model.itm_logits(fused.pooled)
        return logits[:, 1] - logits[:, 0]

    return encode_video, encode_text, rerank


def test_videoclip_forward_matches_jax(pair):
    videos, texts, _, _ = pair["data"]
    ref = pair["jax"]["forward"](videos["video"], texts["input_ids"], texts["attention_mask"])
    with torch.no_grad():
        out = pair["model"](*(torch.from_numpy(x) for x in (
            videos["video"], texts["input_ids"], texts["attention_mask"])))
    for name in ("vision_embeds", "pooled_vision", "text_embeds", "pooled_text", "vision_proj",
                 "text_proj", "temp"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    assert out.clip_middle is None and out.clip_final is None


@pytest.mark.parametrize("mode", ["rerank", "no_rerank", "dsl"])
def test_retrieval_evaluation_matches_jax(pair, mode):
    videos, texts, gt_v, gt_t = pair["data"]
    opts = dict(pair["run"].options, dsl=mode == "dsl")
    j = pair["jax"]
    ref = jret.retrieval_evaluation(
        encode_video=j["encode_video"], encode_text=j["encode_text"],
        rerank_score=None if mode == "no_rerank" else j["rerank"],
        videos=videos, texts=texts, **opts)
    enc_v, enc_t, rerank = _torch_fns(pair["model"])
    got = tret.retrieval_evaluation(
        encode_video=enc_v, encode_text=enc_t,
        rerank_score=None if mode == "no_rerank" else rerank,
        videos=videos, texts=texts, **opts)
    for a, r in zip(got, ref):
        r = np.asarray(r)
        assert a.shape == r.shape
        np.testing.assert_allclose(a, r, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(a == -100.0, r == -100.0)  # the same top-k sets
    assert tret.itm_eval(*got, gt_v, gt_t) == jret.itm_eval(*ref, gt_v, gt_t)


def test_itm_eval_matches_jax_on_fixed_matrices():
    rng = np.random.default_rng(4)
    sq = rng.standard_normal((12, 12))
    sq[3, 7] = sq[3, 2]  # a tie
    gt = np.arange(12)
    assert tret.itm_eval(sq, sq.T, gt, gt) == jret.itm_eval(sq, sq.T, gt, gt)
    v2t, t2v = rng.standard_normal((12, 15)), rng.standard_normal((15, 12))
    gt_txt = [[i, (i + 3) % 15] for i in range(12)]  # two matching texts a video
    gt_vid = np.arange(15) % 12
    assert tret.itm_eval(v2t, t2v, gt_txt, gt_vid) == jret.itm_eval(v2t, t2v, gt_txt, gt_vid)


def test_cli_runs_the_retrieval_task_as_jax_scores_it(pair, monkeypatch):
    """The CLI on the tiny config with the JAX weights gives JAX's metrics."""
    monkeypatch.setattr(tvc, "VideoCLIP", lambda *a, **k: pair["model"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["--config", str(ROOT / TORCH_CFG), "--device", "cpu"]) == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    videos, texts, gt_v, gt_t = pair["data"]
    j = pair["jax"]
    ref = jret.itm_eval(*jret.retrieval_evaluation(
        encode_video=j["encode_video"], encode_text=j["encode_text"], rerank_score=j["rerank"],
        videos=videos, texts=texts, **pair["run"].options), gt_v, gt_t)
    assert out == {"task": "retrieval", **{k: round(v, 4) for k, v in ref.items()}}


def test_cli_module_entry_prints_the_metric_keys():
    res = subprocess.run(
        [sys.executable, "-m", "internvideo_tpu_torch.cli.eval", "--config", TORCH_CFG,
         "--device", "cpu"], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    keys = set(jret.itm_eval(np.eye(3), np.eye(3), np.arange(3), np.arange(3)))
    assert set(out) == {"task"} | keys and all(np.isfinite(out[k]) for k in keys)


def test_unported_options_raise(pair):
    videos, texts, _, _ = pair["data"]
    enc_v, enc_t, rerank = _torch_fns(pair["model"])
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        tret.retrieval_evaluation(encode_video=enc_v, encode_text=enc_t, rerank_score=rerank,
                                  videos=videos, texts=texts, shard_hosts=True)
    with pytest.raises(NotImplementedError, match="queue 1, item 9"):
        cli.main(["--config", str(ROOT / TORCH_CFG), "--device", "cpu", "checkpoint=/x"])


def test_pretrain_tower_encode_vision():
    """With `pretrain` set the tower is the masked student: a masked forward
    sees CLS + the visible tokens and returns the CLIP-align outputs, an
    unmasked one all tokens and none (tests/test_videoclip.py:212-240)."""
    from internvideo_tpu_torch.models.bert import BertConfig
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config
    from internvideo_tpu_torch.models.pretrain import PretrainConfig

    vis = InternVideo2Config(embed_dim=48, depth=2, num_heads=2, mlp_ratio=4.0, patch_size=14,
                             img_size=56, num_frames=2, tubelet_size=1, clip_embed_dim=32,
                             num_classes=0, attn_impl="xla")
    pre = PretrainConfig(encoder=vis, clip_output_dim=40, clip_final_output_dim=24,
                         clip_return_layers=2, mae_return_layers=0)
    bert = BertConfig(vocab_size=128, hidden_size=32, num_layers=4, num_heads=2,
                      intermediate_size=64, fusion_layer=2, dropout=0.0, attn_impl="xla")
    model = tvc.VideoCLIP(tvc.VideoCLIPConfig(vision=vis, text=bert, embed_dim=24,
                                              pretrain=pre),
                          device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    b = 2
    video = torch.randn(b, 2, 56, 56, 3, generator=torch.Generator().manual_seed(1))
    ids, mask = torch.ones(b, 8, dtype=torch.int32), torch.ones(b, 8, dtype=torch.int32)
    keep = torch.arange(16, dtype=torch.int32)[None].expand(b, 16)
    with torch.no_grad():
        out = model(video, ids, mask, keep_indices=keep)
        full = model(video, ids, mask)
        direct = model.vision_encoder(video, keep)
    assert out.vision_embeds.shape[1] == 1 + 16
    assert out.clip_middle.shape == (2, b, 17, 40) and out.clip_final.shape == (b, 24)
    torch.testing.assert_close(out.clip_middle, direct.clip_middle, atol=0, rtol=0)
    assert full.vision_embeds.shape[1] == 1 + vis.num_patches and full.clip_middle is None
    mm = model.text_multimodal(ids, mask, full.vision_embeds)
    assert mm.mlm_logits.shape == (b, 8, 128) and model.itm_logits(mm.pooled).shape == (b, 2)
    with pytest.raises(ValueError, match="pretrain.encoder"):
        tvc.VideoCLIP(tvc.VideoCLIPConfig(vision=vis, text=bert, pretrain=PretrainConfig()),
                      device="cpu", generator=torch.Generator())
