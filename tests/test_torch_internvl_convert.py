"""The InternViT / InternVL converters and convert CLI kinds of the PyTorch
port vs the JAX package.

Synthetic checkpoints in the reference's names (HF `InternVLVisionModel`
under `model.vision_tower.`, the projector under
`model.multi_modal_projector.`, the MLA / Qwen3-MoE text model under
`model.language_model.`), numpy from a seed at tiny widths: the port's
`convert_internvit` (LayerNorm blocks with qkv biases, RMSNorm blocks with
whole-dim QK-norm, the xtuner naming without `encoder.`) and
`convert_internvl` (dense and MoE text) give JAX's trees leaf for leaf,
bit for bit; both raise on a final `layernorm`; the convert CLI's
`internvit` and `internvl` kinds write JAX's CLI's npz (tiny presets put
into both packages); the converted tree loads into the port's
InternVLChat, where only the tower's attention pool (which the reference
has not) keeps its init.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

import internvideo_tpu.models.presets as jpresets
from internvideo_tpu.models import convert as jconvert
from internvideo_tpu.tools import convert_cli as jcli
from internvideo_tpu_torch.core import checkpoint as ck
from internvideo_tpu_torch.models import convert as tconvert
from internvideo_tpu_torch.models import presets
from internvideo_tpu_torch.models.convert import export_mla_llm_hf, params_to_jax
from internvideo_tpu_torch.models.internvl import InternVLChat
from internvideo_tpu_torch.models.llm import MLATransformer
from internvideo_tpu_torch.tools import convert_cli as tcli
from test_torch_internvl import configs

D, DEPTH, MLP, PATCH, TOKENS = 32, 2, 64, 8, 17  # 32 x 32 image at patch 8: 16 patches + cls


def vit_sd(rng, flavor: str, prefix: str = "", xtuner: bool = False,
           qkv_bias: bool = False) -> dict:
    """A reference InternViT state dict: "ln" (LayerNorm, no QK-norm) or
    "rms" (RMSNorm, whole-dim QK-RMSNorm); with or without qkv biases."""
    w = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sd = {"embeddings.patch_embeddings.projection.weight": w(D, 3, PATCH, PATCH),
          "embeddings.patch_embeddings.projection.bias": w(D),
          "embeddings.cls_token": w(1, 1, D), "embeddings.position_embeddings": w(1, TOKENS, D)}
    for i in range(DEPTH):
        b = f"layer.{i}" if xtuner else f"encoder.layer.{i}"
        for n in "qkv":
            sd[f"{b}.attention.{n}_proj.weight"] = w(D, D)
            if qkv_bias:
                sd[f"{b}.attention.{n}_proj.bias"] = w(D)
        if flavor == "rms":
            sd[f"{b}.attention.q_norm.weight"] = w(D)
            sd[f"{b}.attention.k_norm.weight"] = w(D)
        for n, shape in (("attention.projection_layer", (D, D)), ("mlp.fc1", (MLP, D)),
                         ("mlp.fc2", (D, MLP))):
            sd[f"{b}.{n}.weight"], sd[f"{b}.{n}.bias"] = w(*shape), w(shape[0])
        for n in ("layernorm_before", "layernorm_after"):
            sd[f"{b}.{n}.weight"] = w(D)
            if flavor == "ln":
                sd[f"{b}.{n}.bias"] = w(D)
        sd[f"{b}.lambda_1"], sd[f"{b}.lambda_2"] = w(D), w(D)
    return {prefix + k: v for k, v in sd.items()}


def internvl_sd(flavor: str, seed: int = 0) -> dict:
    """A reference compose state dict for configs(flavor) (mini: LayerNorm
    tower, dense text; s1: RMSNorm tower, MoE text): the tower and
    projector from numpy, the text model exported from a seeded port LLM."""
    rng = np.random.default_rng(seed)
    _, tcfg = configs(flavor)
    sd = vit_sd(rng, "ln" if flavor == "mini" else "rms", prefix="model.vision_tower.")
    width, hidden = 4 * D, tcfg.text.hidden_size
    pj = "model.multi_modal_projector."
    for n, shape in (("layer_norm", (width,)), ("linear_1", (hidden, width)),
                     ("linear_2", (hidden, hidden))):
        sd[f"{pj}{n}.weight"] = rng.standard_normal(shape).astype(np.float32)
        sd[f"{pj}{n}.bias"] = rng.standard_normal(shape[:1]).astype(np.float32)
    lm = MLATransformer(tcfg.text, device="cpu", generator=torch.Generator().manual_seed(seed))
    for k, v in export_mla_llm_hf(params_to_jax(lm.state_dict(), lm), tcfg.text).items():
        name = k if k == "lm_head.weight" else "model.language_model." + k[len("model."):]
        sd[name] = v.detach().contiguous().numpy()
    return sd


def flat(tree, path=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, path + (k,)))
        else:
            out["/".join(path + (k,))] = np.asarray(v)
    return out


def same_trees(got, want):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("flavor,xtuner", [("ln", False), ("rms", False), ("rms", True)])
def test_convert_internvit_matches_jax(flavor, xtuner):
    sd = vit_sd(np.random.default_rng(1), flavor, prefix="vt.", xtuner=xtuner,
                qkv_bias=flavor == "ln")
    got = tconvert.convert_internvit({k: torch.from_numpy(v) for k, v in sd.items()},
                                     depth=DEPTH, prefix="vt.")
    same_trees(got, jconvert.convert_internvit(sd, depth=DEPTH, prefix="vt."))
    blk = got["params"]["blocks_1"]
    assert ("bias" in blk["attn"]["qkv"]) == (flavor == "ln")
    assert ("q_norm" in blk["attn"]) == (flavor == "rms")
    sd["vt.layernorm.weight"] = np.ones(D, np.float32)  # a final norm: no compose has one
    for convert in (tconvert.convert_internvit, jconvert.convert_internvit):
        with pytest.raises(NotImplementedError, match="final layernorm"):
            convert(sd, depth=DEPTH, prefix="vt.")


@pytest.mark.parametrize("flavor", ["mini", "s1"])
def test_convert_internvl_matches_jax_and_loads(flavor):
    sd = internvl_sd(flavor)
    jcfg, tcfg = configs(flavor)
    got = tconvert.convert_internvl({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)
    same_trees(got, jconvert.convert_internvl(sd, jcfg))
    model = InternVLChat(tcfg, device="cpu", generator=torch.Generator().manual_seed(5))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    missing, unexpected = model.load_state_dict(tconvert.params_from_jax(got, tcfg),
                                                strict=False)
    assert not unexpected and missing
    assert all(k.startswith("vision_tower.clip_projector.") for k in missing)
    after = model.state_dict()
    assert all(torch.equal(after[k], before[k]) for k in missing)
    torch.testing.assert_close(after["vision_tower.blocks.1.attn.qkv.weight"],
                               torch.from_numpy(np.concatenate([sd[
                                   f"model.vision_tower.encoder.layer.1.attention.{n}_proj.weight"]
                                   for n in "qkv"])), rtol=0, atol=0)
    # a checkpoint without the text model converts the tower and projector only
    vis = {k: v for k, v in sd.items() if not k.startswith(("model.language_model.", "lm_head"))}
    assert "language_model" not in tconvert.convert_internvl(vis, tcfg)["params"]


def _same_npz(a: str, b: str):
    with np.load(a) as za, np.load(b) as zb:
        assert za.files == zb.files
        for k in za.files:
            assert za[k].dtype == zb[k].dtype and za[k].tobytes() == zb[k].tobytes(), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cli_internvit_and_internvl_npz_equal_jax_cli(tmp_path, monkeypatch, dtype):
    """Both CLIs on the same files: `internvit --depth 2` on an xtuner-named
    tower (.safetensors), `internvl --preset` on a compose directory in
    shards, the preset a tiny Intern-S1 put into both packages."""
    jcfg, tcfg = configs("s1")
    monkeypatch.setattr(jpresets, "intern_s1_tiny", lambda: jcfg, raising=False)
    monkeypatch.setattr(presets, "intern_s1_tiny", lambda: tcfg, raising=False)
    vit = vit_sd(np.random.default_rng(2), "rms", xtuner=True)
    ck.write_safetensors(str(tmp_path / "vit.safetensors"),
                         {k: torch.from_numpy(v).to(dtype) for k, v in vit.items()})
    full = {k: torch.from_numpy(v).to(dtype) for k, v in internvl_sd("s1", 3).items()}
    ck.save_hf_checkpoint(str(tmp_path / "s1"), full, shard_size_bytes=40_000)
    for kind, argv in (("internvit", ["--depth", str(DEPTH), "--src",
                                      str(tmp_path / "vit.safetensors")]),
                       ("internvl", ["--preset", "intern_s1_tiny", "--src",
                                     str(tmp_path / "s1")])):
        dst = {who: str(tmp_path / f"{kind}_{who}.npz") for who in ("jax", "torch")}
        for who, cli in (("jax", jcli), ("torch", tcli)):
            with contextlib.redirect_stdout(io.StringIO()):
                assert cli.main(["--kind", kind, *argv, "--dst", dst[who]]) == 0
        _same_npz(dst["jax"], dst["torch"])
    tree = tcli.load_flat_params(dst["torch"])
    qkv = tree["params"]["vision_tower"]["blocks_0"]["attn"]["qkv"]["kernel"]
    assert qkv.dtype == dtype and tuple(qkv.shape) == (D, 3 * D)
    # --depth / --text-layers cut the preset's depths (a checkpoint written
    # at a cut depth), which JAX's CLI cannot
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli.main(["--kind", "internvl", "--preset", "intern_s1_tiny", "--depth", "1",
                          "--text-layers", "1", "--src", str(tmp_path / "s1"),
                          "--dst", str(tmp_path / "cut.npz")]) == 0
    cut = tcli.load_flat_params(str(tmp_path / "cut.npz"))["params"]
    assert sorted(k for k in cut["vision_tower"] if k.startswith("blocks_")) == ["blocks_0"]
    assert sorted(k for k in cut["language_model"] if k.startswith("layers_")) == ["layers_0"]
    one = dataclasses.replace(tcfg, vision=dataclasses.replace(tcfg.vision, depth=1),
                              text=dataclasses.replace(tcfg.text, num_layers=1))
    model = InternVLChat(one, device="cpu", generator=torch.Generator().manual_seed(0))
    missing, unexpected = model.load_state_dict(tconvert.params_from_jax(cut, one), strict=False)
    assert not unexpected and all(k.startswith("vision_tower.clip_projector.") for k in missing)
