"""The port's convert CLI and the entry points that load checkpoints.

  * tools/convert_cli.py vs internvideo_tpu/tools/convert_cli.py on the same
    synthetic reference checkpoints (.safetensors, sharded HF directories,
    reference .npz; fp32 and bf16): the two npz files hold the same keys,
    dtypes and bytes, bf16 as `V2` records in both. Either package's file
    loads in the other where JAX can (JAX's `load_flat_params` returns bf16
    leaves as `V2`, which no JAX model takes; the port reads them as bf16),
    and a bf16 `.pth` converts in the port where JAX's `np.asarray` raises
    (ROADMAP queue 3).
  * `generate --checkpoint` (an HF directory, sharded or not, or one file)
    on the tiny MLA and GQA presets gives the tokens of the model that
    wrote it.
  * the eval CLI's dispatch: a port CheckpointManager directory, a
    single-shard HF directory (which JAX sends to orbax, restoring nothing:
    the departure is pinned), a `.safetensors` file and a converted `.npz`
    load; an empty directory raises.
  * the train CLI's pretrain teachers load the convert CLI's npz.
"""

import contextlib
import dataclasses
import io
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import internvideo_tpu.models.presets as jpresets
from internvideo_tpu.tools import convert_cli as jcli
from internvideo_tpu_torch.cli import eval as eval_cli
from internvideo_tpu_torch.cli import generate as gen_cli
from internvideo_tpu_torch.cli import train as train_cli
from internvideo_tpu_torch.core import checkpoint as ck
from internvideo_tpu_torch.core.config import load_config
from internvideo_tpu_torch.models import presets
from internvideo_tpu_torch.models.convert import (
    convert_internvideo2_encoder,
    export_gqa_llm_hf,
    export_mla_llm_hf,
    params_from_jax,
    params_to_jax,
)
from internvideo_tpu_torch.tools import convert_cli as tcli
from tests.stage2_synth import make_stage2_state_dict
from tests.torch_ckpt_synth import encoder_reference_sd, same_weights

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")


def _quiet(fn, *a):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a)


def _same_npz(a: str, b: str):
    with np.load(a) as za, np.load(b) as zb:
        assert za.files == zb.files
        for k in za.files:
            x, y = za[k], zb[k]
            assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype)
            assert x.tobytes() == y.tobytes(), k


def _both_clis(tmp_path, argv, tag):
    jdst, tdst = str(tmp_path / f"{tag}_jax.npz"), str(tmp_path / f"{tag}_torch.npz")
    assert _quiet(jcli.main, argv + ["--dst", jdst]) == 0
    assert _quiet(tcli.main, argv + ["--dst", tdst]) == 0
    _same_npz(jdst, tdst)
    return jdst, tdst


def _encoder(cfg, seed):
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2

    return InternVideo2(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


TINY_CLS = os.path.join(ROOT, "configs", "torch", "eval_classification_tiny.py")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_npz_equals_jax_cli(tmp_path, dtype):
    cfg = load_config(TINY_CLS).model
    model = _encoder(cfg, 1)
    ref = {k: v.to(dtype) for k, v in encoder_reference_sd(model.state_dict(), cfg).items()}
    src = str(tmp_path / "enc.safetensors")
    ck.write_safetensors(src, ref)
    argv = ["--kind", "internvideo2_encoder", "--depth", "1", "--src", src]
    jdst, tdst = _both_clis(tmp_path, argv, "enc")
    with np.load(tdst) as z:
        want = np.dtype("V2") if dtype == torch.bfloat16 else np.dtype(np.float32)
        assert z["blocks_0/attn/qkv/kernel"].dtype == want
    tree = tcli.load_flat_params(tdst)
    if dtype == torch.float32:  # the port's npz feeds JAX's loader and the model
        jtree = jcli.load_flat_params(tdst)
        np.testing.assert_array_equal(jtree["params"]["blocks_0"]["mlp"]["fc1"]["kernel"],
                                      tree["params"]["blocks_0"]["mlp"]["fc1"]["kernel"].numpy())
        loaded = _encoder(cfg, 2)
        loaded.load_state_dict(params_from_jax(tree, cfg), strict=True)
        assert same_weights(loaded, model)
    else:  # JAX's loader returns the bf16 leaves as V2 records (ROADMAP queue 3)
        jleaf = jcli.load_flat_params(jdst)["params"]["blocks_0"]["mlp"]["fc1"]["kernel"]
        tleaf = tree["params"]["blocks_0"]["mlp"]["fc1"]["kernel"]
        assert jleaf.dtype == np.dtype("V2") and tleaf.dtype == torch.bfloat16
        np.testing.assert_array_equal(jleaf.view(np.uint16),
                                      tleaf.view(torch.int16).numpy().view(np.uint16))
        assert torch.equal(tleaf, ref["blocks.0.mlp.fc1.weight"].t())


def test_stage2_teachers_and_llm_npz_equal_jax_cli(tmp_path, monkeypatch):
    from internvideo_tpu.models.llm import LLMConfig as JLLMConfig
    from internvideo_tpu.models.llm_gqa import GQAConfig as JGQAConfig
    from internvideo_tpu.nn.mla import MLAConfig as JMLAConfig

    # stage 2 from a reference-layout npz
    sd = make_stage2_state_dict(np.random.default_rng(0), d=32, depth=2, patch=8, img=16,
                                frames=2, clip_k=2, clip_out=20, clip_fin=16, td=32, tl=2,
                                ti=64, fusion_layer=1, vocab=50, embed=16)
    np.savez(tmp_path / "s2.npz", **sd)
    _both_clis(tmp_path, ["--kind", "internvideo2_stage2", "--depth", "2",
                          "--clip-return-layers", "2", "--text-layers", "2",
                          "--src", str(tmp_path / "s2.npz")], "s2")
    bert = {k[len("text_encoder."):]: v for k, v in sd.items() if k.startswith("text_encoder.")}
    np.savez(tmp_path / "bert.npz", **bert)
    _both_clis(tmp_path, ["--kind", "hf_bert", "--text-layers", "2",
                          "--src", str(tmp_path / "bert.npz")], "bert")
    enc = {k[len("vision_encoder."):]: v for k, v in sd.items()
           if k.startswith("vision_encoder.") and "clip_" not in k.split(".")[0]
           and not k.startswith("vision_encoder.final_clip")}
    np.savez(tmp_path / "clip_t.npz", **enc)
    _both_clis(tmp_path, ["--kind", "internvl_clip_teacher", "--depth", "2",
                          "--src", str(tmp_path / "clip_t.npz")], "clip_t")
    # the HF LLMs, sharded bf16 directories, on tiny presets injected into JAX's
    monkeypatch.setattr(jpresets, "qwen3_mla_tiny", lambda: JLLMConfig(
        vocab_size=97, hidden_size=32, num_layers=2, intermediate_size=64,
        mrope_section=None, mla=JMLAConfig(hidden_size=32, num_heads=2, kv_lora_rank=16,
                                           qk_rope_head_dim=8, qk_nope_head_dim=8,
                                           v_head_dim=8)), raising=False)
    monkeypatch.setattr(jpresets, "qwen3_dense_tiny", lambda: JGQAConfig(
        vocab_size=97, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=None, intermediate_size=128), raising=False)
    for kind, preset in (("hf_mla_llm", "qwen3_mla_tiny"), ("hf_gqa_llm", "qwen3_dense_tiny")):
        model, cfg = _llm(preset, 3)
        export = export_gqa_llm_hf if kind == "hf_gqa_llm" else export_mla_llm_hf
        hf = {k: v.bfloat16() for k, v in export(params_to_jax(model.state_dict(), model),
                                                 cfg).items()}
        ck.save_hf_checkpoint(str(tmp_path / kind), hf, shard_size_bytes=20_000)
        assert "model.safetensors.index.json" in os.listdir(tmp_path / kind)
        _both_clis(tmp_path, ["--kind", kind, "--preset", preset,
                              "--src", str(tmp_path / kind)], kind)


def test_pretrain_kind_pth_and_later_kinds(tmp_path):
    """internvideo2_pretrain takes its decoder counts from flags (JAX's CLI
    passes none and its converter requires both); a bf16 .pth stays bf16
    (JAX's loader raises on it); kinds of unported models raise."""
    from internvideo_tpu.models import convert as jconv

    sd = make_stage2_state_dict(np.random.default_rng(1), d=32, depth=2, patch=8, img=16,
                                frames=2, clip_k=2, clip_out=20, clip_fin=16, td=32, tl=2,
                                ti=64, fusion_layer=1, vocab=50, embed=16)
    vis = {k[len("vision_encoder."):]: torch.from_numpy(v).bfloat16() for k, v in sd.items()
           if k.startswith("vision_encoder.")}
    torch.save({"model": vis}, tmp_path / "pre.pth")
    with pytest.raises(TypeError):
        jcli.load_state_dict(str(tmp_path / "pre.pth"))
    dst = str(tmp_path / "pre.npz")
    assert _quiet(tcli.main, ["--kind", "internvideo2_pretrain", "--depth", "2",
                              "--clip-return-layers", "2", "--src", str(tmp_path / "pre.pth"),
                              "--dst", dst]) == 0
    got = tcli.load_flat_params(dst)["params"]
    want = jconv.convert_internvideo2_pretrain(
        {k: v.view(torch.int16).numpy().view(ml_dtypes.bfloat16) for k, v in vis.items()},
        depth=2, clip_return_layers=2, mae_return_layers=0)["params"]
    assert got["clip_decoder_1"]["head"]["kernel"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["clip_decoder_1"]["head"]["kernel"].view(torch.int16).numpy(),
        want["clip_decoder_1"]["head"]["kernel"].view(np.int16))
    for kind in ("viclip", "mobileclip_text", "beats_tokenizer"):
        with pytest.raises(NotImplementedError, match="item 10"):
            tcli.main(["--kind", kind, "--src", dst, "--dst", str(tmp_path / "x.npz")])


# -- generate --checkpoint ---------------------------------------------------------------


def _llm(preset, seed):
    from internvideo_tpu_torch.models.llm import MLATransformer
    from internvideo_tpu_torch.models.llm_gqa import GQATransformer

    cfg = getattr(presets, preset)()
    cls = GQATransformer if hasattr(cfg, "num_kv_heads") else MLATransformer
    return cls(cfg, device="cpu", generator=torch.Generator().manual_seed(seed)).eval(), cfg


@pytest.mark.parametrize("preset", ["qwen3_mla_tiny", "qwen3_dense_tiny"])
def test_generate_cli_loads_hf_checkpoints(tmp_path, preset):
    from internvideo_tpu_torch.models.generation import generate

    model, cfg = _llm(preset, 5)
    with torch.no_grad():  # an lm_head with clear margins for greedy tokens
        model.lm_head.weight.mul_(25)
    export = export_gqa_llm_hf if hasattr(cfg, "num_kv_heads") else export_mla_llm_hf
    hf = export(params_to_jax(model.state_dict(), model), cfg)
    ids = [5, 17, 33, 2]
    want = generate(model, torch.tensor([ids]), max_new_tokens=6)[0].tolist()
    ck.save_hf_checkpoint(str(tmp_path / "sharded"), hf, shard_size_bytes=30_000)
    ck.write_safetensors(str(tmp_path / "one.safetensors"), hf)
    ck.save_hf_checkpoint(str(tmp_path / "single"), hf)
    for path in ("sharded", "one.safetensors", "single"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = gen_cli.main(["--preset", preset, "--checkpoint", str(tmp_path / path),
                               "--ids", ",".join(map(str, ids)), "--max-new-tokens", "6",
                               "--seed", "9", "--device", "cpu"])
        assert rc == 0
        assert json.loads(buf.getvalue().strip().splitlines()[-1])["tokens"] == want, path
    loaded, _ = _llm(preset, 9)
    gen_cli.load_checkpoint(loaded, str(tmp_path / "sharded"))
    assert same_weights(loaded, model)


# -- the eval CLI's dispatch -----------------------------------------------------------


def test_eval_checkpoint_dispatch(tmp_path):
    """Each format loads the writer's weights; a single-shard HF directory
    is HF here, where JAX restores nothing from it (the departure); an
    empty directory raises."""
    from internvideo_tpu.cli import eval as jax_eval
    from internvideo_tpu_torch.train.state import TrainState

    run = load_config(TINY_CLS)
    cfg = run.model
    other = _encoder(cfg, 7)
    ref = encoder_reference_sd(other.state_dict(), cfg)
    hf_dir = tmp_path / "hf"
    assert ck.save_hf_checkpoint(str(hf_dir), ref) == ["model.safetensors"]
    ck.write_safetensors(str(tmp_path / "enc.safetensors"), ref)
    np.savez(tmp_path / "enc.npz", **tcli.flatten_params(params_to_jax(other.state_dict(),
                                                                         other)))
    mgr = ck.CheckpointManager(str(tmp_path / "steps"))
    opt = torch.optim.SGD(other.parameters(), lr=0.1)
    mgr.save(3, TrainState.create(other, opt, seed=0))
    for path in (hf_dir, tmp_path / "enc.safetensors", tmp_path / "enc.npz",
                 tmp_path / "steps"):
        model = _encoder(cfg, 0)
        eval_cli.load_weights(
            model, str(path), lambda sd: convert_internvideo2_encoder(sd, depth=cfg.depth), cfg)
        assert same_weights(model, other), path
    out = eval_cli.TASKS["classification"](dataclasses.replace(run, checkpoint=str(hf_dir)), CPU)
    assert out == eval_cli.TASKS["classification"](
        dataclasses.replace(run, checkpoint=str(tmp_path / "enc.npz")), CPU)
    # JAX: no index file -> orbax, which finds no step and keeps the init
    init = {"params": {"marker": np.zeros(1)}}
    assert jax_eval._load_params(None, init, str(hf_dir), lambda sd: 1 / 0) is init
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no step"):
        eval_cli.load_weights(_encoder(cfg, 0), str(tmp_path / "empty"), None)
    open(tmp_path / "x.bin", "w").close()
    with pytest.raises(ValueError, match="npz"):
        eval_cli.load_weights(_encoder(cfg, 0), str(tmp_path / "x.bin"), None)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        eval_cli.load_weights(_encoder(cfg, 0), str(tmp_path / "nothing"), None)


# -- the train CLI's pretrain teachers -----------------------------------------------------


def test_pretrain_teachers_load_convert_cli_npz(tmp_path):
    from internvideo_tpu_torch.models.teachers import CLIPTeacher, MAETeacher

    run = load_config(os.path.join(ROOT, "configs", "torch", "pretrain_tiny.py"))
    t_full = run.model.encoder.num_frames * run.engine.td_ratio
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    clip_t = CLIPTeacher(run.teacher, device="cpu", generator=gen(11))
    mae_t = MAETeacher(run.mae_teacher, num_frames=t_full, device="cpu", generator=gen(12))
    for name, m in (("clip", clip_t), ("mae", mae_t)):
        np.savez(tmp_path / f"{name}.npz", **tcli.flatten_params(params_to_jax(m.state_dict(), m)))
    data = {**run.data, "clip_teacher_checkpoint": str(tmp_path / "clip.npz"),
            "mae_teacher_checkpoint": str(tmp_path / "mae.npz")}
    _, _, (ct, mt) = train_cli.build_pretrain(dataclasses.replace(run, data=data), CPU)
    assert same_weights(ct, clip_t) and same_weights(mt, mae_t)
    assert not any(p.requires_grad for p in list(ct.parameters()) + list(mt.parameters()))
