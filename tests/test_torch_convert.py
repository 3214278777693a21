"""The reference converters of the PyTorch port (models/convert.py,
models/mla_convert.py, nn/embeds.py:interpolate_pos_embed) vs the JAX
package's.

Synthetic reference state dicts are made from a seed at tiny widths, with
the reference's names and shapes: the JAX model's param structure
(`jax.eval_shape` of its init) filled with seeded values, laid out as the
reference does (the Conv3d patchify, the leading broadcast dim of pos
embeds, VideoMAE's q / v biases, BEATs' weight-normed position conv), or
through the JAX package's own HF exports for BERT and the LLMs; stage 2
uses tests/stage2_synth.py. On each, the JAX converter and the port's give
the same tree, key for key and bit for bit, in fp32 and in bf16; the JAX
tree equals the structure it was made from. JAX's `model.apply` on its
tree and the port's model on `params_from_jax` of the port's tree agree in
fp32 within the slice tests' tolerances. `params_to_jax`, the inverse of
`params_from_jax`, is held in tests/test_torch_params_to_jax.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import linen as fnn

from internvideo_tpu.models import convert as jconv
from internvideo_tpu.models import mla_convert as jmla
from internvideo_tpu.nn import embeds as jembeds
from internvideo_tpu_torch.models import convert as tconv
from internvideo_tpu_torch.models import mla_convert as tmla
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.nn import embeds as tembeds
from tests.stage2_synth import make_stage2_state_dict

# -- helpers ---------------------------------------------------------------


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_paths(v, p))
        else:
            out[p] = v
    return out


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _same_tree(want, got, ordered=True):
    """Same paths (in the same order when `ordered`), shapes, dtypes and
    bits (numpy / ml_dtypes vs torch)."""
    w, g = _paths(want), _paths(got)
    if not ordered:
        w, g = dict(sorted(w.items())), dict(sorted(g.items()))
    assert list(w) == list(g), (sorted(set(w) ^ set(g)), list(w)[:5], list(g)[:5])
    for k in w:
        a, t = np.asarray(w[k]), g[k]
        assert isinstance(t, torch.Tensor), k
        assert tuple(t.shape) == a.shape, (k, t.shape, a.shape)
        assert t.dtype == tconv.as_tensor(a).dtype, (k, t.dtype, a.dtype)
        np.testing.assert_array_equal(_bits(t), _bits(a), err_msg=k)


def _np(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy, bf16 as an ml_dtypes array."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _fill(shapes, seed: int, dtype=None) -> dict:
    """A `jax.eval_shape` param tree filled with seeded values: norm scales
    near 1, everything else small."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1]
        v = rng.standard_normal(s.shape).astype(np.float32)
        v = 1.0 + 0.1 * v if name in ("scale", "weight") and len(s.shape) == 1 else 0.05 * v
        return v.astype(dtype or s.dtype)

    def walk(node, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else leaf(path + (k,), v)
                for k, v in node.items()}

    return walk(fnn.unbox(shapes)["params"], ())


_SHAPES: dict = {}


def _eval_shape(module, *args, **kw):
    """`jax.eval_shape` of `module.init`, traced once per module and input
    shapes: several tests fill the same structure."""
    spec = lambda a: (a.shape, str(a.dtype)) if hasattr(a, "shape") else a  # noqa: E731
    key = repr((module, [spec(a) for a in args], sorted((k, spec(v)) for k, v in kw.items())))
    if key not in _SHAPES:
        _SHAPES[key] = jax.eval_shape(lambda: module.init(jax.random.key(0), *args, **kw))
    return _SHAPES[key]


def _sd(tree) -> dict:
    """The port's names for a JAX tree (the base of each reference layout)."""
    return dict(params_from_jax(tree))


def _both(jfn, tfn, sd):
    """(JAX converter on numpy, port converter on tensors) of one state dict."""
    return jfn({k: _np(v) for k, v in sd.items()}), tfn(dict(sd))


DTYPES = [np.float32, ml_dtypes.bfloat16]

# -- InternVideo2 encoder, the pretrain student and its teachers ------------

ENC = dict(embed_dim=48, depth=2, num_heads=2, mlp_ratio=2.0, patch_size=14, img_size=28,
           num_frames=4, tubelet_size=2, clip_embed_dim=16, num_classes=5,
           attn_pool_num_heads=2)


def _encoder_ref(sd: dict, cfg, prefix: str = "") -> dict:
    """Port-named encoder tensors -> the reference layout: the Conv3d
    patchify (D, C, kt, kh, kw), pos embeds with their broadcast dim, the
    attention pool's q / k / v biases as `q_bias` Parameters."""
    out = {}
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        if k == "patch_embed.proj.weight":
            p, ts = cfg.patch_size, cfg.tubelet_size
            v = v.reshape(v.shape[0], ts, p, p, 3).permute(0, 4, 1, 2, 3).contiguous()
        elif k in ("pos_embed", "clip_pos_embed", "mae_pos_embed"):
            v = v[None]
        elif k.startswith("clip_projector.cross_attn.") and k.endswith(".bias") \
                and k.split(".")[2] in "qkv":
            k = f"clip_projector.cross_attn.{k.split('.')[2]}_bias"
        out[k] = v
    return out


def _encoder_tree():
    from internvideo_tpu.models.internvideo2 import InternVideo2, make_config

    cfg = make_config("1B", **ENC, attn_impl="xla")
    return cfg, _fill(_eval_shape(InternVideo2(cfg), jnp.zeros((1, 4, 28, 28, 3))), 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_and_clip_teacher_converters_match_jax(dtype):
    cfg, tree = _encoder_tree()
    tree = jax.tree.map(lambda a: a.astype(dtype), tree)
    ref = _encoder_ref(_sd(tree), cfg)
    assert "clip_projector.cross_attn.q_bias" in ref and ref["pos_embed"].dim() == 3
    j, t = _both(lambda s: jconv.convert_internvideo2_encoder(s, depth=2),
                 lambda s: tconv.convert_internvideo2_encoder(s, depth=2), ref)
    _same_tree(j, t)
    _same_tree(tree, t["params"], ordered=False)  # the layout converts back
    j, t = _both(lambda s: jconv.convert_internvl_clip_teacher(s, depth=2),
                 lambda s: tconv.convert_internvl_clip_teacher(s, depth=2), ref)
    _same_tree(j, t)


def _pretrain_run(pkg):
    """configs/pretrain_tiny.py's student and teachers in either package
    (model fields only: model, teacher, mae_teacher, td_ratio)."""
    if pkg == "jax":
        from internvideo_tpu.models.internvideo2 import InternVideo2Config
        from internvideo_tpu.models.pretrain import PretrainConfig
        from internvideo_tpu.models.teachers import TeacherConfig
    else:
        from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config
        from internvideo_tpu_torch.models.pretrain import PretrainConfig
        from internvideo_tpu_torch.models.teachers import TeacherConfig
    enc = InternVideo2Config(embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0, patch_size=14,
                             img_size=28, num_frames=2, tubelet_size=1, clip_embed_dim=16,
                             num_classes=0)
    teacher = dict(embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0, patch_size=14,
                   img_size=28, clip_embed_dim=16)
    return type("Run", (), dict(
        model=PretrainConfig(encoder=enc, clip_output_dim=32, clip_final_output_dim=16,
                             clip_return_layers=2, mae_output_dim=32, mae_return_layers=1),
        teacher=TeacherConfig(**teacher, return_layers=2, tubelet_size=1),
        mae_teacher=TeacherConfig(**teacher, return_layers=1, tubelet_size=2,
                                  norm_type="layernorm"),
        td_ratio=2))


@pytest.fixture(scope="module")
def pretrain_trees():
    """The tiny UMT recipe's student, CLIP teacher and MAE teacher, as
    filled JAX trees."""
    from internvideo_tpu.models.pretrain import PretrainInternVideo2
    from internvideo_tpu.models.teachers import CLIPTeacher, MAETeacher

    run = _pretrain_run("jax")
    enc = run.model.encoder
    t_full = enc.num_frames * run.td_ratio
    sv = jnp.zeros((1, enc.num_frames, enc.img_size, enc.img_size, 3))
    keep = jnp.zeros((1, enc.num_patches // 2), jnp.int32)
    video = jnp.zeros((1, t_full, enc.img_size, enc.img_size, 3))
    return run, (_fill(_eval_shape(PretrainInternVideo2(run.model), sv, keep), 1),
                 _fill(_eval_shape(CLIPTeacher(run.teacher), sv), 2),
                 _fill(_eval_shape(MAETeacher(run.mae_teacher), video), 3))


def _videomae_ref(tree: dict, cfg) -> dict:
    """A MAETeacher tree -> videomae.py's layout: q_bias / v_bias (the k
    third zero), gamma_1 / gamma_2."""
    d = cfg.embed_dim
    for i in range(cfg.depth):
        b = tree[f"blocks_{i}"]["attn"]["qkv"]["bias"]
        b[d:2 * d] = 0
    out = {}
    for k, v in _encoder_ref(_sd(tree), cfg).items():
        if k.endswith("attn.qkv.bias"):
            pre = k[:-len("qkv.bias")]
            out[pre + "q_bias"], out[pre + "v_bias"] = v[:d], v[2 * d:]
        elif ".ls1.gamma" in k or ".ls2.gamma" in k:
            out[k.replace(".ls1.gamma", ".gamma_1").replace(".ls2.gamma", ".gamma_2")] = v
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_pretrain_and_teacher_converters_match_jax(pretrain_trees, dtype):
    run, trees = pretrain_trees
    student, clip_t, mae_t = (jax.tree.map(lambda a: a.astype(dtype), t) for t in trees)
    pre = run.model
    ref = _encoder_ref(_sd(student), pre.encoder, prefix="encoder.")
    ref.update(_encoder_ref({k: v for k, v in _sd(student).items()
                             if not k.startswith("encoder.")}, pre.encoder))
    kw = dict(depth=pre.encoder.depth, clip_return_layers=pre.clip_return_layers,
              mae_return_layers=pre.mae_return_layers)
    j, t = _both(lambda s: jconv.convert_internvideo2_pretrain(s, **kw),
                 lambda s: tconv.convert_internvideo2_pretrain(s, **kw), ref)
    _same_tree(j, t)
    _same_tree(student, t["params"], ordered=False)
    ref = _encoder_ref(_sd(clip_t), run.teacher, prefix="encoder.")
    j, t = _both(lambda s: jconv.convert_internvl_clip_teacher(s, depth=run.teacher.depth),
                 lambda s: tconv.convert_internvl_clip_teacher(s, depth=run.teacher.depth), ref)
    _same_tree(j, t)
    _same_tree(clip_t, t["params"], ordered=False)
    ref = _videomae_ref(mae_t, run.mae_teacher)
    assert any(k.endswith("attn.q_bias") for k in ref) and not any(".ls1." in k for k in ref)
    for drop_pos in (False, True):  # with the table, and the reference's computed one
        src = {k: v for k, v in ref.items() if not (drop_pos and k == "pos_embed")}
        n = mae_t["pos_embed"].shape[0]
        kw = dict(depth=run.mae_teacher.depth, num_patches=n if drop_pos else None)
        j, t = _both(lambda s: jconv.convert_videomae_teacher(s, **kw),
                     lambda s: tconv.convert_videomae_teacher(s, **kw), src)
        _same_tree(j, t)
    _same_tree(mae_t, tconv.convert_videomae_teacher(ref, depth=run.mae_teacher.depth)["params"],
               ordered=False)


# -- stage 2 and BERT --------------------------------------------------------

STAGE2 = dict(d=32, depth=2, patch=8, img=16, frames=2, clip_k=2, clip_out=20, clip_fin=16,
              td=32, tl=2, ti=64, fusion_layer=1, vocab=50, embed=16, max_pos=64)


def _stage2_configs(pkg):
    if pkg == "jax":
        from internvideo_tpu.models.bert import BertConfig
        from internvideo_tpu.models.internvideo2 import InternVideo2Config
        from internvideo_tpu.models.pretrain import PretrainConfig
        from internvideo_tpu.models.videoclip import VideoCLIPConfig
    else:
        from internvideo_tpu_torch.models.bert import BertConfig
        from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config
        from internvideo_tpu_torch.models.pretrain import PretrainConfig
        from internvideo_tpu_torch.models.videoclip import VideoCLIPConfig
    s = STAGE2
    enc = InternVideo2Config(embed_dim=s["d"], depth=s["depth"], num_heads=2, mlp_ratio=2.0,
                             patch_size=s["patch"], img_size=s["img"], num_frames=s["frames"],
                             tubelet_size=1, clip_embed_dim=s["clip_fin"], num_classes=0,
                             attn_impl="xla" if pkg == "jax" else "plain")
    return VideoCLIPConfig(
        vision=enc,
        pretrain=PretrainConfig(encoder=enc, clip_output_dim=s["clip_out"],
                                clip_final_output_dim=s["clip_fin"],
                                clip_return_layers=s["clip_k"], mae_return_layers=0),
        text=BertConfig(vocab_size=s["vocab"], hidden_size=s["td"], num_layers=s["tl"],
                        num_heads=2, intermediate_size=s["ti"], fusion_layer=s["fusion_layer"],
                        max_position_embeddings=s["max_pos"],
                        **({} if pkg == "jax" else {"attn_impl": "plain"})),
        embed_dim=s["embed"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_stage2_and_bert_converters_match_jax(dtype):
    sd = make_stage2_state_dict(np.random.default_rng(0), **STAGE2)
    sd = {k: tconv.as_tensor(np.asarray(v).astype(dtype)) for k, v in sd.items()}
    kw = dict(depth=2, clip_return_layers=2, text_layers=2)
    j, t = _both(lambda s: jconv.convert_internvideo2_stage2(s, **kw),
                 lambda s: tconv.convert_internvideo2_stage2(s, **kw), sd)
    _same_tree(j, t)
    bert = {k[len("text_encoder."):]: v for k, v in sd.items() if k.startswith("text_encoder.")}
    j, t = _both(lambda s: jconv.convert_hf_bert(s, num_layers=2),
                 lambda s: tconv.convert_hf_bert(s, num_layers=2), bert)
    _same_tree(j, t)
    assert "mlm_decoder" in t["params"] and "crossattention" in t["params"]["layer_1"]
    want = jconv.export_bert_to_hf(j, 2)
    got = tconv.export_bert_to_hf(t, 2)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)
    # the export inverts the converter on the BERT tower
    assert all(torch.equal(got[k], bert[k]) for k in got)


# -- BEATs --------------------------------------------------------------------

from tests.test_torch_audio import BEATS  # noqa: E402


@pytest.mark.parametrize("dtype", DTYPES)
def test_beats_converter_matches_jax(dtype):
    from internvideo_tpu.models.beats import BEATsConfig, BEATsEncoder

    tree = _fill(_eval_shape(BEATsEncoder(BEATsConfig(**BEATS)), jnp.zeros((1, 32, 32))), 4)
    tree = jax.tree.map(lambda a: a.astype(dtype), tree)
    sd, ref = _sd(tree), {}
    for k, v in sd.items():
        if k.startswith("layers.") or k.startswith("encoder_layer_norm."):
            k = "encoder." + k.replace("encoder_layer_norm.", "layer_norm.")
        if k.endswith("relative_attention_bias"):
            k += ".weight"
        if k.startswith("pos_conv."):
            continue
        ref[k] = v
    cout, cin_g, taps = sd["pos_conv.weight"].shape
    rng = np.random.default_rng(5)
    ref["encoder.pos_conv.0.weight_g"] = torch.from_numpy(
        rng.uniform(0.5, 1.5, (1, 1, taps)).astype(np.float32)).to(sd["pos_conv.bias"].dtype)
    ref["encoder.pos_conv.0.weight_v"] = torch.from_numpy(
        rng.standard_normal((cout, cin_g, taps)).astype(np.float32)).to(sd["pos_conv.bias"].dtype)
    ref["encoder.pos_conv.0.bias"] = sd["pos_conv.bias"]
    j, t = _both(lambda s: jconv.convert_beats(s, num_layers=2),
                 lambda s: tconv.convert_beats(s, num_layers=2), ref)
    if dtype is np.float32:
        _same_tree(j, t)
        _same_tree({k: v for k, v in tree.items() if k != "pos_conv"},
                   {k: v for k, v in t["params"].items() if k != "pos_conv"}, ordered=False)
    else:  # JAX rounds each ml_dtypes op of the weight-norm fold (its bf16 sum of
        # squares drifts ~2 %); the port folds in fp32 and rounds once
        jpos, tpos = j["params"].pop("pos_conv"), t["params"].pop("pos_conv")
        _same_tree(j, t)
        g32 = ref["encoder.pos_conv.0.weight_g"].float().numpy()
        v32 = ref["encoder.pos_conv.0.weight_v"].float().numpy()
        fold = g32 * v32 / np.maximum(np.sqrt((v32 ** 2).sum(axis=(0, 1), keepdims=True)), 1e-12)
        want = torch.from_numpy(np.ascontiguousarray(fold.transpose(2, 1, 0))).bfloat16()
        assert torch.equal(tpos["kernel"], want)
        np.testing.assert_allclose(np.asarray(jpos["kernel"], np.float32), want.float().numpy(),
                                   rtol=0, atol=0.05 * float(want.float().abs().max()))


# -- LLMs -----------------------------------------------------------------------

MLA_LLM = dict(vocab_size=97, hidden_size=32, num_layers=2, intermediate_size=64,
               mrope_section=None)
MLA = dict(hidden_size=32, num_heads=2, kv_lora_rank=16, qk_rope_head_dim=8,
           qk_nope_head_dim=8, v_head_dim=8)
GQA = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
           intermediate_size=128, qk_norm=True)


def _mla_cfgs(**over):
    from internvideo_tpu.models.llm import LLMConfig as JLLMConfig
    from internvideo_tpu.nn.mla import MLAConfig as JMLAConfig
    from internvideo_tpu_torch.models.llm import LLMConfig
    from internvideo_tpu_torch.nn.mla import MLAConfig

    mla = {**MLA, **over.pop("mla", {})}
    return (JLLMConfig(**MLA_LLM, **over, mla=JMLAConfig(**mla), attn_impl="xla"),
            LLMConfig(**MLA_LLM, **over, mla=MLAConfig(**mla), attn_impl="kernel"))


def _llm_tree(jcfg, seed):
    from internvideo_tpu.models.llm import MLATransformer
    from internvideo_tpu.models.llm_gqa import GQATransformer

    cls = GQATransformer if hasattr(jcfg, "num_kv_heads") else MLATransformer
    return _fill(_eval_shape(cls(jcfg), jnp.zeros((1, 8), jnp.int32)), seed)


@pytest.mark.parametrize("variant", ["m2la", "q_lora_kv_norm", "tied"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_llm_converter_and_export_match_jax(variant, dtype):
    over = {"m2la": {}, "tied": {"tie_word_embeddings": True},
            "q_lora_kv_norm": {"mla": {"q_lora_rank": 12, "kv_norm": True}}}[variant]
    jcfg, tcfg = _mla_cfgs(**over)
    tree = jax.tree.map(lambda a: a.astype(dtype), _llm_tree(jcfg, 6))
    hf = jconv.export_mla_llm_hf(tree, jcfg)
    got_hf = tconv.export_mla_llm_hf({k: v for k, v in _sd_tree(tree).items()}, tcfg)
    assert list(got_hf) == list(hf)
    for k in hf:
        np.testing.assert_array_equal(_bits(got_hf[k]), _bits(hf[k]), err_msg=k)
    sd = {k: tconv.as_tensor(v) for k, v in hf.items()}
    j, t = _both(lambda s: jconv.convert_hf_mla_llm(s, jcfg),
                 lambda s: tconv.convert_hf_mla_llm(s, tcfg), sd)
    _same_tree(j, t)
    _same_tree(tree, t["params"], ordered=False)  # export then convert is the identity


def _sd_tree(tree):
    """A numpy tree as torch tensors (the port's exports read either)."""
    return jax.tree.map(tconv.as_tensor, tree)


def test_mla_llm_moe_converter_matches_jax():
    """The Qwen3-MoE expert layout: the router and the stacked experts."""
    moe = type("MoE", (), {"num_experts": 3})()
    jcfg, tcfg = _mla_cfgs()
    jcfg, tcfg = (dataclasses.replace(jcfg, moe=moe), dataclasses.replace(tcfg, moe=moe))
    rng = np.random.default_rng(7)
    sd = jconv.export_mla_llm_hf(_llm_tree(_mla_cfgs()[0], 7), _mla_cfgs()[0])
    for i in range(2):
        for n in ("gate_proj", "up_proj", "down_proj"):
            sd.pop(f"model.layers.{i}.mlp.{n}.weight")
        sd[f"model.layers.{i}.mlp.gate.weight"] = rng.standard_normal((3, 32)).astype(np.float32)
        for e in range(3):
            for n, shape in (("gate_proj", (64, 32)), ("up_proj", (64, 32)),
                             ("down_proj", (32, 64))):
                sd[f"model.layers.{i}.mlp.experts.{e}.{n}.weight"] = (
                    rng.standard_normal(shape).astype(np.float32))
    j, t = _both(lambda s: jconv.convert_hf_mla_llm(s, jcfg),
                 lambda s: tconv.convert_hf_mla_llm(s, tcfg),
                 {k: torch.from_numpy(v) for k, v in sd.items()})
    _same_tree(j, t)
    want, got = jconv.export_mla_llm_hf(j, jcfg), tconv.export_mla_llm_hf(t, tcfg)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gqa_llm_converter_and_export_match_jax(dtype):
    from internvideo_tpu.models.llm_gqa import GQAConfig as JGQAConfig
    from internvideo_tpu_torch.models.llm_gqa import GQAConfig

    jcfg, tcfg = JGQAConfig(**GQA, attn_impl="xla"), GQAConfig(**GQA)
    tree = jax.tree.map(lambda a: a.astype(dtype), _llm_tree(jcfg, 8))
    hf = jconv.export_gqa_llm_hf(tree, jcfg)
    got_hf = tconv.export_gqa_llm_hf(_sd_tree(tree), tcfg)
    assert list(got_hf) == list(hf)
    for k in hf:
        np.testing.assert_array_equal(_bits(got_hf[k]), _bits(hf[k]), err_msg=k)
    # the composed-MLLM text prefix is stripped as JAX strips it
    sd = {k.replace("model.", "model.language_model.", 1): tconv.as_tensor(v)
          for k, v in hf.items()}
    j, t = _both(lambda s: jconv.convert_hf_gqa_llm(s, jcfg),
                 lambda s: tconv.convert_hf_gqa_llm(s, tcfg), sd)
    _same_tree(j, t)
    _same_tree(tree, t["params"], ordered=False)


# -- InternVideo3 ---------------------------------------------------------------


def _internvideo3_ref(tree: dict, jcfg) -> dict:
    """A VideoMLLM tree -> the HF layout: the tower and projector under
    `model.visual.` (Conv3d patchify, pos_embed an Embedding), the text
    model through JAX's own export under `model.language_model.`."""
    v = jcfg.vision
    ref = {}
    vis = {k: v_ for k, v_ in _sd(tree).items() if not k.startswith("language_model.")}
    for k, t in vis.items():
        if k == "vision_tower.patch_embed.weight":
            t = t.reshape(t.shape[0], v.temporal_patch_size, v.patch_size, v.patch_size, 3)
            ref["model.visual.patch_embed.proj.weight"] = t.permute(0, 4, 1, 2, 3).contiguous()
            continue
        if k == "vision_tower.patch_embed.bias":
            ref["model.visual.patch_embed.proj.bias"] = t
            continue
        k = (k.replace("vision_tower.", "")
             .replace(".qkv.", ".attn.qkv.").replace(".proj.", ".attn.proj.")
             .replace(".fc1.", ".mlp.linear_fc1.").replace(".fc2.", ".mlp.linear_fc2.")
             .replace("deepstack_merger.", "deepstack_merger_list."))
        ref["model.visual." + (k + ".weight" if k == "pos_embed" else k)] = t
    for k, t in jconv.export_mla_llm_hf(tree["language_model"], jcfg.text).items():
        ref[k.replace("model.", "model.language_model.", 1)] = tconv.as_tensor(t)
    return ref


@pytest.mark.parametrize("dtype", DTYPES)
def test_internvideo3_converter_matches_jax(dtype):
    from tests.torch_mllm_pair import configs, packed_batches

    jcfg, tcfg = configs()
    from internvideo_tpu.models.mllm import VideoMLLM as JVideoMLLM

    batch = next(packed_batches(1))
    shapes = _eval_shape(JVideoMLLM(jcfg), batch["input_ids"], batch["video"],
                         position_ids=batch["position_ids"], segment_ids=batch["segment_ids"])
    tree = jax.tree.map(lambda a: a.astype(dtype), _fill(shapes, 11))
    ref = _internvideo3_ref(tree, jcfg)
    j, t = _both(lambda s: jconv.convert_internvideo3(s, jcfg),
                 lambda s: tconv.convert_internvideo3(s, tcfg), ref)
    _same_tree(j, t)
    _same_tree(tree, t["params"], ordered=False)


# -- dense GQA -> M2LA and the pos-embed surgery ---------------------------------


def test_dense_gqa_to_mla_matches_jax_and_is_exact_at_full_rank():
    from internvideo_tpu.nn.mla import MLAConfig as JMLAConfig
    from internvideo_tpu_torch.nn.mla import MLAConfig, MLAttention
    from internvideo_tpu_torch.nn.rope import rope_cos_sin

    rng = np.random.default_rng(0)
    d, hq, nope, rope, vdim, s = 24, 4, 8, 8, 8, 6
    hd = nope + rope
    rank = tmla.mla_rank_for_exact(MLAConfig(qk_nope_head_dim=nope, v_head_dim=vdim), d, hq)
    assert rank == jmla.mla_rank_for_exact(JMLAConfig(qk_nope_head_dim=nope, v_head_dim=vdim),
                                           d, hq)
    kw = dict(hidden_size=d, num_heads=hq, qk_nope_head_dim=nope, qk_rope_head_dim=rope,
              v_head_dim=vdim, kv_lora_rank=rank)
    tcfg, jcfg = MLAConfig(**kw), JMLAConfig(**kw)
    w = dict(w_q=rng.standard_normal((d, hq, hd)), w_k=rng.standard_normal((d, 1, hd)),
             w_v=rng.standard_normal((d, 1, vdim)), w_o=rng.standard_normal((hq * vdim, d)))
    b = dict(b_q=rng.standard_normal((hq, hd)), b_k=rng.standard_normal((1, hd)),
             b_v=rng.standard_normal((1, vdim)))
    w = {k: (v * 0.2).astype(np.float32) for k, v in w.items()}
    b = {k: (v * 0.1).astype(np.float32) for k, v in b.items()}
    want = jmla.dense_gqa_to_mla(*w.values(), jcfg, **b)
    got = tmla.dense_gqa_to_mla(*(torch.from_numpy(v) for v in w.values()), tcfg,
                                **{k: torch.from_numpy(v) for k, v in b.items()})
    _same_tree(want, got)
    # GQA at a cut rank (padding path) and without biases
    wg = dict(w_q=w["w_q"][:, :4], w_k=np.repeat(w["w_k"], 2, axis=1),
              w_v=np.repeat(w["w_v"], 2, axis=1), w_o=w["w_o"])
    _same_tree(jmla.dense_gqa_to_mla(*wg.values(), jcfg, rank=40),
               tmla.dense_gqa_to_mla(*wg.values(), tcfg, rank=40))

    # exact at full rank: the converted MLAttention == dense MQA attention
    attn = MLAttention(dataclasses.replace(tcfg, q_bias=True, qkv_bias=True), device="cpu",
                       attn_impl="plain").eval()
    attn.load_state_dict(params_from_jax(got), strict=True)
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    cos, sin = rope_cos_sin(torch.arange(s)[None], rope)
    with torch.no_grad():
        out = attn(torch.from_numpy(x), cos.expand(2, s, rope), sin.expand(2, s, rope))
    np.testing.assert_allclose(out.numpy(), _dense_mqa(x, cos, sin, w, b, nope), atol=2e-4,
                               rtol=1e-3)


def _dense_mqa(x, cos, sin, w, b, nope):
    """Dense causal MQA with the MLA conventions (tests/test_mla_convert.py:
    _dense_reference): per-head [nope | rope], half-split rope on the rope
    branch, scale q_head_dim^-0.5."""
    from internvideo_tpu_torch.nn.rope import apply_rope

    q = np.einsum("bsd,dhe->bshe", x, w["w_q"]) + b["b_q"]
    k = np.einsum("bsd,dhe->bshe", x, w["w_k"]) + b["b_k"]
    v = np.einsum("bsd,dhe->bshe", x, w["w_v"]) + b["b_v"]
    rope_q = apply_rope(torch.from_numpy(q[..., nope:]), cos, sin).numpy()
    rope_k = apply_rope(torch.from_numpy(k[..., nope:]), cos, sin).numpy()
    q = np.concatenate([q[..., :nope], rope_q], -1)
    k = np.broadcast_to(np.concatenate([k[..., :nope], rope_k], -1), q.shape)
    bsz, s, hq, hd = q.shape
    v = np.broadcast_to(v, (bsz, s, hq, v.shape[-1]))
    scores = np.einsum("bqhe,bkhe->bhqk", q, k) / np.sqrt(hd)
    scores = np.where(np.tril(np.ones((s, s), bool)), scores, -1e30)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhe->bqhe", p, v).reshape(bsz, s, -1) @ w["w_o"]


@pytest.mark.parametrize("src,dst", [
    ((4, 6, 6), (8, 6, 6)),  # time grows
    ((8, 6, 6), (4, 6, 6)),  # time shrinks (antialiased)
    ((4, 7, 5), (4, 3, 9)),  # height shrinks, width grows
    ((8, 16, 16), (4, 14, 14)),  # every axis shrinks
])
def test_interpolate_pos_embed_matches_jax(src, dst):
    rng = np.random.default_rng(0)
    pe = rng.standard_normal((1 + int(np.prod(src)), 32)).astype(np.float32)
    want = np.asarray(jembeds.interpolate_pos_embed(jnp.asarray(pe), src, dst))
    got = tembeds.interpolate_pos_embed(torch.from_numpy(pe), src, dst)
    assert got.shape == want.shape == (1 + int(np.prod(dst)), 32)
    np.testing.assert_array_equal(got[0].numpy(), pe[0])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    if any(s > d for s, d in zip(src, dst)):  # plain trilinear (no antialias) differs
        vol = torch.from_numpy(pe[1:]).reshape(*src, 32).permute(3, 0, 1, 2)[None]
        plain = torch.nn.functional.interpolate(vol, size=dst, mode="trilinear")
        assert not np.allclose(plain[0].permute(1, 2, 3, 0).reshape(-1, 32).numpy(), want[1:],
                               atol=1e-3)
