"""`params_to_jax` of the PyTorch port (models/convert.py) inverts
`params_from_jax` for every model family: at tiny widths, a seeded port
model's state dict gives a tree with the JAX init's paths and shapes
(`jax.eval_shape`), `params_from_jax` of that tree gives back the state
dict bit for bit, and `params_to_jax` of that gives the same tree again.
"""

import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn

from internvideo_tpu_torch.models.convert import params_from_jax, params_to_jax
from tests.test_torch_convert import (ENC, GQA, _eval_shape, _mla_cfgs, _np, _paths,
                                      _pretrain_run, _same_tree, _stage2_configs)


def _family(name):
    """(port model, JAX init shapes) of one model family at tiny widths."""
    gen = torch.Generator().manual_seed(0)
    if name in ("internvideo2", "internvideo2_int8"):
        from internvideo_tpu.models.internvideo2 import InternVideo2 as J
        from internvideo_tpu.models.internvideo2 import make_config as jmake
        from internvideo_tpu_torch.models.internvideo2 import InternVideo2, make_config

        q = {"quant": "int8"} if name.endswith("int8") else {}
        return (InternVideo2(make_config("1B", **ENC, **q), device="cpu", generator=gen),
                _eval_shape(J(jmake("1B", **ENC, **q, attn_impl="xla")),
                            jnp.zeros((1, 4, 28, 28, 3))))
    if name in ("pretrain", "clip_teacher", "mae_teacher"):
        from internvideo_tpu.models.pretrain import PretrainInternVideo2 as JP
        from internvideo_tpu.models.teachers import CLIPTeacher as JC
        from internvideo_tpu.models.teachers import MAETeacher as JM
        from internvideo_tpu_torch.models.pretrain import PretrainInternVideo2
        from internvideo_tpu_torch.models.teachers import CLIPTeacher, MAETeacher

        jrun, run = _pretrain_run("jax"), _pretrain_run("torch")
        enc = jrun.model.encoder
        t_full = enc.num_frames * jrun.td_ratio
        sv = jnp.zeros((1, enc.num_frames, enc.img_size, enc.img_size, 3))
        if name == "pretrain":
            keep = jnp.zeros((1, enc.num_patches // 2), jnp.int32)
            return (PretrainInternVideo2(run.model, device="cpu", generator=gen),
                    _eval_shape(JP(jrun.model), sv, keep))
        if name == "clip_teacher":
            return (CLIPTeacher(run.teacher, device="cpu", generator=gen),
                    _eval_shape(JC(jrun.teacher), sv))
        video = jnp.zeros((1, t_full, enc.img_size, enc.img_size, 3))
        return (MAETeacher(run.mae_teacher, num_frames=t_full, device="cpu", generator=gen),
                _eval_shape(JM(jrun.mae_teacher), video))
    if name in ("mla_llm", "mla_llm_int8_wo"):
        from internvideo_tpu.models.llm import MLATransformer as J
        from internvideo_tpu_torch.models.llm import MLATransformer

        q = {"quant": "int8_wo"} if name.endswith("int8_wo") else {}
        jc, tc = _mla_cfgs(**q)
        return (MLATransformer(tc, device="cpu", generator=gen),
                _eval_shape(J(jc), jnp.zeros((1, 8), jnp.int32)))
    if name == "gqa_llm":
        from internvideo_tpu.models.llm_gqa import GQAConfig as JGQAConfig
        from internvideo_tpu.models.llm_gqa import GQATransformer as J
        from internvideo_tpu_torch.models.llm_gqa import GQAConfig, GQATransformer

        return (GQATransformer(GQAConfig(**GQA), device="cpu", generator=gen),
                _eval_shape(J(JGQAConfig(**GQA)), jnp.zeros((1, 8), jnp.int32)))
    if name == "videomllm":
        from internvideo_tpu.models.mllm import VideoMLLM as J
        from internvideo_tpu_torch.models.mllm import VideoMLLM
        from tests.torch_mllm_pair import configs, packed_batches

        jcfg, tcfg = configs()
        batch = next(packed_batches(1))
        return (VideoMLLM(tcfg, device="cpu", generator=gen),
                _eval_shape(J(jcfg), batch["input_ids"], batch["video"],
                            position_ids=batch["position_ids"],
                            segment_ids=batch["segment_ids"]))
    if name == "videoclip":
        from internvideo_tpu.models.videoclip import VideoCLIP as J
        from internvideo_tpu_torch.models.videoclip import VideoCLIP

        ids = jnp.zeros((1, 8), jnp.int32)
        return (VideoCLIP(_stage2_configs("torch"), device="cpu", generator=gen),
                _eval_shape(J(_stage2_configs("jax")), jnp.zeros((1, 2, 16, 16, 3)), ids,
                            jnp.ones_like(ids), init_all_branches=True))
    if name in ("videoclip_av_simple", "videoclip_av_beats"):
        from tests.test_torch_audio import _av_configs
        from internvideo_tpu.models.videoclip_av import VideoCLIPAV as J
        from internvideo_tpu_torch.models.videoclip_av import VideoCLIPAV

        tower = name.rsplit("_", 1)[1]
        jcfg, tcfg = _av_configs(tower)
        ids = jnp.zeros((1, 8), jnp.int32)
        audio = jnp.zeros((1, 64 if tower == "simple" else 32, 32))
        return (VideoCLIPAV(tcfg, device="cpu", generator=gen),
                _eval_shape(J(jcfg), ids, jnp.ones_like(ids), jnp.zeros((1, 2, 28, 28, 3)),
                            audio, media_type="audio_video", init_all_branches=True))
    if name == "videochat":
        from test_chat_demo import CFG as JCFG
        from tests.test_torch_chat import CFG
        from internvideo_tpu.models.chat import VideoChat as J
        from internvideo_tpu_torch.models.chat import VideoChat

        return (VideoChat(CFG, device="cpu", generator=gen),
                _eval_shape(J(JCFG), jnp.zeros((1, 3), jnp.int32), jnp.zeros((1, 2, 28, 28, 3))))
    if name == "stal_head":
        from internvideo_tpu.models import stal as jstal
        from internvideo_tpu_torch.models import stal as tstal
        from tests.test_torch_stal import KW, _synth

        feats, boxes, _, mask = _synth()
        return (tstal.ROIActionHead(tstal.STALConfig(**KW), device="cpu", generator=gen),
                _eval_shape(jstal.ROIActionHead(jstal.STALConfig(**KW)), jnp.asarray(feats),
                            jnp.asarray(boxes), jnp.asarray(mask)))
    raise KeyError(name)


FAMILIES = ["internvideo2", "internvideo2_int8", "pretrain", "clip_teacher", "mae_teacher",
            "mla_llm", "mla_llm_int8_wo", "gqa_llm", "videomllm", "videoclip",
            "videoclip_av_simple", "videoclip_av_beats", "videochat", "stal_head"]


@pytest.mark.parametrize("name", FAMILIES)
def test_params_to_jax_inverts_params_from_jax(name):
    model, shapes = _family(name)
    sd = model.state_dict()
    tree = params_to_jax(sd, model)
    want = {k: tuple(v.shape) for k, v in _paths(fnn.unbox(shapes)["params"]).items()}
    got = {k: tuple(v.shape) for k, v in _paths(tree["params"]).items()}
    assert got == want, sorted(set(got.items()) ^ set(want.items()))[:6]
    back = params_from_jax(tree)
    assert list(back) == list(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k]), k
    again = params_to_jax(back, model)
    _same_tree({k: _np(v) for k, v in _paths(tree).items()}, _paths(again))
