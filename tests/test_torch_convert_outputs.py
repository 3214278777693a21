"""The PyTorch port's models on trees from its reference converters vs
the JAX package's models on theirs (models/convert.py).

At tiny widths in fp32, a seeded synthetic reference state dict goes
through the JAX converter into JAX's `model.apply` and through the port's
converter and `params_from_jax` into the port's model; the outputs agree
within the slice tests' tolerances. The encoder, stage 2, the MLA and GQA
LLMs and InternVideo3. The converters' trees themselves are held bit for
bit in tests/test_torch_convert.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from internvideo_tpu.models import convert as jconv
from internvideo_tpu_torch.models import convert as tconv
from internvideo_tpu_torch.models.convert import params_from_jax
from tests.stage2_synth import make_stage2_state_dict
from tests.test_torch_convert import (ENC, GQA, STAGE2, _encoder_ref, _encoder_tree,
                                      _eval_shape, _fill, _internvideo3_ref, _llm_tree,
                                      _mla_cfgs, _np, _sd, _stage2_configs)


def test_encoder_output_matches_jax():
    from internvideo_tpu.models.internvideo2 import InternVideo2 as JInternVideo2
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2, make_config

    cfg, tree = _encoder_tree()
    ref = _encoder_ref(_sd(tree), cfg)
    jtree = jconv.convert_internvideo2_encoder({k: _np(v) for k, v in ref.items()}, depth=2)
    ttree = tconv.convert_internvideo2_encoder(ref, depth=2)
    video = np.random.default_rng(1).standard_normal((2, 4, 28, 28, 3)).astype(np.float32)
    want = jax.jit(JInternVideo2(cfg).apply)(jtree, video)
    tcfg = make_config("1B", **ENC, attn_impl="plain")
    model = InternVideo2(tcfg, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    model.load_state_dict(params_from_jax(ttree, tcfg), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(video))
    for name in ("pooled", "logits", "tokens"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_stage2_output_matches_jax():
    from internvideo_tpu.models.videoclip import VideoCLIP as JVideoCLIP
    from internvideo_tpu_torch.models.videoclip import VideoCLIP

    sd = make_stage2_state_dict(np.random.default_rng(1), **STAGE2)
    kw = dict(depth=2, clip_return_layers=2, text_layers=2)
    jtree = jconv.convert_internvideo2_stage2(sd, **kw)
    ttree = tconv.convert_internvideo2_stage2({k: torch.from_numpy(v) for k, v in sd.items()},
                                              **kw)
    jm, tcfg = JVideoCLIP(_stage2_configs("jax")), _stage2_configs("torch")
    model = VideoCLIP(tcfg, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    model.load_state_dict(params_from_jax(ttree, tcfg), strict=True)
    rng = np.random.default_rng(2)
    video = rng.standard_normal((2, 2, 16, 16, 3)).astype(np.float32)
    ids = rng.integers(1, 50, (2, 8)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, -3:] = 0
    jv = jax.jit(lambda p, v: jm.apply(p, v, method="encode_vision"))(jtree, video)
    jt = jax.jit(lambda p, i, m: jm.apply(p, i, m, method="encode_text"))(jtree, ids, mask)
    with torch.no_grad():
        tv = model.encode_vision(torch.from_numpy(video))
        tt = model.encode_text(torch.from_numpy(ids), torch.from_numpy(mask))
    for name, a, b in (("vision tokens", tv[0], jv[0]), ("vision pooled", tv[1], jv[1]),
                       ("text tokens", tt[0], jt[0]), ("text pooled", tt[1], jt[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_llm_outputs_match_jax():
    """MLA and GQA: JAX on its converted tree, the port on params_from_jax
    of its own; logits at 2e-5 / 1e-4 (the serving tests' bars)."""
    from internvideo_tpu.models.llm import MLATransformer as JMLATransformer
    from internvideo_tpu.models.llm_gqa import GQAConfig as JGQAConfig
    from internvideo_tpu.models.llm_gqa import GQATransformer as JGQATransformer
    from internvideo_tpu_torch.models.llm import MLATransformer
    from internvideo_tpu_torch.models.llm_gqa import GQAConfig, GQATransformer

    ids = np.random.default_rng(9).integers(1, 90, (2, 7)).astype(np.int32)
    jcfg, tcfg = _mla_cfgs()
    cases = [(jcfg, tcfg, JMLATransformer, MLATransformer, jconv.export_mla_llm_hf,
              jconv.convert_hf_mla_llm, tconv.convert_hf_mla_llm),
             (JGQAConfig(**GQA, attn_impl="xla"), GQAConfig(**GQA, attn_impl="kernel"),
              JGQATransformer, GQATransformer, jconv.export_gqa_llm_hf,
              jconv.convert_hf_gqa_llm, tconv.convert_hf_gqa_llm)]
    for jc, tc, jcls, tcls, export, jfn, tfn in cases:
        hf = export(_llm_tree(jc, 10), jc)
        jtree = jfn(hf, jc)
        model = tcls(tc, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
        model.load_state_dict(params_from_jax(tfn(hf, tc), tc), strict=True)
        want = jax.jit(jcls(jc).apply)(jtree, jnp.asarray(ids)).logits
        with torch.no_grad():
            got = model(torch.from_numpy(ids).long()).logits
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4,
                                   err_msg=type(model).__name__)


def test_internvideo3_output_matches_jax():
    """The model on its converted tree, as JAX on its own."""
    from internvideo_tpu.models.mllm import VideoMLLM as JVideoMLLM
    from internvideo_tpu_torch.models.mllm import VideoMLLM
    from tests.torch_mllm_pair import configs, packed_batches, torch_batch

    jcfg, tcfg = configs()
    batch = next(packed_batches(1))
    shapes = _eval_shape(JVideoMLLM(jcfg), batch["input_ids"], batch["video"],
                         position_ids=batch["position_ids"], segment_ids=batch["segment_ids"])
    ref = _internvideo3_ref(_fill(shapes, 11), jcfg)
    j = jconv.convert_internvideo3({k: _np(v) for k, v in ref.items()}, jcfg)
    t = tconv.convert_internvideo3(ref, tcfg)

    tm = VideoMLLM(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(params_from_jax(t, tcfg), strict=True)
    batch = next(packed_batches(2, seed=1))
    want = jax.jit(JVideoMLLM(jcfg).apply)(j, batch["input_ids"], batch["video"],
                                           position_ids=batch["position_ids"],
                                           segment_ids=batch["segment_ids"])
    tb = torch_batch(batch)
    with torch.no_grad():
        out = tm(tb["input_ids"], tb["video"], position_ids=tb["position_ids"],
                 segment_ids=tb["segment_ids"])
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(want.logits),
                               atol=2e-4, rtol=2e-4)
