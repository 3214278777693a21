"""The InternVL / Intern-S1 compose of the PyTorch port vs the JAX package.

Two tiny composes of two layers a tower, each built once (a module-scoped
fixture): an Intern-S1-mini shape (InternViT with LayerNorm blocks, no
QK-norm; dense M2LA text) and an Intern-S1 shape (RMSNorm + whole-dim
QK-RMSNorm; MoE text of the qwen3_moe_tiny class), both on one 32 x 32
image at patch 8 (16 patches -> 4 tokens after the 2 x 2 pixel shuffle).
The weights are
the port's seeded init, carried to JAX by `params_to_jax`; the tree must
equal JAX's `init` tree leaf for leaf (shapes and dtypes, the tower's
unused attention pool included), and `params_from_jax` loads it back with
strict=True. Inputs come from a numpy seed; JAX runs its XLA attention
route (jitted) and the port its plain route, in fp32. Held:
`pixel_shuffle` exactly; the logits within 2e-5; one SFT step
(`make_sft_step` + the port's AdamW against JAX's `make_sft_step` + optax)
on the MoE compose at one layer a tower, at test_torch_sft.py's bars
(loss, grad norm and tokens rtol 1e-4, every parameter after the step atol
1e-5); the presets field for field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from internvideo_tpu.models import presets as jpresets
from internvideo_tpu.models.internvideo2 import InternVideo2Config as JInternVideo2Config
from internvideo_tpu.models.internvl import InternVLChat as JInternVLChat
from internvideo_tpu.models.internvl import InternVLConfig as JInternVLConfig
from internvideo_tpu.models.internvl import pixel_shuffle as jax_pixel_shuffle
from internvideo_tpu.models.llm import LLMConfig as JLLMConfig
from internvideo_tpu.nn.mla import MLAConfig as JMLAConfig
from internvideo_tpu.nn.moe import MoEConfig as JMoEConfig
from internvideo_tpu.train.engines.sft import SFTConfig as JSFTConfig
from internvideo_tpu.train.engines.sft import make_sft_step as jax_make_sft_step
from internvideo_tpu.train.optim import OptimizerConfig as JOptimizerConfig
from internvideo_tpu.train.optim import build_optimizer as jax_build_optimizer
from internvideo_tpu.train.state import TrainState as JTrainState
from internvideo_tpu_torch.models import presets
from internvideo_tpu_torch.models.convert import params_from_jax, params_to_jax
from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config
from internvideo_tpu_torch.models.internvl import InternVLChat, InternVLConfig, pixel_shuffle
from internvideo_tpu_torch.models.llm import LLMConfig
from internvideo_tpu_torch.nn.mla import MLAConfig
from internvideo_tpu_torch.nn.moe import MoEConfig
from internvideo_tpu_torch.train.engines.sft import SFTConfig, make_sft_step
from internvideo_tpu_torch.train.optim import OptimizerConfig, build_optimizer
from internvideo_tpu_torch.train.state import TrainState

IMAGE_ID = 60
N_TOK = 4  # (32 / 8)^2 patches, 2 x 2 pixel shuffle
L = 24
VISION = dict(embed_dim=32, num_heads=2, mlp_ratio=2.0, patch_size=8, img_size=32,
              num_frames=1, tubelet_size=1, num_classes=0, init_values=0.5, clip_embed_dim=16,
              attn_pool_num_heads=2)
FLAVORS = {"mini": dict(qk_normalization=False, norm_type="layernorm"),
           "s1": dict(qk_normalization=True, norm_type="rmsnorm")}
TEXT = dict(vocab_size=64, hidden_size=48, intermediate_size=96, mrope_section=None)
MLA = dict(hidden_size=48, num_heads=2, kv_lora_rank=16, qk_rope_head_dim=8,
           qk_nope_head_dim=8, v_head_dim=8)
MOE = dict(num_experts=4, top_k=2, intermediate_size=24, dispatch="dropless")
OPT = dict(lr=1e-4, total_steps=4)


def configs(flavor: str, depth: int = 2):
    """(JAX config, port config): the mini flavor with dense text, s1 with
    MoE; `depth` layers in the tower and in the text model."""
    moe = flavor == "s1"
    vision = {**VISION, **FLAVORS[flavor], "depth": depth}
    text = {**TEXT, "num_layers": depth}
    jcfg = JInternVLConfig(
        vision=JInternVideo2Config(**vision, attn_impl="xla"),
        text=JLLMConfig(**text, mla=JMLAConfig(**MLA), attn_impl="xla",
                        moe=JMoEConfig(**MOE) if moe else None),
        image_token_id=IMAGE_ID)
    tcfg = InternVLConfig(
        vision=InternVideo2Config(**vision, attn_impl="plain"),
        text=LLMConfig(**text, mla=MLAConfig(**MLA), attn_impl="plain",
                       moe=MoEConfig(**MOE) if moe else None),
        image_token_id=IMAGE_ID)
    return jcfg, tcfg


def batch(b: int, seed: int) -> dict:
    """Packed rows of L tokens: two segments a row, the first holding the
    image's N_TOK placeholders, a tail of pads (-1); 1-D positions
    restarting at each segment; labels -100 on the placeholders and pads."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, IMAGE_ID, size=(b, L)).astype(np.int32)
    seg = np.full((b, L), -1, np.int32)
    pos = np.zeros((b, L), np.int32)
    for r in range(b):
        cut, end = 10 + r, L - 2
        seg[r, :cut], seg[r, cut:end] = 0, 1
        pos[r, :cut], pos[r, cut:end] = np.arange(cut), np.arange(end - cut)
        ids[r, 2 + r:2 + r + N_TOK] = IMAGE_ID
    labels = np.where((ids == IMAGE_ID) | (seg < 0), -100, np.roll(ids, -1, axis=1))
    return {"input_ids": ids, "segment_ids": seg, "position_ids": pos,
            "labels": labels.astype(np.int32),
            "video": rng.standard_normal((b, 32, 32, 3)).astype(np.float32)}


_PAIRS: dict = {}


def _pair(flavor: str, depth: int = 2):
    """(JAX config, JAX module, params, port config, port module), built once
    a flavor and depth: the port's seeded init with the lm_head at std ~0.5
    (so that the loss and its gradients move well above the tolerances, as
    test_torch_sft.py's pair), as JAX's tree."""
    if (flavor, depth) not in _PAIRS:
        jcfg, tcfg = configs(flavor, depth)
        jm = JInternVLChat(jcfg)
        tm = InternVLChat(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            tm.language_model.lm_head.weight.mul_(25)
        params = jax.tree.map(lambda x: x.detach().numpy().copy(),  # not the module's memory
                              params_to_jax(tm.state_dict(), tm)["params"])
        b = batch(1, 0)
        shapes = fnn.unbox(jax.eval_shape(jm.init, jax.random.key(0), b["input_ids"],
                                          b["video"]))["params"]
        spec = lambda t: jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), t)  # noqa: E731
        assert spec(params) == spec(shapes)
        tm.load_state_dict(params_from_jax(params, tcfg), strict=True)
        _PAIRS[flavor, depth] = (jcfg, jm, params, tcfg, tm)
    return _PAIRS[flavor, depth]


@pytest.fixture(scope="module", params=["mini", "s1"])
def pair(request):
    return _pair(request.param)


def _torch(b: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def test_pixel_shuffle_matches_jax_exactly():
    x = np.random.default_rng(0).standard_normal((2, 4, 6, 5)).astype(np.float32)
    want = np.asarray(jax_pixel_shuffle(jnp.asarray(x), 0.5))
    got = pixel_shuffle(torch.from_numpy(x), 0.5).numpy()
    assert got.shape == (2, 2, 3, 20)
    np.testing.assert_array_equal(got, want)
    # channel order (row in block, column in block, channel)
    np.testing.assert_array_equal(got[0, 1, 2, 5:10], x[0, 2, 5])


def test_logits_match_jax(pair):
    jcfg, jm, params, tcfg, tm = pair
    b = batch(2, 1)

    @jax.jit
    def run(p, ids, video, pos, seg):
        out = jm.apply({"params": p}, ids, video, position_ids=pos, segment_ids=seg)
        vis = jm.apply({"params": p}, video, method=JInternVLChat.encode_images)
        return out.logits, out.hidden, vis

    want = run(params, b["input_ids"], b["video"], b["position_ids"], b["segment_ids"])
    tb = _torch(b)
    with torch.no_grad():
        got = tm(tb["input_ids"], tb["video"], position_ids=tb["position_ids"],
                 segment_ids=tb["segment_ids"])
        vis = tm.encode_images(tb["video"])
    assert tuple(got.logits.shape) == (2, L, TEXT["vocab_size"])
    for name, g, w in (("logits", got.logits, want[0]), ("hidden", got.hidden, want[1]),
                       ("images", vis, want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0, err_msg=name)
    if not tcfg.text.moe:  # without images the prompt is text only, as in JAX
        with torch.no_grad():
            text_only = tm(tb["input_ids"], None, position_ids=tb["position_ids"],
                           segment_ids=tb["segment_ids"])
        want = jax.jit(lambda p, ids, pos, seg: jm.apply(
            {"params": p}, ids, None, position_ids=pos, segment_ids=seg).logits)(
            params, b["input_ids"], b["position_ids"], b["segment_ids"])
        np.testing.assert_allclose(text_only.logits.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_sft_step_matches_jax():
    """One packed SFT step on the MoE compose at one layer a tower (JAX's
    jitted step compiles in half the time of two): the port's make_sft_step
    and AdamW against JAX's make_sft_step + optax, on the same weights and
    rows."""
    jcfg, jm, params, tcfg, tm = _pair("s1", depth=1)
    tx, _ = jax_build_optimizer(JOptimizerConfig(**OPT), params)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                         opt_state=tx.init(jparams), tx=tx, apply_fn=jm.apply)
    jstep = jax.jit(jax_make_sft_step(jm, JSFTConfig(ce_chunk_size=16)))
    opt, _ = build_optimizer(OptimizerConfig(**OPT), tm)
    state = TrainState.create(tm, opt, seed=0)
    step = make_sft_step(SFTConfig(ce_chunk_size=16))
    b = batch(2, 2)
    jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, b), jax.random.key(0))
    met = step(state, _torch(b))
    for key in ("loss", "grad_norm", "tokens"):
        np.testing.assert_allclose(met[key].item(), float(jmet[key]), rtol=1e-4, atol=0,
                                   err_msg=key)
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg)
    start = params_from_jax(params, tcfg)
    moved = set()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
        if not torch.equal(p.detach(), start[name]):
            moved.add(name)
    # the tower, the projector, the router and the experts all trained; the
    # unused attention pool moved too (AdamW's decay, as optax's)
    for name in ("vision_tower.blocks.0.attn.qkv.weight", "vision_tower.clip_projector."
                 "cross_attn.q.weight", "mlp1_fc1.weight", "language_model.layers.0.mlp."
                 "router.weight", "language_model.layers.0.mlp.w_up"):
        assert name in moved, name


def test_presets_match_jax():
    for name in ("intern_s1", "intern_s1_mini"):
        assert dataclasses.asdict(getattr(presets, name)()) == \
            dataclasses.asdict(getattr(jpresets, name)()), name
    s1 = presets.intern_s1()
    # the kernel shapes the slice needs: K1 / K4a at 128, S = 1025; K5 at (128, 64)
    assert s1.vision.embed_dim // s1.vision.num_heads == 128
    assert s1.vision.num_patches + 1 == 1025
    assert (s1.text.mla.q_head_dim, s1.text.mla.v_head_dim) == (128, 64)
    mini = presets.intern_s1_mini()
    assert mini.vision.embed_dim // mini.vision.num_heads == 64
    assert (mini.text.mla.q_head_dim, mini.text.mla.v_head_dim) == (256, 128)
