"""The BERT text / fusion tower of the PyTorch port vs the JAX package, on
the CPU, at tests/test_videoclip.py's BERT_TINY widths (4 layers, fusion
from layer 2, hidden 32) with cross-attention from a 48-wide vision stream.

One JAX `BertModel` is built once per module and run eagerly; its params go
through `params_from_jax` into the port's `BertModel`. All three modes
are held at max-abs 1e-5 (fp32): padded masks with zeros in some rows (the
einsum path with the additive bias), the unpadded route (the JAX "xla"
attention against the port's plain route and its kernel route, whose CPU
version is the small-S kernels' plain version), cross-attention with and
without `vision_mask`, and the MLM logits.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax.linen import unbox

from internvideo_tpu.models.bert import BertConfig as JaxBertConfig
from internvideo_tpu.models.bert import BertModel as JaxBertModel
from internvideo_tpu_torch.models.bert import BertConfig, BertModel
from internvideo_tpu_torch.models.convert import params_from_jax

FIELDS = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=2,
              intermediate_size=64, fusion_layer=2, dropout=0.0, attn_impl="xla")
B, L, LV, DV = 2, 10, 5, 48
ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 128, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 7:] = 0
    mask[0, 9:] = 0
    vis = rng.standard_normal((B, LV, DV)).astype(np.float32)
    vmask = np.ones((B, LV), np.int32)
    vmask[0, 3:] = 0

    # eager, not jitted: the init traces every op once and the applies reuse
    # those per-op compiles (a jit would compile each mode's whole graph)
    jmodel = JaxBertModel(JaxBertConfig(**FIELDS))
    params = jmodel.init(jax.random.key(0), ids, mask, vision_embeds=vis, mode="multimodal",
                         with_mlm_logits=True)
    params = jax.tree.map(np.asarray, jax.device_get(unbox(params)))

    cfg = BertConfig(**FIELDS)
    model = BertModel(cfg, vision_width=DV, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    model.eval()

    def jax_run(mode, **arrays):
        out = jmodel.apply(params, mode=mode, with_mlm_logits=True, **arrays)
        return [None if x is None else np.asarray(x)
                for x in (out.last_hidden_state, out.pooled, out.mlm_logits)]

    data = dict(ids=ids, mask=mask, vis=vis, vmask=vmask)
    return model, jax_run, data


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _check(outs, refs):
    with torch.no_grad():
        got = [outs.last_hidden_state, outs.pooled, outs.mlm_logits]
    for name, a, r in zip(("last_hidden_state", "pooled", "mlm_logits"), got, refs):
        np.testing.assert_allclose(a.numpy(), r, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
def test_text_mode(pair, padded):
    model, jax_run, d = pair
    mask = d["mask"] if padded else None
    refs = jax_run("text", input_ids=d["ids"],
                   **({"attention_mask": mask} if padded else {}))
    for impl in ("plain", "kernel"):
        _set_impl(model, impl)
        with torch.no_grad():
            out = model(_t(d["ids"]), _t(mask), mode="text", with_mlm_logits=True)
        _check(out, refs)
    _set_impl(model, "xla")


@pytest.mark.parametrize("vision_masked", [False, True], ids=["cross_unmasked", "cross_masked"])
def test_multimodal_mode(pair, vision_masked):
    model, jax_run, d = pair
    vmask = d["vmask"] if vision_masked else None
    refs = jax_run("multimodal", input_ids=d["ids"], attention_mask=d["mask"],
                   vision_embeds=d["vis"], **({"vision_mask": vmask} if vision_masked else {}))
    with torch.no_grad():
        out = model(_t(d["ids"]), _t(d["mask"]), vision_embeds=_t(d["vis"]),
                    vision_mask=_t(vmask), mode="multimodal", with_mlm_logits=True)
    _check(out, refs)


def test_fusion_mode_on_text_embeds(pair):
    model, jax_run, d = pair
    text = jax_run("text", input_ids=d["ids"], attention_mask=d["mask"])[0]
    refs = jax_run("fusion", encoder_embeds=text, attention_mask=d["mask"],
                   vision_embeds=d["vis"])
    with torch.no_grad():
        out = model(encoder_embeds=_t(text), attention_mask=_t(d["mask"]),
                    vision_embeds=_t(d["vis"]), mode="fusion", with_mlm_logits=True)
    _check(out, refs)
    # text mode then fusion mode equals one multimodal pass (videoclip.py:145-150)
    mm = jax_run("multimodal", input_ids=d["ids"], attention_mask=d["mask"],
                 vision_embeds=d["vis"])
    np.testing.assert_allclose(out.last_hidden_state.numpy(), mm[0], atol=ATOL, rtol=0)


def test_padding_and_dropout_contracts(pair):
    """A padded token does not move the kept ones (test_videoclip.py:59-71);
    dropout needs an explicit generator and is off when deterministic."""
    model, _, d = pair
    ids2 = d["ids"].copy()
    ids2[1, 8] = 55
    with torch.no_grad():
        a = model(_t(d["ids"]), _t(d["mask"])).last_hidden_state
        b = model(_t(ids2), _t(d["mask"])).last_hidden_state
    torch.testing.assert_close(a[1, :7], b[1, :7], atol=1e-6, rtol=0)
    drop = BertModel(dataclasses.replace(BertConfig(**FIELDS), dropout=0.1), vision_width=DV,
                     device="cpu", generator=torch.Generator().manual_seed(0))
    drop.load_state_dict(model.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(drop(_t(d["ids"]), _t(d["mask"])).last_hidden_state, a)
        with pytest.raises(ValueError, match="generator"):
            drop(_t(d["ids"]), _t(d["mask"]), deterministic=False)
        gen = torch.Generator().manual_seed(1)
        noisy = drop(_t(d["ids"]), _t(d["mask"]), deterministic=False, generator=gen)
    assert not torch.allclose(noisy.last_hidden_state, a)


def _set_impl(model, impl):
    for m in model.modules():
        if hasattr(m, "attn_impl"):
            m.attn_impl = impl


def test_param_names_cover_the_jax_tree(pair):
    model, _, _ = pair
    names = set(model.state_dict())
    assert "layer.3.crossattention.key.weight" in names
    assert model.layer[3].crossattention.key.weight.shape == (32, DV)
    assert model.layer[1].crossattention is None
    with pytest.raises(ValueError, match="blocks"):
        params_from_jax({"layer_0": {}}, BertConfig(**FIELDS))
