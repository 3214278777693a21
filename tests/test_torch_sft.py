"""The SFT training slice of the PyTorch port vs the JAX package.

Same params (JAX `init` -> `params_from_jax`), same packed rows (numpy from
a seed): the chunked CE and its gradients; the packers and the 3D mRoPE
grids, exactly; one SFT step (loss, grad norm, the params after AdamW) on a
packed row with a video at the configs/sft_tiny.py widths, also with
grad_accum = 2 and the full batch's token count, against the JAX step, with
the bars of test_torch_train.py; the CLI's task `sft` on the CPU.
"""

import dataclasses
import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internvideo_tpu.cli.train import _synthetic_sft_stream as jax_sft_stream
from internvideo_tpu.core.config import load_config as jax_load_config
from internvideo_tpu.data import mllm_tokenize as jtok
from internvideo_tpu.data import packing as jpack
from internvideo_tpu.train.chunked_ce import chunked_cross_entropy as jax_chunked_ce
from internvideo_tpu.train.engines.sft import SFTConfig as JSFTConfig
from internvideo_tpu.train.engines.sft import make_sft_step as jax_make_sft_step
from internvideo_tpu.train.optim import OptimizerConfig as JOptimizerConfig
from internvideo_tpu.train.optim import build_optimizer as jax_build_optimizer
from internvideo_tpu.train.state import TrainState as JTrainState
from internvideo_tpu_torch.cli import train as cli
from internvideo_tpu_torch.core.config import load_config
from internvideo_tpu_torch.core.mesh import MeshConfig
from internvideo_tpu_torch.data import mllm_tokenize as ttok
from internvideo_tpu_torch.data import packing as tpack
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.train.chunked_ce import chunked_cross_entropy
from internvideo_tpu_torch.train.engines.sft import SFTConfig, make_sft_step
from internvideo_tpu_torch.train.optim import OptimizerConfig, build_optimizer
from internvideo_tpu_torch.train.state import TrainState
from torch_mllm_pair import DATA, PACK, mllm_pair, packed_batches, torch_batch

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = os.path.join(ROOT, "configs", "torch", "sft_tiny.py")


# -- chunked CE -------------------------------------------------------------------

@pytest.mark.parametrize("chunk,total", [(8, None), (16, 11.0), (64, None)])
def test_chunked_cross_entropy_matches_jax(chunk, total):
    rng = np.random.default_rng(chunk)
    h = rng.standard_normal((2, 37, 16)).astype(np.float32)
    w = rng.standard_normal((16, 50)).astype(np.float32)
    y = rng.integers(0, 50, size=(2, 37)).astype(np.int32)
    y[rng.random((2, 37)) < 0.3] = -100
    tot = None if total is None else jnp.asarray(total)

    def jloss(h, w):
        return jax_chunked_ce(h, w, jnp.asarray(y), chunk_size=chunk, total_valid=tot)

    want, (gh, gw) = jax.value_and_grad(jloss, argnums=(0, 1))(h, w)
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()  # the port takes (V, D)
    got = chunked_cross_entropy(th, tw, torch.from_numpy(y), chunk_size=chunk,
                                total_valid=None if total is None else torch.tensor(total))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(gw), atol=1e-6, rtol=1e-5)


# -- packing and mRoPE grids ----------------------------------------------------------

def test_packers_match_jax_exactly():
    rng = np.random.default_rng(0)
    lengths = rng.integers(1, 300, size=40).tolist() + [600]
    for budget in (256, 512):
        want, got = jpack.soft_pack(lengths, budget), tpack.soft_pack(lengths, budget)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        want, got = jpack.hard_pack(lengths, budget), tpack.hard_pack(lengths, budget)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    streams = [rng.integers(1, 99, size=n) for n in lengths[:9]]
    for a, b in zip(tpack.hard_pack_streams(streams, 128), jpack.hard_pack_streams(streams, 128)):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert tpack.attention_efficiency(lengths) == jpack.attention_efficiency(lengths)


def test_rope_index_and_pack_mllm_items_match_jax_exactly():
    rng = np.random.default_rng(1)
    items = ttok.synthetic_sft_items(rng, PACK, DATA)
    items += ttok.synthetic_sft_items(rng, PACK, DATA)
    for it in items:
        grids = np.tile([[1, 4, 4]], (2, 1)) if it.media else None
        kw = dict(video_token_id=DATA.video_token_id,
                  vision_start_token_id=DATA.vision_start_token_id)
        want = jtok.get_rope_index_3d(it.input_ids, grids, **kw)
        np.testing.assert_array_equal(ttok.get_rope_index_3d(it.input_ids, grids, **kw), want)
        np.testing.assert_array_equal(it.position_ids, want)
    for one_video in (False, True):
        want = jtok.pack_mllm_items(items, PACK, pad_token_id=3, one_video_per_pack=one_video)
        got = ttok.pack_mllm_items(items, PACK, pad_token_id=3, one_video_per_pack=one_video)
        assert got.keys() == want.keys()
        for key in got:
            if isinstance(got[key], np.ndarray):
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            else:
                assert got[key] == want[key], key


# -- the SFT step against JAX ------------------------------------------------------------

OPT = dict(lr=1e-4, total_steps=4)


@pytest.fixture(scope="module")
def pair():
    return mllm_pair()


def _jax_micro(batch, ga):
    """The JAX Trainer's grad_accum reshape (trainer.py:203-229)."""
    if ga == 1:
        return batch
    out = {k: v.reshape((ga, -1) + v.shape[1:]) for k, v in batch.items() if k != "position_ids"}
    pos = batch["position_ids"]
    out["position_ids"] = np.moveaxis(
        np.moveaxis(pos, 0, 1).reshape((ga, -1) + pos.shape[:1] + pos.shape[2:]), 2, 1)
    return out


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_sft_step_matches_jax(pair, grad_accum):
    jcfg, jm, params, tcfg, tm = pair
    tx, _ = jax_build_optimizer(JOptimizerConfig(**OPT), params)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                         opt_state=tx.init(jparams), tx=tx, apply_fn=jm.apply)
    jstep = jax.jit(jax_make_sft_step(jm, JSFTConfig(ce_chunk_size=16), grad_accum=grad_accum))

    tm.load_state_dict(params_from_jax(params, tcfg), strict=True)
    opt, _ = build_optimizer(OptimizerConfig(**OPT), tm)
    state = TrainState.create(tm, opt, seed=0)
    step = make_sft_step(SFTConfig(ce_chunk_size=16), grad_accum=grad_accum)
    stream = packed_batches(2, seed=2)
    for i in range(2):
        batch = _jax_micro(next(stream), grad_accum)
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch), jax.random.key(0))
        met = step(state, torch_batch(batch))
        for key in ("loss", "grad_norm", "tokens"):
            np.testing.assert_allclose(met[key].item(), float(jmet[key]), rtol=1e-4, atol=0,
                                       err_msg=f"step {i} {key}")
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg)
    start = params_from_jax(params, tcfg)
    still = set()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
        if torch.equal(p.detach(), start[name]):
            still.add(name)
    # every parameter trained, the tower's included, but the last deepstack
    # merger's undecayed ones: its tap is added after the last LLM layer, at
    # the visual positions only, whose labels are -100 (in JAX as here)
    assert still == {f"deepstack_merger.1.{n}" for n in (
        "norm.weight", "norm.bias", "linear_fc1.bias", "linear_fc2.bias")}


def test_grad_accum_uses_the_full_batch_token_count(pair):
    """With grad_accum = 2 the loss is the batch's token mean, whatever the
    split of valid labels between the micro-batches."""
    *_, tcfg, tm = pair
    batch = next(packed_batches(2, seed=3))
    batch["labels"][0, 10:] = -100  # very unequal counts
    tb = torch_batch(batch)
    with torch.no_grad():
        out = tm(tb["input_ids"], tb["video"], position_ids=tb["position_ids"],
                 segment_ids=tb["segment_ids"], with_logits=False)
        want = chunked_cross_entropy(out.hidden, tm.language_model.lm_head.weight, tb["labels"])
    losses = []
    for ga in (1, 2):
        opt, _ = build_optimizer(OptimizerConfig(lr=0.0, total_steps=4), tm)
        state = TrainState.create(tm, opt)
        met = make_sft_step(SFTConfig(ce_chunk_size=16), grad_accum=ga)(
            state, torch_batch(_jax_micro(batch, ga)))
        losses.append(met["loss"].item())
    np.testing.assert_allclose(losses, [want.item()] * 2, rtol=1e-5)


# -- the CLI ------------------------------------------------------------------------------

def test_cli_sft_on_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(["--config", TINY, "--device", "cpu"]) == 0
    steps = [ln for ln in buf.getvalue().splitlines() if ln.startswith("step:")]
    assert len(steps) == 2
    for line in steps:
        fields = dict(f.split(": ") for f in line.split("  "))
        assert np.isfinite(float(fields["loss"])) and np.isfinite(float(fields["grad_norm"]))


def test_sft_config_stream_and_refusals_mirror_jax():
    from internvideo_tpu.core.config import config_to_dict as jax_to_dict
    from internvideo_tpu_torch.core.config import config_to_dict

    jrun = jax_load_config(os.path.join(ROOT, "configs", "sft_tiny.py"))
    trun = load_config(TINY)
    for field in ("task", "trainer", "model", "data", "engine"):
        assert config_to_dict(getattr(trun, field)) == jax_to_dict(getattr(jrun, field)), field
    # the synthetic stream, draw for draw
    _, shapes = cli.build_sft(trun, torch.device("cpu"))
    example = {k: np.zeros(s, np.float32 if k == "video" else np.int32)
               for k, s in shapes.items()}
    for a, b in zip((next(s) for s in [cli._synthetic_sft_stream(shapes)] * 2),
                    (next(s) for s in [jax_sft_stream(example)] * 2)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # data.jsonl is ported: the batch shapes follow the tokenize config's grid
    jrun = load_config(os.path.join(ROOT, "configs", "torch", "sft_jsonl_tiny.py"))
    _, shapes = cli.build_sft(jrun, torch.device("cpu"))
    first = next(cli._mllm_jsonl_stream(jrun))
    assert shapes == {k: v.shape for k, v in first.items()}
    with pytest.raises(NotImplementedError, match="item 8"):
        make_sft_step(SFTConfig(), mesh=MeshConfig(fsdp=1, seq=4))
