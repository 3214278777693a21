"""The trainer's HF export, MFU and tensorboard sink, and the port's
profiling and prober utilities.

  * `hf_export_every` with `hf_export_fn` writes an HF checkpoint every N
    steps whose weights reload bit for bit (through `convert_hf_mla_llm`
    for an MLA LLM); without an export function it writes nothing, as in
    JAX.
  * `flops_per_batch` logs tflops_per_sec, and MFU against the peak of one
    device times the devices in use; the peak table holds only the card's
    own figure (no TPU entry), and a device it lacks logs no `mfu`.
    utils/flops.py equals JAX's.
  * the tensorboard sink hands every numeric field to SummaryWriter;
    without the `tensorboard` package it raises an ImportError that names
    it.
  * profiling: `trace` writes a trace with the `annotate` span, `timed`
    and `StepProfiler`.

The prober is held in tests/test_torch_prober.py.
"""

import glob
import os
from pathlib import Path
import sys

import numpy as np
import pytest
import torch

from internvideo_tpu.utils import flops as jflops
from internvideo_tpu.utils import metrics as jmetrics
from internvideo_tpu_torch.core import checkpoint as ck
from internvideo_tpu_torch.models.convert import (
    convert_hf_mla_llm,
    export_mla_llm_hf,
    params_from_jax,
)
from internvideo_tpu_torch.train.trainer import Trainer, TrainerConfig, hf_export_fn
from internvideo_tpu_torch.utils import flops, metrics, profiling


def _mla_trainer(tmp_path, **cfg_kw):
    """A tiny MLA LLM trained on next-token CE with SGD."""
    from internvideo_tpu_torch.models import presets
    from internvideo_tpu_torch.models.llm import MLATransformer
    from internvideo_tpu_torch.train.optim import OptimizerConfig

    cfg = presets.qwen3_mla_tiny()
    model = MLATransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(0))

    def build(grad_accum=1):
        def step(state, batch):
            logits = state.model(batch["ids"]).logits
            loss = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                                                     batch["ids"][:, 1:].reshape(-1))
            state.optimizer.zero_grad()
            loss.backward()
            state.optimizer.step()
            state.step += 1
            return {"loss": loss.detach(), "tokens": torch.tensor(float(batch["ids"].numel())),
                    "finite": torch.isfinite(loss).float()}
        return step

    tcfg = TrainerConfig(total_steps=4, log_every=2, optimizer=OptimizerConfig(
        lr=1e-2, warmup_steps=0, total_steps=4), **cfg_kw)
    trainer = Trainer(tcfg, model, build)
    trainer.metrics.print_fn = lambda msg: None
    rng = np.random.default_rng(0)
    data = ({"ids": rng.integers(1, 97, (2, 8)).astype(np.int64)} for _ in range(8))
    return trainer, cfg, data


def test_trainer_hf_export_every(tmp_path):
    out = str(tmp_path / "hf")
    trainer, cfg, data = _mla_trainer(tmp_path, hf_export_every=2)
    trainer.export_fn = hf_export_fn(out, lambda tree: export_mla_llm_hf(tree, cfg),
                                     shard_size_bytes=40_000)
    seen = []
    export = trainer.export_fn
    trainer.export_fn = lambda state, step: (seen.append(
        {k: v.clone() for k, v in state.model.state_dict().items()}), export(state, step))
    trainer.fit(data)
    assert sorted(os.listdir(out)) == ["step_2", "step_4"]
    assert "model.safetensors.index.json" in os.listdir(os.path.join(out, "step_2"))
    for step, want in zip((2, 4), seen):
        sd = params_from_jax(convert_hf_mla_llm(
            ck.load_hf_checkpoint(os.path.join(out, f"step_{step}")), cfg), cfg)
        assert sd.keys() == want.keys()
        assert all(torch.equal(sd[k], want[k]) for k in sd), step
    assert not torch.equal(seen[0]["norm.weight"], seen[1]["norm.weight"])
    # JAX's contract: hf_export_every without an export function writes nothing
    quiet, _, data = _mla_trainer(tmp_path, hf_export_every=1)
    quiet.fit(data)
    assert quiet.export_fn is None and not os.path.exists(tmp_path / "step_1")


def test_flops_mfu_and_tokens_per_sec(tmp_path, monkeypatch):
    trainer, _, data = _mla_trainer(tmp_path, flops_per_batch=3e9)
    records = []
    log = trainer.metrics.log_step
    trainer.metrics.log_step = lambda *a, **k: records.append(log(*a, **k)) or records[-1]
    trainer.fit(data)
    assert len(records) == 2
    for r in records:  # no known peak on the CPU: achieved FLOPs only, as JAX
        assert r["tflops_per_sec"] > 0 and "mfu" not in r
        assert r["tokens_per_sec"] == pytest.approx(2 * 16 / (2 * r["time_per_step"]))
    m = metrics.MetricLogger(print_fn=lambda s: None, log_every=1)
    m.set_peak_flops(peak=2e12)
    for world in (1, 4):  # the fleet's peak: one device's times the world size
        monkeypatch.setattr(metrics, "_world_size", lambda: world)
        m.add_flops(8e12)
        r = m.log_step(1)
        assert r["mfu"] == pytest.approx(r["tflops_per_sec"] / (2.0 * world))
    # the peak table: the card's own figure only, never a TPU's
    assert metrics._PEAK_BF16 == {"NVIDIA H100 80GB HBM3": 989e12}
    assert not set(metrics._PEAK_BF16) & set(jmetrics._PEAK_BF16)
    assert metrics.device_peak_flops("cpu") is None
    from internvideo_tpu.models.internvideo2 import make_config as jmake
    from internvideo_tpu_torch.models.internvideo2 import make_config

    for size in ("B", "1B"):
        assert flops.encoder_forward_flops(make_config(size), 3) == \
            jflops.encoder_forward_flops(jmake(size), 3)
    assert flops.train_step_flops(2.0) == jflops.train_step_flops(2.0)


def test_tensorboard_sink(tmp_path, monkeypatch):
    """The sink writes every numeric field but the step through
    `torch.utils.tensorboard.SummaryWriter` (a recording stand-in here:
    where TensorFlow is installed, the real package imports it, ~16 s);
    without the package the logger raises an ImportError that names it."""
    calls = []

    class Writer:
        def __init__(self, logdir):
            calls.append(("init", logdir))

        def add_scalar(self, k, v, step):
            calls.append((k, v, step))

        def close(self):
            calls.append(("close",))

    fake = type(sys)("torch.utils.tensorboard")
    fake.SummaryWriter = Writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    tb = str(tmp_path / "tb")
    m = metrics.MetricLogger(tensorboard_dir=tb, print_fn=lambda s: None, log_every=1)
    m.update(loss=1.5)
    r = m.log_step(7, extra={"lr": 0.1, "note": "x"})
    m.close()
    assert calls[0] == ("init", tb) and calls[-1] == ("close",)
    assert {c[0]: c[1:] for c in calls[1:-1]} == {
        "time_per_step": (r["time_per_step"], 7), "loss": (1.5, 7), "lr": (0.1, 7)}
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="tensorboard"):
        metrics.MetricLogger(tensorboard_dir=tb)


def test_profiling(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir) as prof:
        with profiling.annotate("matmul_region"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    assert any(e.key == "matmul_region" for e in prof.key_averages())
    files = glob.glob(os.path.join(logdir, "*.json"))
    assert files and "matmul_region" in Path(files[0]).read_text()
    res = {}
    with profiling.timed("block", res, device="cpu"):
        sum(range(1000))
    assert res["block"] > 0
    sp = profiling.StepProfiler(str(tmp_path / "steps"), start=1, stop=3)
    for i in range(5):
        sp.step(i)
        with profiling.annotate(f"step{i}"):
            torch.ones(8).sum()
    sp.close()
    text = Path(glob.glob(str(tmp_path / "steps" / "*.json"))[0]).read_text()
    assert "step1" in text and "step2" in text and "step0" not in text and "step3" not in text
