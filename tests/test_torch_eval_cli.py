"""Classification eval of the PyTorch port vs the JAX package's, and its CLI."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from internvideo_tpu.eval import classification as jax_cls
from internvideo_tpu_torch.cli import eval as cli
from internvideo_tpu_torch.core import config as port_config
from internvideo_tpu_torch.eval import classification as port_cls

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = os.path.join(ROOT, "configs", "torch", "eval_classification_tiny.py")


def _views(seed=0, n_videos=6, n_views=3, n_classes=7):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n_videos).astype(np.int32)
    return [{"video": rng.standard_normal((n_videos, n_classes)).astype(np.float32),
             "label": labels, "video_id": np.arange(n_videos, dtype=np.int32)}
            for _ in range(n_views)]


def test_final_test_and_validate_match_jax():
    views = _views()
    # forward = identity: the "video" is the fixed logits
    ref = jax_cls.final_test(lambda x: x, views)
    assert port_cls.final_test(lambda x: x, views) == ref
    # a forward returning torch tensors gives the same dict
    assert port_cls.final_test(lambda x: torch.from_numpy(x), views) == ref
    assert port_cls.validate(lambda x: x, views) == jax_cls.validate(lambda x: x, views)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_cls.final_test(lambda x: x, views, merge_hosts=True)


def test_config_overrides_match_jax():
    from internvideo_tpu.core import config as jax_config

    run = port_config.load_config(TINY)
    over = ["model.depth=2", "options.merge_hosts=False", "task=classification"]
    new = port_config.apply_overrides(run, over)
    assert new.model.depth == 2 and new.options == {"merge_hosts": False}
    jax_run = jax_config.load_config(os.path.join(ROOT, "configs", "eval_classification_tiny.py"))
    jax_new = jax_config.apply_overrides(jax_run, over)
    want = jax_config.config_to_dict(jax_new.model)
    got = port_config.config_to_dict(new.model)
    assert got == want
    with pytest.raises(AttributeError):
        port_config.apply_overrides(run, ["model.nope=1"])


def _main(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_classification_on_cpu():
    out = _main("--config", TINY, "--device", "cpu")
    assert out["task"] == "classification" and out["num_videos"] == 4
    assert 0 <= out["top1"] <= 100 and 0 <= out["top5"] <= 100


def test_cli_rejects_unported_tasks_and_checkpoints(monkeypatch):
    # every task of the JAX CLI is ported: an unknown name is the only task error
    from internvideo_tpu.cli import eval as jax_cli

    assert set(cli.TASKS) == set(jax_cli.TASKS)
    for task in ("nope", "openset_v2"):
        with pytest.raises(SystemExit, match="unknown task"):
            _main("--config", TINY, "--device", "cpu", f"task={task}")
    # checkpoint= loads since checkpoint I/O was ported (it raised
    # NotImplementedError before); a missing one is an error, not the init
    with pytest.raises(FileNotFoundError, match="does not exist"):
        _main("--config", TINY, "--device", "cpu", "checkpoint=/nonexistent")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        _main("--config", TINY)


def test_cli_module_entry_prints_task_json():
    res = subprocess.run(
        [sys.executable, "-m", "internvideo_tpu_torch.cli.eval", "--config", TINY,
         "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["task"] == "classification"
