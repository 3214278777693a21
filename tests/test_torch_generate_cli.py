"""The port's generate CLI on the CPU with the tiny smoke preset
`qwen3_mla_tiny` (the widths tests/test_generate_cli.py injects): in-process
and on the command line; the refusals and a missing `--checkpoint`;
`--device cuda` without a card exits non-zero."""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from internvideo_tpu_torch.cli.generate import main

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_generate_cli_random_init():
    base = ["--preset", "qwen3_mla_tiny", "--ids", "1,2,3", "--max-new-tokens", "4",
            "--device", "cpu"]
    rc, out = _run(base)
    assert rc == 0 and len(out["tokens"]) == 4
    assert all(0 <= t < 97 for t in out["tokens"])
    rc, paged = _run(base + ["--paged", "--page-size", "4"])
    assert rc == 0 and paged == out  # greedy: paged decode is token-identical
    rc, samp = _run(base + ["--temperature", "0.8", "--top-k", "5", "--top-p", "0.9",
                            "--seed", "3"])
    assert rc == 0 and len(samp["tokens"]) == 4
    assert _run(base + ["--temperature", "0.8", "--seed", "3"]) == \
        _run(base + ["--temperature", "0.8", "--seed", "3"])


def test_generate_cli_refusals():
    cpu = ["--preset", "qwen3_mla_tiny", "--device", "cpu"]
    for extra, match in ((["--prompt", "hello", "--tokenizer", "tok"], "tokenizer"),
                         ([], "--ids"),
                         (["--ids", "1", "--preset", "no_such_preset"], "unknown preset")):
        with pytest.raises(SystemExit, match=match):
            main(cpu + extra)
    # --checkpoint loads (tests/test_torch_convert_cli.py); a missing one raises
    with pytest.raises(FileNotFoundError):
        main(cpu + ["--ids", "1", "--checkpoint", "x.safetensors"])


def test_generate_cli_tiny_preset_on_the_command_line():
    """`python -m internvideo_tpu_torch.cli.generate --preset qwen3_mla_tiny
    ... --device cpu` prints the tokens; without `--device` on a machine with
    no GPU it exits non-zero."""
    cmd = [sys.executable, "-m", "internvideo_tpu_torch.cli.generate", "--preset",
           "qwen3_mla_tiny", "--ids", "1,2,3", "--max-new-tokens", "4"]
    res = subprocess.run(cmd + ["--device", "cpu", "--paged", "--page-size", "4"],
                         capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    tokens = json.loads(res.stdout.strip().splitlines()[-1])["tokens"]
    assert len(tokens) == 4 and all(0 <= t < 97 for t in tokens)
    if torch.cuda.is_available():
        return  # the refusal below needs a machine without a CUDA device
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
