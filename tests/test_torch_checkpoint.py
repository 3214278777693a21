"""The safetensors / HF bridge of the PyTorch port (core/checkpoint.py) vs
the JAX package's: a file either package writes reads back bit for bit in
the other, for fp32, bf16 (ml_dtypes on the JAX side), fp8, integer and
bool tags; the same tensors give the same bytes; sharding names its files
and index as JAX does; a later export removes the earlier one's shards and
index; flatten / unflatten match."""

import json
import os
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from internvideo_tpu.core import checkpoint as jck
from internvideo_tpu_torch.core import checkpoint as ck


def _numpy_tensors(rng):
    """Every tag both packages write, as numpy (ml_dtypes for bf16 / fp8)."""
    return {
        "a.weight": rng.standard_normal((3, 5)).astype(np.float32),
        "b.bias": rng.standard_normal(7).astype(ml_dtypes.bfloat16),
        "c.f8": rng.standard_normal((2, 4)).astype(ml_dtypes.float8_e4m3fn),
        "d.f8": rng.standard_normal(3).astype(ml_dtypes.float8_e5m2),
        "e.half": rng.standard_normal((2, 2)).astype(np.float16),
        "f.ids": np.arange(6, dtype=np.int64).reshape(2, 3),
        "g.i32": np.array([1, -2, 3], np.int32),
        "h.u8": np.arange(5, dtype=np.uint8),
        "i.mask": np.array([True, False, True]),
        "j.f64": rng.standard_normal(2),
    }


def _bits(a) -> np.ndarray:
    """The raw bytes of a numpy array or tensor, for bit equality."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _same(np_arr, t: torch.Tensor):
    assert tuple(t.shape) == np_arr.shape
    np.testing.assert_array_equal(_bits(t), _bits(np_arr))


def test_files_cross_read_bit_for_bit(tmp_path):
    tensors = _numpy_tensors(np.random.default_rng(0))
    jpath, tpath = str(tmp_path / "jax.safetensors"), str(tmp_path / "torch.safetensors")
    jck.write_safetensors(jpath, tensors)
    ck.write_safetensors(tpath, {k: ck.as_tensor(v) for k, v in tensors.items()})
    # the same tensors give the same file
    assert Path(jpath).read_bytes() == Path(tpath).read_bytes()
    got = ck.read_safetensors(jpath)
    assert list(got) == list(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == ck.as_tensor(v).dtype, k
        _same(v, got[k])
    back = jck.read_safetensors(tpath)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(_bits(back[k]), _bits(v))


def test_scalars_keep_their_shape(tmp_path):
    """A 0-d tensor is written with shape [] (the format's scalar). JAX's
    writer passes it through np.ascontiguousarray, which makes it [1]
    (ROADMAP queue 3); each package reads the other's file."""
    path = str(tmp_path / "x.safetensors")
    ck.write_safetensors(path, {"temp": torch.tensor(0.07)})
    assert ck.read_safetensors(path)["temp"].shape == ()
    assert jck.read_safetensors(path)["temp"].shape == ()
    jck.write_safetensors(path, {"temp": np.asarray(np.float32(0.07))})
    got = ck.read_safetensors(path)["temp"]
    assert got.shape == (1,) and got.item() == np.float32(0.07)


def test_unaligned_offsets_and_empty_tensors(tmp_path):
    """A bf16 tensor of odd length puts the fp32 tensor after it at an
    offset that is not a multiple of 4: it reads as a copy, not a view."""
    t = {"odd": torch.arange(3, dtype=torch.bfloat16), "f32": torch.randn(4, 2),
         "empty": torch.zeros(0, 3), "i8": torch.tensor([-1, 2], dtype=torch.int8)}
    path = str(tmp_path / "x.safetensors")
    ck.write_safetensors(path, t)
    got = ck.read_safetensors(path)
    for k, v in t.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    back = jck.read_safetensors(path)
    np.testing.assert_array_equal(back["f32"], t["f32"].numpy())
    assert back["empty"].shape == (0, 3)


def test_unsupported_dtype_raises(tmp_path):
    with pytest.raises(ValueError, match="cannot serialize"):
        ck.write_safetensors(str(tmp_path / "x.safetensors"),
                             {"c": torch.zeros(2, dtype=torch.complex64)})


@pytest.mark.parametrize("shard_mb", [None, 1])
def test_hf_directories_cross_load(tmp_path, shard_mb):
    """One file under the shard size, shards + index above it: file names,
    index and tensors equal between the packages."""
    rng = np.random.default_rng(1)
    tensors = {f"model.layers.{i}.w": rng.standard_normal((256, 256)).astype(np.float32)
               for i in range(6)}
    tensors["model.norm.weight"] = rng.standard_normal(256).astype(ml_dtypes.bfloat16)
    kw = {} if shard_mb is None else {"shard_size_bytes": shard_mb * 1024**2}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jck.save_hf_checkpoint(jdir, tensors, **kw)
    files = ck.save_hf_checkpoint(tdir, {k: ck.as_tensor(v) for k, v in tensors.items()}, **kw)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    assert sorted(files) == sorted(f for f in os.listdir(tdir) if f.endswith(".safetensors"))
    if shard_mb is None:
        assert files == ["model.safetensors"]
    else:
        assert files == ["model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors"]
        with open(os.path.join(jdir, "model.safetensors.index.json")) as f:
            jindex = json.load(f)
        with open(os.path.join(tdir, "model.safetensors.index.json")) as f:
            assert json.load(f) == jindex
    for fn in files:
        assert Path(jdir, fn).read_bytes() == Path(tdir, fn).read_bytes(), fn
    got, back = ck.load_hf_checkpoint(jdir), jck.load_hf_checkpoint(tdir)
    assert set(got) == set(back) == set(tensors)
    for k, v in tensors.items():
        _same(v, got[k])
        np.testing.assert_array_equal(_bits(back[k]), _bits(v))


def test_stale_shards_and_index_are_removed(tmp_path):
    d = str(tmp_path / "ckpt")
    big = {f"w{i}": torch.randn(128, 128) for i in range(4)}
    ck.save_hf_checkpoint(d, big, shard_size_bytes=100_000)
    assert "model.safetensors.index.json" in os.listdir(d)
    Path(d, "config.json").write_text("{}")  # not ours: stays
    small = {"w": torch.ones(3)}
    ck.save_hf_checkpoint(d, small)
    assert sorted(os.listdir(d)) == ["config.json", "model.safetensors"]
    got = ck.load_hf_checkpoint(d)
    assert list(got) == ["w"] and torch.equal(got["w"], small["w"])
    # JAX's loader sees the same single file
    assert list(jck.load_hf_checkpoint(d)) == ["w"]


def test_flatten_unflatten_match_jax():
    rng = np.random.default_rng(2)
    tree = {"blocks_0": {"attn": {"qkv": {"kernel": rng.standard_normal((4, 12))}}},
            "cls_token": rng.standard_normal((1, 1, 4)).astype(np.float32)}
    want = jck.flatten_params(tree)
    got = ck.flatten_params(tree)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    back = ck.unflatten_params(got)
    assert torch.equal(back["blocks_0"]["attn"]["qkv"]["kernel"],
                       got["blocks_0.attn.qkv.kernel"])
    assert jck.unflatten_params(want).keys() == back.keys()
