"""The port's video readers and samplers, loader, tokenizers vs the JAX package.

Same seeded numpy inputs through both packages: the frame samplers (every
mode, seeded generators) and the readers (`.npy`, an image directory, a
GIF, an MJPG container through cv2) give identical indices and uint8
frames (max-abs 0); MetaLoader's schedule and items and StatefulIterator's
index stream (with a resume and per-host shards) are identical; the
port's `prefetch_to_device` on the CPU yields the same batches as tensors,
re-raises producer errors, stops its thread when closed and refuses
`sharding=`; ToyTokenizer's ids and ClipBpeTokenizer's ids, masks and
decodes equal JAX's, the latter on a small merge table the test learns
and writes (the real CLIP vocabulary is not in the repository).
"""

import collections
import gzip
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

from internvideo_tpu.data import clip_bpe as jbpe
from internvideo_tpu.data import loader as jloader
from internvideo_tpu.data import tokenizer as jtok
from internvideo_tpu.data import video as jvideo
from internvideo_tpu_torch.data import clip_bpe as tbpe
from internvideo_tpu_torch.data import loader as tloader
from internvideo_tpu_torch.data import tokenizer as ttok
from internvideo_tpu_torch.data import video as tvideo


# -- samplers ---------------------------------------------------------------------------

SAMPLER_CASES = [
    dict(num_frames=8, vlen=100, sample="rand"),
    dict(num_frames=8, vlen=5, sample="rand"),  # loop-padded
    dict(num_frames=8, vlen=100, sample="middle"),
    dict(num_frames=8, vlen=100, sample="middle", fix_start=3),
    dict(num_frames=16, vlen=300, sample="dense"),
    dict(num_frames=16, vlen=300, sample="dense", clip_idx=2, num_clips=4),
    dict(num_frames=16, vlen=20, sample="dense", input_fps=60.0),
    dict(num_frames=8, vlen=97, sample="sparse"),
    dict(num_frames=8, vlen=97, sample="sparse", clip_idx=1, num_clips=3),
    dict(num_frames=8, vlen=4, sample="sparse"),
]


@pytest.mark.parametrize("case", SAMPLER_CASES, ids=lambda c: "-".join(map(str, c.values())))
def test_frame_samplers_match_jax(case):
    for seed in range(3):
        want = jvideo.sample_frame_indices(**case, rng=np.random.default_rng(seed))
        got = tvideo.sample_frame_indices(**case, rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    with pytest.raises(ValueError, match="unknown sampling"):
        tvideo.sample_frame_indices(4, 10, sample="nope")


# -- readers ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """One seeded clip as `.npy`, a PNG directory, a GIF and an MJPG `.avi`."""
    import cv2
    from PIL import Image

    root = tmp_path_factory.mktemp("media")
    clip = np.random.default_rng(0).integers(0, 256, (12, 24, 32, 3), dtype=np.uint8)
    paths = {"npy": str(root / "clip.npy"), "imgdir": str(root / "frames"),
             "gif": str(root / "clip.gif"), "avi": str(root / "clip.avi")}
    np.save(paths["npy"], clip)
    os.makedirs(paths["imgdir"])
    for i, f in enumerate(clip):
        Image.fromarray(f).save(os.path.join(paths["imgdir"], f"{i:03d}.png"))
    frames = [Image.fromarray(f) for f in clip]
    frames[0].save(paths["gif"], save_all=True, append_images=frames[1:], duration=40)
    writer = cv2.VideoWriter(paths["avi"], cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (32, 24))
    for f in clip:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    return clip, paths


@pytest.mark.parametrize("kind", ["npy", "imgdir", "gif", "avi"])
def test_readers_match_jax(media, kind):
    clip, paths = media
    path = paths[kind]
    assert tvideo.video_length(path) == jvideo.video_length(path) == len(clip)
    idx = np.array([0, 3, 3, 7, 11, 2])
    got, want = tvideo.read_frames(path, idx), jvideo.read_frames(path, idx)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (6, 24, 32, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() == 0
    if kind in ("npy", "imgdir"):  # lossless formats: the clip itself
        np.testing.assert_array_equal(got, clip[idx])
    for sample in ("rand", "middle", "sparse"):
        got = tvideo.read_video(path, 5, sample=sample, rng=np.random.default_rng(4))
        want = jvideo.read_video(path, 5, sample=sample, rng=np.random.default_rng(4))
        np.testing.assert_array_equal(got, want)


def test_pyav_branch_raises_without_pyav(media):
    _, paths = media
    for mod in (tvideo, jvideo):
        with pytest.raises(ImportError, match="PyAV"):
            mod.read_frames_av(paths["avi"], np.arange(2))
    assert tvideo._pyav() is None  # not installed here: containers go to cv2


# -- loader -----------------------------------------------------------------------------

def test_metaloader_matches_jax():
    sources = {"a": list(range(5)), "b": list("xyz"), "c": [10, 11]}
    for kw in ({}, {"counts": {"a": 2, "b": 6, "c": 3}, "seed": 3, "epoch": 2}):
        want = jloader.MetaLoader(sources, **kw)
        got = tloader.MetaLoader(sources, **kw)
        assert got.schedule() == want.schedule() and len(got) == len(want)
        assert list(got) == list(want)
    with pytest.raises(ValueError, match="'e' is empty"):
        list(tloader.MetaLoader({"e": []}, counts={"e": 1}))


def test_stateful_iterator_resume_and_shards_match_jax():
    for kw in ({}, {"seed": 5, "num_shards": 3, "shard_id": 1}, {"shuffle": False}):
        want_it, got_it = iter(jloader.StatefulIterator(10, **kw)), None
        want = [next(want_it) for _ in range(25)]  # two epochs and a half
        first = tloader.StatefulIterator(10, **kw)
        got_it = iter(first)
        got = [next(got_it) for _ in range(7)]
        resumed = tloader.StatefulIterator(10, **kw)
        resumed.load_state_dict(first.state_dict())
        it = iter(resumed)
        got += [next(it) for _ in range(18)]
        assert got == want, kw


def test_prefetch_to_device_on_the_cpu():
    rng = np.random.default_rng(0)
    batches = [{"video": rng.standard_normal((2, 3)).astype(np.float32),
                "label": np.arange(2, dtype=np.int32), "meta": ("a", np.int64(i))}
               for i in range(5)]
    out = list(tloader.prefetch_to_device(iter(batches), torch.device("cpu"), size=2))
    assert len(out) == 5
    for got, want in zip(out, batches):
        assert isinstance(got["video"], torch.Tensor) and got["video"].device.type == "cpu"
        np.testing.assert_array_equal(got["video"].numpy(), want["video"])
        np.testing.assert_array_equal(got["label"].numpy(), want["label"])
        assert got["meta"][0] == "a" and int(got["meta"][1]) == int(want["meta"][1])

    def broken():
        yield batches[0]
        raise IOError("corrupt clip")

    it = tloader.prefetch_to_device(broken(), "cpu")
    next(it)
    with pytest.raises(IOError, match="corrupt clip"):
        next(it)

    def endless():
        i = 0
        while True:
            i += 1
            yield {"x": np.full(3, i)}

    before = set(threading.enumerate())
    gen = tloader.prefetch_to_device(endless(), "cpu", size=2)
    assert int(next(gen)["x"][0]) == 1
    (producer,) = set(threading.enumerate()) - before
    assert producer.name == "prefetch_to_device"
    gen.close()  # stops the producer at its next put and drops the queue
    deadline = time.time() + 5
    while producer.is_alive():
        assert time.time() < deadline, "the producer thread outlived close()"
        time.sleep(0.05)
    with pytest.raises(NotImplementedError, match="item 8"):
        next(tloader.prefetch_to_device(iter(batches), "cpu", sharding="fsdp"))


# -- tokenizers -------------------------------------------------------------------------

TEXTS = [
    "a person is feeding ducks by the lake",
    "Doing Brazilian jiu-jitsu, GRAPPLING!",
    "it's 42 degrees; we're melting...",
    "划独木舟",  # CJK goes through the byte fallback
    "café au lait & croissants <3",
    "a photo of a dog <|endoftext|>",  # a literal special -> its single id
    "",
    "the otter and the other otters " * 12,  # truncated at 77
]


def test_toy_tokenizer_matches_jax():
    vocab = ["the", "a", "dog"]
    want, got = jtok.ToyTokenizer(vocab), ttok.ToyTokenizer(vocab)
    for max_length in (8, 32):
        w, g = want(TEXTS, max_length=max_length), got(TEXTS, max_length=max_length)
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(g[k], w[k])
            assert g[k].dtype == w[k].dtype
    small_w, small_g = jtok.ToyTokenizer(max_vocab=205), ttok.ToyTokenizer(max_vocab=205)
    np.testing.assert_array_equal(small_g(TEXTS)["input_ids"], small_w(TEXTS)["input_ids"])
    assert got.vocab_size == want.vocab_size == 4096


def _learn_merges(texts, n):
    """A small BPE merge table learnt greedily from `texts`' words."""
    byte_enc = jbpe.byte_to_printable()
    words = collections.Counter()
    for t in texts:
        for w in re.findall(r"\S+", t.lower()):
            mapped = "".join(byte_enc[b] for b in w.encode("utf-8"))
            words[tuple(mapped[:-1]) + (mapped[-1] + "</w>",)] += 1
    merges = []
    for _ in range(n):
        pairs = collections.Counter()
        for w, c in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        new = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new[tuple(out)] += c
        words = new
    return merges


@pytest.fixture(scope="module")
def bpe_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("bpe") / "merges.txt.gz"
    merges = _learn_merges(TEXTS, 80)
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: test\n" + "\n".join(" ".join(m) for m in merges))
    return str(path)


def test_clip_bpe_matches_jax(bpe_path):
    want, got = jbpe.ClipBpeTokenizer(bpe_path), tbpe.ClipBpeTokenizer(bpe_path)
    assert got.vocab_size == want.vocab_size == 512 + 80 + 2
    assert (got.sot_id, got.eot_id) == (want.sot_id, want.eot_id)
    for t in TEXTS:
        ids = got.encode(t)
        assert ids == want.encode(t), t
        assert got.decode(ids) == want.decode(ids)
    assert any(i >= 512 for t in TEXTS for i in got.encode(t))  # merges were used
    np.testing.assert_array_equal(got.tokenize(TEXTS), want.tokenize(TEXTS))
    w, g = want(TEXTS, max_length=16), got(TEXTS, max_length=16)
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(ValueError, match="longer than"):
        got.tokenize(TEXTS[-1], context_length=8, truncate=False)
