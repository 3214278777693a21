"""The port's dataset classes, corpus registry and real-file eval configs vs
the JAX package.

Same annotation files and seeded `.npy` clips through both packages:
CsvVideoDataset's train batches (random-resized crop, flip, RandAugment,
erasing) and multi-view `eval_views`, JsonlVideoTextDataset's batches (train
and eval transforms, with and without its token cache, the cache file
reused), VideoQADataset's items in both modes, `answers_with_weights` and
WeightedConcatDataset give identical arrays (max-abs 0 on floats made by
the same numpy ops) and tokens; the corpus registry holds the same specs
and compositions and resolves paths alike; an audio row gives JAX's
batch, and one that must demux without a backend JAX's RuntimeError. The
real-file eval configs mirror the JAX ones and give the JAX eval CLI's
metrics when both CLIs hold the JAX init weights.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from internvideo_tpu.cli import eval as jcli
from internvideo_tpu.core.config import config_to_dict as jax_to_dict
from internvideo_tpu.core.config import load_config as jax_load_config
from internvideo_tpu.data import corpus as jcorpus
from internvideo_tpu.data import datasets as jds
from internvideo_tpu.data.tokenizer import ToyTokenizer as JToyTokenizer
from internvideo_tpu_torch.cli import eval as tcli
from internvideo_tpu_torch.core.config import config_to_dict, load_config
from internvideo_tpu_torch.data import corpus as tcorpus
from internvideo_tpu_torch.data import datasets as tds
from internvideo_tpu_torch.data.tokenizer import ToyTokenizer
from internvideo_tpu_torch.models import internvideo2 as tiv2
from internvideo_tpu_torch.models import videoclip as tvc
from internvideo_tpu_torch.models.convert import params_from_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
CAPTIONS = ["a dog runs", "two cats sleep on a sofa", "the lake at dusk",
            "a man plays guitar", "children in a park", "rain on a window"]


def _equal_batches(got, want):
    assert got.keys() == want.keys()
    for k in got:
        g, w = got[k], want[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    paths = []
    for i, shape in enumerate([(16, 40, 56, 3), (9, 64, 48, 3), (24, 36, 36, 3)]):
        p = str(root / f"c{i}.npy")
        np.save(p, rng.integers(0, 256, shape, dtype=np.uint8))
        paths.append(p)
    return root, paths


@pytest.mark.parametrize("augment", [False, True])
def test_csv_dataset_matches_jax(clips, augment):
    root, paths = clips
    anno = root / "anno.csv"
    anno.write_text("".join(f"{os.path.basename(p)},{i % 2}\n" for i, p in enumerate(paths)))
    kw = dict(num_frames=4, img_size=32, seed=3, media_root=str(root),
              use_rand_augment=augment, use_erasing=augment)
    got_ds, want_ds = tds.CsvVideoDataset(str(anno), **kw), jds.CsvVideoDataset(str(anno), **kw)
    assert got_ds.samples == want_ds.samples and len(got_ds) == 3
    got, want = got_ds.train_batches(2), want_ds.train_batches(2)
    for _ in range(3):
        _equal_batches(next(got), next(want))
    ev = dict(kw, train=False)
    got = list(tds.CsvVideoDataset(str(anno), **ev).eval_views(4, num_clips=3))
    want = list(jds.CsvVideoDataset(str(anno), **ev).eval_views(4, num_clips=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _equal_batches(g, w)


@pytest.mark.parametrize("cached", [False, True])
def test_jsonl_dataset_matches_jax(clips, tmp_path, cached):
    root, paths = clips
    anno = tmp_path / "anno.jsonl"
    anno.write_text("".join(json.dumps({"video": os.path.basename(paths[i % 3]), "caption": c})
                            + "\n" for i, c in enumerate(CAPTIONS)))
    kw = dict(num_frames=3, img_size=24, max_length=8, seed=1, media_root=str(root))
    for train in (True, False):
        caches = ((str(tmp_path / "tcache"), str(tmp_path / "jcache")) if cached
                  else (None, None))
        got_ds = tds.JsonlVideoTextDataset(str(anno), ToyTokenizer(), cache_dir=caches[0], **kw)
        want_ds = jds.JsonlVideoTextDataset(str(anno), JToyTokenizer(), cache_dir=caches[1], **kw)
        assert got_ds.items == want_ds.items
        got, want = got_ds.batches(4, train=train), want_ds.batches(4, train=train)
        for _ in range(2):
            _equal_batches(next(got), next(want))
    if cached:  # the second construction read the cache the first wrote
        files = os.listdir(tmp_path / "tcache")
        assert files == os.listdir(tmp_path / "jcache") and len(files) == 1
        reread = tds.JsonlVideoTextDataset(str(anno), None, cache_dir=str(tmp_path / "tcache"),
                                           **kw)
        np.testing.assert_array_equal(reread.tokens([0, 5])["input_ids"],
                                      ToyTokenizer()(CAPTIONS, max_length=8)["input_ids"][[0, 5]])


def test_jsonl_audio_rows_raise_item_10(clips, tmp_path, monkeypatch):
    """Audio rows load as JAX's do (data/audio.py): a row that must demux its
    video's audio raises JAX's RuntimeError when neither PyAV nor ffmpeg is
    there (both hidden here), and a wav row gives JAX's batch."""
    from scipy.io import wavfile

    _, paths = clips
    anno = tmp_path / "av.jsonl"
    anno.write_text(json.dumps({"video": paths[0], "caption": "a"}) + "\n")
    monkeypatch.setitem(sys.modules, "av", None)
    monkeypatch.setattr("shutil.which", lambda name: None)
    for mod, tok in ((tds, ToyTokenizer), (jds, JToyTokenizer)):
        ds = mod.JsonlVideoTextDataset(str(anno), tok(), media_type="audio_video",
                                       read_audio_from_video=True)
        with pytest.raises(RuntimeError, match="PyAV.*ffmpeg"):
            next(ds.batches(1))
    wav = str(tmp_path / "a.wav")
    t = np.arange(24_000) / 16_000
    wavfile.write(wav, 16_000, (0.5 * np.sin(2 * np.pi * 440 * t) * 32767).astype(np.int16))
    anno.write_text(json.dumps({"video": paths[0], "audio": wav, "caption": "a tone"}) + "\n")
    kw = dict(num_frames=3, img_size=24, max_length=8, media_type="audio_video")
    got = next(tds.JsonlVideoTextDataset(str(anno), ToyTokenizer(), **kw).batches(1))
    want = next(jds.JsonlVideoTextDataset(str(anno), JToyTokenizer(), **kw).batches(1))
    _equal_batches(got, want)
    assert got["audio"].shape == (1, 998, 64) and int((~got["audio_padding_mask"]).sum()) == 148
    with pytest.raises(ValueError, match="unknown media_type"):
        tds.JsonlVideoTextDataset(str(anno), ToyTokenizer(), media_type="smell")


def test_video_qa_dataset_and_weights_match_jax(clips, tmp_path):
    _, paths = clips
    for raw in (["cat", "cat", "dog"], "yes", ["a", "b", "a", "a"]):
        assert tds.answers_with_weights(raw) == jds.answers_with_weights(raw)
    ann = tmp_path / "qa.jsonl"
    rows = [{"video": paths[0], "question": "what  is this?", "answer": ["a cat", "a cat", "a dog"]},
            {"video": paths[1], "question": "how many?", "answer": "two", "question_id": 7}]
    ann.write_text("\n".join(json.dumps(r) for r in rows))
    for mode in ("train", "eval"):
        kw = dict(num_frames=2, img_size=16, mode=mode, answer_list=["a cat", "two"], seed=2)
        got, want = tds.VideoQADataset(str(ann), **kw), jds.VideoQADataset(str(ann), **kw)
        assert len(got) == len(want) == 2 and got.answer_list == want.answer_list
        for i in range(2):
            g, w = got[i], want[i]
            assert g.keys() == w.keys()
            for k in g:
                if isinstance(w[k], np.ndarray):
                    np.testing.assert_array_equal(g[k], w[k])
                else:
                    assert g[k] == w[k]


def test_weighted_concat_dataset_matches_jax():
    a, b = [f"a{i}" for i in range(3)], [f"b{i}" for i in range(2)]
    got, want = tds.WeightedConcatDataset([a, b], [2, 3]), jds.WeightedConcatDataset([a, b], [2, 3])
    assert len(got) == len(want) == 12
    assert [got[i] for i in range(12)] == [want[i] for i in range(12)]


def _fresh(module, monkeypatch):
    """A new copy of `module` with its registry as the file defines it
    (other tests register corpora into the imported one)."""
    name = f"_fresh_{module.__name__}"
    spec = importlib.util.spec_from_file_location(name, module.__file__)
    fresh = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, name, fresh)  # dataclasses look their module up
    spec.loader.exec_module(fresh)
    return fresh


def test_corpus_registry_matches_jax(monkeypatch):
    port, ref = _fresh(tcorpus, monkeypatch), _fresh(jcorpus, monkeypatch)
    assert port.available_corpora() == ref.available_corpora()
    for name in port.available_corpora():
        got, want = port.get_composition(name), ref.get_composition(name)
        assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s) for s in want]
    monkeypatch.setenv("IVT_DATA_PATH", "/data")
    assert tcorpus.data_root() == jcorpus.data_root() == "/data"
    assert tcorpus.get_corpus("webvid").anno() == "/data/anno/webvid.jsonl"
    assert tcorpus.get_corpus("webvid").root() == jcorpus.get_corpus("webvid").root()
    with pytest.raises(KeyError, match="unknown corpus"):
        tcorpus.get_corpus("nope")
    with pytest.raises(ValueError, match="unknown corpora"):
        tcorpus.register_composition("bad", ["webvid", "nope"])
    with pytest.raises(ValueError, match="already registered"):
        tcorpus.register_corpus(tcorpus.get_corpus("webvid"))


def test_corpus_build_datasets_matches_jax(tmp_path, monkeypatch):
    root = tmp_path / "dataroot"
    (root / "anno").mkdir(parents=True)
    media = root / "media" / "toy"
    media.mkdir(parents=True)
    np.save(str(media / "c0.npy"),
            np.random.default_rng(1).integers(0, 256, (8, 36, 36, 3), dtype=np.uint8))
    (root / "anno" / "toy.jsonl").write_text(
        json.dumps({"video": "c0.npy", "caption": "hello"}) + "\n")
    (root / "anno" / "toy_cls.csv").write_text("c0.npy,3\n")
    monkeypatch.setenv("IVT_DATA_PATH", str(root))
    for mod in (tcorpus, jcorpus):
        monkeypatch.setattr(mod, "_REGISTRY", dict(mod._REGISTRY))
        monkeypatch.setattr(mod, "_COMPOSITIONS", dict(mod._COMPOSITIONS))
        mod.register_corpus(mod.CorpusSpec(name="toy", anno_path="anno/toy.jsonl",
                                           media_root="media/toy"), overwrite=True)
        mod.register_corpus(mod.CorpusSpec(name="toy_cls", anno_path="anno/toy_cls.csv",
                                           media_root="media/toy", format="csv"),
                            overwrite=True)
        mod.register_composition("toy_mix", ["toy", "toy_cls"])
    got = tcorpus.build_datasets("toy_mix", ToyTokenizer(), num_frames=4, img_size=28)
    want = jcorpus.build_datasets("toy_mix", JToyTokenizer(), num_frames=4, img_size=28)
    assert got.keys() == want.keys() == {"toy", "toy_cls"}
    _equal_batches(next(got["toy"].batches(1)), next(want["toy"].batches(1)))
    _equal_batches(next(got["toy_cls"].train_batches(1)), next(want["toy_cls"].train_batches(1)))
    assert next(got["toy"].batches(1))["video"].shape == (1, 4, 28, 28, 3)
    with pytest.raises(ValueError, match="needs tokenizer"):
        tcorpus.build_datasets("toy")


# -- the real-file eval configs through both CLIs -------------------------------------------

def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("task", ["classification", "retrieval"])
def test_realfile_configs_give_the_jax_cli_metrics(monkeypatch, task):
    name = f"eval_{task}_realfile"
    jrun = jax_load_config(os.path.join(ROOT, "configs", f"{name}.py"))
    trun = load_config(os.path.join(ROOT, "configs", "torch", f"{name}.py"))
    for field in ("task", "model", "options", "checkpoint"):
        assert config_to_dict(getattr(trun, field)) == jax_to_dict(getattr(jrun, field)), field
    got_data, want_data = trun.data(), jrun.data()  # the same files, made alike
    for g, w in zip(got_data if task == "classification" else got_data[:2],
                    want_data if task == "classification" else want_data[:2]):
        _equal_batches(g, w)

    captured = {}
    load_params = jcli._load_params

    def capture(model, init_params, checkpoint, convert):
        captured["params"] = jax.tree.map(np.asarray, jax.device_get(
            __import__("flax").linen.unbox(init_params)))
        return load_params(model, init_params, checkpoint, convert)

    monkeypatch.setattr(jcli, "_load_params", capture)
    want = _run(jcli.main, ["--config", os.path.join(ROOT, "configs", f"{name}.py")])

    if task == "classification":
        class Loaded(tiv2.InternVideo2):
            def __init__(self, cfg, **kw):
                super().__init__(cfg, **kw)
                self.load_state_dict(params_from_jax(captured["params"], cfg), strict=True)

        monkeypatch.setattr(tiv2, "InternVideo2", Loaded)
    else:
        def videoclip(run, device):
            model = tvc.VideoCLIP(run.model, device=device,
                                  generator=torch.Generator().manual_seed(0))
            model.load_state_dict(params_from_jax(captured["params"], run.model), strict=True)
            return model.eval()

        monkeypatch.setattr(tcli, "_videoclip", videoclip)
    got = _run(tcli.main, ["--config", os.path.join(ROOT, "configs", "torch", f"{name}.py"),
                           "--device", "cpu"])
    assert got == want
    assert got["task"] == task
