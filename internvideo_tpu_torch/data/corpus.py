"""Named-corpus registry: corpus name -> annotation / media paths.

Port of internvideo_tpu/data/corpus.py, with the same table: every corpus
of the reference's `available_corpus` (multi_modality/configs/data.py) is
a frozen `CorpusSpec` with its annotation path, media root and media type;
compositions are lists of corpus names that MetaLoader interleaves, so
overriding a corpus reaches every composition that holds it. Relative paths
resolve under one data root, the IVT_DATA_PATH environment variable.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence


def data_root() -> str:
    return os.environ.get("IVT_DATA_PATH", "")


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    """One corpus: where its annotations and media live, and how to read it.

    anno_path/media_root are stored relative to `data_root()` unless
    absolute; `.anno()` / `.root()` resolve them.
    """

    name: str
    anno_path: str  # jsonl ({"video","caption"}) or csv ("path,label")
    media_root: str = ""
    media_type: str = "video"  # video | image | audio | audio_video
    format: str = "jsonl"  # jsonl | csv
    # reference per-corpus flags (configs/data.py): these gate reader options
    read_audio_from_video: bool = False
    is_paragraph_retrieval: bool = False  # didemo/anet: captions joined
    max_txt_l: Optional[int] = None

    def anno(self) -> str:
        if os.path.isabs(self.anno_path):
            return self.anno_path
        return os.path.join(data_root(), self.anno_path)

    def root(self) -> str:
        if not self.media_root or os.path.isabs(self.media_root):
            return self.media_root
        return os.path.join(data_root(), self.media_root)


_REGISTRY: Dict[str, CorpusSpec] = {}
_COMPOSITIONS: Dict[str, List[str]] = {}


def register_corpus(spec: CorpusSpec, overwrite: bool = False) -> CorpusSpec:
    if spec.name in _REGISTRY and not overwrite:
        raise ValueError(f"corpus {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def register_composition(name: str, members: Sequence[str]) -> None:
    unknown = [m for m in members if m not in _REGISTRY]
    if unknown:
        raise ValueError(f"composition {name!r}: unknown corpora {unknown}")
    _COMPOSITIONS[name] = list(members)


def get_corpus(name: str) -> CorpusSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown corpus {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def get_composition(name: str) -> List[CorpusSpec]:
    """Resolve a name to a list of specs (single corpus -> 1-list)."""
    if name in _COMPOSITIONS:
        return [_REGISTRY[m] for m in _COMPOSITIONS[name]]
    return [get_corpus(name)]


def available_corpora() -> List[str]:
    return sorted(_REGISTRY) + sorted(_COMPOSITIONS)


# ---------------------------------------------------------------------------
# The reference's named table (configs/data.py:8-360), default relative paths.
# Annotation layouts ship as jsonl here (the framework's native format;
# tools/preprocess.py converts reference sqlite/json annotations).
# ---------------------------------------------------------------------------

def _std(name: str, media_type: str = "video", **kw) -> None:
    register_corpus(CorpusSpec(
        name=name,
        anno_path=f"anno/{name}.jsonl",
        media_root=f"media/{name}",
        media_type=media_type,
        **kw,
    ))


# pretraining image corpora (configs/data.py:10-55)
for _n in ("cc3m", "cc12m", "sbu", "vg", "coco", "laion_2b", "laion_coco",
           "laion_pop"):
    _std(_n, "image")
# pretraining video corpora (:57-105)
for _n in ("webvid", "webvid_10m", "webvid_fuse_10m", "internvid_v1",
           "internvid_10m_flt", "kinetics400_raw", "kinetics710_raw"):
    _std(_n, "video")
_std("internvid_v2_avs", "audio_video", read_audio_from_video=True)
# retrieval train/val/test (:134-310)
for _n in ("msrvtt_ret_train9k", "msrvtt_ret_test1k", "msrvtt_1k_test",
           "msvd_ret_train", "msvd_ret_val", "msvd_ret_test",
           "lsmdc_ret_train", "lsmdc_ret_val", "lsmdc_ret_test_1000",
           "vatex_en_ret_train", "vatex_en_ret_val", "vatex_ch_ret_val"):
    _std(_n, "video")
for _n in ("didemo_ret_train", "didemo_ret_val", "didemo_ret_test",
           "anet_ret_train", "anet_ret_val"):
    _std(_n, "video", is_paragraph_retrieval=True, max_txt_l=64)
# action-cls zero-shot val sets as csv (:175-215)
for _n in ("k400_act_val", "k600_act_val", "k700_act_val", "mit_act_val",
           "ucf101_act_val", "hmdb51_act_val"):
    register_corpus(CorpusSpec(
        name=_n, anno_path=f"anno/{_n}.csv", media_root=f"media/{_n}",
        media_type="video", format="csv",
    ))
# MC-QA (:216-228)
for _n in ("ssv2_mc_val", "charades_mc_test"):
    _std(_n, "video")
# audio retrieval (:314-351)
for _n in ("audiocaps_ret_train", "audiocaps_ret_test",
           "clothov1_ret_train", "clothov1_ret_test",
           "clothov2_ret_train", "clothov2_ret_test"):
    _std(_n, "audio")

# compositions (:107-131)
register_composition("pretrain_example_data_1B", ["cc3m", "webvid"])
register_composition(
    "pretrain_example_data_6B", ["cc3m", "webvid", "internvid_v2_avs"])
register_composition(
    "data_25m", ["webvid_10m", "cc3m", "coco", "vg", "sbu", "cc12m"])


# ---------------------------------------------------------------------------
# Construction: corpus specs -> dataset objects / MetaLoader sources
# ---------------------------------------------------------------------------

def build_datasets(
    name: str,
    tokenizer=None,
    *,
    num_frames: int = 8,
    img_size: int = 224,
    max_length: int = 32,
    cache_dir: Optional[str] = None,
    train: bool = True,
):
    """Resolve a corpus/composition name into constructed dataset objects.

    Returns {corpus_name: dataset}; jsonl corpora need `tokenizer`.
    Mirrors create_dataset's dispatch on media/anno type
    (multi_modality/dataset/__init__.py:157).
    """
    from internvideo_tpu_torch.data.datasets import CsvVideoDataset, JsonlVideoTextDataset

    out = {}
    for spec in get_composition(name):
        if spec.format == "csv":
            out[spec.name] = CsvVideoDataset(
                spec.anno(), num_frames=num_frames, img_size=img_size,
                train=train, media_root=spec.root(),
            )
        else:
            if tokenizer is None:
                raise ValueError(f"corpus {spec.name}: jsonl needs tokenizer")
            out[spec.name] = JsonlVideoTextDataset(
                spec.anno(), tokenizer,
                num_frames=1 if spec.media_type == "image" else num_frames,
                img_size=img_size,
                max_length=spec.max_txt_l or max_length,
                cache_dir=cache_dir, media_root=spec.root(),
                media_type=spec.media_type,
                read_audio_from_video=spec.read_audio_from_video,
            )
    return out
