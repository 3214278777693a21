"""The port's multiprocess decode workers vs the JAX package.

`default_collate` of nested samples equals JAX's; WorkerPool's batches
equal JAX's WorkerPool's on the same dataset, ordered, with forked workers,
in-process with a ragged last batch, on a resumed StatefulIterator's index
stream, and in parallel (the 0.2 s items of different workers overlap in
time); then the whole host pipeline, WorkerPool -> prefetch_to_device ->
the port's Trainer on the finetune engine, on the CPU.
"""

import os
import time

import numpy as np
import torch

from internvideo_tpu.data.workers import WorkerPool as JWorkerPool
from internvideo_tpu.data.workers import default_collate as jax_collate
from internvideo_tpu_torch.data.loader import StatefulIterator, prefetch_to_device
from internvideo_tpu_torch.data.workers import WorkerPool, default_collate


class _Dataset:
    def __len__(self):
        return 20

    def __getitem__(self, i):
        return {"x": np.full((3,), i, np.float32), "idx": np.int32(i),
                "pair": (np.int32(i), np.zeros((1,)) + i)}


def _equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_default_collate_matches_jax():
    items = [{"a": np.ones((2,)) * i, "b": (np.int32(i), np.zeros((1,))), "c": [1.5, i]}
             for i in range(3)]
    _equal(default_collate(items), jax_collate(items))
    out = default_collate(items)
    assert out["a"].shape == (3, 2) and out["b"][1].shape == (3, 1)


def test_worker_pool_matches_jax():
    ds = _Dataset()
    for kw, indices in ((dict(batch_size=4, num_workers=2, prefetch=2), None),
                        (dict(batch_size=6, num_workers=0, drop_last=False), None),
                        (dict(batch_size=2, num_workers=2), [5, 3, 9, 1])):
        got = list(WorkerPool(ds, **kw).iterate(indices))
        want = list(JWorkerPool(ds, **kw).iterate(indices))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    ragged = list(WorkerPool(ds, batch_size=6, num_workers=0, drop_last=False).iterate())
    assert [len(b["idx"]) for b in ragged] == [6, 6, 6, 2]


def test_worker_pool_resumes_a_stateful_index_stream():
    ds = _Dataset()
    full = StatefulIterator(len(ds), seed=3)
    it = iter(full)
    want = [next(it) for _ in range(12)]
    first = StatefulIterator(len(ds), seed=3)
    it = iter(first)
    head = [next(it) for _ in range(4)]
    resumed = StatefulIterator(len(ds), seed=3)
    resumed.load_state_dict(first.state_dict())
    it = iter(resumed)
    tail = (next(it) for _ in range(8))
    batches = list(WorkerPool(ds, batch_size=4, num_workers=2).iterate(tail))
    got = head + np.concatenate([b["idx"] for b in batches]).tolist()
    assert got == want


class _SlowDataset(_Dataset):
    def __getitem__(self, i):
        t0 = time.time()
        time.sleep(0.2)
        return {"idx": np.int32(i), "pid": np.int64(os.getpid()), "t0": np.float64(t0),
                "t1": np.float64(time.time())}


def test_worker_pool_forks_and_runs_in_parallel():
    batches = list(WorkerPool(_SlowDataset(), batch_size=5, num_workers=4,
                              prefetch=4).iterate())
    np.testing.assert_array_equal(np.concatenate([b["idx"] for b in batches]), np.arange(20))
    spans = [(float(b["t0"][j]), float(b["t1"][j]), int(b["pid"][j]))
             for b in batches for j in range(len(b["pid"]))]
    assert os.getpid() not in {p for *_, p in spans}  # decoded in child processes
    overlaps = sum(1 for i, (s1, e1, p1) in enumerate(spans) for (s2, e2, p2) in spans[i + 1:]
                   if p1 != p2 and s1 < e2 and s2 < e1)
    assert overlaps >= 5, (overlaps, spans[:4])


class _VideoDs:
    def __len__(self):
        return 32

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return {"video": rng.normal(size=(2, 28, 28, 3)).astype(np.float32),
                "label": np.int32(i % 5)}


def test_worker_pool_to_trainer_pipeline():
    """WorkerPool decode -> prefetch_to_device -> the port's Trainer.fit on
    the finetune engine, as the JAX test drives its Trainer."""
    from internvideo_tpu_torch.core.mesh import MeshConfig
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2, InternVideo2Config
    from internvideo_tpu_torch.train.engines.finetune import FinetuneConfig, make_finetune_step
    from internvideo_tpu_torch.train.optim import OptimizerConfig
    from internvideo_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = InternVideo2Config(embed_dim=32, depth=1, num_heads=2, mlp_ratio=2.0, patch_size=14,
                             img_size=28, num_frames=2, tubelet_size=1, clip_embed_dim=16,
                             num_classes=5, attn_impl="xla")
    model = InternVideo2(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(
        TrainerConfig(total_steps=4, log_every=2,
                      mesh=MeshConfig(replica=1, fsdp=-1, seq=1, tensor=1),
                      optimizer=OptimizerConfig(lr=1e-3, total_steps=4)),
        model,
        lambda grad_accum=1: make_finetune_step(FinetuneConfig(mixup=None, num_classes=5),
                                                grad_accum=grad_accum))
    logged = []
    trainer.metrics.print_fn = logged.append
    pool = WorkerPool(_VideoDs(), batch_size=8, num_workers=2, prefetch=2)
    trainer.fit(prefetch_to_device(pool.iterate(), torch.device("cpu")), steps=4)
    assert trainer.state.step == 4 and len(logged) == 2
