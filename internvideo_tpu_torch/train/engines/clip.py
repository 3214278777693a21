"""Stage-2 VideoCLIP losses and train step (VTC + VTM + MLM [+ UTA]).

Port of internvideo_tpu/train/engines/clip.py (`make_clip_train_step`):

  * VTC: softmax-CE over the batch's similarity with idx-based soft targets
    (same-idx pairs are positives), both directions;
  * VTM: one negative per row drawn from the masked similarity (hard: in
    proportion to softmax; soft: uniformly), a fusion pass over 3B rows
    (positive, negative video, negative text) and a 2-way CE on itm_head;
  * MLM: BERT 80/10/10 corruption (pad and CLS never masked), the
    multimodal pass and CE on the masked positions;
  * UTA (with `uta` > 0): the frozen CLIP teacher on the clip, the shared
    keep draw (data/masking.py), the masked student and 2 - 2 cos against
    the teacher's tokens at CLS + keep + 1 and its pooled output.

`make_av_clip_train_step` / `av_clip_loss` (JAX :318-401) train the
audio-visual VideoCLIPAV as one media type a step ("video", "audio",
"audio_video"): the same VTC + VTM + MLM on the media's tokens.

`clip_loss` is one micro-batch's loss. Every random draw can be passed in
(the parity tests pass the JAX draws); the rest come from `generator`, in
this order: the keep indices (UTA only), the model's forward (tower
DropPath, text dropout), the VTM negatives (text then video), the VTM
fusion dropout, the MLM corruption (selection, kind, random ids), the MLM
pass's dropout. JAX splits its key into independent streams instead, which
torch cannot reproduce: only the draws' distributions match.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from internvideo_tpu_torch.models.videoclip_av import MEDIA_TYPES
from internvideo_tpu_torch.train.engines.pretrain import _align_loss, draw_keep_indices
from internvideo_tpu_torch.train.step import make_accum_step

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class CLIPLossConfig:
    """Same fields and defaults as internvideo_tpu's CLIPLossConfig."""

    vtc: float = 1.0
    vtm: float = 1.0
    mlm: float = 1.0
    vtm_hard_neg: bool = True
    mlm_probability: float = 0.5
    mask_token_id: int = 103  # [MASK] for bert-base vocabs
    pad_token_id: int = 0
    cls_token_id: int = 101
    vocab_size: int = 30522
    # stage-2 UTA: needs the pretrain student as the tower and a frozen
    # CLIP teacher passed to make_clip_train_step
    uta: float = 0.0
    mask_type: str = "attention"  # attention | tube | random
    mask_ratio: float = 0.8
    clip_loss_ratio: tuple[float, float] = (1.0, 1.0)  # (middle, final)
    distill_final_features: bool = True


def get_sim(vision_proj: torch.Tensor, text_proj: torch.Tensor, temp=1.0, agg: str = "mean"):
    """(sim_v2t, sim_t2v) of l2-normed features over temp; vision (B, C) or
    per-frame (B, T, C), aggregated over frames by mean or max."""
    v = vision_proj / torch.linalg.vector_norm(vision_proj.float(), dim=-1, keepdim=True)
    t = text_proj / torch.linalg.vector_norm(text_proj.float(), dim=-1, keepdim=True)
    if v.dim() == 3:
        s = torch.einsum("mld,nd->mln", v, t) / temp
        s = s.mean(1) if agg == "mean" else s.max(1).values
        return s, s.T
    s = v @ t.T / temp
    return s, s.T


def _positives(idx: Optional[torch.Tensor], n: int, device=None) -> torch.Tensor:
    """(n, n) bool: the pairs that count as positives (the diagonal, or
    under `idx` every pair of the same idx)."""
    if idx is None:
        return torch.eye(n, dtype=torch.bool, device=device)
    return idx[:, None] == idx[None, :]


def _idx_targets(idx: Optional[torch.Tensor], n: int, device=None) -> torch.Tensor:
    """Soft targets: the positives, row-normalised."""
    m = _positives(idx, n, device).float()
    return m / m.sum(1, keepdim=True)


def vtc_loss(vision_proj, text_proj, idx, temp, agg: str = "mean") -> torch.Tensor:
    sim_v2t, sim_t2v = get_sim(vision_proj, text_proj, temp, agg)
    targets = _idx_targets(idx, sim_v2t.shape[0], sim_v2t.device).detach()
    l_v2t = -(torch.log_softmax(sim_v2t, dim=1) * targets).sum(1).mean()
    l_t2v = -(torch.log_softmax(sim_t2v, dim=1) * targets).sum(1).mean()
    return (l_v2t + l_t2v) / 2


@torch.no_grad()
def mine_negatives(generator: torch.Generator, vision_proj, text_proj, idx, temp, hard: bool):
    """(vis_neg, txt_neg): per-row negative indices for VTM, never a
    positive (the same row, or under `idx` the same idx). Hard: drawn in
    proportion to softmax of the masked similarity; soft: the argmax of
    masked normal noise."""
    sim_v2t, sim_t2v = get_sim(vision_proj, text_proj, temp)
    n = sim_v2t.shape[0]
    pos = _positives(idx, n, sim_v2t.device)

    def draw(sim):
        if hard:
            probs = torch.softmax(sim.float().masked_fill(pos, NEG), dim=1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]
        noise = torch.randn((n, n), generator=generator, device=sim.device)
        return noise.masked_fill(pos, NEG).argmax(1)

    txt_neg = draw(sim_v2t)
    return draw(sim_t2v), txt_neg


def mlm_corrupt(generator: torch.Generator, input_ids: torch.Tensor, cfg: CLIPLossConfig):
    """BERT 80/10/10 corruption: (corrupted ids, labels), labels -100 on
    positions left alone; pad and CLS are never selected."""
    shape, dev = input_ids.shape, input_ids.device
    special = (input_ids == cfg.pad_token_id) | (input_ids == cfg.cls_token_id)
    masked = (torch.rand(shape, generator=generator, device=dev) < cfg.mlm_probability) & ~special
    labels = torch.where(masked, input_ids, torch.full_like(input_ids, -100))
    u = torch.rand(shape, generator=generator, device=dev)
    rand_ids = torch.randint(0, cfg.vocab_size, shape, generator=generator, device=dev,
                             dtype=input_ids.dtype)
    out = torch.where(masked & (u < 0.8), torch.full_like(input_ids, cfg.mask_token_id),
                      input_ids)
    out = torch.where(masked & (u >= 0.8) & (u < 0.9), rand_ids, out)
    return out, labels


def mlm_loss_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    valid = labels != -100
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = torch.gather(logp, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    return -(picked * valid).sum() / valid.sum().clamp_min(1)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel at a = -0.5 on |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) fp32 weights of one axis of `jax.image.resize(method=
    "bicubic")` (antialiased: the kernel widens by n_in / n_out when
    shrinking; columns renormalised; samples outside the input zeroed)."""
    inv_scale = 1.0 / (n_out / n_in)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs()
    w = _keys_cubic(x / max(inv_scale, 1.0))
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bicubic(video: torch.Tensor, size: int) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, size, size, C) as jax.image.resize(...,
    method="bicubic") computes it (F.interpolate's bicubic uses a = -0.75
    and no antialiasing, and differs)."""
    h, w = video.shape[2:4]
    out = video
    if h != size:
        out = torch.einsum("bthwc,hH->btHwc", out, _resize_weights(h, size, video.device)
                           .to(video.dtype))
    if w != size:
        out = torch.einsum("bthwc,wW->bthWc", out, _resize_weights(w, size, video.device)
                           .to(video.dtype))
    return out


@torch.no_grad()
def teacher_targets(teacher, video: torch.Tensor):
    """The frozen CLIP teacher on `video`, resized to its img_size when the
    clip's differs: (z (K, B, 1+N, C), pooled (B, C'), attn (B*T, N))."""
    size = teacher.config.img_size
    if video.shape[2] != size:
        video = resize_bicubic(video, size)
    return teacher(video)


def _check(cfg: CLIPLossConfig, teacher) -> None:
    if cfg.uta > 0 and teacher is None:
        raise ValueError("cfg.uta > 0 needs a frozen CLIP teacher")
    if cfg.mlm and max(cfg.mask_token_id, cfg.cls_token_id) >= cfg.vocab_size:
        raise ValueError(
            f"vocab_size={cfg.vocab_size} does not cover the special ids "
            f"(mask={cfg.mask_token_id}, cls={cfg.cls_token_id})")


def clip_loss(model, cfg: CLIPLossConfig, batch: dict, *, keep=None, vis_neg=None,
              txt_neg=None, corrupted=None, mlm_labels=None,
              generator: Optional[torch.Generator] = None, teacher=None,
              deterministic: bool = False):
    """(loss, aux) of one micro-batch {"video", "input_ids",
    "attention_mask", optional "idx"} for a VideoCLIP `model`; aux holds
    `loss_vtc`, `loss_vtm`, `loss_mlm` (each when its weight is set) and
    `loss_uta` (when `uta` > 0). Draws not passed come from `generator` in
    the module docstring's order."""
    _check(cfg, teacher)
    video, ids, mask = batch["video"], batch["input_ids"], batch["attention_mask"]
    idx = batch.get("idx")
    losses = {}
    tgt_middle = tgt_final = None
    if cfg.uta > 0:
        z, tgt_final, attn = teacher_targets(teacher, video)
        if keep is None:
            keep = draw_keep_indices(cfg, generator, attn, video.shape[0], video.shape[1])
        keep = keep.long()
        gather = torch.cat([torch.zeros_like(keep[:, :1]), keep + 1], dim=1)
        tgt_middle = torch.gather(
            z, 2, gather[None, :, :, None].expand(z.shape[0], -1, -1, z.shape[-1]))
    out = model(video, ids, mask, keep_indices=keep, deterministic=deterministic,
                generator=generator)

    if cfg.uta > 0:
        loss_mid = _align_loss(out.clip_middle, tgt_middle)
        if cfg.distill_final_features and cfg.clip_loss_ratio[1] > 0:
            loss_fin = _align_loss(out.clip_final, tgt_final)
        else:
            loss_fin = torch.zeros((), device=video.device)
        losses["loss_uta"] = (loss_mid * cfg.clip_loss_ratio[0]
                              + loss_fin * cfg.clip_loss_ratio[1])

    losses.update(_text_media_losses(model, cfg, out, ids, mask, idx, vis_neg=vis_neg,
                                     txt_neg=txt_neg, corrupted=corrupted,
                                     mlm_labels=mlm_labels, generator=generator,
                                     deterministic=deterministic))
    return _total(cfg, losses), losses


def _total(cfg: CLIPLossConfig, losses: dict):
    """The weighted sum of the loss terms present."""
    return (cfg.uta * losses.get("loss_uta", 0.0) + cfg.vtc * losses.get("loss_vtc", 0.0)
            + cfg.vtm * losses.get("loss_vtm", 0.0) + cfg.mlm * losses.get("loss_mlm", 0.0))


def _text_media_losses(model, cfg: CLIPLossConfig, out, ids, mask, idx, *, vis_neg, txt_neg,
                       corrupted, mlm_labels, generator, deterministic: bool) -> dict:
    """VTC, VTM and MLM (each when its weight is set) of a model's output
    `out` (a VideoCLIPOutput: media tokens as `vision_embeds`, their
    projection as `vision_proj`); draws not passed come from `generator`."""
    losses = {}
    if cfg.vtc:
        losses["loss_vtc"] = vtc_loss(out.vision_proj, out.text_proj, idx, out.temp)

    if cfg.vtm:
        if vis_neg is None or txt_neg is None:
            vis_neg, txt_neg = mine_negatives(generator, out.vision_proj, out.text_proj, idx,
                                              out.temp, cfg.vtm_hard_neg)
        b = out.vision_embeds.shape[0]
        ve, te = out.vision_embeds, out.text_embeds
        vis_all = torch.cat([ve, ve[vis_neg], ve], dim=0)
        txt_all = torch.cat([te, te, te[txt_neg]], dim=0)
        mask_all = torch.cat([mask, mask, mask[txt_neg]], dim=0)
        fused = model.fusion(txt_all, mask_all, vis_all, deterministic=deterministic,
                             generator=generator)
        logits = model.itm_logits(fused.pooled).float()
        labels = torch.cat([torch.ones(b, dtype=torch.long, device=logits.device),
                            torch.zeros(2 * b, dtype=torch.long, device=logits.device)])
        losses["loss_vtm"] = -torch.log_softmax(logits, dim=-1)[
            torch.arange(3 * b, device=logits.device), labels].mean()

    if cfg.mlm:
        if corrupted is None or mlm_labels is None:
            corrupted, mlm_labels = mlm_corrupt(generator, ids, cfg)
        mlm_out = model.text_multimodal(corrupted, mask, out.vision_embeds,
                                        deterministic=deterministic, generator=generator)
        losses["loss_mlm"] = mlm_loss_from_logits(mlm_out.mlm_logits, mlm_labels)
    return losses


def make_clip_train_step(cfg: CLIPLossConfig, teacher=None, *, grad_accum: int = 1):
    """step(state, batch) -> metrics for a VideoCLIP model; batch
    {"video", "input_ids", "attention_mask", "idx"}. With `uta` > 0,
    `teacher` is the frozen CLIP teacher (train/state.py `frozen_teacher`)
    on the model's device. Each micro-batch draws from a generator on the
    video's device seeded by the train state."""
    _check(cfg, teacher)

    def loss_fn(model, batch, seed: int):
        gen = torch.Generator(device=batch["video"].device).manual_seed(seed)
        return clip_loss(model, cfg, batch, generator=gen, teacher=teacher)

    return make_accum_step(loss_fn, grad_accum=grad_accum)


def av_clip_loss(model, cfg: CLIPLossConfig, media_type: str, batch: dict, *, vis_neg=None,
                 txt_neg=None, corrupted=None, mlm_labels=None,
                 generator: Optional[torch.Generator] = None, deterministic: bool = False):
    """(loss, aux) of one micro-batch for a VideoCLIPAV `model` trained as
    `media_type` ("video", "audio" or "audio_video"): the media's tokens
    and projection in place of the tower's, then VTC + VTM + MLM as in
    `clip_loss` (`uta` does not apply). batch: {"input_ids",
    "attention_mask", optional "idx", and "video" and / or "audio" as the
    media type needs}; other keys (the audio padding mask) are ignored, as
    in JAX. Draws not passed come from `generator` in this order: the
    model's forward (tower DropPath, text dropout), the VTM negatives, the
    VTM fusion dropout, the MLM corruption, the MLM pass's dropout."""
    _check(dataclasses.replace(cfg, uta=0.0), None)
    ids, mask = batch["input_ids"], batch["attention_mask"]
    out = model(ids, mask, video=batch.get("video"), audio=batch.get("audio"),
                media_type=media_type, deterministic=deterministic, generator=generator)
    losses = _text_media_losses(model, cfg, out, ids, mask, batch.get("idx"), vis_neg=vis_neg,
                                txt_neg=txt_neg, corrupted=corrupted, mlm_labels=mlm_labels,
                                generator=generator, deterministic=deterministic)
    return _total(cfg, losses), losses


def make_av_clip_train_step(cfg: CLIPLossConfig, media_type: str = "audio_video", *,
                            grad_accum: int = 1):
    """step(state, batch) -> metrics for a VideoCLIPAV model and ONE media
    type, as JAX's `make_av_clip_train_step` (one step per media type; a
    MetaLoader schedule picks which to call). Each micro-batch draws from a
    generator on the batch's device seeded by the train state."""
    _check(dataclasses.replace(cfg, uta=0.0), None)
    if media_type not in MEDIA_TYPES:
        raise ValueError(f"unknown media_type {media_type!r}; one of {MEDIA_TYPES}")

    def loss_fn(model, batch, seed: int):
        gen = torch.Generator(device=batch["input_ids"].device).manual_seed(seed)
        return av_clip_loss(model, cfg, media_type, batch, generator=gen)

    return make_accum_step(loss_fn, grad_accum=grad_accum)
