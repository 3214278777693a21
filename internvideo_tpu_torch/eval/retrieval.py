"""Video-text retrieval evaluation: PyTorch port.

Port of internvideo_tpu/eval/retrieval.py, the two-stage protocol of the
reference (multi_modality/tasks/retrieval_utils.py):

  1. dual-encoder stage: every video and every text through its tower in
     batches, the ITC matrix of the l2-normalised projections (optionally
     rescaled by the dual softmax, DSL);
  2. cross-encoder rerank: each video's top-k texts (and each text's top-k
     videos) through the fusion layers, the ITM positive-class margin added
     to the ITC score; -100 elsewhere;
  3. `itm_eval`: R@1/5/10 and median / mean rank in both directions.

The post-processing is the JAX module's numpy, line for line (:65-151,
:154-205). What differs: the token embeddings stay where the towers left
them (torch tensors, on the card) and the rerank gathers its pairs there,
instead of a host round-trip; the projections go to numpy as float32 (the
JAX module keeps a bf16 model's projections in ml_dtypes bf16, which numpy
alone has no type for). The tail-chunk padding of `_encode_in_batches` and
`_rerank_rows` only kept TPU compiles to one program, so it is dropped: each
row's scores do not depend on the rest of its batch. `shard_hosts=True`
raises: host sharding waits for the distributed port (ROADMAP queue 1,
item 8).

`encode_video(batch)` / `encode_text(batch)` take a dict of numpy slices and
return (token embeddings, projection) tensors; `rerank_score(vis_embeds,
txt_embeds, txt_mask)` takes the gathered pair tensors and the texts'
(n, L) numpy mask and returns the (n,) ITM margins.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _encode_in_batches(encode_fn, data: dict, batch_size: int):
    """(token embeddings concatenated as a tensor, projections as float32
    numpy) over `data`'s leading axis in chunks of `batch_size`."""
    n = next(iter(data.values())).shape[0]
    embeds, projs = [], []
    for s in range(0, n, batch_size):
        tokens, proj = encode_fn({k: v[s:s + batch_size] for k, v in data.items()})
        embeds.append(tokens)
        projs.append(proj.float().cpu().numpy())
    return torch.cat(embeds), np.concatenate(projs)


def retrieval_evaluation(
    *,
    encode_video: Callable,  # {video} -> (vision_embeds, vision_proj)
    encode_text: Callable,  # {input_ids, attention_mask} -> (text_embeds, text_proj)
    rerank_score: Optional[Callable],  # (vis_embeds, txt_embeds, txt_mask) -> itm margin
    videos: dict,  # {"video": (Nv, ...)}
    texts: dict,  # {"input_ids": (Nt, L), "attention_mask": (Nt, L)}
    batch_size: int = 32,
    k_test: int = 16,
    rerank_batch: int = 32,
    shard_hosts: bool = False,
    dsl: bool = False,  # dual-softmax (retrieval_utils.py:283-287)
):
    """Returns (score_v2t, score_t2v) as numpy (Nv, Nt) / (Nt, Nv) matrices."""
    if shard_hosts:
        raise NotImplementedError(
            "shard_hosts: rerank rows sharded across hosts are not ported yet "
            "(ROADMAP queue 1, item 8)")
    vis_embeds, vis_proj = _encode_in_batches(encode_video, videos, batch_size)
    txt_embeds, txt_proj = _encode_in_batches(encode_text, texts, batch_size)

    v = vis_proj / np.linalg.norm(vis_proj, axis=-1, keepdims=True)
    t = txt_proj / np.linalg.norm(txt_proj, axis=-1, keepdims=True)
    itc = v @ t.T  # (Nv, Nt)

    if dsl:
        # dual-softmax: rescale each score by its column-softmax mass; both
        # directions derive from the v2t matrix, as the reference does
        def _sm0(m):
            e = np.exp(m - m.max(axis=0, keepdims=True))
            return e / e.sum(axis=0, keepdims=True)

        itc_t2v = itc.T * _sm0(itc.T)
        itc = itc * _sm0(itc)
        if rerank_score is None:
            return itc, itc_t2v
        itc_t = itc_t2v  # the rerank base is the DSL-rescaled t2v
    else:
        itc_t = itc.T

    if rerank_score is None:
        return itc, itc_t

    nv, nt = itc.shape
    k = min(k_test, nt)
    kv = min(k_test, nv)
    mask_arr = np.asarray(texts["attention_mask"])

    score_v2t = np.full_like(itc, -100.0)
    topk_v = _topk_idx(itc, k)  # (Nv, k)
    itm = _rerank_rows(rerank_score, vis_embeds, txt_embeds, mask_arr, topk_v, rerank_batch)
    rows = np.arange(nv)[:, None]
    score_v2t[rows, topk_v] = itc[rows, topk_v] + itm

    score_t2v = np.full_like(itc_t, -100.0)
    topk_t = _topk_idx(itc_t, kv)
    itm = _rerank_rows(
        lambda t_rep, v_cand, m_rep: rerank_score(v_cand, t_rep, m_rep),
        txt_embeds, vis_embeds, None, topk_t, rerank_batch, row_masks=mask_arr)
    rows = np.arange(nt)[:, None]
    score_t2v[rows, topk_t] = itc_t[rows, topk_t] + itm
    return score_v2t, score_t2v


def _topk_idx(scores: np.ndarray, k: int) -> np.ndarray:
    return np.argpartition(-scores, kth=k - 1, axis=1)[:, :k]


def _rerank_rows(fn, row_feats, cand_feats, cand_masks, topk, rerank_batch,
                 *, row_masks=None) -> np.ndarray:
    """Pair each row with its top-k candidates and score them in batches of
    whole row groups (max(1, rerank_batch // k) rows a batch); the (n, k)
    ITM margins as float32 numpy."""
    n, k = topk.shape
    rows_per = max(1, rerank_batch // k)
    itm = np.zeros((n, k), np.float32)
    for s in range(0, n, rows_per):
        rows = np.arange(s, min(s + rows_per, n))
        idx = topk[rows].reshape(-1)
        a = torch.repeat_interleave(row_feats[torch.as_tensor(rows, device=row_feats.device)],
                                    k, dim=0)
        b = cand_feats[torch.as_tensor(idx, device=cand_feats.device)]
        if row_masks is not None:  # t2v: the mask belongs to the text row
            m = np.repeat(row_masks[rows], k, axis=0)
        else:  # v2t: the mask belongs to the text candidate
            m = cand_masks[idx]
        out = fn(a, b, m)
        itm[rows] = np.asarray(torch.as_tensor(out).float().cpu()).reshape(len(rows), k)
    return itm


def itm_eval(
    score_v2t: np.ndarray,  # (Nv, Nt)
    score_t2v: np.ndarray,  # (Nt, Nv)
    gt_txt_ids,  # (Nv,) or list[list[int]]: matching text ids per video
    gt_vid_ids,  # (Nt,): matching video id per text
) -> dict:
    """R@1/5/10 + median / mean rank, both directions (retrieval_utils.py:1243)."""

    def ranks(scores, gts):
        out = np.zeros(scores.shape[0])
        for i, row in enumerate(scores):
            order = np.argsort(-row)
            gt = gts[i]
            gt = [gt] if np.isscalar(gt) else list(np.atleast_1d(gt))
            out[i] = min(np.where(order == g)[0][0] for g in gt)
        return out

    r_v2t = ranks(score_v2t, gt_txt_ids)
    r_t2v = ranks(score_t2v, gt_vid_ids)

    def metrics(r, prefix):
        return {
            f"{prefix}_r1": 100.0 * float(np.mean(r < 1)),
            f"{prefix}_r5": 100.0 * float(np.mean(r < 5)),
            f"{prefix}_r10": 100.0 * float(np.mean(r < 10)),
            f"{prefix}_mdR": float(np.median(r) + 1),
            f"{prefix}_meanR": float(np.mean(r) + 1),
        }

    out = {**metrics(r_v2t, "v2t"), **metrics(r_t2v, "t2v")}
    out["r_mean"] = (
        out["v2t_r1"] + out["v2t_r5"] + out["v2t_r10"]
        + out["t2v_r1"] + out["t2v_r5"] + out["t2v_r10"]
    ) / 6
    return out
