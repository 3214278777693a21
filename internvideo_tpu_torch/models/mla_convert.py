"""Dense GQA / MQA attention -> M2LA latent attention weight conversion.

Port of internvideo_tpu/models/mla_convert.py. The transform:

  * per-head split: the last `qk_rope_head_dim` dims of each dense K / Q
    head are the rotary branch, the first `qk_nope_head_dim` the content
    branch;
  * the per-q-head K-nope and V up-projections (GQA groups expanded) are
    factorized together by a truncated SVD,
        W_kv (D, H (nope + v)) ~ kv_a_nope (D, R) @ kv_b (R, H (nope + v)),
    exact when R >= rank(W_kv), a least-squares compression below it;
  * the shared rotary key is the mean of the per-KV-head rotary branches
    (exact for MQA, Hkv == 1);
  * K / V biases become a constant latent offset, solved by least squares
    against kv_b (exact at full rank).

The linear algebra runs in numpy, as JAX's does, so the two give the same
bits; inputs are torch tensors or numpy arrays (fp32 or fp64), outputs are
the MLAttention param tree of torch tensors (`params_from_jax` maps it to
the port's state_dict). The config is the port's `nn/mla.py:MLAConfig`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from internvideo_tpu_torch.nn.mla import MLAConfig


def _np(a) -> Optional[np.ndarray]:
    if a is None:
        return None
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def dense_gqa_to_mla(w_q, w_k, w_v, w_o, cfg: MLAConfig, *, b_q=None, b_k=None, b_v=None,
                     b_o=None, rank: Optional[int] = None) -> dict:
    """w_q (D, Hq, hd) per head [nope | rope], w_k (D, Hkv, hd), w_v (D,
    Hkv, v), w_o (Hq * v, D); optional biases b_q (Hq, hd), b_k (Hkv, hd),
    b_v (Hkv, v), b_o (D,) -> {"params": MLAttention tree}."""
    w_q, w_k, w_v, w_o = (_np(a) for a in (w_q, w_k, w_v, w_o))
    b_q, b_k, b_v, b_o = (_np(a) for a in (b_q, b_k, b_v, b_o))
    d, hq, hd = w_q.shape
    _, hkv, _ = w_k.shape
    nope, rope, vdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    if nope + rope != hd:
        raise ValueError(f"qk_nope({nope}) + qk_rope({rope}) must equal the dense head "
                         f"dim ({hd})")
    if vdim != w_v.shape[-1]:
        raise ValueError("v_head_dim mismatch")
    if hq % hkv:
        raise ValueError("Hq must be a multiple of Hkv")
    group = hq // hkv
    r = rank or cfg.kv_lora_rank

    # expand GQA groups to per-q-head K-nope / V up-projections
    k_nope = np.repeat(w_k[..., :nope], group, axis=1)  # (D, Hq, nope)
    v_exp = np.repeat(w_v, group, axis=1)  # (D, Hq, v)
    w_kv = np.concatenate([k_nope, v_exp], axis=-1).reshape(d, hq * (nope + vdim))
    u, s, vt = np.linalg.svd(w_kv, full_matrices=False)
    r_eff = min(r, s.shape[0])
    kv_a_nope = u[:, :r_eff] * s[:r_eff]  # (D, r_eff)
    kv_b_flat = vt[:r_eff]  # (r_eff, Hq (nope + v))
    if r_eff < r:  # pad latent channels up to the configured rank
        kv_a_nope = np.pad(kv_a_nope, ((0, 0), (0, r - r_eff)))
        kv_b_flat = np.pad(kv_b_flat, ((0, r - r_eff), (0, 0)))
    kv_b = kv_b_flat.reshape(r, hq, nope + vdim)

    # shared rotary key: the mean over KV heads (exact for MQA)
    w_kpe = w_k[..., nope:].mean(axis=1)  # (D, rope)
    kv_a_kernel = np.concatenate([kv_a_nope, w_kpe], axis=1)  # (D, r + rope)

    kv_a_bias = None
    if b_k is not None or b_v is not None:
        bk = b_k if b_k is not None else np.zeros((hkv, hd), w_k.dtype)
        bv = b_v if b_v is not None else np.zeros((hkv, vdim), w_v.dtype)
        t = np.concatenate([np.repeat(bk[:, :nope], group, 0), np.repeat(bv, group, 0)],
                           axis=-1).reshape(-1)  # (Hq (nope + v),)
        c = np.linalg.lstsq(kv_b.reshape(r, -1).T, t, rcond=None)[0]  # c @ kv_b ~ t
        kv_a_bias = np.concatenate([c, bk[:, nope:].mean(axis=0)])

    q = {"kernel": _t(w_q.reshape(d, hq * hd))}
    if b_q is not None:
        q["bias"] = _t(b_q.reshape(-1))
    kv_a = {"kernel": _t(kv_a_kernel)}
    if kv_a_bias is not None:
        kv_a["bias"] = _t(kv_a_bias)
    o = {"kernel": _t(w_o)}
    if b_o is not None:
        o["bias"] = _t(b_o)
    return {"params": {"q_proj": q, "kv_a_proj_with_mqa": kv_a, "kv_b_proj_kernel": _t(kv_b),
                       "o_proj": o}}


def mla_rank_for_exact(cfg: MLAConfig, hidden_size: int, num_heads: int) -> int:
    """Smallest latent rank at which the SVD factorization is lossless."""
    return min(hidden_size, num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim))
