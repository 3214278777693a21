"""Paged absorbed-MLA decode (K6): the Hopper CUDA kernel and its plain
version.

Counterpart of internvideo_tpu/ops/paged_decode.py:131 `paged_mla_decode`
(the Pallas `_decode_kernel` :47): one generated token per sequence attends
over its latent cache in a shared page pool, with the absorbed query
q_lat = q_nope @ W_uk and the rotated rope query q_pe. A CUDA tensor runs
the kernel (`csrc/paged_decode.cu`: in bf16 a tensor-core kernel with up
to 32 heads of a sequence in one CTA, at the serving paths' (R, P); in
fp32 a CUDA-core kernel) or raises; a CPU tensor runs the plain version, the
gather formulation of `MLAttention.decode_paged`'s XLA branch
(internvideo_tpu/nn/mla.py:441-458).
"""

from __future__ import annotations

import ctypes

import torch

from internvideo_tpu_torch.nn.paged_cache import batched_paged_gather
from internvideo_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_R = 1024  # csrc/paged_decode.cu kMaxR: 4 latent columns a thread, 256 threads
_MAX_C = _MAX_R + 128  # kMaxC: a warp holds its head's R + P query row in registers
_TILE = 16  # tokens per shared-memory tile (kTokens; the bf16 kernel's kStageTokens)
_HEADS_PER_CTA = 8
_TARGET_CTAS = 264  # two CTAs for each of the H100's 132 SMs
# The bf16 kernel (paged_decode_mma_kernel): its (R, P) instantiations, those
# of qwen3_8b_mla and of qwen3_2b_mla / internvideo25_hico_2b and the MoE
# presets, and the heads of one CTA (two m16 tiles; more heads take more CTAs)
BF16_LATENT_ROPE = ((896, 128), (512, 64))
BF16_HEADS_PER_CTA = 32
_launches = {"paged_decode": 0}


def launch_count(kernel: str = "paged_decode") -> int:
    """How many times K6 (its split pass + merge pass, counted as one) has
    been launched on the card in this process."""
    return _launches[kernel]


def reset_launch_count() -> None:
    _launches["paged_decode"] = 0


def paged_mla_decode_ref(q_lat, q_pe, pages, block_tables, seq_lens, *, softmax_scale: float):
    """Plain PyTorch version: gather each sequence's pages, fp32 scores
    (the Pallas kernel's `preferred_element_type=float32`; the JAX XLA
    branch rounds them to the model dtype first) with slots at positions >=
    seq_len set to -1e30, fp32 softmax, probabilities cast to q's dtype
    before probs . c; (B, H, R) in q's dtype. Identical to the XLA branch
    in fp32."""
    r = q_lat.shape[-1]
    cache = batched_paged_gather(pages, block_tables.long())  # (B, L, R + P)
    dt = q_lat.dtype
    c, p = cache[..., :r].to(dt), cache[..., r:].to(dt)
    scores = (torch.einsum("bhr,bsr->bhs", q_lat.float(), c.float())
              + torch.einsum("bhd,bsd->bhs", q_pe.float(), p.float())) * softmax_scale
    valid = (torch.arange(cache.shape[1], device=cache.device)[None, None, :]
             < seq_lens.to(cache.device).long()[:, None, None])
    scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dt)
    return torch.einsum("bhs,bsr->bhr", probs, c)


def split_len_for(batch: int, heads: int, max_tokens: int) -> int:
    """Tokens per CTA of the fp32 kernel's split pass: a multiple of the
    16-token tile, small enough that batch x head groups x splits reaches
    ~2 CTAs per SM."""
    groups = batch * -(-heads // _HEADS_PER_CTA)
    want = max(1, -(-_TARGET_CTAS // groups))
    return max(_TILE, -(-max(1, -(-max_tokens // want)) // _TILE) * _TILE)


def split_len_bf16(batch: int, max_tokens: int, sms: int, head_groups: int = 1) -> int:
    """Tokens per CTA of the bf16 kernel, whose CTA takes a group of up to
    32 heads of a sequence and holds its SM alone: a multiple of the
    16-token stage, as small as lets batch x head groups x splits stay
    within one CTA per SM (one wave)."""
    splits = max(1, sms // (batch * head_groups))
    return max(_TILE, -(-max(1, -(-max_tokens // splits)) // _TILE) * _TILE)


def _split_len(dtype, batch: int, heads: int, max_tokens: int, device) -> int:
    if dtype == torch.bfloat16:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        return split_len_bf16(batch, max_tokens, sms, -(-heads // BF16_HEADS_PER_CTA))
    return split_len_for(batch, heads, max_tokens)


def _paged_decode_cuda(q_lat, q_pe, pages, block_tables, seq_lens, scale: float):
    b, h, r = q_lat.shape
    p_dim = q_pe.shape[-1]
    n_pages, page_size, c = pages.shape
    dt = q_lat.dtype
    if dt not in _DTYPE_CODES or q_pe.dtype != dt or pages.dtype != dt:
        raise NotImplementedError(
            f"paged decode kernel takes float32 or bfloat16 q_lat / q_pe / pages of one "
            f"dtype, got {q_lat.dtype} / {q_pe.dtype} / {pages.dtype}")
    if q_pe.shape[:2] != (b, h) or c != r + p_dim or block_tables.shape[0] != b \
            or seq_lens.shape != (b,):
        raise ValueError(
            f"q_lat {tuple(q_lat.shape)} / q_pe {tuple(q_pe.shape)} / pages "
            f"{tuple(pages.shape)} / block_tables {tuple(block_tables.shape)} / seq_lens "
            f"{tuple(seq_lens.shape)} do not form one paged decode")
    if r > _MAX_R or c > _MAX_C or r % 4:
        raise NotImplementedError(
            f"latent rank {r} / rope dim {p_dim}: the kernel takes R <= {_MAX_R}, a multiple "
            f"of 4, and R + P <= {_MAX_C}")
    if dt == torch.bfloat16 and (r, p_dim) not in BF16_LATENT_ROPE:
        raise NotImplementedError(
            f"(R {r}, P {p_dim}) is not instantiated in the bf16 kernel of "
            f"csrc/paged_decode.cu: (R, P) in {BF16_LATENT_ROPE} (ROADMAP queue 2, K6)")
    item = pages.element_size()
    if (r * item) % 16 or (p_dim * item) % 16 or not pages.is_contiguous() \
            or pages.data_ptr() % 16:
        raise ValueError(
            "the kernel loads 16-byte chunks of the pool and the queries: pages must be "
            "contiguous and 16-byte aligned, with R * itemsize and P * itemsize multiples of "
            f"16 (pages {tuple(pages.shape)} {pages.dtype}, R {r}, P {p_dim})")
    dev = q_lat.device
    for name, x in (("q_pe", q_pe), ("pages", pages), ("block_tables", block_tables),
                    ("seq_lens", seq_lens)):
        if x.device != dev:
            raise ValueError(f"paged decode: q_lat on {dev} but {name} on {x.device}")
    q_lat, q_pe = (x.contiguous() for x in (q_lat, q_pe))
    q_lat, q_pe = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q_lat, q_pe))
    tables = block_tables.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    max_pages = tables.shape[1]
    split_len = _split_len(dt, b, h, max_pages * page_size, dev)
    n_splits = max(1, -(-(max_pages * page_size) // split_len))
    out = torch.empty((b, h, r), dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    part_acc = torch.empty((b, n_splits, h, r), dtype=torch.float32, device=dev)
    part_ml = torch.empty((b, n_splits, h, 2), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ivt_paged_decode(
            _DTYPE_CODES[dt], q_lat.data_ptr(), q_pe.data_ptr(), pages.data_ptr(),
            tables.data_ptr(), lens.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            out.data_ptr(), b, h, r, p_dim, page_size, max_pages, split_len, n_splits,
            float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: cudaError_t {rc}")
    _launches["paged_decode"] += 1
    return out


def paged_mla_decode(
    q_lat: torch.Tensor,  # (B, H, R) latent-absorbed queries
    q_pe: torch.Tensor,  # (B, H, P) rope queries (already rotated)
    pages: torch.Tensor,  # (num_pages, page_size, R + P) latent page pool
    block_tables: torch.Tensor,  # (B, max_pages) int32 page ids
    seq_lens: torch.Tensor,  # (B,) int32 valid tokens per sequence
    *,
    softmax_scale: float,
    pages_per_block: int | None = None,  # TPU DMA grouping: accepted, unused
) -> torch.Tensor:
    """-> (B, H, R) latent context per query head: K6 on CUDA tensors, the
    plain version on CPU tensors."""
    if q_lat.is_cuda:
        return _paged_decode_cuda(q_lat, q_pe, pages, block_tables, seq_lens, softmax_scale)
    if q_lat.device.type != "cpu":
        raise NotImplementedError(f"no paged decode for device {q_lat.device}")
    return paged_mla_decode_ref(q_lat, q_pe, pages, block_tables, seq_lens,
                                softmax_scale=softmax_scale)
