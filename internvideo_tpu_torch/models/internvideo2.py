"""InternVideo2 video encoder: PyTorch port.

Port of internvideo_tpu/models/internvideo2.py: reshape+GEMM tubelet
patchify, CLS token, learnable pos embed initialised from the 3D sin-cos
table, `depth` pre-norm blocks with whole-dim QK-RMSNorm and fp32
LayerScale, mean-query attention pooling to `clip_embed_dim`, then
LayerNorm + linear head when `num_classes` > 0.

Casts follow JAX: the pos embed is added after a cast to `dtype`; the CLS
token is `cls_token + pos[:1]` in `dtype`; norm weights and LayerScale
gammas stay fp32 whatever `param_dtype` is. The pooling head runs the plain
attention route, as the JAX model pins it (`attn_impl="xla"`, :278).

Training: `deterministic=False` with an explicit `generator` applies
DropPath at the linear ramp `drop_path_rate * i / (depth - 1)`; every
block's keep masks are drawn before the blocks run, so that `remat=True`
(one `torch.utils.checkpoint` per block, the JAX `nn.remat` with no policy)
recomputes each block with the mask its forward used.

Masked forward (UMT pretraining): `keep_indices` (B, n_vis) gathers a
static count of visible tokens right after the pos embed, before the CLS
token goes in front (:200-202). `return_pool_attn` also returns the pooling
head's attention over the tokens (:248-283), which the CLIP teacher hands
to attention-guided masking. `norm_type="layernorm"` builds LayerNorm
blocks (eps `norm_eps`, default 1e-6).

`quant="int8"` (serving) builds every block's qkv, proj, fc1 and fc2 as
`ops/quant.py:Int8Dense` (K7 on the card); the patch embed and the pooling
head stay dense. Its weights come from a dense model's state_dict through
`quantize_params_like`.

Not ported yet (each raises NotImplementedError; ROADMAP queue 1):
`remat_policy`, `pool_type="cls_proj"`, `ln_pre`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.utils.checkpoint
from torch import nn

from internvideo_tpu_torch.nn.dense import Dense, trunc_normal_
from internvideo_tpu_torch.nn.embeds import PatchEmbed3D, get_3d_sincos_pos_embed
from internvideo_tpu_torch.nn.norms import LayerNorm
from internvideo_tpu_torch.nn.transformer import AttentionPoolingBlock, Block, draw_keep_masks


@dataclasses.dataclass(frozen=True)
class InternVideo2Config:
    """Same fields and defaults as internvideo_tpu's InternVideo2Config."""

    embed_dim: int = 1408
    depth: int = 40
    num_heads: int = 16
    mlp_ratio: float = 48 / 11
    patch_size: int = 14
    img_size: int = 224
    num_frames: int = 8
    tubelet_size: int = 1
    qkv_bias: bool = False
    qk_normalization: bool = True
    init_values: float = 1e-5
    drop_path_rate: float = 0.0
    attn_pool_num_heads: int = 16
    clip_embed_dim: int = 768
    num_classes: int = 0  # 0 = no classifier head
    dtype: str = "float32"
    param_dtype: str = "float32"
    attn_impl: str = "auto"  # auto | kernel | plain (JAX: pallas | xla)
    norm_type: str = "rmsnorm"
    norm_eps: Optional[float] = None
    ln_pre: bool = False
    pool_type: str = "attn"
    mlp_act: str = "gelu"  # gelu | gelu_tanh | quick_gelu
    remat: bool = False
    remat_policy: Optional[str] = None
    quant: Optional[str] = None

    @property
    def grid_size(self) -> tuple[int, int, int]:
        return (
            self.num_frames // self.tubelet_size,
            self.img_size // self.patch_size,
            self.img_size // self.patch_size,
        )

    @property
    def num_patches(self) -> int:
        t, h, w = self.grid_size
        return t * h * w


INTERNVIDEO2_SIZES: dict[str, dict] = {
    "S": dict(embed_dim=384, depth=12, num_heads=6, mlp_ratio=4.0),
    "B": dict(embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0),
    "L": dict(embed_dim=1024, depth=24, num_heads=16, mlp_ratio=4.0),
    "1B": dict(embed_dim=1408, depth=40, num_heads=16, mlp_ratio=48 / 11),
    "6B": dict(embed_dim=3200, depth=48, num_heads=25, mlp_ratio=4.0),
}


def make_config(size: str, **overrides) -> InternVideo2Config:
    return InternVideo2Config(**{**INTERNVIDEO2_SIZES[size], **overrides})


@dataclasses.dataclass
class EncoderOutput:
    pooled: Optional[torch.Tensor]  # (B, clip_embed_dim) attention-pooled embedding
    logits: Optional[torch.Tensor]  # (B, num_classes) if a head is configured
    tokens: torch.Tensor  # (B, 1+N, D) final-layer hidden states
    hidden_states: Optional[tuple]  # per-layer (B, 1+N, D) when requested
    pool_attn: Optional[torch.Tensor] = None  # (B, 1+N) pooling attention


def _unported(cfg: InternVideo2Config) -> Optional[str]:
    if cfg.remat_policy is not None:
        return f"remat_policy={cfg.remat_policy!r} (ROADMAP queue 1, item 9)"
    if cfg.pool_type != "attn":
        return f"pool_type={cfg.pool_type!r} (ROADMAP queue 1, item 10: ViCLIP)"
    if cfg.ln_pre:
        return "ln_pre (ROADMAP queue 1, item 10: ViCLIP)"
    return None


class InternVideo2(nn.Module):
    def __init__(self, config: InternVideo2Config, *, device,
                 generator: torch.Generator):
        super().__init__()
        missing = _unported(config)
        if missing:
            raise NotImplementedError(f"InternVideo2: {missing} is not ported yet")
        self.config = cfg = config
        dtype = getattr(torch, cfg.dtype)
        param_dtype = getattr(torch, cfg.param_dtype)
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        d = cfg.embed_dim

        self.patch_embed = PatchEmbed3D(
            d, patch_size=cfg.patch_size, tubelet_size=cfg.tubelet_size, **kw)
        self.cls_token = nn.Parameter(
            torch.empty(1, 1, d, dtype=param_dtype, device=device))
        gt, gh, _ = cfg.grid_size
        pos = get_3d_sincos_pos_embed(d, gh, gt, cls_token=True)
        self.pos_embed = nn.Parameter(
            torch.from_numpy(pos).to(device=device, dtype=param_dtype))
        self.drop_path_rates = [cfg.drop_path_rate * i / max(cfg.depth - 1, 1)
                                for i in range(cfg.depth)]
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
                  qk_normalization=cfg.qk_normalization,
                  init_values=cfg.init_values, drop_path=rate,
                  attn_impl=cfg.attn_impl, mlp_act=cfg.mlp_act,
                  norm_type=cfg.norm_type, norm_eps=cfg.norm_eps, quant=cfg.quant, **kw)
            for rate in self.drop_path_rates
        )
        # single-query attention: the plain route, as the JAX model pins it
        self.clip_projector = AttentionPoolingBlock(
            d, cfg.attn_pool_num_heads, cfg.clip_embed_dim, attn_impl="plain", **kw)
        if cfg.num_classes:
            self.fc_norm = LayerNorm(cfg.clip_embed_dim, eps=1e-5, dtype=dtype,
                                     device=device)
            self.head = Dense(cfg.clip_embed_dim, cfg.num_classes,
                              init_std=0.02 * 0.001, **kw)
        else:
            self.fc_norm = self.head = None
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init in module order: truncated-normal Dense weights
        (std 0.02; lecun for the patch projection; 2e-5 for the head), zero
        biases, truncated-normal(0.02) CLS token. Norms, gammas and the
        pos embed keep their constructor values."""
        trunc_normal_(self.cls_token, 0.02, generator)
        for m in self.modules():
            if isinstance(m, Dense):
                m.init_weights(generator)

    def forward(
        self,
        video: torch.Tensor,  # (B, T, H, W, 3) channels-last
        *,
        keep_indices: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        return_hidden_states: bool = False,
        return_hidden_layers: Optional[Sequence[int]] = None,
        return_pool_attn: bool = False,
        with_pool: bool = True,
    ) -> EncoderOutput:
        """`keep_indices`: (B, n_vis) visible positions in [0, N); only
        those tokens enter the blocks. `generator` draws the DropPath masks;
        it is needed when not `deterministic` and `drop_path_rate` > 0, and
        lives on the video's device. `with_pool=False` skips the pooling head
        and the classifier (`pooled` and `logits` None) for a caller that
        reads only the tokens (the InternVL compose)."""
        cfg = self.config
        dtype = self.dtype
        x = self.patch_embed(video)  # (B, T', L, D)
        b = x.shape[0]
        x = x.reshape(b, -1, cfg.embed_dim)
        pos = self.pos_embed
        x = x + pos[1:].to(dtype)
        if keep_indices is not None:
            x = torch.gather(x, 1, keep_indices.long()[..., None].expand(-1, -1, cfg.embed_dim))
        cls = (self.cls_token.to(dtype) + pos[:1].to(dtype)).expand(b, 1, cfg.embed_dim)
        x = torch.cat([cls, x], dim=1)

        keep = [None] * cfg.depth
        if not deterministic and cfg.drop_path_rate > 0:
            if generator is None:
                raise ValueError("drop_path_rate > 0 in training needs a generator")
            keep = draw_keep_masks(self.drop_path_rates, b, generator)
        hidden = []
        for i, blk in enumerate(self.blocks):
            if cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    blk, x, deterministic, keep[i], use_reentrant=False,
                    preserve_rng_state=False)
            else:
                x = blk(x, deterministic, keep[i])
            if return_hidden_states or (
                return_hidden_layers and i in return_hidden_layers
            ):
                hidden.append(x)

        pool_attn = None
        if not with_pool:
            return EncoderOutput(pooled=None, logits=None, tokens=x,
                                 hidden_states=tuple(hidden) if hidden else None)
        if return_pool_attn:
            pooled, pool_attn = self.clip_projector(x, return_attn=True)
        else:
            pooled = self.clip_projector(x)
        logits = None
        if self.head is not None:
            logits = self.head(self.fc_norm(pooled))
        return EncoderOutput(
            pooled=pooled,
            logits=logits,
            tokens=x,
            hidden_states=tuple(hidden) if hidden else None,
            pool_attn=pool_attn,
        )
