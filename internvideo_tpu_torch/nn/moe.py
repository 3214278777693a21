"""Mixture-of-Experts: top-k router + single-device expert dispatch.

Port of internvideo_tpu/nn/moe.py:

  * `route_tokens`: the greedy softmax router (Qwen3-MoE / GPT-OSS) and
    the DeepSeek-V3 sigmoid NoAux router (correction bias for the choice
    only, node-limited groups, `router_scaling_factor`);
  * `moe_act`: SwiGLU, or GPT-OSS's clipped SwiGLU;
  * `MoEMlp` with two dispatches:
      - "dropless": a stable sort of the (token, slot) pairs by expert, one
        GEMM per projection for each expert's contiguous group of rows
        (`grouped_experts`; the group sizes are read to the host once a
        call), then an inverse permutation to (N, k, D) and a sum over k,
        so the k slots of a token add in a fixed order;
      - "capacity": choice-major positions in each expert's capacity
        max(int(cf * n * k / e), 1); slots past it drop; the experts run as
        batched products over (E, capacity, D).
    `expert_bias` (GPT-OSS), `num_shared_experts` (DeepSeek-V3), the
    Switch aux loss (0 under bias balancing), `expert_load` and
    `dropped_fraction`;
  * `update_router_bias` (the DeepSeek-V3 bias step).

The router runs in `router_dtype` (float32) on float32 parameters even in
a bf16 model; the expert stacks are kept in `param_dtype`, in the JAX
layout (E, D, I) / (E, I, D), and cast to `dtype` for the products. The
expert products are plain torch on both devices, as the JAX package leaves
`ragged_dot` / `einsum` to XLA: the module holds no kernel.
`dispatch="dropless_ep"` (expert parallelism) is not ported (ROADMAP
queue 1, item 8b).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from internvideo_tpu_torch.nn.dense import Dense, trunc_normal_


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    intermediate_size: int = 1024
    capacity_factor: float = 1.25
    router_bias_balancing: bool = False  # DeepSeek-V3 style
    aux_loss_weight: float = 0.01
    router_dtype: str = "float32"
    # "capacity" | "dropless" | "dropless_ep" (not ported: item 8b)
    dispatch: str = "capacity"
    ep_buffer_factor: float = 2.0
    # "softmax": greedy router; "sigmoid": the DeepSeek-V3 NoAux router
    scoring_func: str = "softmax"
    router_scaling_factor: float = 1.0  # multiplies the final gates
    norm_topk_prob: bool = True  # normalize gates over the chosen k
    # node-limited routing: each token uses experts of its topk_group best
    # groups (group score = the sum of its top-2 choice scores)
    n_group: int = 1
    topk_group: int = 1
    # always-on shared experts: one SwiGLU of num_shared * intermediate_size
    num_shared_experts: int = 0
    # "swiglu" or GPT-OSS's "clipped_swiglu"
    act_fn: str = "swiglu"
    clip_alpha: float = 1.702
    clip_limit: float = 7.0
    # per-expert biases on the three projections (GPT-OSS)
    expert_bias: bool = False


@dataclasses.dataclass
class MoEOutput:
    output: torch.Tensor
    aux_loss: torch.Tensor  # load-balancing loss (0 under bias balancing)
    expert_load: torch.Tensor  # (E,) fraction of (token, slot) pairs per expert
    dropped_fraction: torch.Tensor  # 0 for dropless; capacity overflow otherwise


def route_tokens(router_logits: torch.Tensor, cfg: MoEConfig,
                 router_bias: Optional[torch.Tensor] = None):
    """(N, E) logits -> (top_idx (N, k) int64, top_gate (N, k), router_weights
    (N, E)); router_weights is the per-expert distribution of the balancing
    loss. JAX nn/moe.py:94-155, tie order included: top-k sorted by value."""
    e, k = cfg.num_experts, cfg.top_k
    n = router_logits.shape[0]
    if cfg.scoring_func == "sigmoid":
        scores = torch.sigmoid(router_logits)
        choice = scores
        if router_bias is not None:
            choice = choice + router_bias.detach()[None, :]
        if cfg.n_group > 1 and cfg.topk_group < cfg.n_group:
            g = cfg.n_group
            if e % g:
                raise ValueError(f"num_experts {e} % n_group {g} != 0")
            cg = choice.reshape(n, g, e // g)
            group_scores = cg.topk(min(2, e // g), dim=-1).values.sum(-1)  # (N, g)
            gidx = group_scores.topk(cfg.topk_group, dim=-1).indices
            gmask = torch.zeros(n, g, dtype=torch.bool, device=cg.device).scatter_(1, gidx, True)
            choice = torch.where(gmask[..., None], cg, 0.0).reshape(n, e)
        top_idx = choice.topk(k, dim=-1).indices
        top_gate = scores.gather(-1, top_idx)
        if cfg.norm_topk_prob and k > 1:
            top_gate = top_gate / (top_gate.sum(-1, keepdim=True) + 1e-20)
        top_gate = top_gate * cfg.router_scaling_factor
        router_weights = choice / choice.sum(-1, keepdim=True).clamp(min=1e-20)
        return top_idx, top_gate, router_weights

    probs = torch.softmax(router_logits, dim=-1)
    scores = router_logits
    if router_bias is not None:
        scores = scores + router_bias.detach()[None, :]
    top_idx = scores.topk(k, dim=-1).indices
    top_gate = probs.gather(-1, top_idx)
    if cfg.norm_topk_prob:
        top_gate = top_gate / top_gate.sum(-1, keepdim=True).clamp(min=1e-9)
    top_gate = top_gate * cfg.router_scaling_factor
    return top_idx, top_gate, probs


def moe_act(cfg: MoEConfig, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SwiGLU, or GPT-OSS's clipped SwiGLU: gate clamped above, up clamped
    both sides, and the (up + 1) form."""
    if cfg.act_fn == "clipped_swiglu":
        gate = gate.clamp(max=cfg.clip_limit)
        up = up.clamp(-cfg.clip_limit, cfg.clip_limit)
        return (up + 1.0) * (gate * torch.sigmoid(cfg.clip_alpha * gate))
    if cfg.act_fn != "swiglu":
        raise ValueError(f"unknown act_fn {cfg.act_fn}")
    return F.silu(gate) * up


def grouped_experts(cfg: MoEConfig, xs: torch.Tensor, sizes: list, w_gate, w_up, w_down,
                    biases=None) -> torch.Tensor:
    """The expert MLP of rows `xs` (M, D) sorted by expert, `sizes[e]` rows
    for expert e: one product per projection for each non-empty group
    (JAX's `ragged_dot`), with each expert's (b_gate, b_up, b_down) when
    `biases` is given. -> (M, D)."""
    d_out = w_down.shape[-1]
    if torch.is_grad_enabled():
        # One unbind of each stack (and one split of the rows, below): their
        # backwards write every expert's gradient into one tensor, where an
        # index or slice per expert gives each a zero-filled gradient of the
        # whole tensor for autograd to sum.
        w_gate, w_up, w_down = (w.unbind(0) for w in (w_gate, w_up, w_down))
        if biases is not None:
            biases = tuple(b.unbind(0) for b in biases)
    parts = []
    for ei, rows in enumerate(xs.split(sizes)):
        if rows.shape[0] == 0:
            continue
        h, u = rows @ w_gate[ei], rows @ w_up[ei]
        if biases is not None:
            h, u = h + biases[0][ei], u + biases[1][ei]
        y = moe_act(cfg, h, u) @ w_down[ei]
        parts.append(y if biases is None else y + biases[2][ei])
    if not parts:
        return xs.new_zeros((0, d_out))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


class MoEMlp(nn.Module):
    """(B, S, D) -> MoEOutput. Parameters: `router.weight` (E, D) float32,
    `w_gate` / `w_up` (E, D, I) and `w_down` (E, I, D) in param_dtype; with
    `expert_bias` `b_gate` / `b_up` (E, I) and `b_down` (E, D); with shared
    experts `shared_{gate,up,down}_proj.weight` (the JAX names)."""

    def __init__(self, cfg: MoEConfig, hidden_size: int, *, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if cfg.dispatch not in ("capacity", "dropless", "dropless_ep"):
            raise ValueError(f"unknown dispatch {cfg.dispatch!r}")
        if cfg.dispatch == "dropless_ep":
            raise NotImplementedError(
                "dispatch='dropless_ep' (expert parallelism over a mesh) is not ported yet "
                "(ROADMAP queue 1, item 8b); use 'dropless' or 'capacity' on one device")
        self.cfg, self.dtype = cfg, dtype
        e, d, i = cfg.num_experts, hidden_size, cfg.intermediate_size
        rdt = getattr(torch, cfg.router_dtype)
        self.router = Dense(d, e, bias=False, dtype=rdt, param_dtype=torch.float32,
                            device=device)

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=param_dtype, device=device))

        self.w_gate, self.w_up, self.w_down = param(e, d, i), param(e, d, i), param(e, i, d)
        if cfg.expert_bias:
            self.b_gate, self.b_up, self.b_down = param(e, i), param(e, i), param(e, d)
        if cfg.num_shared_experts > 0:
            i_sh = i * cfg.num_shared_experts
            kw = dict(bias=False, dtype=dtype, param_dtype=param_dtype, device=device)
            self.shared_gate_proj = Dense(d, i_sh, **kw)
            self.shared_up_proj = Dense(d, i_sh, **kw)
            self.shared_down_proj = Dense(i_sh, d, **kw)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Truncated normal (std 0.02) everywhere, biases included (JAX's
        initialisers); the stacks one expert at a time, so the fp32 sample
        buffer stays one expert's size."""
        self.router.init_weights(generator)
        stacks = [self.w_gate, self.w_up, self.w_down]
        if self.cfg.expert_bias:
            stacks += [self.b_gate, self.b_up, self.b_down]
        for w in stacks:
            for row in w:
                trunc_normal_(row, 0.02, generator)
        if self.cfg.num_shared_experts > 0:
            for d in (self.shared_gate_proj, self.shared_up_proj, self.shared_down_proj):
                d.init_weights(generator)

    def _biases(self):
        if not self.cfg.expert_bias:
            return None
        return tuple(b.to(self.dtype) for b in (self.b_gate, self.b_up, self.b_down))

    def _dropless(self, xt, top_idx, top_gate, w_gate, w_up, w_down):
        n, d = xt.shape
        k = self.cfg.top_k
        flat_e = top_idx.reshape(-1)  # (N k,) expert of each slot
        order = torch.argsort(flat_e, stable=True)  # ties keep token order
        sizes = torch.bincount(flat_e, minlength=self.cfg.num_experts).tolist()
        xs = xt[order // k]  # (N k, D) sorted by expert
        ys = grouped_experts(self.cfg, xs, sizes, w_gate, w_up, w_down, self._biases())
        gate_sorted = top_gate.reshape(-1)[order]
        weighted = (ys * gate_sorted[:, None]).to(ys.dtype)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.numel(), device=order.device)
        out = weighted[inv].reshape(n, k, d).sum(1)
        return out, torch.zeros((), dtype=torch.float32, device=xt.device)

    def _capacity(self, xt, top_idx, top_gate, w_gate, w_up, w_down):
        cfg = self.cfg
        n, d = xt.shape
        e, k = cfg.num_experts, cfg.top_k
        cap = max(int(cfg.capacity_factor * n * k / e), 1)
        # choice-major positions: every token's 1st choice ranks before any
        # token's 2nd (JAX nn/moe.py:259-272)
        onehot = F.one_hot(top_idx, e)  # (N, k, E)
        flat = onehot.transpose(0, 1).reshape(n * k, e)
        pos = (torch.cumsum(flat, 0) * flat - 1).amax(-1).reshape(k, n).t()  # (N, k)
        keep = pos < cap
        combine_w = torch.where(keep, top_gate, 0.0)
        safe_pos = torch.where(keep, pos, cap - 1).reshape(-1)
        expert = top_idx.reshape(-1)
        src = torch.where(keep.reshape(-1, 1), xt.repeat_interleave(k, 0), 0.0)
        disp = xt.new_zeros((e, cap, d)).index_put((expert, safe_pos), src, accumulate=True)
        h, u = torch.bmm(disp, w_gate), torch.bmm(disp, w_up)
        biases = self._biases()
        if biases is not None:
            h, u = h + biases[0][:, None, :], u + biases[1][:, None, :]
        out_e = torch.bmm(moe_act(cfg, h, u), w_down)
        if biases is not None:
            out_e = out_e + biases[2][:, None, :]
        gathered = out_e[expert, safe_pos].reshape(n, k, d)
        out = (gathered * combine_w[..., None]).sum(1)
        return out, 1.0 - keep.float().mean()

    def forward(self, x: torch.Tensor, router_bias: Optional[torch.Tensor] = None) -> MoEOutput:
        cfg = self.cfg
        b, s, d = x.shape
        n = b * s
        e, k = cfg.num_experts, cfg.top_k
        xt = x.reshape(n, d)
        router_logits = self.router(xt.to(getattr(torch, cfg.router_dtype)))  # (N, E)
        top_idx, top_gate, router_weights = route_tokens(router_logits, cfg, router_bias)
        dt = self.dtype
        w_gate, w_up, w_down = (w.to(dt) for w in (self.w_gate, self.w_up, self.w_down))
        dispatch = self._dropless if cfg.dispatch == "dropless" else self._capacity
        out, dropped = dispatch(xt, top_idx, top_gate, w_gate, w_up, w_down)
        if cfg.num_shared_experts > 0:
            sh = self.shared_down_proj(moe_act(cfg, self.shared_gate_proj(xt),
                                               self.shared_up_proj(xt)))
            out = out + sh.to(out.dtype)
        # Switch load-balancing loss: E * sum_e f_e * p_e
        load = torch.bincount(top_idx.reshape(-1), minlength=e).float() / n / k
        if cfg.router_bias_balancing:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            aux = cfg.aux_loss_weight * e * (load * router_weights.mean(0)).sum()
        return MoEOutput(output=out.reshape(b, s, d).to(x.dtype), aux_loss=aux,
                         expert_load=load, dropped_fraction=dropped.float())


def update_router_bias(router_bias: torch.Tensor, expert_load: torch.Tensor, *,
                       speed: float = 1e-3) -> torch.Tensor:
    """DeepSeek-V3 no-aux-loss balancing: overloaded experts (load above the
    mean) get their bias lowered, underloaded raised, by a fixed speed."""
    err = expert_load.mean() - expert_load
    return router_bias + speed * torch.sign(err)
