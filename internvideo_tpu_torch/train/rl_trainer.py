"""RL trainer: rollout <-> GRPO-train alternation with a replay buffer.

Port of internvideo_tpu/train/rl_trainer.py (the counterpart of xtuner's
RLTrainer, InternVideo3_sft/xtuner/v1/train/rl_trainer.py:122, alternating
`_rollout_step` :510 and `_train_step` :534). The rollouts run the same
`nn.Module` the trainer updates, so the reference's trainer -> rollout
weight synchronisation, which JAX reduces to a pointer swap, is nothing
here.

Two rollout backends, as in JAX:

  * compiled (default): prefill, then `max_new_tokens - 1` sample-decode
    steps over the model's dense cache, a Python loop over the model's
    `prefill` / `decode_step` (the JAX `lax.scan`). Decode attends on the
    plain route, as the JAX models' decode does. The port keeps the JAX
    loop's semantics (:183-209), so that its greedy rollout is
    token-identical to JAX's: the scan emits the token it feeds, so the
    response is [t0, t0, t1, ..., t_{T-2}] (the first sampled token twice,
    the last sample dropped), and the decode at step s writes cache entry
    lp + s, so entry lp stays unwritten (zeros);
  * `ServingEngine` (pass `engine=`): continuous batching over the paged
    pool (serve/engine.py) with `temperature > 0`, and video prompts for a
    VideoMLLM policy. The engine must serve this very model at the
    trainer's rollout temperature.

Loop per iteration:
  1. rollout: each prompt is repeated `group_size` times and sampled; the
     behaviour log-probs are recorded teacher-forced under the rollout-time
     weights (exact trainer numerics);
  2. reward: the host `reward_fn(prompt_ids, response_ids) -> float`;
  3. advantages: group-relative normalisation (GRPO);
  4. train: `ppo_epochs` GRPO updates over the buffer, with optional
     minibatches and mask-weighted grad accumulation that equals the
     unaccumulated update, and a k3 KL against a frozen copy of the initial
     policy (made only when `kl_beta > 0`).

The trainer runs on its model's device. The replay buffer holds tensors on
that device; only the sampled tokens come to the host, for `reward_fn`
and the eos mask. The log-probs' full-vocab head runs over chunks of one
microbatch's rows (the trunk over the whole batch), so the fp32 logits of
a whole rollout batch never exist at once; per row it is the same
computation. Sampling draws from a `torch.Generator` on the model's
device, seeded by `fit(seed=)` and saved with checkpoints; its draws
differ from `jax.random`'s, greedy tokens do not. Mesh training
(`mesh=`, `param_shardings=`) is not ported (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from internvideo_tpu_torch.core.checkpoint import CheckpointManager
from internvideo_tpu_torch.train.rl import (
    GRPOConfig,
    group_relative_advantages,
    grpo_policy_loss,
    token_logprobs,
)
from internvideo_tpu_torch.train.state import TrainState


@dataclasses.dataclass(frozen=True)
class RLTrainerConfig:
    grpo: GRPOConfig = GRPOConfig()
    max_new_tokens: int = 16
    rollout_temperature: float = 1.0
    ppo_epochs: int = 1
    lr: float = 1e-3
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0  # pads ragged engine responses to max_new_tokens
    cache_dtype: str = "float32"
    # PPO minibatching: rows per optimizer update (None = the whole rollout
    # batch in one update); must divide the rollout batch
    minibatch_size: Optional[int] = None
    # microbatches per update whose gradients combine mask-weighted, so the
    # accumulated update equals the unaccumulated one (token-mean loss)
    grad_accum: int = 1


class ReplayBuffer:
    """Rollout storage (xtuner dataflow / replay equivalent): batches of
    tensors on the trainer's device."""

    def __init__(self):
        self.items: list[dict[str, torch.Tensor]] = []

    def add(self, batch: dict[str, torch.Tensor]):
        self.items.append(batch)

    def drain(self) -> list[dict[str, torch.Tensor]]:
        out, self.items = self.items, []
        return out

    def __len__(self):
        return len(self.items)


def sequence_logprobs(model, full_ids: torch.Tensor, video=None,
                      head_rows: Optional[int] = None) -> torch.Tensor:
    """(B, L) ids -> (B, L - 1) fp32 next-token log-probs under `model`
    (JAX `_logp_fn` :211-219): the trunk over the whole batch, then the
    full-vocab head and `token_logprobs` over chunks of `head_rows` rows
    (default: all), which gives each row the same numbers."""
    if video is not None:
        hidden = model(full_ids, video, with_logits=False).hidden
    else:
        hidden = model(full_ids, with_logits=False).hidden
    rows = head_rows or full_ids.shape[0]
    return torch.cat([
        token_logprobs(model._head(hidden[r:r + rows, :-1]), full_ids[r:r + rows, 1:])
        for r in range(0, full_ids.shape[0], rows)])


class RLTrainer:
    """model: a language model with `forward(..., with_logits=)`,
    `init_cache` / `prefill` / `decode_step` / `embed` and `_head`
    (models/llm.MLATransformer, models/llm_gqa.GQATransformer), or a
    VideoMLLM (video prompts need `engine=`), on its device; its parameters
    are the policy, updated in place. reward_fn runs on the host.

    optimizer: a factory `params -> torch.optim.Optimizer`; default
      torch's fused Adam at `cfg.lr` (optax.adam's update, JAX :128).
    engine: an optional serve.ServingEngine built on this very model, at
      temperature == cfg.rollout_temperature.
    """

    def __init__(
        self,
        model,
        cfg: RLTrainerConfig,
        reward_fn: Callable[[np.ndarray, np.ndarray], float],
        optimizer: Optional[Callable] = None,
        *,
        mesh=None,
        param_shardings=None,
        engine=None,
    ):
        if mesh is not None or param_shardings is not None:
            raise NotImplementedError(
                "mesh RL training (sharded rollout / logp / update) is not ported yet "
                "(ROADMAP queue 1, item 8)")
        if engine is not None:
            if engine.model is not model:
                raise ValueError("the engine must serve the trainer's model (engine.model is "
                                 "not model)")
            if abs(engine.temperature - cfg.rollout_temperature) > 1e-9:
                raise ValueError(
                    f"engine.temperature ({engine.temperature}) must match "
                    f"cfg.rollout_temperature ({cfg.rollout_temperature})")
        self.model, self.cfg, self.reward_fn, self.engine = model, cfg, reward_fn, engine
        self.device = model.device
        params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer = (optimizer(params) if optimizer is not None
                          else torch.optim.Adam(params, lr=cfg.lr, fused=True))
        # frozen reference policy for the KL penalty: the initial weights
        self.ref_model = None
        if cfg.grpo.kl_beta > 0:
            self.ref_model = copy.deepcopy(model).requires_grad_(False)
        self.buffer = ReplayBuffer()
        self._iter = 0  # fit() iteration counter (checkpoint / resume state)
        self._gen: Optional[torch.Generator] = None  # set by fit(); saved with checkpoints

    # ---- rollout -----------------------------------------------------------

    def _sample(self, logits, generator):
        logits = logits[:, -1].float()
        if self.cfg.rollout_temperature > 0:
            probs = torch.softmax(logits / self.cfg.rollout_temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]
        return logits.argmax(dim=-1)

    @torch.no_grad()
    def _rollout(self, prompt_ids: torch.Tensor, generator) -> torch.Tensor:
        """(B, Lp) prompts -> (B, T) sampled tokens over the dense cache."""
        cfg, model = self.cfg, self.model
        b, lp = prompt_ids.shape
        caches = model.init_cache(b, lp + cfg.max_new_tokens, getattr(torch, cfg.cache_dtype))
        out = model.prefill(model.embed(prompt_ids), caches)
        first = self._sample(out.logits, generator)
        token, emitted = first, []
        for step in range(1, cfg.max_new_tokens):  # the JAX scan's body
            out = model.decode_step(token[:, None], caches, lp + step)
            emitted.append(token)  # the scan emits its input token
            token = self._sample(out.logits, generator)
        return torch.stack([first] + emitted, dim=1)

    def _engine_rollout(self, expanded: np.ndarray, videos):
        """Submit every (prompt, video) sample to the ServingEngine, drain,
        pad ragged (eos-truncated) responses to max_new_tokens with
        pad_token_id; returns (tokens (N, T), lengths (N,)) on the host."""
        cfg, eng = self.cfg, self.engine
        eng.reset()
        rids = [eng.submit(expanded[i], cfg.max_new_tokens,
                           video=None if videos is None else videos[i])
                for i in range(expanded.shape[0])]
        outs = eng.run()
        gen = np.full((expanded.shape[0], cfg.max_new_tokens), cfg.pad_token_id, np.int64)
        lengths = np.zeros(expanded.shape[0], np.int64)
        for i, rid in enumerate(rids):
            toks = outs[rid]
            gen[i, :len(toks)] = toks
            lengths[i] = len(toks)
        return gen, lengths

    def _head_rows(self, rows: int) -> int:
        """Rows of one microbatch of a `rows`-row rollout batch."""
        return max(1, (self.cfg.minibatch_size or rows) // max(1, self.cfg.grad_accum))

    def rollout_step(self, prompt_ids, generator: Optional[torch.Generator] = None,
                     videos=None) -> dict:
        """Repeat prompts x group_size, sample, judge, store in the buffer.

        prompt_ids: (P, Lp) integers. videos: optional (P, T, H, W, 3) pixels
        aligned with the prompts (VideoMLLM policies; needs `engine=`).
        Returns summary metrics (mean reward)."""
        cfg = self.cfg
        g = cfg.grpo.group_size
        prompt_ids = np.asarray(prompt_ids)
        p, lp = prompt_ids.shape
        expanded = np.repeat(prompt_ids, g, axis=0).astype(np.int64)  # (P*G, Lp)
        vid = None
        if videos is not None:
            if self.engine is None:
                raise ValueError("video prompts need the ServingEngine rollout backend "
                                 "(pass engine=)")
            vid = torch.as_tensor(np.asarray(videos), device=self.device)
            vid = vid.repeat_interleave(g, dim=0)
        lengths = None
        if self.engine is not None:
            gen, lengths = self._engine_rollout(expanded, vid)
            gen_t = torch.from_numpy(gen).to(self.device)
        else:
            gen_t = self._rollout(torch.from_numpy(expanded).to(self.device), generator)
            gen = gen_t.cpu().numpy()

        # response mask over next-token slots (L - 1): slot i predicts
        # full_ids[i + 1], so responses start at lp - 1; truncated after the
        # first eos (inclusive). Engine responses carry their true lengths.
        t = gen.shape[1]
        mask = np.zeros((p * g, lp + t - 1), np.float32)
        for row in range(p * g):
            end = t if lengths is None else int(lengths[row])
            if lengths is None and cfg.eos_token_id is not None:
                hits = np.nonzero(gen[row] == cfg.eos_token_id)[0]
                if hits.size:
                    end = int(hits[0]) + 1
            mask[row, lp - 1:lp - 1 + end] = 1.0

        full_ids = torch.cat([torch.from_numpy(expanded).to(self.device), gen_t], dim=1)
        with torch.no_grad():
            logp_old = sequence_logprobs(self.model, full_ids, vid,
                                         self._head_rows(full_ids.shape[0]))
        rewards = np.asarray([self.reward_fn(prompt_ids[row // g], gen[row])
                              for row in range(p * g)], np.float32)
        advantages = group_relative_advantages(torch.from_numpy(rewards), g, cfg.grpo.adv_eps)
        batch = {"full_ids": full_ids, "logp_old": logp_old,
                 "advantages": advantages.to(self.device),
                 "mask": torch.from_numpy(mask).to(self.device)}
        if vid is not None:
            batch["video"] = vid
        self.buffer.add(batch)
        return {"reward_mean": float(rewards.mean())}

    # ---- update ------------------------------------------------------------

    def _loss_of(self, batch: dict):
        """(loss, metrics) of one (micro)batch: the policy's log-probs with
        autograd, then the frozen reference's without (JAX `_loss_of`
        :230-247)."""
        video = batch.get("video")
        logp = sequence_logprobs(self.model, batch["full_ids"], video)
        logp_ref = None
        if self.ref_model is not None:
            with torch.no_grad():
                logp_ref = sequence_logprobs(self.ref_model, batch["full_ids"], video)
        return grpo_policy_loss(logp, batch["logp_old"], batch["advantages"], batch["mask"],
                                self.cfg.grpo, logp_ref=logp_ref)

    def train_step(self) -> dict:
        """ppo_epochs GRPO updates over the drained buffer; with
        `minibatch_size` each rollout batch takes one optimizer update per
        minibatch (PPO minibatching)."""
        cfg = self.cfg
        batches = self.buffer.drain()
        metrics = {}
        for _ in range(cfg.ppo_epochs):
            for b in batches:
                rows = b["full_ids"].shape[0]
                mb = cfg.minibatch_size or rows
                if rows % mb:
                    raise ValueError(f"minibatch_size {mb} must divide the rollout batch {rows}")
                for start in range(0, rows, mb):
                    metrics = self._minibatch_update(
                        {k: v[start:start + mb] for k, v in b.items()})
        return metrics

    def _minibatch_update(self, sub: dict) -> dict:
        """One optimizer update from `sub`, over `grad_accum` microbatches:
        each backpropagates its token-mean loss times its raw mask sum, and
        the summed gradients are divided by the minibatch's mask sum (floor
        1) before the step, which equals the whole minibatch's gradient
        (JAX `_grads_fn` / `_apply_fn` :249-274). A zero-mask microbatch adds
        nothing."""
        cfg = self.cfg
        rows = sub["full_ids"].shape[0]
        if rows % cfg.grad_accum:
            raise ValueError(f"grad_accum {cfg.grad_accum} must divide the minibatch {rows}")
        micro = rows // cfg.grad_accum
        self.optimizer.zero_grad(set_to_none=True)
        if cfg.grad_accum <= 1:
            loss, m = self._loss_of(sub)
            loss.backward()
            self.optimizer.step()
            return {k: float(v.detach()) for k, v in dict(m, loss=loss).items()}
        acc, total = None, 0.0
        for start in range(0, rows, micro):
            mb = {k: v[start:start + micro] for k, v in sub.items()}
            loss, m = self._loss_of(mb)
            denom = mb["mask"].sum()
            (loss * denom).backward()
            scaled = {k: v.detach() * denom for k, v in dict(m, loss=loss).items()}
            acc = scaled if acc is None else {k: acc[k] + v for k, v in scaled.items()}
            total = total + denom
        td = max(float(total), 1.0)
        with torch.no_grad():
            torch._foreach_div_([p.grad for p in self.model.parameters() if p.grad is not None],
                                td)
        self.optimizer.step()
        return {k: float(v) / td for k, v in acc.items()}

    # ---- checkpoint / resume (reference rl_trainer.py resume machinery) ----

    def _state(self) -> TrainState:
        if self._gen is None:
            self._gen = torch.Generator(self.device).manual_seed(0)
        return TrainState(step=self._iter, model=self.model, optimizer=self.optimizer,
                          generator=self._gen)

    def save_checkpoint(self, directory: str):
        """Save the whole RL state (weights, optimizer, iteration, sampling
        generator) so that a killed run resumes mid-schedule."""
        CheckpointManager(directory).save(self._iter, self._state(), force=True)

    def restore_checkpoint(self, directory: str) -> bool:
        """Restore the latest checkpoint in `directory`; True if one was
        found. The frozen KL reference is not part of the state: it is the
        initial policy, rebuilt by the caller the same way on every run."""
        state = CheckpointManager(directory).restore(self._state())
        if state is None:
            return False
        self._iter = state.step
        return True

    def fit(self, prompt_batches, iterations: int, *, seed: int = 0,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0):
        """Alternate rollout / train (rl_trainer.py fit :652). prompt_batches:
        callable(i) -> (P, Lp) prompts, or (prompts, videos) for VideoMLLM
        policies, for iteration i. Returns the history.

        With checkpoint_dir set, resumes from the latest checkpoint there
        (same iteration counter and sampling stream) and saves every
        `checkpoint_every` iterations and at the end."""
        history = []
        if self._gen is None:
            self._gen = torch.Generator(self.device).manual_seed(seed)
        saved_at = None
        if checkpoint_dir and self.restore_checkpoint(checkpoint_dir):
            saved_at = self._iter
        while self._iter < iterations:
            i = self._iter
            batch = prompt_batches(i)
            videos = None
            if isinstance(batch, tuple):
                batch, videos = batch
            r = self.rollout_step(np.asarray(batch), self._gen, videos=videos)
            m = self.train_step()
            history.append({**r, **m, "iter": i})
            self._iter = i + 1
            if checkpoint_dir and checkpoint_every and self._iter % checkpoint_every == 0:
                self.save_checkpoint(checkpoint_dir)
                saved_at = self._iter
        if checkpoint_dir and saved_at != self._iter:
            self.save_checkpoint(checkpoint_dir)
        return history
