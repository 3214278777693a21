"""The kernel shapes the InternVL / Intern-S1 compose adds, on the card:
K1's forward (csrc/flash_fwd.cu, body in flash_fwd_causal.cu) and K4a's dq
and dk/dv (csrc/flash_bwd.cu, bodies in flash_bwd_causal_{dq,dkv}.cu) at
head dim 128, the InternViT-6B tower's (25 heads, S 1025 at 448 px); and
K5 / K8's backward (csrc/flash_bwd_causal_{dq,dkv}.cu) at (d_qk, d_v) =
(128, 64), `qwen3_moe_text`'s, with and without segments; each against its
plain PyTorch version in fp32 and bf16.

Needs an NVIDIA GPU with nvcc (the kernels have no CPU mode), so every test
here is marked `cuda` and skips without a card. The file imports neither
jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_internvl_kernels_cuda.py -m cuda
"""

import pytest
import torch

from internvideo_tpu_torch.ops import flash_attention as fa


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _grads(fn, q, k, v, do):
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves)
    return [out.detach(), *torch.autograd.grad(out, leaves, do)]


def _check(got, want, dtype, case):
    """out within 2e-5 and grads within 5e-4 in fp32; rel-L2 <= 1e-2 each
    in bf16."""
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, atol=2e-5 if name == "out" else 5e-4, rtol=0,
                                       msg=f"{case} {name}")
        else:
            assert torch.isfinite(a).all() and _rel(a, w) <= 1e-2, (case, name, _rel(a, w))


# (B, S, H): the tower's S 1025 (a 1-row last query tile) at its 25 heads,
# a ragged S, and the 64-key stages' edges
K1_CASES = [(1, 1025, 25), (2, 1025, 3), (1, 777, 2), (2, 129, 2), (1, 65, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_k4a_at_head_dim_128(dtype):
    """K1's out and LSE and K4a's dq / dk / dv at d 128, q / k / v views of
    one projection as the tower makes them, held to the plain forward and
    backward (the backward on the kernel's own out and LSE); one launch of
    each kernel a call."""
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(0)
    for b, s, h in K1_CASES:
        qkv = torch.randn(b, s, 3 * h * 128, device="cuda", generator=g).to(dt)
        q, k, v = (x.unflatten(-1, (h, 128)) for x in qkv.split(h * 128, dim=-1))
        do = torch.randn(b, s, h, 128, device="cuda", generator=g).to(dt)
        before = {n: fa.launch_count(n) for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out, lse = fa.flash_attention_with_lse(*leaves)
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        assert all(fa.launch_count(n) == c + 1 for n, c in before.items())
        ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, 128 ** -0.5)
        want = fa.flash_attention_bwd_ref(q, k, v, out.detach(), lse.detach(), do, 128 ** -0.5)
        _check([out.detach(), *grads], [ref, *want], dt, (b, s, h))
        torch.testing.assert_close(lse, ref_lse, atol=2e-5 if dt == torch.float32 else 1e-2,
                                   rtol=0, msg=str((b, s, h)))


def _segments(b, s):
    """Rows of 2-3 segments and a tail of pads (-1)."""
    ids = torch.full((b, s), -1, dtype=torch.int32)
    for r in range(b):
        lens = [s // 2, s // 4 - 7 * r, s // 8 + 5 * r][:3 - r % 2]
        ids[r, :sum(lens)] = torch.repeat_interleave(torch.arange(len(lens), dtype=torch.int32),
                                                     torch.tensor(lens))
    return ids.cuda()


# (B, S, H): the prefill's 32 heads, a ragged S, the 128-row / 64-key edges
K5_CASES = [(2, 1024, 32), (2, 333, 4), (1, 129, 2), (1, 65, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_k8_backward_at_128_64(dtype, segments):
    """K5's dq and dk/dv (with segments: K8's) at (d_qk, d_v) = (128, 64),
    causal, k / v strided views of one projection as MLAttention makes them,
    against autograd through the plain forward; one launch of each a call."""
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(1)
    tag = "_seg" if segments else ""
    for b, s, h in K5_CASES:
        q = torch.randn(b, s, h, 128, device="cuda", generator=g).to(dt)
        kv = torch.randn(b, s, h, 192, device="cuda", generator=g).to(dt)
        k, v = kv[..., :128], kv[..., 128:]
        do = torch.randn(b, s, h, 64, device="cuda", generator=g).to(dt)
        seg = _segments(b, s) if segments else None
        kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
        names = (f"flash_bwd_causal_dq{tag}", f"flash_bwd_causal_dkv{tag}")
        before = {n: fa.launch_count(n) for n in names}
        got = _grads(lambda q, k, v: fa.flash_attention(q, k, v, **kw), q, k, v, do)
        torch.cuda.synchronize()
        assert all(fa.launch_count(n) == c + 1 for n, c in before.items())
        ref_out, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, 128 ** -0.5, True, 0, seg,
                                                           seg)
        want = [ref_out, *fa.flash_attention_bwd_ref(q, k, v, ref_out, ref_lse, do, 128 ** -0.5,
                                                     causal=True, q_segment_ids=seg,
                                                     kv_segment_ids=seg)]
        _check(got, want, dt, (b, s, h, segments))
