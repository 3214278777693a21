"""The CUDA small-S attention kernels (K2 forward, K4b dq and dk/dv) vs
their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with nvcc (the kernels have no CPU mode), so every test
here is marked `cuda` and skips without a card. The file imports neither
jax nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_small_s_kernel_cuda.py -m cuda
"""

import pytest
import torch

from internvideo_tpu_torch.ops import flash_attention as fa

# (B, Sq, Sk, H, D): the pretrain family at the student's head dim, the
# CLIP teacher's head dim 128, a ragged Sq != Sk, a single query row and
# the student's S = 833 (ragged against every tile).
SHAPES = [
    (2, 205, 205, 4, 88),
    (1, 413, 413, 8, 88),
    (2, 257, 257, 4, 128),
    (1, 205, 300, 2, 64),
    (1, 1, 257, 2, 88),
    (1, 833, 833, 2, 88),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the small-S kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_s_kernels_match_plain(dtype):
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator("cuda").manual_seed(0)
    for b, sq, sk, h, d in SHAPES:
        rnd = lambda s: torch.randn(b, s, h, d, device="cuda", generator=gen).to(dt)  # noqa: E731
        q, k, v, g = rnd(sq), rnd(sk), rnd(sk), rnd(sq)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        before = {n: fa.launch_count(n) for n in fa.KERNELS}
        out = fa.flash_attention(q, k, v)
        grads = torch.autograd.grad((out.float() * g.float()).sum(), (q, k, v))
        torch.cuda.synchronize()
        after = {n: fa.launch_count(n) - before[n] for n in fa.KERNELS}
        assert after == {**dict.fromkeys(fa.KERNELS, 0), "small_s_fwd": 1,
                         "small_s_bwd_dq": 1, "small_s_bwd_dkv": 1}, after
        qd, kd, vd = (x.detach() for x in (q, k, v))
        scale = d ** -0.5
        ref, lse = fa.small_s_attention_ref(qd, kd, vd, scale)
        refs = fa.small_s_attention_bwd_ref(qd, kd, vd, ref, lse, g, scale)
        shape = (b, sq, sk, h, d)
        if dt == torch.float32:
            torch.testing.assert_close(out, ref, atol=2e-5, rtol=0, msg=str(shape))
            for name, x, r in zip(("dq", "dk", "dv"), grads, refs):
                torch.testing.assert_close(x, r, atol=5e-4, rtol=0, msg=f"{name} {shape}")
        else:
            assert _rel(out, ref) <= 1e-2, (shape, _rel(out, ref))
            for name, x, r in zip(("dq", "dk", "dv"), grads, refs):
                assert _rel(x, r) <= 1e-2, (name, shape, _rel(x, r))


@pytest.mark.cuda
def test_small_s_takes_strided_qkv_views_and_rejects_what_it_cannot_take():
    _card()
    b, s, h, d = 2, 833, 4, 88
    qkv = torch.randn(b, s, 3 * h * d, device="cuda").bfloat16()
    q, k, v = qkv.split(h * d, dim=-1)  # (B, S, H*D) views, the JAX layout
    out = fa.small_s_attention(q, k, v, h, d ** -0.5)
    ref, _ = fa.small_s_attention_ref(*(x.unflatten(-1, (h, d)) for x in (q, k, v)), d ** -0.5)
    assert _rel(out, ref.flatten(-2)) <= 1e-2
    apply = lambda *x: fa.SmallSAttention.apply(*x, 0.1)  # noqa: E731
    with pytest.raises(NotImplementedError, match="head dim"):
        apply(*(torch.randn(1, 8, 2, 40, device="cuda") for _ in range(3)))
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        apply(*(torch.randn(1, 8, 2, 64, device="cuda").half() for _ in range(3)))
    misaligned = torch.randn(1, 8, 2, 65, device="cuda").bfloat16()[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        apply(misaligned, misaligned, misaligned)
