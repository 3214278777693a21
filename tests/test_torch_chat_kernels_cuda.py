"""The attention kernels at InternVideo2-Chat's shapes vs their plain PyTorch
versions, on the card: K1 at the ViT's (B, 2049, 16, 88) and at the QFormer
cross-attention's 32 queries on 2049 keys with 12 heads of 64, K2 at the
QFormer self-attention's (B, 32, 12, 64), and K5 at the LLM prefill over
[32 queries | prompt] ((B, 32 + 64, 32, 256 / 128) and a ragged prompt of
61), each at B 1 and B 8, through the public `flash_attention` route the
models call (one launch of the named kernel and nothing else).

Needs an NVIDIA GPU with nvcc (the kernels have no CPU mode), so every test
here is marked `cuda` and skips without a card. The file imports neither
jax nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_chat_kernels_cuda.py -m cuda
"""

import pytest
import torch

from internvideo_tpu_torch.ops import flash_attention as fa

# (kernel, B, Sq, Sk, H, d_qk, d_v, causal)
CASES = [
    (kernel, b, sq, sk, h, d, dv, causal)
    for b in (1, 8)
    for kernel, sq, sk, h, d, dv, causal in (
        ("flash_fwd", 2049, 2049, 16, 88, 88, False),
        ("flash_fwd", 32, 2049, 12, 64, 64, False),
        ("small_s_fwd", 32, 32, 12, 64, 64, False),
        ("flash_fwd_causal", 96, 96, 32, 256, 128, True),
        ("flash_fwd_causal", 93, 93, 32, 256, 128, True),
    )
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c[:7])))
def test_chat_shapes_match_plain(dtype, case):
    _card()
    kernel, b, sq, sk, h, d, dv, causal = case
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(0)
    if sq == sk and not causal:  # the ViT's q / k / v: views of one projection
        qkv = torch.randn(b, sq, 3, h, d, device="cuda", generator=g).to(dt)
        q, k, v = qkv.unbind(2)
    else:
        q = torch.randn(b, sq, h, d, device="cuda", generator=g).to(dt)
        k = torch.randn(b, sk, h, d, device="cuda", generator=g).to(dt)
        v = torch.randn(b, sk, h, dv, device="cuda", generator=g).to(dt)
    before = {n: fa.launch_count(n) for n in fa.KERNELS}
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    after = {n: fa.launch_count(n) - before[n] for n in fa.KERNELS}
    assert after == {**dict.fromkeys(fa.KERNELS, 0), kernel: 1}, after
    ref, _ = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5, causal)
    if dt == torch.float32:
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=0, msg=str(case))
    else:
        assert _rel(out, ref) <= 1e-2, (case, _rel(out, ref))
