"""The causal / narrow-v / segmented flash attention of the PyTorch port (the
plain versions of K5 forward + backward and K8) vs the JAX package.

On the CPU `FlashAttention` runs `flash_attention_ref_with_lse` and
`flash_attention_bwd_ref`; they are held against the JAX Pallas kernels in
interpret mode, at the shapes of the JAX kernel tests
(tests/test_flash_attention.py: test_grads_segment_ids :80,
test_causal_q_position_offset :152, test_packed_segment_block_skipping
_parity :511, test_narrow_v_head_dim :569 with one K/V head per query
head), forward at 2e-5 and gradients at 5e-4. The CUDA kernels are held
against these plain versions on the card (test_torch_sft_kernels_cuda.py,
chip_smoke.py phase 20).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internvideo_tpu.ops.flash_attention import flash_attention as jax_flash
from internvideo_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash_lse
from internvideo_tpu_torch.ops import flash_attention as fa


def _segments(kind, b, s):
    if kind is None:
        return None
    if kind == "halves":
        ids = np.repeat([0, 1], [s // 2, s - s // 2])
    elif kind == "packed":
        ids = np.repeat(np.arange(4), [130, 100, 200, 82])
    elif kind == "edges":  # boundaries inside the CUDA tiles, then whole tiles of pads
        ids = np.repeat([0, 1, 2, -1], [50, 60, 30, s - 140])
    else:  # three samples, then pads of -1 as pack_mllm_items leaves them
        ids = np.repeat([0, 1, 2, -1], [50, 40, 30, s - 120])
    return np.tile(ids[None], (b, 1)).astype(np.int32)


# (B, Sq, Sk, H, d_qk, d_v, causal, q_position_offset, segments)
CASES = {
    "grads_segment_ids": (1, 256, 256, 2, 64, 64, False, 0, "halves"),
    "causal_q_position_offset": (1, 72, 200, 2, 64, 64, True, 128, None),
    "packed_dense": (2, 512, 512, 2, 32, 32, False, 0, "packed"),
    "packed_causal": (2, 512, 512, 2, 32, 32, True, 0, "packed"),
    "narrow_v_causal": (2, 200, 200, 4, 64, 32, True, 0, None),
    "narrow_v_dense": (2, 200, 200, 4, 64, 32, False, 0, None),
    "pads_causal": (1, 160, 160, 2, 64, 32, True, 0, "pads"),
    # the SFT pair (256 / 128) with segment boundaries inside the CUDA
    # backward's tiles and the last 64- and 128-row tiles all pads; the same
    # ids non-causal at (64, 64)
    "edges_narrow_v_causal": (1, 320, 320, 2, 256, 128, True, 0, "edges"),
    "edges_dense": (1, 320, 320, 2, 64, 64, False, 0, "edges"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_grads_match_jax(case):
    b, sq, sk, h, d, dv, causal, off, kind = CASES[case]
    rng = np.random.default_rng(sq + d)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, dv)).astype(np.float32)
    g = rng.standard_normal((b, sq, h, dv)).astype(np.float32)
    gl = rng.standard_normal((b, h, sq)).astype(np.float32)
    seg = _segments(kind, b, sq)
    kw = dict(causal=causal, q_position_offset=off)
    jkw = dict(kw, q_segment_ids=None if seg is None else jnp.asarray(seg),
               kv_segment_ids=None if seg is None else jnp.asarray(seg))
    tkw = dict(kw, q_segment_ids=None if seg is None else torch.from_numpy(seg),
               kv_segment_ids=None if seg is None else torch.from_numpy(seg))
    blocks = dict(block_q=128, block_k=128, interpret=True)

    def jax_loss(q, k, v):
        out, lse = jax_flash_lse(q, k, v, **jkw, **blocks)
        return jnp.sum(out * g) + jnp.sum(jnp.where(jnp.isfinite(lse), lse, 0.0) * gl), out

    (_, jout), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv, **tkw)
    assert out.shape == (b, sq, h, dv)
    loss = (out * torch.from_numpy(g)).sum() + (
        torch.where(torch.isfinite(lse), lse, 0.0) * torch.from_numpy(gl)).sum()
    grads = torch.autograd.grad(loss, (tq, tk, tv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=2e-5, rtol=2e-5)
    for name, a, r in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=5e-4, rtol=5e-4,
                                   err_msg=f"{case} {name}")
    # the dispatcher's flash_attention (no LSE) takes the same route
    got = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), **tkw)
    torch.testing.assert_close(got, out.detach(), atol=0, rtol=0)


def test_pads_attend_each_other_as_in_jax():
    """Segment ids mask by equality: the pad id -1 that pack_mllm_items
    gives both q and kv meets itself, so pad rows attend to the pad keys
    before them (causally) and get a nonzero output, as in the JAX kernel
    and attention_xla."""
    b, s, h, d = 1, 160, 2, 64
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    seg = _segments("pads", b, s)
    out = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True,
                             q_segment_ids=torch.from_numpy(seg),
                             kv_segment_ids=torch.from_numpy(seg))
    assert out[:, 120:].abs().amin(dim=-1).gt(0).all()
    want = jax_flash(q, k, v, causal=True, q_segment_ids=jnp.asarray(seg),
                     kv_segment_ids=jnp.asarray(seg), interpret=True, block_q=64, block_k=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    # a pad query's first pad key is itself: row 120 copies v[120]
    np.testing.assert_allclose(out[0, 120].numpy(), v[0, 120], atol=1e-6)
