"""The port's flash attention against the JAX package's Pallas kernels
(interpret mode on the CPU) on the same numpy inputs: the plain version of
K2 (output and softmax statistics), the plain version of K3 and K4 (the
gradients from the same statistics), and gradients through the port's
autograd Function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_shuffling_data_loader_tpu.ops.flash_attention import (
    _flash_backward_pallas,
    _flash_forward,
)
from ray_shuffling_data_loader_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from ray_shuffling_data_loader_tpu.ops.ring_attention import attention_reference as jax_attention_reference
from ray_shuffling_data_loader_tpu_torch.ops.flash_attention import (
    NEG_INF,
    attention_reference,
    flash_attention,
    flash_backward_reference,
    flash_bwd_dkv_kernel,
    flash_bwd_dq_kernel,
    flash_forward_reference,
    flash_fwd_kernel,
)

# The shapes and blocks of tests/test_flash_attention.py's dense check.
SHAPES = [
    ((2, 64, 2, 8), (16, 16)),  # several kv blocks per q block
    ((1, 56, 2, 8), (16, 24)),  # ragged: seq divides neither block
    ((2, 8, 1, 4), (128, 128)),  # seq smaller than the block
]


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape,blocks", SHAPES)
def test_forward_reference_matches_pallas_with_stats(causal, shape, blocks):
    q, k, v = _qkv(shape, seed=1)
    want = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, *blocks,
        interpret=True, return_stats=True,
    )
    got = flash_forward_reference(*_t(q, k, v), causal)
    b, t, h, _ = shape
    for name, g, w in zip(("out", "m", "l"), got, want):
        assert g.dtype == torch.float32
        assert g.shape == (shape if name == "out" else (b, h, t))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape,blocks", SHAPES)
def test_backward_reference_matches_pallas_from_the_same_stats(causal, shape, blocks):
    q, k, v = _qkv(shape, seed=2)
    ct = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jq, jk, jv, jct = map(jnp.asarray, (q, k, v, ct))
    out, m, l = _flash_forward(jq, jk, jv, causal, *blocks, interpret=True, return_stats=True)
    want = _flash_backward_pallas(jq, jk, jv, out, m, l, jct, causal, *blocks, interpret=True)
    got = flash_backward_reference(*_t(q, k, v, out, m, l, ct), causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_through_the_function_match_jax(causal):
    """(1, 300, 2, 8): several 128-wide kv blocks and a ragged tail on the
    JAX side, as tests/test_flash_attention.py runs it."""
    q, k, v = _qkv((1, 300, 2, 8), seed=6)

    def loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal=causal, use_pallas=True, interpret=True) ** 2)

    want = jax.grad(loss, (0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
    (flash_attention(tq, tk, tv, causal) ** 2).sum().backward()
    for name, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0, err_msg=name)


def test_bfloat16_matches_pallas():
    q, k, v = _qkv((2, 32, 2, 8), seed=3)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = jax_flash_attention(jq, jk, jv, use_pallas=True, block_q=16, block_k=16, interpret=True)
    tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, k, v))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    # Both sides compute in float32 and round once to bfloat16, so they
    # differ by at most one bfloat16 step; atol is that step at max |out|.
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2, atol=step)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_reference_matches_jax(causal):
    q, k, v = _qkv((2, 24, 3, 8), seed=4)
    want = jax_attention_reference(*map(jnp.asarray, (q, k, v)), causal=causal)
    got = attention_reference(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    # The plain K2's output is the same attention.
    out, _, _ = flash_forward_reference(*_t(q, k, v), causal)
    np.testing.assert_allclose(out.numpy(), got.numpy(), atol=1e-6, rtol=0)


def test_fully_masked_rows_contribute_nothing():
    """A row whose max stays NEG_INF gets probabilities of 0 in both plain
    versions (the kernels' live-row guard), never NaN."""
    q, k, v = _t(*_qkv((1, 4, 1, 4), seed=5))
    m = torch.full((1, 1, 4), NEG_INF)
    l = torch.zeros((1, 1, 4))
    dq, dk, dv = flash_backward_reference(q, k, v, torch.zeros_like(q), m, l, torch.ones_like(q))
    for g in (dq, dk, dv):
        assert torch.equal(g, torch.zeros_like(g))


def test_kernels_refuse_cpu_tensors():
    q, k, v = _t(*_qkv((1, 8, 1, 4)))
    stats = torch.zeros((1, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_kernel(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dkv_kernel(q, k, v, q, stats, stats, stats, torch.empty_like(k), torch.empty_like(v))
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dq_kernel(q, k, v, q, stats, stats, stats, torch.empty_like(q))
    # On CPU tensors the Function runs the plain versions, not the kernels.
    before = (flash_fwd_kernel.launches, flash_bwd_dkv_kernel.launches, flash_bwd_dq_kernel.launches)
    q.requires_grad_(True)
    flash_attention(q, k, v, True).sum().backward()
    assert q.grad is not None
    after = (flash_fwd_kernel.launches, flash_bwd_dkv_kernel.launches, flash_bwd_dq_kernel.launches)
    assert after == before
