"""The port's flash attention against the JAX package's Pallas kernels
(interpret mode on the CPU) on the same numpy inputs: the plain version of
K2 (output and softmax statistics), the plain version of K3 and K4 (the
gradients from the same statistics), and gradients through the port's
autograd Function; and the choice between the CUDA-core and the
tensor-core routes of K2, K3 and K4."""

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
    MAX_HEAD_DIM,
    NEG_INF,
    T_MIN,
    attention_reference,
    flash_attention,
    flash_backward_reference,
    flash_bwd_dkv_kernel,
    flash_bwd_dq_kernel,
    flash_forward_reference,
    flash_fwd_kernel,
    flash_route,
    mma_supported,
)

# The shapes and blocks of tests/test_flash_attention.py's dense check.
SHAPES = [
    ((2, 64, 2, 8), (16, 16)),  # several kv blocks per q block
    ((1, 56, 2, 8), (16, 24)),  # ragged: seq divides neither block
    ((2, 8, 1, 4), (128, 128)),  # seq smaller than the block
    # Shapes of the tensor-core route (head dims 32, 64, 128), t ragged
    # against its 64-row tiles.
    ((1, 200, 2, 64), (128, 128)),
    ((1, 130, 3, 32), (64, 64)),
    ((1, 72, 2, 128), (32, 32)),
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


def test_backward_reference_matches_pallas_at_the_lm_head_dim():
    """The CausalLM's head dim 16, causal, with t = 96 ragged against the
    64-row tiles of the tensor-core kernels and the Pallas blocks."""
    shape, blocks = (1, 96, 2, 16), (64, 64)
    q, k, v = _qkv(shape, seed=8)
    ct = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    jq, jk, jv, jct = map(jnp.asarray, (q, k, v, ct))
    out, m, l = _flash_forward(jq, jk, jv, True, *blocks, interpret=True, return_stats=True)
    want = _flash_backward_pallas(jq, jk, jv, out, m, l, jct, True, *blocks, interpret=True)
    got = flash_backward_reference(*_t(q, k, v, out, m, l, ct), True)
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


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _packed(shape):
    """q, k, v as the encoder block hands them over: views of one packed
    ``[b, t, 3, h, hd]`` projection."""
    b, t, h, hd = shape
    return torch.zeros((b, t, 3, h, hd), dtype=torch.bfloat16).unbind(2)


def _offset_by_one(shape):
    """A bf16 tensor whose data starts 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(shape)


def _odd_head_stride(shape):
    """Heads 40 bytes apart: hd = 16 of a [.., h, 20] tensor."""
    b, t, h, hd = shape
    return torch.zeros((b, t, h, hd + 4), dtype=torch.bfloat16)[..., :hd]


ROUTE_CASES = [
    ("bf16_at_t_min", lambda: (_bf16((2, T_MIN, 4, 16)),), "mma"),
    ("fp32_at_t_min", lambda: (torch.zeros((2, T_MIN, 4, 16)),), "simt"),
    ("bf16_below_t_min", lambda: (_bf16((2, T_MIN - 1, 4, 16)),), "simt"),
    ("tabtransformer", lambda: (_bf16((8, 19, 4, 8)),), "simt"),
    ("causal_lm_packed", lambda: _packed((4, 512, 4, 16)), "mma"),
    ("hd8", lambda: (_bf16((2, 128, 2, 8)),), "simt"),
    ("hd16", lambda: (_bf16((2, 128, 2, 16)),), "mma"),
    ("hd20", lambda: (_bf16((2, 128, 2, 20)),), "simt"),
    ("hd64", lambda: (_bf16((2, 128, 2, 64)),), "mma"),
    ("hd120", lambda: (_bf16((2, 128, 2, 120)),), "simt"),
    ("hd128", lambda: (_bf16((2, 128, 2, MAX_HEAD_DIM)),), "mma"),
    ("hd144", lambda: (_bf16((2, 128, 2, 144)),), "simt"),
    ("unaligned_pointer", lambda: (_bf16((2, 128, 2, 64)), _offset_by_one((2, 128, 2, 64))), "simt"),
    ("unaligned_head_stride", lambda: (_odd_head_stride((2, 128, 2, 16)),), "simt"),
    ("mixed_dtypes", lambda: (_bf16((2, 128, 2, 64)), torch.zeros((2, 128, 2, 64))), "simt"),
]


@pytest.mark.parametrize("name,make,want", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_flash_route(name, make, want):
    tensors = make()
    assert flash_route(*tensors) == want
    # Below T_MIN the tensor-core kernels still take the tensors (a forced
    # route launches them); only the default prefers the CUDA-core route.
    assert mma_supported(*tensors) == (want == "mma" or name == "bf16_below_t_min")


REFUSED = [
    ("fp32", lambda: torch.zeros((1, 64, 2, 16))),
    ("hd20", lambda: _bf16((1, 64, 2, 20))),
    ("hd8", lambda: _bf16((1, 64, 2, 8))),
    ("unaligned", lambda: _offset_by_one((1, 64, 2, 16))),
]


@pytest.mark.parametrize("name,make", REFUSED, ids=[c[0] for c in REFUSED])
def test_mma_route_refuses_shapes_it_does_not_take(name, make):
    q = make()
    b, t, h, _ = q.shape
    stats = torch.zeros((b, h, t))
    with pytest.raises(ValueError, match="mma route"):
        flash_fwd_kernel(q, q, q, route="mma")
    with pytest.raises(ValueError, match="mma route"):
        flash_bwd_dkv_kernel(q, q, q, q, stats, stats, stats, q.clone(), q.clone(), route="mma")
    with pytest.raises(ValueError, match="mma route"):
        flash_bwd_dq_kernel(q, q, q, q, stats, stats, stats, q.clone(), route="mma")


def test_route_argument_is_checked_before_the_device():
    q = _bf16((1, T_MIN - 1, 2, 16))
    stats = torch.zeros((1, 2, T_MIN - 1))
    with pytest.raises(ValueError, match="route must be"):
        flash_fwd_kernel(q, q, q, route="tensor")
    with pytest.raises(ValueError, match="route must be"):
        flash_bwd_dq_kernel(q, q, q, q, stats, stats, stats, q.clone(), route="tensor")
    # A route the tensors allow passes its check and then meets the CPU
    # refusal, forced below T_MIN as well.
    for route in ("mma", "simt"):
        with pytest.raises(ValueError, match="CUDA"):
            flash_fwd_kernel(q, q, q, route=route)
        with pytest.raises(ValueError, match="CUDA"):
            flash_bwd_dq_kernel(q, q, q, q, stats, stats, stats, q.clone(), route=route)


def test_cpu_function_counts_no_launch_on_either_route():
    qkv = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 64, 3, 2, 16))).to(
        torch.bfloat16).requires_grad_(True)
    counters = (flash_fwd_kernel, flash_bwd_dkv_kernel, flash_bwd_dq_kernel)
    before = tuple(fn.mma_launches for fn in counters)
    flash_attention(*qkv.unbind(2), causal=True).float().sum().backward()
    assert tuple(fn.mma_launches for fn in counters) == before
