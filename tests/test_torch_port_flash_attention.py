"""The port's flash attention against the JAX package's Pallas kernels
(interpret mode on the CPU) on the same numpy inputs: the plain version of
K2 (output and softmax statistics), the plain version of K3 and K4 (the
gradients from the same statistics), and gradients through the port's
autograd Function; the choice between the CUDA-core and the tensor-core
routes of K2, K3 and K4; K2's wgmma route (the long heads' forward on
Hopper's warpgroup tensor cores), its threshold and its refusals; and the
short route of the forward (one kernel for out, m and l) and of the
backward (one kernel for dQ, dK and dV) of short packed bf16 heads, its
rules and its refusals."""

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
    BWD_ROUTES,
    MAX_HEAD_DIM,
    NEG_INF,
    ROUTES,
    T_MIN,
    T_WGMMA,
    WGMMA_HEAD_DIMS,
    attention_reference,
    flash_attention,
    flash_attention_qkv,
    flash_backward,
    flash_backward_reference,
    flash_bwd_dkv_kernel,
    flash_bwd_dq_kernel,
    flash_bwd_route,
    flash_bwd_short_kernel,
    flash_forward_reference,
    flash_fwd_kernel,
    flash_fwd_kernel_route,
    flash_fwd_route,
    flash_fwd_short_kernel,
    flash_route,
    mma_supported,
    short_fwd_supported,
    short_supported,
    wgmma_supported,
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
    # K2's wgmma route at hd 16, t ragged against its 128-row tiles.
    ((2, 200, 2, 16), (128, 128)),
    # Shapes of the backward's short route: the TabTransformer's heads
    # (t 19, hd 8) and the longest short head at hd 16.
    ((3, 19, 4, 8), (16, 16)),
    ((2, 31, 2, 16), (16, 16)),
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
@pytest.mark.parametrize("shape", [(3, 19, 4, 8), (2, 31, 2, 16)], ids=["tabtransformer", "t31_hd16"])
def test_bfloat16_matches_pallas_at_the_short_shapes(shape, causal):
    """The plain forward that the short kernel is held to on the card, at
    the kernel's dtype: out, m and l against the Pallas forward (interpret
    mode) on the same bf16 inputs."""
    q, k, v = _qkv(shape, seed=12)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = _flash_forward(jq, jk, jv, causal, 16, 16, interpret=True, return_stats=True)
    got = flash_forward_reference(*(x.to(torch.bfloat16) for x in _t(q, k, v)), causal)
    out_want = np.asarray(want[0].astype(jnp.float32))
    assert got[0].dtype == torch.bfloat16
    # As test_bfloat16_matches_pallas: one bfloat16 step at max |out|.
    step = 2.0 ** (np.floor(np.log2(np.abs(out_want).max())) - 7)
    np.testing.assert_allclose(got[0].float().numpy(), out_want, rtol=5e-2, atol=step)
    for name, g, w in zip(("m", "l"), got[1:], want[1:]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0, err_msg=name)


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


def _short_views(b, t, h, hd, dtype=torch.bfloat16):
    """The backward's tensors as the encoder block hands them over: q, k, v
    views of one packed ``[b, t, 3, h, hd]``, contiguous out and dO."""
    q, k, v = torch.zeros((b, t, 3, h, hd), dtype=dtype).unbind(2)
    return q, k, v, torch.zeros((b, t, h, hd), dtype=dtype), torch.zeros((b, t, h, hd), dtype=dtype)


def _separate(b, t, h, hd):
    """q, k and v allocated one by one: the short route takes only views of
    one packed projection."""
    return tuple(_bf16((b, t, h, hd)) for _ in range(5))


def _strided_out(b, t, h, hd):
    """dO whose token rows are not contiguous (a view of a wider tensor)."""
    q, k, v, out, _ = _short_views(b, t, h, hd)
    return q, k, v, out, torch.zeros((b, t, h + 1, hd), dtype=torch.bfloat16)[:, :, :h]


BWD_ROUTE_CASES = [
    ("tabtransformer_packed", lambda: _short_views(8, 19, 4, 8), "short"),
    ("hd16_below_t_min", lambda: _short_views(4, T_MIN - 1, 4, 16), "short"),
    ("one_token", lambda: _short_views(2, 1, 3, 8), "short"),
    ("widest", lambda: _short_views(2, 19, 16, 8), "short"),
    ("fp32", lambda: _short_views(8, 19, 4, 8, torch.float32), "simt"),
    ("hd20", lambda: _short_views(8, 19, 4, 20), "simt"),
    ("hd32", lambda: _short_views(8, 19, 4, 32), "simt"),
    ("too_wide", lambda: _short_views(2, 19, 17, 8), "simt"),
    ("separate_qkv", lambda: _separate(8, 19, 4, 8), "simt"),
    ("strided_dout", lambda: _strided_out(8, 19, 4, 8), "simt"),
    ("hd16_at_t_min", lambda: _short_views(4, T_MIN, 4, 16), "mma"),
]


@pytest.mark.parametrize("name,make,want", BWD_ROUTE_CASES, ids=[c[0] for c in BWD_ROUTE_CASES])
def test_flash_bwd_route(name, make, want):
    q, k, v, out, dout = make()
    assert flash_bwd_route(q, k, v, out, dout) == want
    assert short_supported(q, k, v, out, dout) == (want == "short")
    # K2's route does not change: the TabTransformer's forward stays on
    # the CUDA-core kernel.
    if name == "tabtransformer_packed":
        assert flash_route(q, k, v) == "simt"


# The forward's route at the same tensors (it reads no out or dO), q, k and
# v allocated one by one below T_MIN at hd 16; and K2's wgmma route: taken
# at every head dim it takes from T_WGMMA tokens on, packed or not; below
# T_WGMMA, at the head dims it refuses (48, 80, 96) and in fp32, K2's mma
# or CUDA-core route.
FWD_ROUTE_CASES = [
    (name, make, {"separate_qkv": "simt", "strided_dout": "short"}.get(name, want))
    for name, make, want in BWD_ROUTE_CASES
] + [("separate_qkv_hd16_below_t_min", lambda: _separate(4, T_MIN - 1, 4, 16), "simt")] + [
    (f"wgmma_hd{hd}", lambda hd=hd: _short_views(2, T_WGMMA, 2, hd), "wgmma") for hd in WGMMA_HEAD_DIMS
] + [
    ("wgmma_separate_qkv", lambda: _separate(2, T_WGMMA + 77, 3, 32), "wgmma"),
    ("causal_lm_packed", lambda: _short_views(4, 512, 4, 16), "wgmma"),
    ("attention_bench_packed", lambda: _short_views(2, 4096, 8, 64), "wgmma"),
    ("hd64_below_t_wgmma", lambda: _short_views(2, T_WGMMA - 1, 2, 64), "mma"),
] + [(f"hd{hd}_refused_by_wgmma", lambda hd=hd: _short_views(2, T_WGMMA, 2, hd), "mma") for hd in (48, 80, 96)] + [
    ("fp32_at_t_wgmma", lambda: _short_views(2, T_WGMMA, 2, 64, torch.float32), "simt"),
]


@pytest.mark.parametrize("name,make,want", FWD_ROUTE_CASES, ids=[c[0] for c in FWD_ROUTE_CASES])
def test_flash_fwd_route(name, make, want):
    q, k, v, _, _ = make()
    assert flash_fwd_route(q, k, v) == want
    assert short_fwd_supported(q, k, v) == (want == "short")
    # Outside the short route the forward is K2's route, and K3's and K4's
    # rule stays flash_route's: the wgmma route is K2's alone.
    if want != "short":
        assert flash_fwd_kernel_route(q, k, v) == want
        assert flash_route(q, k, v) == ("mma" if want == "wgmma" else want)
    # The wgmma kernel takes every t; the rule takes it from T_WGMMA on.
    if want == "wgmma" or name == "hd64_below_t_wgmma":
        assert wgmma_supported(q, k, v)


@pytest.mark.parametrize("name,make", [c[:2] for c in FWD_ROUTE_CASES if c[2] != "short"],
                         ids=[c[0] for c in FWD_ROUTE_CASES if c[2] != "short"])
def test_short_forward_refuses_shapes_it_does_not_take(name, make):
    """A forced short forward on tensors it does not take raises before the
    device check (the tensors here are on the CPU)."""
    q, k, v, _, _ = make()
    with pytest.raises(ValueError, match="short route"):
        flash_fwd_short_kernel(q, k, v)


@pytest.mark.parametrize("name,make", [c[:2] for c in FWD_ROUTE_CASES if c[2] == "short"],
                         ids=[c[0] for c in FWD_ROUTE_CASES if c[2] == "short"])
def test_short_forward_takes_its_shapes_and_then_checks_the_device(name, make):
    """Tensors the short forward takes pass its check and meet the CPU
    refusal; K2's wrapper knows no short route, so flash_fwd_short_kernel
    is the one way to force it."""
    q, k, v, _, _ = make()
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_short_kernel(q, k, v, causal=True)
    with pytest.raises(ValueError, match="route must be"):
        flash_fwd_kernel(q, k, v, route="short")


@pytest.mark.parametrize("name,make", [c[:2] for c in BWD_ROUTE_CASES if c[2] != "short"],
                         ids=[c[0] for c in BWD_ROUTE_CASES if c[2] != "short"])
def test_short_route_refuses_shapes_it_does_not_take(name, make):
    """A forced short route on tensors it does not take raises before the
    device check (the tensors here are on the CPU); the backward takes them
    to K3 and K4, which meet the CPU refusal."""
    q, k, v, out, dout = make()
    b, t, h, _ = q.shape
    stats = torch.zeros((b, h, t))
    grads = torch.zeros((b, t, 3) + q.shape[2:], dtype=q.dtype).unbind(2)
    with pytest.raises(ValueError, match="short route"):
        flash_bwd_short_kernel(q, k, v, out, dout, stats, stats, *grads)
    with pytest.raises(ValueError, match="CUDA"):
        flash_backward(q, k, v, out, dout, stats, stats, *grads)


def test_short_route_checks_its_gradients_and_then_the_device():
    q, k, v, out, dout = _short_views(2, 19, 4, 8)
    stats = torch.zeros((2, 4, 19))
    # Gradients that are not views of one packed gradient are refused.
    with pytest.raises(ValueError, match="short route"):
        flash_bwd_short_kernel(q, k, v, out, dout, stats, stats, *(_bf16((2, 19, 4, 8)) for _ in range(3)))
    # Tensors the route takes pass its check and meet the CPU refusal.
    grads = torch.zeros((2, 19, 3, 4, 8), dtype=torch.bfloat16).unbind(2)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_short_kernel(q, k, v, out, dout, stats, stats, *grads)
    with pytest.raises(ValueError, match="CUDA"):
        flash_backward(q, k, v, out, dout, stats, stats, *grads)


def test_short_is_the_backward_route_alone():
    q, k, v, out, dout = _short_views(2, 19, 4, 8)
    stats = torch.zeros((2, 4, 19))
    with pytest.raises(ValueError, match="route must be"):
        flash_fwd_kernel(q, k, v, route="short")
    with pytest.raises(ValueError, match="route must be"):
        flash_bwd_dkv_kernel(q, k, v, dout, stats, stats, stats, out.clone(), out.clone(), route="short")
    with pytest.raises(ValueError, match="route must be"):
        flash_bwd_dq_kernel(q, k, v, dout, stats, stats, stats, out.clone(), route="short")


@pytest.mark.parametrize("causal", [False, True])
def test_cpu_function_counts_no_launch_at_the_short_shape(causal):
    """The TabTransformer's packed bf16 heads on the CPU: the Function runs
    the plain versions and counts no launch on any route, and its packed
    gradient is the plain backward's."""
    rng = np.random.default_rng(11)
    qkv = torch.from_numpy(rng.standard_normal((3, 19, 3, 4, 8)).astype(np.float32)).to(torch.bfloat16)
    ct = torch.from_numpy(rng.standard_normal((3, 19, 4, 8)).astype(np.float32)).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert flash_fwd_route(q, k, v) == "short"
    assert flash_bwd_route(q, k, v, torch.zeros_like(ct), ct) == "short"
    counters = (flash_fwd_kernel, flash_bwd_dkv_kernel, flash_bwd_dq_kernel, flash_fwd_short_kernel,
                flash_bwd_short_kernel)
    before = tuple(fn.launches for fn in counters)
    leaf = qkv.clone().requires_grad_(True)
    flash_attention_qkv(leaf, causal).backward(ct)
    assert tuple(fn.launches for fn in counters) == before
    out, m, l = flash_forward_reference(q, k, v, causal)
    want = torch.stack(flash_backward_reference(q, k, v, out, m, l, ct, causal), dim=2)
    assert torch.equal(leaf.grad, want)


# Tensors K2's wgmma kernel does not take, whatever t.
WGMMA_REFUSED = [
    ("hd48", lambda: _packed((1, T_WGMMA, 2, 48))),
    ("hd80", lambda: _packed((1, T_WGMMA, 2, 80))),
    ("hd96", lambda: _packed((1, T_WGMMA, 2, 96))),
    ("hd8", lambda: _packed((1, T_WGMMA, 2, 8))),
    ("fp32", lambda: torch.zeros((1, T_WGMMA, 3, 2, 64)).unbind(2)),
    ("unaligned_pointer", lambda: (_offset_by_one((1, T_WGMMA, 2, 64)),) * 3),
    ("unaligned_head_stride", lambda: (_odd_head_stride((1, T_WGMMA, 2, 16)),) * 3),
]


@pytest.mark.parametrize("name,make", WGMMA_REFUSED, ids=[c[0] for c in WGMMA_REFUSED])
def test_wgmma_route_refuses_tensors_it_does_not_take(name, make):
    """A forced wgmma route on tensors it does not take raises before the
    device check (the tensors here are on the CPU), and K2's rule passes
    them to another route."""
    q, k, v = make()
    assert not wgmma_supported(q, k, v)
    assert flash_fwd_kernel_route(q, k, v) != "wgmma"
    with pytest.raises(ValueError, match="wgmma route"):
        flash_fwd_kernel(q, k, v, route="wgmma")


@pytest.mark.parametrize("hd", WGMMA_HEAD_DIMS)
def test_wgmma_threshold(hd):
    """K2's rule takes the wgmma route from T_WGMMA tokens on, the mma route
    below it; a forced wgmma route below T_WGMMA passes its check (the
    kernel takes any t) and meets the CPU refusal."""
    below = _packed((2, T_WGMMA - 1, 2, hd))
    at = _packed((2, T_WGMMA, 2, hd))
    assert T_MIN < T_WGMMA
    assert wgmma_supported(*below) and wgmma_supported(*at)
    assert flash_fwd_kernel_route(*below) == "mma"
    assert flash_fwd_kernel_route(*at) == "wgmma"
    assert flash_fwd_route(*at) == "wgmma"
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_kernel(*below, route="wgmma")
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_kernel(*at, causal=True)


def test_wgmma_is_the_forward_route_alone():
    """K2 knows three routes, K3 and K4 two: a forced wgmma route on the
    backward kernels is an unknown route, raised before the device check."""
    assert ROUTES == ("wgmma", "mma", "simt") and BWD_ROUTES == ("mma", "simt")
    q, k, v = _packed((1, T_WGMMA, 2, 64))
    stats = torch.zeros((1, 2, T_WGMMA))
    with pytest.raises(ValueError, match="route must be"):
        flash_bwd_dkv_kernel(q, k, v, q, stats, stats, stats, q.clone(), q.clone(), route="wgmma")
    with pytest.raises(ValueError, match="route must be"):
        flash_bwd_dq_kernel(q, k, v, q, stats, stats, stats, q.clone(), route="wgmma")
    # The backward of tensors whose forward takes the wgmma route is K3's
    # and K4's mma route.
    out = torch.zeros(q.shape, dtype=q.dtype)
    assert flash_bwd_route(q, k, v, out, out.clone()) == "mma"


@pytest.mark.parametrize("causal", [False, True])
def test_cpu_function_counts_no_wgmma_launch(causal):
    """Packed bf16 heads the wgmma route takes, on the CPU: the Function
    runs the plain versions, counts no launch on any route, and its output
    and packed gradient are the plain versions'."""
    rng = np.random.default_rng(13)
    shape = (1, T_WGMMA + 3, 2, 16)
    b, t, h, hd = shape
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3, h, hd)).astype(np.float32)).to(torch.bfloat16)
    ct = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert flash_fwd_route(q, k, v) == "wgmma"
    counters = (flash_fwd_kernel, flash_bwd_dkv_kernel, flash_bwd_dq_kernel, flash_fwd_short_kernel,
                flash_bwd_short_kernel)
    before = tuple(fn.launches for fn in counters) + (flash_fwd_kernel.wgmma_launches,)
    leaf = qkv.clone().requires_grad_(True)
    got = flash_attention_qkv(leaf, causal)
    got.backward(ct)
    assert tuple(fn.launches for fn in counters) + (flash_fwd_kernel.wgmma_launches,) == before
    out, m, l = flash_forward_reference(q, k, v, causal)
    assert torch.equal(got.detach(), out)
    want = torch.stack(flash_backward_reference(q, k, v, out, m, l, ct, causal), dim=2)
    assert torch.equal(leaf.grad, want)
