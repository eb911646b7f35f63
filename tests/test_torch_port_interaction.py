"""The port's dot interaction against the JAX package's Pallas kernel
(interpret mode on the CPU) on the same numpy inputs, and the choice
between the CUDA-core and the tensor-core routes of the kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_shuffling_data_loader_tpu.ops.interaction import dot_interaction as jax_dot_interaction
from ray_shuffling_data_loader_tpu_torch.ops.interaction import (
    dot_interaction,
    dot_interaction_reference,
    interaction_backward,
    interaction_kernel,
    interaction_route,
    num_pairs,
)


def _inputs(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_pallas(x):
    return jax_dot_interaction(x, use_pallas=True, interpret=True, block_batch=256)


def test_reference_matches_pallas_fp32_ragged_tail():
    x = _inputs((500, 27, 16))  # 500 = one full 256-row tile + a ragged tail
    want = np.asarray(_jax_pallas(jnp.asarray(x)))
    got = dot_interaction_reference(torch.from_numpy(x)).numpy()
    assert got.shape == (500, num_pairs(27))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_reference_matches_pallas_bf16():
    x = _inputs((64, 19, 32), seed=1)
    want = np.asarray(_jax_pallas(jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    got = dot_interaction_reference(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # Both sum in fp32 and round once to bf16; the sums' order differs.
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-6)


def test_reference_matches_pallas_bf16_at_a_tensor_core_shape():
    """A shape of the tensor-core route other than the DLRM's: N = 27, D =
    16, 300 rows = one 256-row Pallas tile and a ragged tail."""
    x = _inputs((300, 27, 16), seed=4)
    want = np.asarray(_jax_pallas(jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    assert interaction_route(xt) == "mma"
    got = dot_interaction_reference(xt)
    assert got.dtype == torch.bfloat16 and got.shape == (300, num_pairs(27))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-6)


def _jax_grad(x):
    return np.asarray(
        jax.grad(lambda v: jnp.sum(_jax_pallas(v) ** 2))(jnp.asarray(x))
    )


@pytest.mark.parametrize("route", ["autograd_reference", "kernel_backward_algebra"])
def test_gradient_matches_custom_vjp(route):
    x = _inputs((96, 19, 8), seed=2)
    want = _jax_grad(x)
    xt = torch.from_numpy(x)
    if route == "autograd_reference":
        xt.requires_grad_(True)
        (dot_interaction(xt) ** 2).sum().backward()
        got = xt.grad.numpy()
    else:
        # The backward the kernel's autograd.Function runs on the card.
        out = dot_interaction_reference(xt)
        got = interaction_backward(xt, 2.0 * out).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_kernel_refuses_cpu_tensors():
    x = torch.from_numpy(_inputs((4, 5, 3)))
    with pytest.raises(ValueError):
        dot_interaction(x, use_kernel=True)
    with pytest.raises(ValueError):
        interaction_kernel(x)
    # The default on a CPU tensor is the plain version, not the kernel.
    before = interaction_kernel.launches
    torch.testing.assert_close(dot_interaction(x), dot_interaction_reference(x))
    assert interaction_kernel.launches == before


def _offset_by_one(shape):
    """A bf16 tensor whose data starts 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(shape)


ROUTE_CASES = [
    ("dlrm_bf16", lambda: torch.zeros((8, 19, 32), dtype=torch.bfloat16), "mma"),
    ("fp32", lambda: torch.zeros((8, 19, 32)), "simt"),
    ("d20", lambda: torch.zeros((8, 19, 20), dtype=torch.bfloat16), "simt"),
    ("d8", lambda: torch.zeros((8, 19, 8), dtype=torch.bfloat16), "simt"),
    ("d128", lambda: torch.zeros((8, 27, 128), dtype=torch.bfloat16), "mma"),
    ("d144", lambda: torch.zeros((8, 27, 144), dtype=torch.bfloat16), "simt"),
    ("n2", lambda: torch.zeros((8, 2, 16), dtype=torch.bfloat16), "mma"),
    ("n64", lambda: torch.zeros((8, 64, 64), dtype=torch.bfloat16), "mma"),
    ("n65", lambda: torch.zeros((8, 65, 32), dtype=torch.bfloat16), "simt"),
    ("unaligned_pointer", lambda: _offset_by_one((8, 19, 32)), "simt"),
    ("not_contiguous", lambda: torch.zeros((8, 32, 19), dtype=torch.bfloat16).transpose(1, 2), "simt"),
]


@pytest.mark.parametrize("name,make,want", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_interaction_route(name, make, want):
    assert interaction_route(make()) == want


def test_n_above_64_is_refused_by_both_routes():
    x = torch.zeros((8, 65, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mma route"):
        interaction_kernel(x, route="mma")
    for route in ("simt", None):
        with pytest.raises(ValueError, match="N <= 64"):
            interaction_kernel(x, route=route)


def test_mma_route_refusals():
    with pytest.raises(ValueError, match="route must be"):
        interaction_kernel(torch.zeros((8, 19, 32), dtype=torch.bfloat16), route="tensor")
    # fp32 and a misaligned pointer: the route does not take them.
    for x in (torch.zeros((8, 19, 32)), _offset_by_one((8, 19, 32))):
        with pytest.raises(ValueError, match="mma route"):
            interaction_kernel(x, route="mma")
    # A tensor the route takes passes its check and meets the CPU refusal;
    # nothing is counted.
    before = (interaction_kernel.launches, interaction_kernel.mma_launches)
    with pytest.raises(ValueError, match="CUDA"):
        interaction_kernel(torch.zeros((8, 19, 32), dtype=torch.bfloat16), route="mma")
    assert (interaction_kernel.launches, interaction_kernel.mma_launches) == before
