"""DLRM dot interaction: ``[B, N, D] -> [B, N(N-1)/2]``, the strict upper
triangle of each sample's Gram matrix, pairs in row-major order.

On a CUDA tensor the forward is the hand-written kernel
``csrc/interaction.cu`` (fp32 accumulation, output in the input dtype) and
the backward is plain tensor algebra: scatter the cotangent into a
strict-upper ``[B, N, N]`` matrix, symmetrize it, multiply by ``x``. On a
CPU tensor the plain reference runs. There is no fallback from one to the
other: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ray_shuffling_data_loader_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 64  # kMaxN of csrc/interaction.cu


def num_pairs(n: int) -> int:
    return n * (n - 1) // 2


def dot_interaction_reference(stacked: torch.Tensor) -> torch.Tensor:
    """The plain version: an fp32 Gram via ``einsum``, then the strict
    upper triangle, cast back to the input dtype."""
    n = stacked.shape[1]
    x = stacked.float()
    gram = torch.einsum("bnd,bmd->bnm", x, x)
    iu, ju = torch.triu_indices(n, n, 1, device=stacked.device)
    return gram[:, iu, ju].to(stacked.dtype)


def interaction_backward(stacked: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """d/dx of ``triu(x xᵀ)`` applied to the cotangent ``ct`` ``[B, P]``."""
    b, n, _ = stacked.shape
    iu, ju = torch.triu_indices(n, n, 1, device=stacked.device)
    gram_ct = torch.zeros((b, n, n), dtype=ct.dtype, device=ct.device)
    gram_ct[:, iu, ju] = ct
    sym = gram_ct + gram_ct.transpose(1, 2)
    return torch.bmm(sym, stacked.to(ct.dtype)).to(stacked.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load("interaction")
    fn = lib.rsdl_interaction_fwd
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def interaction_kernel(stacked: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. Counts its launches
    in ``interaction_kernel.launches``."""
    if not stacked.is_cuda:
        raise ValueError("interaction_kernel needs a CUDA tensor")
    if stacked.dtype not in _DTYPE_CODES:
        raise TypeError(f"interaction_kernel takes float32 or bfloat16, not {stacked.dtype}")
    if stacked.dim() != 3:
        raise ValueError(f"interaction_kernel takes [B, N, D], got {tuple(stacked.shape)}")
    if not stacked.is_contiguous():
        raise ValueError("interaction_kernel needs a contiguous tensor")
    b, n, d = stacked.shape
    if not 2 <= n <= MAX_N or d < 1:
        raise ValueError(f"interaction_kernel takes 2 <= N <= {MAX_N} and D >= 1, got N={n}, D={d}")
    lib = _library()
    out = torch.empty((b, num_pairs(n)), dtype=stacked.dtype, device=stacked.device)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(stacked.device).cuda_stream
    with torch.cuda.device(stacked.device):
        rc = lib.rsdl_interaction_fwd(
            stacked.data_ptr(), out.data_ptr(), b, n, d,
            _DTYPE_CODES[stacked.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"interaction kernel launch failed: CUDA error {rc}")
    interaction_kernel.launches += 1
    return out


interaction_kernel.launches = 0


class DotInteraction(torch.autograd.Function):
    """Kernel forward, plain backward."""

    @staticmethod
    def forward(ctx, stacked: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(stacked)
        return interaction_kernel(stacked)

    @staticmethod
    def backward(ctx, ct: torch.Tensor) -> torch.Tensor:
        (stacked,) = ctx.saved_tensors
        return interaction_backward(stacked, ct)


def dot_interaction(stacked: torch.Tensor, use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Pairwise dot interaction ``[B, N, D] -> [B, N(N-1)/2]``.

    ``use_kernel``: ``None`` runs the kernel on a CUDA tensor and the
    reference on a CPU tensor; ``True`` on a CPU tensor raises; ``False``
    runs the reference.
    """
    if use_kernel is None:
        use_kernel = stacked.is_cuda
    if not use_kernel:
        return dot_interaction_reference(stacked)
    if not stacked.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor")
    return DotInteraction.apply(stacked.contiguous())
