"""DLRM dot interaction: ``[B, N, D] -> [B, N(N-1)/2]``, the strict upper
triangle of each sample's Gram matrix, pairs in row-major order.

On a CUDA tensor the forward is a hand-written kernel (fp32 accumulation,
output in the input dtype) on one of two routes, which
:func:`interaction_route` picks per call: ``"mma"``, the tensor-core
kernel ``csrc/interaction_mma.cu``, for contiguous bf16 inputs with ``D`` a
multiple of 16 up to 128 and a 16-byte aligned pointer; ``"simt"``, the
CUDA-core kernel ``csrc/interaction.cu``, for everything else. The
backward is plain tensor algebra: scatter the cotangent into a
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
MAX_N = 64  # kMaxN of csrc/interaction.cu and csrc/interaction_mma.cu
MMA_MAX_D = 128  # kMaxD of csrc/interaction_mma.cu
ROUTES = ("mma", "simt")


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


def interaction_route(stacked: torch.Tensor) -> str:
    """``"mma"`` where the tensor-core kernel takes ``stacked``: bf16,
    contiguous ``[B, N, D]`` with ``2 <= N <= 64``, ``D`` a multiple of 16
    up to 128 and a 16-byte aligned pointer; else ``"simt"``."""
    if (
        stacked.dtype == torch.bfloat16
        and stacked.dim() == 3
        and stacked.is_contiguous()
        and 2 <= stacked.shape[1] <= MAX_N
        and stacked.shape[2] % 16 == 0
        and 16 <= stacked.shape[2] <= MMA_MAX_D
        and stacked.data_ptr() % 16 == 0
    ):
        return "mma"
    return "simt"


def _library(name: str, fn_name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def interaction_kernel(stacked: torch.Tensor, route=None) -> torch.Tensor:
    """Launch K1 on the current stream. ``route`` (None:
    :func:`interaction_route`) picks the kernel; ``"mma"`` on a tensor it
    does not take raises ``ValueError``. Counts its launches in
    ``interaction_kernel.launches``, those of the tensor-core route also in
    ``interaction_kernel.mma_launches``."""
    if route is None:
        route = interaction_route(stacked)
    elif route not in ROUTES:
        raise ValueError(f"interaction_kernel: route must be None or one of {ROUTES}, got {route!r}")
    elif route == "mma" and interaction_route(stacked) != "mma":
        raise ValueError(
            f"interaction_kernel: the mma route takes contiguous bf16 [B, N, D] with 2 <= N <= {MAX_N}, "
            f"D a multiple of 16 up to {MMA_MAX_D} and a 16-byte aligned pointer; got {stacked.dtype} "
            f"{tuple(stacked.shape)}"
        )
    if stacked.dtype not in _DTYPE_CODES:
        raise TypeError(f"interaction_kernel takes float32 or bfloat16, not {stacked.dtype}")
    if stacked.dim() != 3:
        raise ValueError(f"interaction_kernel takes [B, N, D], got {tuple(stacked.shape)}")
    b, n, d = stacked.shape
    if not 2 <= n <= MAX_N or d < 1:
        raise ValueError(f"interaction_kernel takes 2 <= N <= {MAX_N} and D >= 1, got N={n}, D={d}")
    if not stacked.is_cuda:
        raise ValueError("interaction_kernel needs a CUDA tensor")
    if not stacked.is_contiguous():
        raise ValueError("interaction_kernel needs a contiguous tensor")
    # rsdl-lint: disable=vocabulary-drift -- C symbols of the kernel library,
    # looked up by name: not Prometheus aliases, never on a scrape
    name, fn = ("interaction_mma", "rsdl_interaction_mma") if route == "mma" else (
        "interaction", "rsdl_interaction_fwd")  # rsdl-lint: disable=vocabulary-drift -- a C symbol, not a metric
    lib = _library(name, fn)
    out = torch.empty((b, num_pairs(n)), dtype=stacked.dtype, device=stacked.device)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(stacked.device).cuda_stream
    with torch.cuda.device(stacked.device):
        rc = getattr(lib, fn)(
            stacked.data_ptr(), out.data_ptr(), b, n, d,
            _DTYPE_CODES[stacked.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"interaction kernel ({route}) launch failed: CUDA error {rc}")
    interaction_kernel.launches += 1
    interaction_kernel.mma_launches += route == "mma"
    return out


interaction_kernel.launches = interaction_kernel.mma_launches = 0


class DotInteraction(torch.autograd.Function):
    """Kernel forward (the default route), plain backward."""

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
