"""Flash attention over ``[batch, seq, heads, head_dim]``, forward and
backward.

On CUDA tensors the forward is the hand-written kernel K2, which also
returns the float32 softmax row statistics ``(m, l)``, and the backward is
dK and dV (K3), then dQ (K4), both recomputing the probabilities from the
saved statistics. ``D = rowsum(dO * out)`` between them is plain tensor
code. Each kernel has two routes, which :func:`flash_route` picks per
call, one rule for all three: ``"mma"``, tensor-core kernels
(``csrc/flash_fwd_mma.cu``, ``csrc/flash_bwd_dkv_mma.cu``,
``csrc/flash_bwd_dq_mma.cu``) for bf16 heads of at least :data:`T_MIN`
tokens and a head dim that is a multiple of 16; ``"simt"``, the CUDA-core
kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), for everything
else. On CPU tensors the same :class:`FlashAttention` runs the two plain versions,
:func:`flash_forward_reference` and :func:`flash_backward_reference`, which
compute the same quantities densely and hand over the same statistics.
There is no fallback from one to the other: a kernel that fails to build
or launch raises. ``RSDL_FLASH_BWD=xla`` (the JAX package's escape hatch)
replaces K3 and K4, on either device, by the exact backward in key chunks
of :func:`~.ring_attention.blockwise_attention`.

The kernels take strided tensors with a contiguous last dim. The
Function works on one packed ``[b, t, 3, h, hd]`` projection: the kernels
read ``q``, ``k`` and ``v`` as views of it, and the backward writes dQ, dK
and dV into views of one packed gradient, so autograd neither copies the
inputs nor zero-fills and adds a full-size gradient per view.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Sequence, Tuple

import torch

from ray_shuffling_data_loader_tpu_torch.ops import _build

NEG_INF = -1e30  # finite "minus infinity": NEG_INF - NEG_INF is 0, not NaN
MAX_HEAD_DIM = 128  # kMaxHeadDim of csrc/flash_common.cuh
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The shortest sequence that takes the tensor-core route. chip_smoke.py's
# route sweep times both routes of K2, K3 and K4 on the card at
# [4, t, 4, hd] causal, hd 16 and 64, t 32 to 256: the tensor-core route
# was the faster at every point, t = 32 included (PERF.md), so the
# crossover lies at or below the sweep's shortest t.
T_MIN = 32
ROUTES = ("mma", "simt")
# The key chunk of the RSDL_FLASH_BWD=xla backward: the JAX package's
# max(block_k, 128) at its default block_k of 128.
FLASH_BWD_XLA_CHUNK = 128


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Dense softmax attention, ``[batch, seq, heads, head_dim]``, scores in
    float32, causal positions masked with the finite ``NEG_INF``."""
    w = torch.softmax(_scores(q, k, causal), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scaled, masked float32 scores ``[b, h, tq, tk]``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = s.shape[-1]
        pos = torch.arange(t, device=s.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, NEG_INF)
    return s


def row_dot(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``D = rowsum(dout ⊙ out)`` in float32, contiguous ``[b, h, t]``: the
    softmax Jacobian's diagonal term of the backward. An elementwise
    product and a sum (as an ``einsum`` it lowers to one matrix-vector
    product per row on CUDA, many times slower)."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_forward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of K2: ``(out, m, l)``, with ``m`` and ``l`` float32
    ``[b, h, t]``: the row max of the scaled, masked scores and
    ``sum(exp(s - m))``. Rows whose max is still ``NEG_INF`` get
    probabilities of 0; ``out = acc / max(l, 1e-30)`` in q's dtype."""
    s = _scores(q, k, causal)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(m[..., None] > NEG_INF / 2, p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = acc / l.clamp_min(1e-30).permute(0, 2, 1)[..., None]
    return out.to(q.dtype), m, l


def flash_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    dout: torch.Tensor,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of K3 and K4: ``(dq, dk, dv)`` from the saved
    statistics, densely and in float32, each cast to its input's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, causal)
    p = torch.exp(s - m[..., None]) / l.clamp_min(1e-30)[..., None]
    p = torch.where(m[..., None] > NEG_INF / 2, p, 0.0)
    do = dout.float()
    big_d = row_dot(dout, out)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = p * (dp - big_d[..., None])
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def mma_supported(*tensors: torch.Tensor) -> bool:
    """Whether the tensor-core kernels take these ``[b, t, h, hd]`` tensors
    (the inputs and outputs of one call): bf16, one shape, ``hd`` a multiple
    of 16 up to 128, a contiguous last dim, and 16-byte aligned pointers and
    (b, t, h) strides, as ``vectorizable`` of ``csrc/flash_common.cuh``
    checks them."""
    q = tensors[0]
    if q.dim() != 4 or q.shape[3] % 16 or q.shape[3] > MAX_HEAD_DIM:
        return False
    for x in tensors:
        if x.dtype != torch.bfloat16 or x.shape != q.shape or x.stride(-1) != 1:
            return False
        if x.data_ptr() % 16 or any(s * x.element_size() % 16 for s in x.stride()[:3]):
            return False
    return True


def flash_route(*tensors: torch.Tensor) -> str:
    """The route of K2, K3 and K4 for these tensors: ``"mma"`` where
    :func:`mma_supported` holds and the sequence has at least
    :data:`T_MIN` tokens, else ``"simt"``."""
    if mma_supported(*tensors) and tensors[0].shape[1] >= T_MIN:
        return "mma"
    return "simt"


def _pick_route(name: str, route, tensors: Sequence[torch.Tensor]) -> str:
    """``route`` checked against the tensors, or :func:`flash_route` when
    it is None."""
    if route is None:
        return flash_route(*tensors)
    if route not in ROUTES:
        raise ValueError(f"{name}: route must be None or one of {ROUTES}, got {route!r}")
    if route == "mma" and not mma_supported(*tensors):
        shapes = ", ".join(f"{x.dtype} {tuple(x.shape)}" for x in tensors)
        raise ValueError(
            f"{name}: the mma route takes bf16 [b, t, h, hd] tensors with hd a multiple of 16 "
            f"up to {MAX_HEAD_DIM} and 16-byte aligned pointers and strides; got {shapes}"
        )
    return route


def _library(name: str, fn_name: str, n_ptrs: int) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        # pointers, strides, then b, t, h, hd, causal, dtype, and the stream
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptrs + [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def _check_inputs(name: str, tensors: Sequence[torch.Tensor]) -> Tuple[int, int, int, int]:
    q = tensors[0]
    for x in tensors:
        if not x.is_cuda:
            raise ValueError(f"{name} needs CUDA tensors")
        if x.device != q.device:
            raise ValueError(f"{name}: tensors on {x.device} and {q.device}")
        if x.dtype not in _DTYPE_CODES or x.dtype != q.dtype:
            raise TypeError(f"{name} takes one dtype, float32 or bfloat16; got {x.dtype} and {q.dtype}")
        if x.dim() != 4 or x.shape != q.shape:
            raise ValueError(f"{name} takes [b, t, h, hd] tensors of one shape, got {tuple(x.shape)}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dim")
    b, t, h, hd = q.shape
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"{name} takes 1 <= head_dim <= {MAX_HEAD_DIM}, got {hd}")
    return b, t, h, hd


def _check_stats(name: str, shape: Tuple[int, int, int], device, stats: Sequence[torch.Tensor]) -> None:
    for x in stats:
        if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} takes contiguous float32 [b, h, t] = {shape} statistics")
        if x.device != device:
            raise ValueError(f"{name}: statistics on {x.device}, inputs on {device}")


def _strides(tensors: Sequence[torch.Tensor]):
    vals = [s for x in tensors for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def flash_fwd_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False, route=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2 on the current stream: ``(out, m, l)``. ``route`` (None:
    :func:`flash_route`) picks the kernel; ``"mma"`` on tensors it does not
    take raises ``ValueError``. Counts its launches in
    ``flash_fwd_kernel.launches``, those of the tensor-core route also in
    ``flash_fwd_kernel.mma_launches``."""
    route = _pick_route("flash_fwd_kernel", route, (q, k, v))
    b, t, h, hd = _check_inputs("flash_fwd_kernel", (q, k, v))
    name = "flash_fwd_mma" if route == "mma" else "flash_fwd"
    fn = f"rsdl_{name}"
    lib = _library(name, fn, 6)
    out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device)
    m = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        rc = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
            _strides((q, k, v, out)), b, t, h, hd, int(causal), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(rc, f"flash forward kernel ({route})")
    flash_fwd_kernel.launches += 1
    flash_fwd_kernel.mma_launches += route == "mma"
    return out, m, l


def flash_bwd_dkv_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    big_d: torch.Tensor,
    dk: torch.Tensor,
    dv: torch.Tensor,
    causal: bool = False,
    route=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on the current stream, writing into ``dk`` and ``dv``
    (``[b, t, h, hd]`` in q's dtype, any strides but a contiguous last dim),
    and return them. ``big_d`` is ``rowsum(dout * out)``, float32
    ``[b, h, t]``. ``route`` as for :func:`flash_fwd_kernel`. Counts its
    launches in ``flash_bwd_dkv_kernel.launches`` and those of the
    tensor-core route also in ``flash_bwd_dkv_kernel.mma_launches``."""
    tensors = (q, k, v, dout, dk, dv)
    route = _pick_route("flash_bwd_dkv_kernel", route, tensors)
    b, t, h, hd = _check_inputs("flash_bwd_dkv_kernel", tensors)
    _check_stats("flash_bwd_dkv_kernel", (b, h, t), q.device, (m, l, big_d))
    name, fn = ("flash_bwd_dkv_mma", "rsdl_flash_bwd_dkv_mma") if route == "mma" else (
        "flash_bwd", "rsdl_flash_bwd_dkv")
    lib = _library(name, fn, 9)
    with torch.cuda.device(q.device):
        rc = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            m.data_ptr(), l.data_ptr(), big_d.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides(tensors), b, t, h, hd, int(causal), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(rc, f"flash dK/dV kernel ({route})")
    flash_bwd_dkv_kernel.launches += 1
    flash_bwd_dkv_kernel.mma_launches += route == "mma"
    return dk, dv


def flash_bwd_dq_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    big_d: torch.Tensor,
    dq: torch.Tensor,
    causal: bool = False,
    route=None,
) -> torch.Tensor:
    """Launch K4 on the current stream, writing into ``dq`` (as ``dk`` of
    :func:`flash_bwd_dkv_kernel`), and return it. ``route`` as for
    :func:`flash_fwd_kernel`. Counts its launches in
    ``flash_bwd_dq_kernel.launches`` and those of the tensor-core route also
    in ``flash_bwd_dq_kernel.mma_launches``."""
    tensors = (q, k, v, dout, dq)
    route = _pick_route("flash_bwd_dq_kernel", route, tensors)
    b, t, h, hd = _check_inputs("flash_bwd_dq_kernel", tensors)
    _check_stats("flash_bwd_dq_kernel", (b, h, t), q.device, (m, l, big_d))
    name, fn = ("flash_bwd_dq_mma", "rsdl_flash_bwd_dq_mma") if route == "mma" else (
        "flash_bwd", "rsdl_flash_bwd_dq")
    lib = _library(name, fn, 8)
    with torch.cuda.device(q.device):
        rc = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            m.data_ptr(), l.data_ptr(), big_d.data_ptr(), dq.data_ptr(),
            _strides(tensors), b, t, h, hd, int(causal), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(rc, f"flash dQ kernel ({route})")
    flash_bwd_dq_kernel.launches += 1
    flash_bwd_dq_kernel.mma_launches += route == "mma"
    return dq


flash_fwd_kernel.launches = flash_fwd_kernel.mma_launches = 0
flash_bwd_dkv_kernel.launches = flash_bwd_dkv_kernel.mma_launches = 0
flash_bwd_dq_kernel.launches = flash_bwd_dq_kernel.mma_launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention over a packed ``qkv`` ``[b, t, 3, h, hd]``: K2 forward
    saving ``(qkv, out, m, l)``; K3 then K4 backward, writing into views of
    one packed gradient. On CPU tensors, the plain versions of the same."""

    @staticmethod
    def forward(ctx, qkv, causal: bool):
        q, k, v = qkv.unbind(2)
        if qkv.is_cuda:
            out, m, l = flash_fwd_kernel(q, k, v, causal)
        else:
            out, m, l = flash_forward_reference(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(qkv, out, m, l)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, m, l = ctx.saved_tensors
        q, k, v = qkv.unbind(2)
        if os.environ.get("RSDL_FLASH_BWD", "pallas").lower() == "xla":
            # The escape hatch of the JAX package's flash VJP: the exact
            # backward in key chunks of 128, in place of K3 and K4.
            from ray_shuffling_data_loader_tpu_torch.ops.ring_attention import _chunked_attention_bwd

            grads = _chunked_attention_bwd(q, k, v, out, dout, ctx.causal, FLASH_BWD_XLA_CHUNK)
            return torch.stack(grads, dim=2), None
        if not qkv.is_cuda:
            grads = flash_backward_reference(q, k, v, out, m, l, dout, ctx.causal)
            return torch.stack(grads, dim=2), None
        # The kernels take dO with any strides but a contiguous last dim;
        # only a cotangent strided there is copied.
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        big_d = row_dot(dout, out)
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        dq, dk, dv = dqkv.unbind(2)
        flash_bwd_dkv_kernel(q, k, v, dout, m, l, big_d, dk, dv, ctx.causal)
        flash_bwd_dq_kernel(q, k, v, dout, m, l, big_d, dq, ctx.causal)
        return dqkv, None


def flash_attention_qkv(qkv: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Softmax attention over a packed ``[batch, seq, 3, heads, head_dim]``
    projection (q, k, v along dim 2), exact and differentiable: the kernels
    on CUDA tensors, the plain versions on CPU tensors. Returns
    ``[batch, seq, heads, head_dim]``."""
    return FlashAttention.apply(qkv, causal)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """:func:`flash_attention_qkv` over separate ``[batch, seq, heads,
    head_dim]`` tensors, stacked into one packed copy first."""
    return flash_attention_qkv(torch.stack((q, k, v), dim=2), causal)
