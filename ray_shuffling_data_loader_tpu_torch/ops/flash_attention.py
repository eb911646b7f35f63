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
else. K2 has one more, which :func:`flash_fwd_kernel_route` picks before
those two: ``"wgmma"``, a warp-specialised kernel on Hopper's warpgroup
tensor cores fed by TMA (``csrc/flash_fwd_wgmma.cu``, shared pieces in
``csrc/flash_wgmma.cuh``), for bf16 heads of at least :data:`T_WGMMA`
tokens and a head dim in :data:`WGMMA_HEAD_DIMS`. Forward and backward
each have a short route, which
:func:`flash_fwd_route` and :func:`flash_bwd_route` pick before the other
two, for bf16 heads shorter than :data:`T_MIN` with a head dim of 8 or 16,
read from one packed projection (the TabTransformer's): ``"short"``, one
tensor-core kernel a direction, ``csrc/flash_fwd_short.cu`` for out, m and
l, ``csrc/flash_bwd_short.cu`` for dQ, dK, dV and D together (shared
pieces in ``csrc/flash_short.cuh``). On CPU tensors the
same :class:`FlashAttention` runs the two plain versions,
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
# The shortest sequence that takes K2's wgmma route: chip_smoke.py's route
# sweep times K2's three routes at [4, t, 4, hd] causal, hd 16 and 64, t 32
# to 2048, the wgmma and mma routes in alternating rounds (PERF.md). From
# t = 128 the wgmma forward was the faster at both head dims (1.4x and 1.5x
# at 128, 2.6x and 3.1x at 2048). Below, the mma forward was the faster at
# hd 16 in every call (2-7 %); at hd 64 the wgmma forward was up to 5 %
# the faster, a cost one threshold for both head dims accepts.
T_WGMMA = 128
WGMMA_HEAD_DIMS = (16, 32, 64, 128)
# K2's routes; K3 and K4 take the last two.
ROUTES = ("wgmma", "mma", "simt")
BWD_ROUTES = ROUTES[1:]
# The short route: head dims, and the widest h * hd whose batch rows a
# block of its kernels stages whole (kMaxWidth of csrc/flash_short.cuh).
SHORT_HEAD_DIMS = (8, 16)
SHORT_MAX_WIDTH = 128
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


def wgmma_supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether K2's wgmma kernel takes these ``[b, t, h, hd]`` tensors: as
    :func:`mma_supported` takes them, with ``hd`` in
    :data:`WGMMA_HEAD_DIMS` (a TMA box row of 32, 64 or 128 bytes, or two
    of 128)."""
    return q.dim() == 4 and q.shape[3] in WGMMA_HEAD_DIMS and mma_supported(q, k, v)


def flash_fwd_kernel_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """K2's route: ``"wgmma"`` where :func:`wgmma_supported` holds and the
    sequence has at least :data:`T_WGMMA` tokens, else :func:`flash_route`."""
    if wgmma_supported(q, k, v) and q.shape[1] >= T_WGMMA:
        return "wgmma"
    return flash_route(q, k, v)


def _rows_packed(x: torch.Tensor, shape, row_stride: int) -> bool:
    """Whether ``x`` is a bf16 ``[b, t, h, hd]`` of ``shape`` whose token
    rows are ``row_stride`` elements apart and whose (h, hd) are
    contiguous, with a 16-byte aligned pointer and batch stride."""
    _, _, h, hd = shape
    return (x.dtype == torch.bfloat16 and x.shape == shape and x.stride()[1:] == (row_stride, hd, 1)
            and x.data_ptr() % 16 == 0 and x.stride(0) % 8 == 0)


def _packed_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether q, k and v are the three views of one ``[b, t, 3, h, hd]``
    bf16 projection whose batch rows are contiguous and 16-byte aligned."""
    if q.dim() != 4:
        return False
    width = q.shape[2] * q.shape[3]
    step = width * q.element_size()
    return (all(_rows_packed(x, q.shape, 3 * width) and x.stride(0) == q.stride(0) for x in (q, k, v))
            and k.data_ptr() == q.data_ptr() + step and v.data_ptr() == q.data_ptr() + 2 * step)


def short_fwd_supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the short route takes this forward: bf16 heads of
    ``1 <= t <`` :data:`T_MIN` tokens, hd in :data:`SHORT_HEAD_DIMS`,
    ``h * hd <=`` :data:`SHORT_MAX_WIDTH`; q, k and v the views of one
    packed ``[b, t, 3, h, hd]`` whose batch rows are contiguous, with a
    16-byte aligned pointer and batch stride."""
    if q.dim() != 4:
        return False
    _, t, h, hd = q.shape
    return 1 <= t < T_MIN and hd in SHORT_HEAD_DIMS and h * hd <= SHORT_MAX_WIDTH and _packed_qkv(q, k, v)


def short_supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                    dout: torch.Tensor) -> bool:
    """Whether the short route takes this backward: q, k and v as
    :func:`short_fwd_supported` takes them, out and dO ``[b, t, h, hd]``
    with contiguous, 16-byte aligned batch rows."""
    return short_fwd_supported(q, k, v) and all(_rows_packed(x, q.shape, q.shape[2] * q.shape[3])
                                                for x in (out, dout))


def flash_fwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The route of the forward: ``"short"`` where
    :func:`short_fwd_supported` holds, else K2's
    :func:`flash_fwd_kernel_route`."""
    if short_fwd_supported(q, k, v):
        return "short"
    return flash_fwd_kernel_route(q, k, v)


def flash_bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                    dout: torch.Tensor) -> str:
    """The route of the backward: ``"short"`` where :func:`short_supported`
    holds, else K3's and K4's :func:`flash_route`."""
    if short_supported(q, k, v, out, dout):
        return "short"
    return flash_route(q, k, v, dout)


def _pick_route(name: str, route, tensors: Sequence[torch.Tensor], routes=BWD_ROUTES, rule=flash_route) -> str:
    """``route``, one of the kernel's ``routes``, checked against the
    tensors, or the kernel's ``rule`` when it is None."""
    if route is None:
        return rule(*tensors)
    if route not in routes:
        raise ValueError(f"{name}: route must be None or one of {routes}, got {route!r}")
    if route == "wgmma" and not wgmma_supported(*tensors):
        shapes = ", ".join(f"{x.dtype} {tuple(x.shape)}" for x in tensors)
        raise ValueError(
            f"{name}: the wgmma route takes bf16 [b, t, h, hd] tensors with hd in {WGMMA_HEAD_DIMS} "
            f"and 16-byte aligned pointers and strides; got {shapes}"
        )
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
    :func:`flash_fwd_kernel_route`) picks the kernel; ``"wgmma"`` or
    ``"mma"`` on tensors it does not take raises ``ValueError``, before the
    device check. Counts its launches in ``flash_fwd_kernel.launches``,
    those of the wgmma route also in ``flash_fwd_kernel.wgmma_launches``
    and those of the mma route in ``flash_fwd_kernel.mma_launches``."""
    route = _pick_route("flash_fwd_kernel", route, (q, k, v), ROUTES, flash_fwd_kernel_route)
    b, t, h, hd = _check_inputs("flash_fwd_kernel", (q, k, v))
    name = {"wgmma": "flash_fwd_wgmma", "mma": "flash_fwd_mma"}.get(route, "flash_fwd")
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
    flash_fwd_kernel.wgmma_launches += route == "wgmma"
    flash_fwd_kernel.mma_launches += route == "mma"
    return out, m, l


def flash_fwd_short_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the short route's forward on the current stream: ``(out, m,
    l)`` as :func:`flash_fwd_kernel` returns them, out contiguous. Tensors
    :func:`short_fwd_supported` does not take raise ``ValueError``, before
    the device check. Counts its launches in
    ``flash_fwd_short_kernel.launches``."""
    if not short_fwd_supported(q, k, v):
        shapes = ", ".join(f"{x.dtype} {tuple(x.shape)} {x.stride()}" for x in (q, k, v))
        raise ValueError(
            f"flash_fwd_short_kernel: the short route takes bf16 [b, t < {T_MIN}, h, hd] heads, hd in "
            f"{SHORT_HEAD_DIMS}, h * hd <= {SHORT_MAX_WIDTH}, q, k, v the views of one packed [b, t, 3, h, hd] "
            f"with contiguous, 16-byte aligned batch rows; got {shapes}"
        )
    b, t, h, hd = _check_inputs("flash_fwd_short_kernel", (q, k, v))
    lib = _build.load("flash_fwd_short")
    fn = lib.rsdl_flash_fwd_short
    if fn.argtypes is None:
        # qkv, out, m, l; qkv's batch stride; b, t, h, hd, causal; the stream
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device)
    m = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(), q.stride(0), b, t, h, hd, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(rc, "flash short forward kernel")
    flash_fwd_short_kernel.launches += 1
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
    ``[b, h, t]``. ``route`` (None: :func:`flash_route`) picks the kernel,
    ``"mma"`` or ``"simt"``; ``"mma"`` on tensors it does not take raises
    ``ValueError``. Counts its
    launches in ``flash_bwd_dkv_kernel.launches`` and those of the
    tensor-core route also in ``flash_bwd_dkv_kernel.mma_launches``."""
    tensors = (q, k, v, dout, dk, dv)
    route = _pick_route("flash_bwd_dkv_kernel", route, tensors)
    b, t, h, hd = _check_inputs("flash_bwd_dkv_kernel", tensors)
    _check_stats("flash_bwd_dkv_kernel", (b, h, t), q.device, (m, l, big_d))
    # rsdl-lint: disable=vocabulary-drift -- C symbols of the kernel library,
    # looked up by name: not Prometheus aliases, never on a scrape
    name, fn = ("flash_bwd_dkv_mma", "rsdl_flash_bwd_dkv_mma") if route == "mma" else (
        "flash_bwd", "rsdl_flash_bwd_dkv")  # rsdl-lint: disable=vocabulary-drift -- a C symbol, not a metric
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
    :func:`flash_bwd_dkv_kernel`. Counts its launches in
    ``flash_bwd_dq_kernel.launches`` and those of the tensor-core route also
    in ``flash_bwd_dq_kernel.mma_launches``."""
    tensors = (q, k, v, dout, dq)
    route = _pick_route("flash_bwd_dq_kernel", route, tensors)
    b, t, h, hd = _check_inputs("flash_bwd_dq_kernel", tensors)
    _check_stats("flash_bwd_dq_kernel", (b, h, t), q.device, (m, l, big_d))
    # rsdl-lint: disable=vocabulary-drift -- C symbols of the kernel library,
    # looked up by name: not Prometheus aliases, never on a scrape
    name, fn = ("flash_bwd_dq_mma", "rsdl_flash_bwd_dq_mma") if route == "mma" else (
        "flash_bwd", "rsdl_flash_bwd_dq")  # rsdl-lint: disable=vocabulary-drift -- a C symbol, not a metric
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


def flash_bwd_short_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    dq: torch.Tensor,
    dk: torch.Tensor,
    dv: torch.Tensor,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the short route's kernel on the current stream: dQ, dK and dV
    in one launch, with ``D = rowsum(dout * out)`` taken inside it, written
    into ``dq``, ``dk`` and ``dv`` (the views of one packed gradient laid out
    as q, k and v), and return them. Tensors :func:`short_supported` does
    not take raise ``ValueError``, before the device check. Counts its
    launches in ``flash_bwd_short_kernel.launches``."""
    if not short_supported(q, k, v, out, dout) or not _packed_qkv(dq, dk, dv) or dq.shape != q.shape:
        shapes = ", ".join(f"{x.dtype} {tuple(x.shape)} {x.stride()}" for x in (q, k, v, out, dout, dq))
        raise ValueError(
            f"flash_bwd_short_kernel: the short route takes bf16 [b, t < {T_MIN}, h, hd] heads, hd in "
            f"{SHORT_HEAD_DIMS}, h * hd <= {SHORT_MAX_WIDTH}, q, k, v (and dq, dk, dv) the views of one packed "
            f"[b, t, 3, h, hd] and out, dout with contiguous batch rows, 16-byte aligned; got {shapes}"
        )
    b, t, h, hd = _check_inputs("flash_bwd_short_kernel", (q, k, v, out, dout, dq, dk, dv))
    _check_stats("flash_bwd_short_kernel", (b, h, t), q.device, (m, l))
    lib = _build.load("flash_bwd_short")
    fn = lib.rsdl_flash_bwd_short
    if fn.argtypes is None:
        # qkv, out, dout, m, l, dqkv; their batch strides; b, t, h, hd,
        # causal; the stream
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), out.data_ptr(), dout.data_ptr(), m.data_ptr(), l.data_ptr(), dq.data_ptr(),
            q.stride(0), out.stride(0), dout.stride(0), dq.stride(0), b, t, h, hd, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(rc, "flash short backward kernel")
    flash_bwd_short_kernel.launches += 1
    return dq, dk, dv


def flash_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    dq: torch.Tensor,
    dk: torch.Tensor,
    dv: torch.Tensor,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' backward, written into ``dq``, ``dk`` and ``dv``, on
    :func:`flash_bwd_route`'s route: ``"short"`` launches
    :func:`flash_bwd_short_kernel`; ``"mma"`` or ``"simt"`` takes
    :func:`row_dot`, then K3 and K4 on that route."""
    route = flash_bwd_route(q, k, v, out, dout)
    if route == "short":
        return flash_bwd_short_kernel(q, k, v, out, dout, m, l, dq, dk, dv, causal)
    big_d = row_dot(dout, out)
    flash_bwd_dkv_kernel(q, k, v, dout, m, l, big_d, dk, dv, causal, route)
    flash_bwd_dq_kernel(q, k, v, dout, m, l, big_d, dq, causal, route)
    return dq, dk, dv


flash_fwd_kernel.launches = flash_fwd_kernel.wgmma_launches = flash_fwd_kernel.mma_launches = 0
flash_fwd_short_kernel.launches = 0
flash_bwd_dkv_kernel.launches = flash_bwd_dkv_kernel.mma_launches = 0
flash_bwd_dq_kernel.launches = flash_bwd_dq_kernel.mma_launches = 0
flash_bwd_short_kernel.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention over a packed ``qkv`` ``[b, t, 3, h, hd]``: the forward on
    :func:`flash_fwd_route`'s route (the short kernel, or K2 on its own
    route), saving
    ``(qkv, out, m, l)``; :func:`flash_backward` (the short kernel, or K3
    then K4), writing into views of one packed gradient. On CPU tensors,
    the plain versions of the same."""

    @staticmethod
    def forward(ctx, qkv, causal: bool):
        q, k, v = qkv.unbind(2)
        if qkv.is_cuda:
            if flash_fwd_route(q, k, v) == "short":
                out, m, l = flash_fwd_short_kernel(q, k, v, causal)
            else:
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
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        flash_backward(q, k, v, out, dout, m, l, *dqkv.unbind(2), ctx.causal)
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
