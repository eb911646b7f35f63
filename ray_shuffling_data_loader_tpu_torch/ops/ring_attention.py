"""Sequence-parallel exact attention over a process group: ring and
Ulysses, and the single-device attention in key chunks that Ulysses runs
on the CPU.

Each rank of a sequence-parallel group holds one chunk of the sequence,
``[batch, seq / p, heads, head_dim]``, in group-rank order; the functions
here take and return such chunks. Both schedules are exact, forward and
backward, against dense attention on the whole sequence.

**Ring**: Q stays put; the K/V chunks take ``p`` hops around the group
(send to rank ``me + 1``, receive from ``me − 1``), and each hop folds its
block into a running softmax (row max ``m``, normalizer ``l``,
un-normalized output, all float32). The backward runs its own ring:
``(k, v, dk, dv)`` rotate together, dk and dv accumulate in float32 and
arrive home after ``p`` hops, and the score blocks are recomputed from the
saved ``(m, l)``. With ``use_flash`` each forward hop is the flash kernel
K2, which returns its block's ``(out, m, l)``: on the diagonal the causal
kernel, below it the plain one, and above it none (the hop still passes
its K/V on).

**Ulysses**: one all-to-all turns sequence chunks of all heads into the
whole sequence of ``heads / p`` heads; this rank attends over it (the
flash kernels K2, K3, K4 with ``use_flash``; :func:`blockwise_attention`
else), and the inverse all-to-all returns sequence chunks. Needs ``heads
% p == 0``.

``use_flash=None`` means the kernels on CUDA tensors and the plain tensor
code on CPU tensors. ``use_flash=True`` on CPU tensors runs the same hops
with the kernels' plain versions; ``use_flash=False`` runs the plain
tensor code on either device (the comparisons use it). A group of None is
this rank alone.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ray_shuffling_data_loader_tpu_torch.ops.flash_attention import (
    NEG_INF,
    attention_reference,
    flash_attention_qkv,
    flash_forward_reference,
    flash_fwd_kernel,
)
from ray_shuffling_data_loader_tpu_torch.parallel.collectives import all_to_all, group_size_rank, p2p


def _stats_update(m, l, s):
    """Fold score block ``s`` ([b, h, tq, ck]) into the running softmax
    statistics; returns the rescale factor and probabilities too. Rows
    with no valid key yet keep probabilities of 0 (their ``m`` is still the
    finite NEG_INF), so fully masked rows finish as 0."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p_ij = torch.exp(s - m_new[..., None])
    p_ij = torch.where(m_new[..., None] > NEG_INF / 2, p_ij, 0.0)
    l_new = l * alpha + p_ij.sum(dim=-1)
    return m_new, l_new, alpha, p_ij


def _online_update(o, m, l, s, v_c):
    """One flash-style step: the statistics and the un-normalized output
    against values ``v_c`` ([b, ck, h, d])."""
    m_new, l_new, alpha, p_ij = _stats_update(m, l, s)
    o_new = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p_ij, v_c.float())
    return o_new, m_new, l_new


def _accum_init(b, h, tq, d, device):
    return (
        torch.zeros((b, h, tq, d), dtype=torch.float32, device=device),
        torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=device),
        torch.zeros((b, h, tq), dtype=torch.float32, device=device),
    )


def _accum_finish(o, l, out_dtype):
    # Fully masked rows have o == l == 0: the clamped divide gives 0.
    out = o / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(out_dtype)


def _ring_mask(s, i, me, p, tq, tk):
    """The global-position causal mask of hop ``i`` (chunk ``(me − i) % p``)."""
    chunk = (me - i) % p
    q_pos = me * tq + torch.arange(tq, device=s.device)
    k_pos = chunk * tk + torch.arange(tk, device=s.device)
    return torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)


def _hop_kind(causal: bool, i: int, me: int, p: int) -> str:
    """What hop ``i`` computes: ``"full"``, ``"diagonal"`` (the causal
    block of this rank's own chunk) or ``"masked"`` (a later chunk: no
    query sees it)."""
    if not causal:
        return "full"
    chunk = (me - i) % p
    return "diagonal" if chunk == me else "full" if chunk < me else "masked"


def _flash_hop(q, k, v, causal: bool):
    """K2 on CUDA tensors, its plain version on CPU tensors."""
    if q.is_cuda:
        return flash_fwd_kernel(q, k, v, causal)
    return flash_forward_reference(q, k, v, causal)


def _rotate(tensors, group, p: int, me: int):
    """Pass ``tensors`` on one hop: send to ``me + 1``, receive from ``me − 1``."""
    return p2p(list(tensors), group, send_to=(me + 1) % p, recv_from=(me - 1) % p)


def _ring_fwd_local(q, k, v, group, causal: bool, use_flash: bool):
    """The forward ring: ``(out, m, l)``; the statistics are the backward's
    residuals."""
    p, me = group_size_rank(group)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    o, m, l = _accum_init(b, h, tq, d, q.device)
    qf = q.float() * (1.0 / math.sqrt(d))
    k_c, v_c = k, v
    for i in range(p):
        kind = _hop_kind(causal, i, me, p)
        if kind != "masked":
            if use_flash:
                o_i, m_i, l_i = _flash_hop(q, k_c, v_c, kind == "diagonal")
                # Merge the hop's normalized block: un-normalize with l_i,
                # rescale both sides to the joint max.
                o_i = o_i.float().permute(0, 2, 1, 3) * l_i[..., None]
                m_new = torch.maximum(m, m_i)
                alpha, beta = torch.exp(m - m_new), torch.exp(m_i - m_new)
                o = o * alpha[..., None] + o_i * beta[..., None]
                l = l * alpha + l_i * beta
                m = m_new
            else:
                s = torch.einsum("bqhd,bkhd->bhqk", qf, k_c.float())
                if causal:
                    s = _ring_mask(s, i, me, p, tq, tk)
                o, m, l = _online_update(o, m, l, s, v_c)
        if i < p - 1:
            k_c, v_c = _rotate((k_c, v_c), group, p, me)
    return _accum_finish(o, l, q.dtype), m, l


def _ring_bwd_local(q, k, v, out, m, l, dout, group, causal: bool):
    """The backward ring: ``(dq, dk, dv)``. Each hop recomputes its score
    block from the saved statistics; dk and dv travel with their chunk."""
    p, me = group_size_rank(group)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf, dof = q.float(), dout.float()
    l_safe = l.clamp_min(1e-30)
    live = (m > NEG_INF / 2)[..., None]
    big_d = torch.einsum("bqhd,bqhd->bhq", dof, out.float())
    dq = torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device)
    dk_c = torch.zeros((b, tk, h, d), dtype=torch.float32, device=q.device)
    dv_c = torch.zeros_like(dk_c)
    k_c, v_c = k, v
    for i in range(p):
        if _hop_kind(causal, i, me, p) != "masked":
            kf, vf = k_c.float(), v_c.float()
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
            if causal:
                s = _ring_mask(s, i, me, p, tq, tk)
            prob = torch.where(live, torch.exp(s - m[..., None]) / l_safe[..., None], 0.0)
            dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
            ds = prob * (dp - big_d[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
            dk_c = dk_c + torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
            dv_c = dv_c + torch.einsum("bhqk,bqhd->bkhd", prob, dof)
        # After p hops every chunk's dk, dv are home; k, v need p - 1.
        if i < p - 1:
            k_c, v_c, dk_c, dv_c = _rotate((k_c, v_c, dk_c, dv_c), group, p, me)
        elif p > 1:
            dk_c, dv_c = _rotate((dk_c, dv_c), group, p, me)
    return dq.to(q.dtype), dk_c.to(k.dtype), dv_c.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool, use_flash: bool):
        out, m, l = _ring_fwd_local(q, k, v, group, causal, use_flash)
        ctx.group, ctx.causal = group, causal
        ctx.save_for_backward(q, k, v, out, m, l)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = _ring_bwd_local(q, k, v, out, m, l, dout, ctx.group, ctx.causal)
        return dq, dk, dv, None, None, None


def _blockwise_fwd(q, k, v, causal: bool, kv_chunk: int, with_output: bool = True):
    """Attention in key chunks: ``(out, m, l)``, with ``out`` in q's dtype
    and ``m``, ``l`` float32 ``[b, h, tq]``. ``with_output=False`` skips the
    values (``out`` is None): the backward needs only the statistics."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    chunk = min(kv_chunk, tk)
    nch = -(-tk // chunk)
    pad = nch * chunk - tk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qf = q.float() * (1.0 / math.sqrt(d))
    q_pos = torch.arange(tq, device=q.device)
    o, m, l = _accum_init(b, h, tq, d, q.device)
    for i in range(nch):
        k_c = k[:, i * chunk:(i + 1) * chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_c.float())
        if pad or causal:
            k_pos = i * chunk + torch.arange(chunk, device=q.device)
            valid = (k_pos < tk)[None, :]
            if causal:
                valid = valid & (q_pos[:, None] >= k_pos[None, :])
            s = torch.where(valid, s, NEG_INF)
        if with_output:
            o, m, l = _online_update(o, m, l, s, v[:, i * chunk:(i + 1) * chunk])
        else:
            m, l, _, _ = _stats_update(m, l, s)
    return (_accum_finish(o, l, q.dtype) if with_output else None), m, l


def _chunked_attention_bwd(q, k, v, out, dout, causal: bool, kv_chunk: int):
    """The exact attention backward in key chunks: one chunked pass for
    the softmax statistics, then per chunk ``ds = p ⊙ (dO·vᵀ − D)`` with
    ``D = rowsum(dO ⊙ out)``, accumulating dq and emitting that chunk's dk
    and dv. The extra memory is ``[b, h, tq, kv_chunk]``, never ``[T, T]``.
    Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    chunk = min(kv_chunk, tk)
    nch = -(-tk // chunk)
    pad = nch * chunk - tk
    _, m, l = _blockwise_fwd(q, k, v, causal, kv_chunk, with_output=False)
    l = l.clamp_min(1e-30)
    live = (m > NEG_INF / 2)[..., None]
    kp, vp = (F.pad(k, (0, 0, 0, 0, 0, pad)), F.pad(v, (0, 0, 0, 0, 0, pad))) if pad else (k, v)
    scale = 1.0 / math.sqrt(d)
    qf, dof = q.float(), dout.float()
    big_d = torch.einsum("bqhd,bqhd->bhq", dof, out.float())
    q_pos = torch.arange(tq, device=q.device)
    dq = torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for i in range(nch):
        k_c = kp[:, i * chunk:(i + 1) * chunk].float()
        v_c = vp[:, i * chunk:(i + 1) * chunk].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_c) * scale
        if pad or causal:
            k_pos = i * chunk + torch.arange(chunk, device=q.device)
            valid = (k_pos < tk)[None, :]
            if causal:
                valid = valid & (q_pos[:, None] >= k_pos[None, :])
            s = torch.where(valid, s, NEG_INF)
        prob = torch.where(live, torch.exp(s - m[..., None]) / l[..., None], 0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, v_c)
        ds = prob * (dp - big_d[..., None])
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_c) * scale
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale)
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", prob, dof))
    dk = torch.cat(dks, dim=1)[:, :tk]
    dv = torch.cat(dvs, dim=1)[:, :tk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _BlockwiseAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, kv_chunk: int):
        out, _, _ = _blockwise_fwd(q, k, v, causal, kv_chunk)
        ctx.causal, ctx.kv_chunk = causal, kv_chunk
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = _chunked_attention_bwd(q, k, v, out, dout, ctx.causal, ctx.kv_chunk)
        return dq, dk, dv, None, None


def blockwise_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False, kv_chunk: int = 1024
) -> torch.Tensor:
    """Exact attention over ``[batch, seq, heads, head_dim]`` on one device,
    in key chunks of ``kv_chunk`` (an online softmax): the score memory is
    ``[b, h, tq, kv_chunk]``, forward and backward (the backward recomputes
    each chunk)."""
    return _BlockwiseAttention.apply(q, k, v, causal, kv_chunk)


def _resolve_flash(use_flash: Optional[bool], q: torch.Tensor) -> bool:
    """``None``: the kernels on CUDA tensors, the plain tensor code on CPU
    tensors."""
    return q.is_cuda if use_flash is None else use_flash


def make_ring_attention(group, causal: bool = False, use_flash: Optional[bool] = None):
    """Ring attention over ``group`` (the sequence-parallel group; None: this
    rank alone): ``fn(q, k, v) -> out`` on this rank's sequence chunks
    ``[batch, seq / p, heads, head_dim]``, differentiable. Every rank of the
    group must call it with chunks of one shape, in group-rank order of the
    sequence."""

    def ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return _RingAttention.apply(q, k, v, group, causal, _resolve_flash(use_flash, q))

    return ring


def ring_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None, causal: bool = False
) -> torch.Tensor:
    """One-shot :func:`make_ring_attention`; dense attention
    (:func:`attention_reference`) when no group is given."""
    if group is None:
        return attention_reference(q, k, v, causal=causal)
    return make_ring_attention(group, causal)(q, k, v)


def _ulysses_local(q, k, v, group, causal: bool, kv_chunk: int, use_flash: bool):
    p, _ = group_size_rank(group)
    if q.shape[2] % p:
        raise ValueError(f"Ulysses attention needs heads divisible by the group size: {q.shape[2]} heads, {p} ranks")
    # [B, T/p, 3, H, D] -> [B, T, 3, H/p, D]: split heads, gather the sequence.
    qkv = all_to_all(torch.stack((q, k, v), dim=2), group, split_dim=3, concat_dim=1)
    if use_flash:
        out = flash_attention_qkv(qkv, causal)
    else:
        out = blockwise_attention(*qkv.unbind(2), causal=causal, kv_chunk=kv_chunk)
    # [B, T, H/p, D] -> [B, T/p, H, D]: back to sequence chunks.
    return all_to_all(out, group, split_dim=1, concat_dim=2)


def make_ulysses_attention(group, causal: bool = False, kv_chunk: int = 1024, use_flash: Optional[bool] = None):
    """All-to-all (Ulysses) attention over ``group``: ``fn(q, k, v) -> out``
    on sequence chunks, as :func:`make_ring_attention`. One all-to-all each
    way (q, k and v travel in one); this rank attends over the whole
    sequence of ``heads / p`` heads, with the flash kernels or
    :func:`blockwise_attention` in chunks of ``kv_chunk``. Raises
    ``ValueError`` when the heads do not divide by the group's size."""

    def ulysses(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return _ulysses_local(q, k, v, group, causal, kv_chunk, _resolve_flash(use_flash, q))

    return ulysses
