"""The port's sequence-parallel attention against the JAX package's, on the
same numpy inputs at ``tests/test_ring_attention.py``'s shape: ring (4
ranks) and Ulysses (2 ranks), causal and not, with each hop or body on
the plain tensor code and on the flash path (the port's plain versions of
K2–K4 on the CPU, JAX's Pallas kernels in interpret mode), forward and
gradients of ``sum(out ** 2)``; ``blockwise_attention``; the
``RSDL_FLASH_BWD=xla`` backward; and the encoder's ``attention_fn`` hook.
Ranks run as ``gloo`` processes on the CPU, each under a deadline and
killed on failure; JAX runs in this process on the virtual devices."""

import functools
import importlib
import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_port_helpers as helpers
from ray_shuffling_data_loader_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from ray_shuffling_data_loader_tpu_torch import ops as port_ops
from ray_shuffling_data_loader_tpu_torch.models import CausalLM, EncoderBlock, transformer_for_data_spec
from ray_shuffling_data_loader_tpu_torch.models.transformer import dense
from ray_shuffling_data_loader_tpu_torch.ops.flash_attention import FLASH_BWD_XLA_CHUNK

# The packages' ``ops.ring_attention`` is the one-shot function; the modules:
jax_ring = importlib.import_module("ray_shuffling_data_loader_tpu.ops.ring_attention")
port_ring = importlib.import_module("ray_shuffling_data_loader_tpu_torch.ops.ring_attention")

B, T, H, D = 2, 64, 2, 8  # tests/test_ring_attention.py's shape
RING_P, ULYSSES_P = 4, 2  # Ulysses needs H % p == 0
KV_CHUNK = 24  # ragged against T: the blockwise body's padded last chunk
# tests/test_ring_attention.py's tolerances: the forward 2e-5, gradients 1e-4.
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
DEADLINE_S = 90
CASES = [(schedule, causal, flash) for schedule in ("ring", "ulysses")
         for causal in (False, True) for flash in (False, True)]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _qkv(seed, shape=(B, T, H, D)):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))


def _case_name(schedule, causal, flash):
    return f"{schedule}_{'causal' if causal else 'full'}_{'flash' if flash else 'plain'}"


def _jax_case(schedule, causal, flash, q, k, v):
    """JAX's op over a one-axis mesh of the case's size: ``(out, dq, dk, dv)``."""
    p = RING_P if schedule == "ring" else ULYSSES_P
    mesh = Mesh(np.array(jax.devices()[:p]), ("sp",))
    if schedule == "ring":
        fn = jax_ring.make_ring_attention(mesh, "sp", causal=causal, use_flash=flash)
    else:
        fn = jax_ring.make_ulysses_attention(mesh, "sp", causal=causal, kv_chunk=KV_CHUNK, use_flash=flash)
    q, k, v = (jnp.asarray(x) for x in (q, k, v))
    grads = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) ** 2), (0, 1, 2))(q, k, v)
    return (np.asarray(fn(q, k, v)), *(np.asarray(g) for g in grads))


def _wait_all(procs, deadline_s=DEADLINE_S):
    deadline = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errs = [p.stderr.read() if p.stderr else "" for p in procs]
    assert all(p.returncode == 0 for p in procs), errs


@pytest.fixture(scope="module")
def sp_ranks(tmp_path_factory):
    """The port's cases, each group of ranks spawned once: ``{world:
    [per-rank results]}`` and the inputs."""
    root = tmp_path_factory.mktemp("sp")
    q, k, v = _qkv(10)
    np.savez(str(root / "inputs.npz"), q=q, k=k, v=v)
    results = {}
    for world in (RING_P, ULYSSES_P):
        schedule = "ring" if world == RING_P else "ulysses"
        out_dir = root / f"world{world}"
        out_dir.mkdir()
        spec = {
            "world": world, "inputs": str(root / "inputs.npz"), "kv_chunk": KV_CHUNK,
            "sp_cases": [(_case_name(*c), c[0], c[1], c[2]) for c in CASES if c[0] == schedule],
            "ulysses_mismatch": world == RING_P,  # 2 heads over 4 ranks
            "init_method": f"tcp://localhost:{_free_port()}", "out_dir": str(out_dir),
        }
        spec_path = str(out_dir / "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        helper = os.path.join(helpers.REPO, "tests", "torch_port_helpers.py")
        _wait_all([subprocess.Popen([sys.executable, helper, spec_path, str(r)], stderr=subprocess.PIPE, text=True)
                   for r in range(world)])
        results[world] = [dict(np.load(str(out_dir / f"rank{r}.npz"))) for r in range(world)]
    return results, (q, k, v)


@pytest.mark.parametrize("schedule,causal,flash", CASES)
def test_sequence_parallel_matches_jax(sp_ranks, schedule, causal, flash):
    """Each rank's output and gradients are its sequence chunk of JAX's on
    the global arrays, for the plain hops/body and the flash path."""
    results, (q, k, v) = sp_ranks
    ranks = results[RING_P if schedule == "ring" else ULYSSES_P]
    name = _case_name(schedule, causal, flash)
    want = _jax_case(schedule, causal, flash, q, k, v)
    for key, w in zip(("out", "dq", "dk", "dv"), want):
        got = np.concatenate([r[f"{name}_{key}"] for r in ranks], axis=1)
        np.testing.assert_allclose(got, w, **(FWD_TOL if key == "out" else GRAD_TOL), err_msg=f"{name} {key}")


def test_ranks_load_no_jax_and_ulysses_refuses_heads_that_do_not_split(sp_ranks):
    results, _ = sp_ranks
    for ranks in results.values():
        assert all(r["loaded_jax"].size == 0 for r in ranks)
    for r in results[RING_P]:
        assert "heads divisible by the group size" in str(r["mismatch_error"])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_chunk", [16, 24, 1024])
def test_blockwise_matches_jax(causal, kv_chunk):
    """Forward and gradients, a ragged last chunk and a chunk above T
    among them (tests/test_ring_attention.py's shape)."""
    q, k, v = _qkv(6, (2, 56, 2, 8))
    jfn = functools.partial(jax_ring.blockwise_attention, causal=causal, kv_chunk=kv_chunk)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = [np.asarray(jfn(jq, jk, jv))]
    want += [np.asarray(g) for g in jax.grad(lambda *a: jnp.sum(jfn(*a) ** 2), (0, 1, 2))(jq, jk, jv)]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = port_ops.blockwise_attention(tq, tk, tv, causal=causal, kv_chunk=kv_chunk)
    (out ** 2).sum().backward()
    for key, got, w in zip(("out", "dq", "dk", "dv"), (out, tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.detach().numpy(), w, **(FWD_TOL if key == "out" else GRAD_TOL), err_msg=key)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_xla_escape_hatch_matches_jax(monkeypatch, causal):
    """``RSDL_FLASH_BWD=xla``: the port's flash backward is the chunked one,
    and its gradients are JAX's (whose Pallas VJP takes the same hatch)."""
    monkeypatch.setenv("RSDL_FLASH_BWD", "xla")
    calls = []
    chunked = port_ring._chunked_attention_bwd

    def counted(*args):
        calls.append(args[-1])
        return chunked(*args)

    monkeypatch.setattr(port_ring, "_chunked_attention_bwd", counted)
    q, k, v = _qkv(3, (2, 192, 2, 8))  # 192 keys: two chunks of 128, the last ragged
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jfn = functools.partial(jax_flash_attention, causal=causal, use_pallas=True, interpret=True,
                            block_q=16, block_k=16)
    want = jax.grad(lambda *a: jnp.sum(jfn(*a) ** 2), (0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    (port_ops.flash_attention(tq, tk, tv, causal) ** 2).sum().backward()
    assert calls == [FLASH_BWD_XLA_CHUNK] == [128]
    for key, got, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL, err_msg=key)


def test_ring_without_a_group_is_dense_attention():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2))
    for causal in (False, True):
        torch.testing.assert_close(port_ops.ring_attention(q, k, v, causal=causal),
                                   port_ops.attention_reference(q, k, v, causal=causal), rtol=0, atol=0)


def _block_before_the_hook(block, x):
    """``EncoderBlock.forward`` as it was before ``attention_fn``: the packed
    projection straight into ``flash_attention_qkv``."""
    import torch.nn.functional as F

    b, t, d = x.shape
    h = block.ln_attn(x)
    qkv = dense(block.qkv, h, x.dtype).reshape(b, t, 3, block.num_heads, d // block.num_heads)
    x = x + dense(block.proj, port_ops.flash_attention_qkv(qkv, block.causal).reshape(b, t, d), x.dtype)
    h = F.gelu(dense(block.mlp_up, block.ln_mlp(x), x.dtype), approximate="tanh")
    return x + dense(block.mlp_down, h, x.dtype)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_fn_none_leaves_the_block_bit_equal(causal):
    gen = torch.Generator().manual_seed(0)
    block = EncoderBlock(16, 2, causal=causal, generator=gen)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 24, 16)).astype(np.float32))
    with torch.no_grad():
        got = block(x)
        torch.testing.assert_close(got, _block_before_the_hook(block, x), rtol=0, atol=0)
        # The same attention through the hook: the same bits.
        block.attention_fn = functools.partial(port_ops.flash_attention, causal=causal)
        torch.testing.assert_close(block(x), got, rtol=0, atol=0)


def test_attention_fn_none_leaves_the_models_bit_equal():
    """The TabTransformer and the CausalLM with no hook against the same
    models whose blocks call the attention they had before it."""
    tt = transformer_for_data_spec(embed_dim=8, num_layers=2, num_heads=2, vocab_cap=64,
                                   compute_dtype=torch.float32, device="cpu")
    feats = {c: torch.arange(16, dtype=torch.int32) * (i + 3) for i, c in enumerate(tt.columns)}
    lm = CausalLM(32, 40, embed_dim=16, num_layers=2, num_heads=2, compute_dtype=torch.float32, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 32, (2, 40)).astype(np.int32))
    with torch.no_grad():
        got_tt, got_lm = tt(feats), lm(tokens)
        assert torch.equal(lm(tokens, start=0), got_lm)
        for model in (tt, lm):
            for block in model.blocks:
                block.forward = functools.partial(_block_before_the_hook, block)
        torch.testing.assert_close(tt(feats), got_tt, rtol=0, atol=0)
        torch.testing.assert_close(lm(tokens), got_lm, rtol=0, atol=0)
