"""The port's long-context trainer (``train_long_context``) against the
JAX package's recipe (``examples/train_long_context.py``): a ``(data 2,
sp 4)`` world of 8 ``gloo`` CPU ranks, ring, Ulysses and dense attention,
three Adam steps from the same weights (converted by
``lm_state_dict_from_jax``) on the same tokens, against the example's
jitted step on a ``(data, sp)`` mesh of 8 virtual devices, in float32 and
bfloat16 compute; and the parameters bit-identical on every rank."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ray_shuffling_data_loader_tpu.models import lm as jax_lm
from ray_shuffling_data_loader_tpu.ops import attention_reference, make_ring_attention, make_ulysses_attention
from ray_shuffling_data_loader_tpu_torch import train_long_context
from ray_shuffling_data_loader_tpu_torch.convert import lm_state_dict_from_jax
from ray_shuffling_data_loader_tpu_torch.models import synthetic_tokens

DP, SP, STEPS = 2, 4, 3
# The narrow width: the example's batch, vocab, heads, layers and lr.
WIDTH = dict(batch=4, seq_len=64, vocab=64, embed_dim=32, layers=2, heads=4, lr=3e-3, seed=0)
ATTENTIONS = ("ring", "ulysses", "dense")
# float32 compute: the same function summed in other orders.
FP32_TOL = 1e-5
# bfloat16 compute: both round every activation to bf16 (a step of 2**-8
# of its value), in matmuls and sums of other orders, so single roundings
# part and the loss (about 4.2) moves by a few bf16 steps of the logits.
BF16_TOL = 2e-3


def _jax_losses(attention, dtype, params, tokens_host):
    """The example's jitted step (``examples/train_long_context.py:87-141``)
    from ``params``: the losses of ``STEPS`` steps."""
    mesh = Mesh(np.array(jax.devices()[:DP * SP]).reshape(DP, SP), ("data", "sp"))
    if attention == "ring":
        attention_fn = make_ring_attention(mesh, "sp", causal=True, batch_axis="data")
    elif attention == "ulysses":
        attention_fn = make_ulysses_attention(mesh, "sp", causal=True, batch_axis="data")
    else:
        attention_fn = functools.partial(attention_reference, causal=True)
    model = jax_lm.CausalLM(
        vocab_size=WIDTH["vocab"], max_seq_len=WIDTH["seq_len"], embed_dim=WIDTH["embed_dim"],
        num_layers=WIDTH["layers"], num_heads=WIDTH["heads"], compute_dtype=dtype, attention_fn=attention_fn,
    )
    tokens = jax.device_put(jnp.asarray(tokens_host), NamedSharding(mesh, P("data", "sp")))
    optimizer = optax.adam(WIDTH["lr"])

    @jax.jit
    def step(params, opt_state, tokens):
        def loss_fn(params):
            return jax_lm.next_token_loss(model.apply(params, tokens), tokens)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    replicated = NamedSharding(mesh, P())
    params = jax.device_put(params, replicated)
    opt_state = jax.device_put(optimizer.init(params), replicated)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(float(loss))
    return np.asarray(losses)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's losses per (attention, dtype) and the port's 8 ranks, spawned
    once for every attention and dtype."""
    tokens = synthetic_tokens(WIDTH["batch"], WIDTH["seq_len"], WIDTH["vocab"], seed=WIDTH["seed"])
    init_model = jax_lm.CausalLM(
        vocab_size=WIDTH["vocab"], max_seq_len=WIDTH["seq_len"], embed_dim=WIDTH["embed_dim"],
        num_layers=WIDTH["layers"], num_heads=WIDTH["heads"],
    )
    params = init_model.init(jax.random.key(WIDTH["seed"]), jnp.asarray(tokens))
    want = {(a, d): _jax_losses(a, getattr(jnp, d), params, tokens)
            for a in ATTENTIONS for d in ("float32", "bfloat16")}
    state_path = str(tmp_path_factory.mktemp("lc") / "init.pt")
    torch.save(lm_state_dict_from_jax(jax.tree.map(np.asarray, params)), state_path)
    args = train_long_context.parse_args([
        "--dp", str(DP), "--sp", str(SP), "--steps", str(STEPS), "--backend", "gloo", "--device", "cpu",
        "--attention", *ATTENTIONS, "--compute-dtype", "float32", "bfloat16", "--init-state", state_path,
        "--timeout", "120", *(x for k, v in WIDTH.items() for x in (f"--{k.replace('_', '-')}", str(v))),
    ])
    out = train_long_context.run(args)
    assert out["returncode"] == 0, out["problems"]
    return want, out["ranks"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attention", ATTENTIONS)
def test_adam_steps_match_the_jax_example(runs, attention, dtype):
    want, ranks = runs
    run = next(r for r in ranks[0]["runs"] if r["attention"] == attention and r["compute_dtype"] == dtype)
    np.testing.assert_allclose(run["losses"], want[attention, dtype], rtol=0,
                               atol=FP32_TOL if dtype == "float32" else BF16_TOL)


def test_every_rank_ends_with_the_same_parameters_and_losses(runs):
    _, ranks = runs
    assert [(r["data_index"], r["sp_index"]) for r in ranks] == [(d, s) for d in range(DP) for s in range(SP)]
    for i in range(len(ranks[0]["runs"])):
        assert len({r["runs"][i]["params_sha256"] for r in ranks}) == 1
        assert all(r["runs"][i]["losses"] == ranks[0]["runs"][i]["losses"] for r in ranks)


def test_token_shards_and_loss_normalization():
    """The ``[data, sp]`` blocks tile the tokens; each chunk's targets run
    into the next chunk, the last sp rank's stop at the sequence's end; and
    the shards' losses sum to the global next-token loss."""
    from types import SimpleNamespace

    import ray_shuffling_data_loader_tpu_torch as port

    b, t, v = 4, 32, 16
    tokens = torch.from_numpy(synthetic_tokens(b, t, v, seed=3))
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal((b, t, v)).astype(np.float32))
    total = 0.0
    for d in range(DP):
        for s in range(SP):
            mesh = SimpleNamespace(data_index=d, sp_index=s, data_size=DP, sp_size=SP)
            inputs, targets, start = train_long_context.token_shard(tokens, mesh)
            rows, cols = slice(d * b // DP, (d + 1) * b // DP), slice(start, start + t // SP)
            assert torch.equal(inputs, tokens[rows, cols]) and start == s * t // SP
            assert targets.shape[1] == t // SP - (s == SP - 1)
            assert torch.equal(targets, tokens[rows, start + 1:start + 1 + targets.shape[1]])
            total += float(train_long_context.shard_loss(logits[rows, cols], targets, b * (t - 1)))
    np.testing.assert_allclose(total, float(port.next_token_loss(logits, tokens)), rtol=1e-6)


def test_the_trainer_refuses_shapes_it_cannot_shard():
    with pytest.raises(SystemExit):
        train_long_context.parse_args(["--backend", "gloo", "--seq-len", "510"])
    with pytest.raises(SystemExit):
        train_long_context.parse_args(["--backend", "gloo", "--attention", "ulysses", "--heads", "6"])
    with pytest.raises(SystemExit):
        train_long_context.parse_args([])  # the backend is always explicit
