"""The port's causal LM against the JAX package's flax model (causal
Pallas flash attention in interpret mode) with the same weights, converted
by ``lm_state_dict_from_jax``: the token stream, the forward, causality,
and three Adam steps of the next-token loss."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from ray_shuffling_data_loader_tpu.models import lm as jax_lm
from ray_shuffling_data_loader_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from ray_shuffling_data_loader_tpu_torch.convert import lm_state_dict_from_jax
from ray_shuffling_data_loader_tpu_torch.models import CausalLM, next_token_loss, synthetic_tokens
from ray_shuffling_data_loader_tpu_torch.parallel import make_optimizer

VOCAB, SEQ, BATCH = 32, 64, 2
WIDTHS = dict(embed_dim=16, num_layers=2, num_heads=2)
CAUSAL_PALLAS = functools.partial(
    jax_flash_attention, causal=True, use_pallas=True, interpret=True, block_q=16, block_k=16
)


def _models(tokens):
    jmodel = jax_lm.CausalLM(
        vocab_size=VOCAB, max_seq_len=SEQ, compute_dtype=jnp.float32,
        attention_fn=CAUSAL_PALLAS, **WIDTHS,
    )
    params = jmodel.init(jax.random.key(0), jnp.asarray(tokens))
    tmodel = CausalLM(VOCAB, SEQ, compute_dtype=torch.float32, device="cpu", **WIDTHS)
    tmodel.load_state_dict(lm_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def test_synthetic_tokens_match_jax():
    for args in ((2, 64, 32, 0), (4, 512, 64, 0), (3, 17, 5, 9)):
        np.testing.assert_array_equal(synthetic_tokens(*args), jax_lm.synthetic_tokens(*args))


def test_forward_matches_flax():
    tokens = synthetic_tokens(BATCH, SEQ, VOCAB, seed=1)
    jmodel, params, tmodel = _models(tokens)
    want = np.asarray(jmodel.apply(params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tokens))
    assert got.shape == (BATCH, SEQ, VOCAB) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        float(next_token_loss(got, torch.from_numpy(tokens))),
        float(jax_lm.next_token_loss(jnp.asarray(want), jnp.asarray(tokens))),
        atol=1e-6, rtol=0,
    )


def test_forward_is_causal():
    """Changing a future token must not change earlier logits."""
    tokens = synthetic_tokens(BATCH, SEQ, VOCAB, seed=1)
    model = CausalLM(VOCAB, SEQ, compute_dtype=torch.float32, device="cpu", num_layers=1,
                     embed_dim=16, num_heads=2)
    perturbed = tokens.copy()
    perturbed[:, SEQ // 2:] = (perturbed[:, SEQ // 2:] + 1) % VOCAB
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens)).numpy()
        logits_p = model(torch.from_numpy(perturbed)).numpy()
    assert np.isfinite(logits).all()
    np.testing.assert_allclose(logits[:, : SEQ // 2], logits_p[:, : SEQ // 2], rtol=1e-5, atol=1e-5)
    assert not np.allclose(logits[:, SEQ // 2:], logits_p[:, SEQ // 2:])


def test_three_adam_steps_match_optax():
    tokens = synthetic_tokens(BATCH, SEQ, VOCAB, seed=2)
    jmodel, params, tmodel = _models(tokens)
    opt = optax.adam(3e-3)
    opt_state = opt.init(params)
    jtokens = jnp.asarray(tokens)

    @jax.jit
    def jstep(params, opt_state):
        loss, grads = jax.value_and_grad(
            lambda p: jax_lm.next_token_loss(jmodel.apply(p, jtokens), jtokens)
        )(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    topt = make_optimizer(tmodel, lr=3e-3)
    ttokens = torch.from_numpy(tokens)
    jax_losses, port_losses = [], []
    for _ in range(3):
        params, opt_state, loss = jstep(params, opt_state)
        jax_losses.append(float(loss))
        topt.zero_grad(set_to_none=True)
        tloss = next_token_loss(tmodel(ttokens), ttokens)
        tloss.backward()
        topt.step()
        port_losses.append(tloss.item())
    np.testing.assert_allclose(port_losses, jax_losses, atol=1e-4, rtol=0)
    assert port_losses[-1] < port_losses[0]
