"""The port's TabTransformer and its train step against flax/optax with
the same weights (flax params converted by
``transformer_state_dict_from_jax``), the JAX side attending through the
Pallas flash kernels in interpret mode; and three steps of the whole slice
(Parquet -> shuffle -> staged batches -> step) against the JAX package's
loader and step on the same files."""

import functools
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_shuffling_data_loader_tpu.data_generation import DATA_SPEC, LABEL_COLUMN
from ray_shuffling_data_loader_tpu.jax_dataset import JaxShufflingDataset
from ray_shuffling_data_loader_tpu.models import transformer as jax_transformer
from ray_shuffling_data_loader_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from ray_shuffling_data_loader_tpu.parallel.train import TrainState, make_step_body
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch.convert import transformer_state_dict_from_jax
from ray_shuffling_data_loader_tpu_torch.data_generation import generate_data
from ray_shuffling_data_loader_tpu_torch.device_dataset import DeviceShufflingDataset
from ray_shuffling_data_loader_tpu_torch.models import transformer_for_data_spec
from ray_shuffling_data_loader_tpu_torch.parallel import make_optimizer, make_train_step

EMBED_DIM, LAYERS, HEADS, VOCAB_CAP, BATCH = 16, 2, 2, 64, 64
FEATURES = [c for c in DATA_SPEC if c != LABEL_COLUMN]
PALLAS = functools.partial(jax_flash_attention, use_pallas=True, interpret=True, block_q=16, block_k=16)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _batch(seed=0):
    """Ids over the full DATA_SPEC ranges (the model folds them into its
    capped tables) and soft labels, as numpy."""
    rng = np.random.default_rng(seed)
    feats = {c: rng.integers(0, DATA_SPEC[c][1], BATCH).astype(np.int32) for c in FEATURES}
    return feats, rng.random(BATCH).astype(np.float32)


def _jax(feats):
    return {k: jnp.asarray(v) for k, v in feats.items()}


def _torch(feats):
    return {k: torch.from_numpy(v) for k, v in feats.items()}


def _models(compute, init_feats):
    jdt, tdt = DTYPES[compute]
    jmodel = jax_transformer.transformer_for_data_spec(
        embed_dim=EMBED_DIM, num_layers=LAYERS, num_heads=HEADS, vocab_cap=VOCAB_CAP,
        attention_fn=PALLAS,
    ).clone(compute_dtype=jdt)
    params = jmodel.init(jax.random.key(0), _jax(init_feats))
    tmodel = transformer_for_data_spec(
        embed_dim=EMBED_DIM, num_layers=LAYERS, num_heads=HEADS, vocab_cap=VOCAB_CAP,
        compute_dtype=tdt, device="cpu",
    )
    tmodel.load_state_dict(transformer_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def test_state_dict_names_cover_the_module():
    feats, _ = _batch()
    _, params, tmodel = _models("fp32", feats)
    converted = transformer_state_dict_from_jax(jax.tree.map(np.asarray, params))
    assert set(converted) == set(tmodel.state_dict())
    with pytest.raises(KeyError):
        transformer_state_dict_from_jax({"Dense_0": {"kernel": np.zeros((2, 2)), "bias": np.zeros(2)}})


@pytest.mark.parametrize(
    "compute,rtol",
    [
        ("fp32", 0),
        # bf16 rounds at other points in the two frameworks: flax's GELU
        # rounds after each of its steps, torch's once. A logit is a sum of
        # terms that cancel, so the error is relative to the logits' scale.
        ("bf16", 2e-2),
    ],
)
def test_forward_matches_flax(compute, rtol):
    feats, _ = _batch()
    jmodel, params, tmodel = _models(compute, feats)
    feats, _ = _batch(1)
    want = np.asarray(jmodel.apply(params, _jax(feats)))
    with torch.no_grad():
        got = tmodel(_torch(feats))
    assert got.dtype == torch.float32 and got.shape == (BATCH,)
    atol = 1e-5 if compute == "fp32" else rtol * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=rtol)


def test_train_step_matches_optax_adam():
    feats, labels = _batch(2)
    jmodel, params, tmodel = _models("fp32", feats)
    opt = optax.adam(1e-3)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=opt.init(params))
    new_state, metrics = jax.jit(make_step_body(jmodel, opt))(state, _jax(feats), jnp.asarray(labels))
    step = make_train_step(tmodel, make_optimizer(tmodel, lr=1e-3))
    out = step(_torch(feats), torch.from_numpy(labels))
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]), atol=1e-5, rtol=0)
    want = transformer_state_dict_from_jax(jax.tree.map(np.asarray, new_state.params))
    got = tmodel.state_dict()
    assert set(got) == set(want)
    for name in want:
        g, w = got[name].numpy(), want[name].numpy()
        if name.endswith("qkv.bias"):
            # The key bias adds the same q . b_k to every score of a row,
            # which the softmax cancels: its true gradient is 0, and Adam's
            # first step turns rounding noise into up to +-lr. Hold that
            # slice to the bound and the rest exactly.
            keys = slice(EMBED_DIM, 2 * EMBED_DIM)
            assert np.abs(g[keys]).max() <= 1e-3 * (1 + 1e-5)
            g, w = np.delete(g, np.r_[keys]), np.delete(w, np.r_[keys])
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)


def test_three_slice_steps_match_jax(tmp_path, local_runtime):
    steps = 3
    port_runtime.init(num_workers=2)
    try:
        files, _ = generate_data(1024, 4, 2, 0.0, str(tmp_path))
        kwargs = dict(feature_columns=FEATURES, label_column=LABEL_COLUMN, num_reducers=4, seed=3)
        tds = DeviceShufflingDataset(
            files, 1, 1, BATCH, 0, device="cpu", queue_name=f"tt-{uuid.uuid4().hex[:8]}", **kwargs
        )
        tds.set_epoch(0)
        port_batches = list(tds)
    finally:
        port_runtime.shutdown()
    jds = JaxShufflingDataset(files, 1, 1, BATCH, 0, queue_name=f"tt-{uuid.uuid4().hex[:8]}", **kwargs)
    jds.set_epoch(0)
    jax_batches = []
    for features, labels in jds:  # run the epoch to its end
        if len(jax_batches) < steps:
            jax_batches.append(({k: np.asarray(v) for k, v in features.items()}, np.asarray(labels)))

    jmodel, params, tmodel = _models("fp32", jax_batches[0][0])
    opt = optax.adam(1e-3)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=opt.init(params))
    jstep = jax.jit(make_step_body(jmodel, opt))
    tstep = make_train_step(tmodel, make_optimizer(tmodel, lr=1e-3))
    jax_losses, port_losses = [], []
    for (jf, jl), (tf, tl) in zip(jax_batches, port_batches[:steps]):
        state, metrics = jstep(state, _jax(jf), jnp.asarray(jl))
        jax_losses.append(float(metrics["loss"]))
        port_losses.append(float(tstep(tf, tl)["loss"]))
    assert len(port_losses) == steps
    np.testing.assert_allclose(port_losses, jax_losses, atol=1e-4, rtol=0)
