"""The port's DLRM and train step against flax/optax with the same
weights (flax params converted by ``dlrm_state_dict_from_jax``)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_shuffling_data_loader_tpu.data_generation import DATA_SPEC, LABEL_COLUMN
from ray_shuffling_data_loader_tpu.models import dlrm as jax_dlrm
from ray_shuffling_data_loader_tpu.parallel.train import TrainState, make_step_body
from ray_shuffling_data_loader_tpu_torch.convert import dlrm_state_dict_from_jax
from ray_shuffling_data_loader_tpu_torch.models import dlrm_for_data_spec
from ray_shuffling_data_loader_tpu_torch.parallel import make_optimizer, make_train_step

EMBED_DIM, TOP_MLP, VOCAB_CAP, BATCH = 8, (32, 16), 1024, 64


def _batch(seed=0):
    """Ids over the full DATA_SPEC ranges (the model folds them into its
    capped tables) and soft labels, as numpy."""
    rng = np.random.default_rng(seed)
    feats = {
        c: rng.integers(0, high, BATCH).astype(np.int32)
        for c, (_, high, _) in DATA_SPEC.items()
        if c != LABEL_COLUMN
    }
    labels = rng.random(BATCH).astype(np.float32)
    return feats, labels


def _models(compute):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[compute]
    jmodel = jax_dlrm.dlrm_for_data_spec(
        embed_dim=EMBED_DIM, top_mlp=TOP_MLP, vocab_cap=VOCAB_CAP,
        use_pallas_interaction=True,
    ).clone(compute_dtype=jdt)
    feats, _ = _batch()
    params = jmodel.init(jax.random.key(0), {k: jnp.asarray(v) for k, v in feats.items()})
    tmodel = dlrm_for_data_spec(
        embed_dim=EMBED_DIM, top_mlp=TOP_MLP, vocab_cap=VOCAB_CAP, compute_dtype=tdt,
        device="cpu",
    )
    tmodel.load_state_dict(dlrm_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def test_columns_in_sorted_string_order():
    model = dlrm_for_data_spec(embed_dim=4, top_mlp=(8,), vocab_cap=16, device="cpu")
    assert model.columns == sorted(model.columns)
    i = model.columns.index("embeddings_name1")
    assert model.columns[i + 1] == "embeddings_name10"


@pytest.mark.parametrize(
    "compute,tol",
    [
        ("fp32", dict(atol=1e-5, rtol=0)),
        # bf16 may round inputs, weights and sums at different points in
        # the two frameworks.
        ("bf16", dict(atol=0, rtol=2e-2)),
    ],
)
def test_forward_matches_flax(compute, tol):
    jmodel, params, tmodel = _models(compute)
    feats, _ = _batch(1)
    want = np.asarray(jmodel.apply(params, {k: jnp.asarray(v) for k, v in feats.items()}))
    with torch.no_grad():
        got = tmodel({k: torch.from_numpy(v) for k, v in feats.items()})
    assert got.dtype == torch.float32 and got.shape == (BATCH,)
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_train_step_matches_optax_adam():
    jmodel, params, tmodel = _models("fp32")
    feats, labels = _batch(2)
    opt = optax.adam(1e-3)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=opt.init(params))
    new_state, metrics = jax.jit(make_step_body(jmodel, opt))(
        state, {k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(labels)
    )
    step = make_train_step(tmodel, make_optimizer(tmodel, lr=1e-3))
    out = step({k: torch.from_numpy(v) for k, v in feats.items()}, torch.from_numpy(labels))
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]), atol=1e-5, rtol=0)
    want = dlrm_state_dict_from_jax(jax.tree.map(np.asarray, new_state.params))
    got = tmodel.state_dict()
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(
            got[name].numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name
        )
