"""The whole slice on the CPU: Parquet -> the port's shuffle and staging ->
the port's DLRM train step, against the JAX package's loader, flax model
and optax step on the same files and weights."""

import uuid

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from ray_shuffling_data_loader_tpu.jax_dataset import JaxShufflingDataset
from ray_shuffling_data_loader_tpu.models import dlrm as jax_dlrm
from ray_shuffling_data_loader_tpu.parallel.train import TrainState, make_step_body
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch.convert import dlrm_state_dict_from_jax
from ray_shuffling_data_loader_tpu_torch.data_generation import (
    DATA_SPEC,
    LABEL_COLUMN,
    generate_data,
)
from ray_shuffling_data_loader_tpu_torch.device_dataset import DeviceShufflingDataset
from ray_shuffling_data_loader_tpu_torch.models import dlrm_for_data_spec
from ray_shuffling_data_loader_tpu_torch.parallel import make_optimizer, make_train_step

STEPS, BATCH = 3, 256
FEATURES = [c for c in DATA_SPEC if c != LABEL_COLUMN]


def _first_batches(ds, n):
    ds.set_epoch(0)
    out = []
    for features, labels in ds:  # run the epoch to its end
        if len(out) < n:
            out.append(({k: np.asarray(v) for k, v in features.items()}, np.asarray(labels)))
    return out


def test_three_train_steps_match_jax(tmp_path, local_runtime):
    port_runtime.init(num_workers=2)
    try:
        files, _ = generate_data(4096, 4, 2, 0.0, str(tmp_path))
        kwargs = dict(feature_columns=FEATURES, label_column=LABEL_COLUMN, num_reducers=4, seed=3)
        tds = DeviceShufflingDataset(
            files, 1, 1, BATCH, 0, device="cpu", queue_name=f"slice-{uuid.uuid4().hex[:8]}", **kwargs
        )
        port_batches = []
        tds.set_epoch(0)
        for features, labels in tds:
            port_batches.append((features, labels))
    finally:
        port_runtime.shutdown()
    jax_batches = _first_batches(
        JaxShufflingDataset(files, 1, 1, BATCH, 0, queue_name=f"slice-{uuid.uuid4().hex[:8]}", **kwargs),
        STEPS,
    )

    jmodel = jax_dlrm.dlrm_for_data_spec(
        embed_dim=8, top_mlp=(32, 16), vocab_cap=1024, use_pallas_interaction=True
    ).clone(compute_dtype=jnp.float32)
    feats0 = {k: jnp.asarray(v) for k, v in jax_batches[0][0].items()}
    params = jmodel.init(jax.random.key(1), feats0)
    opt = optax.adam(1e-3)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=opt.init(params))
    jstep = jax.jit(make_step_body(jmodel, opt))

    tmodel = dlrm_for_data_spec(embed_dim=8, top_mlp=(32, 16), vocab_cap=1024, compute_dtype=torch.float32,
                                device="cpu")
    tmodel.load_state_dict(dlrm_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    tstep = make_train_step(tmodel, make_optimizer(tmodel, lr=1e-3))

    jax_losses, port_losses = [], []
    for (jf, jl), (tf, tl) in zip(jax_batches, port_batches[:STEPS]):
        state, metrics = jstep(state, {k: jnp.asarray(v) for k, v in jf.items()}, jnp.asarray(jl))
        jax_losses.append(float(metrics["loss"]))
        port_losses.append(float(tstep(tf, tl)["loss"]))
    assert len(port_losses) == STEPS
    np.testing.assert_allclose(port_losses, jax_losses, atol=1e-4, rtol=0)
