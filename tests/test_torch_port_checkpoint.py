"""The port's checkpoint and resume against the JAX package's: the
manager's round trip, retention and atomic publish, torn-publish debris,
the cursor's refusals and plan family, ``skip_batches`` and
``start_epoch`` resumes against the JAX package's stream, an end-to-end
preemption replay, cursors crossing between the packages, and a JAX
``TrainState`` (parameters and Adam moments) continued by the port."""

import json
import os
import time
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_shuffling_data_loader_tpu import checkpoint as jax_checkpoint
from ray_shuffling_data_loader_tpu.dataset import ShufflingDataset as JaxShufflingDataset
from ray_shuffling_data_loader_tpu.models import dlrm as jax_dlrm
from ray_shuffling_data_loader_tpu.models import transformer as jax_transformer
from ray_shuffling_data_loader_tpu.parallel.train import TrainState, make_step_body
from ray_shuffling_data_loader_tpu_torch import checkpoint as ckpt_mod
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch.checkpoint import BatchCursor, CheckpointManager
from ray_shuffling_data_loader_tpu_torch.convert import (
    adam_state_dict_from_jax,
    dlrm_state_dict_from_jax,
    transformer_state_dict_from_jax,
)
from ray_shuffling_data_loader_tpu_torch.data_generation import DATA_SPEC, LABEL_COLUMN, generate_data
from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset
from ray_shuffling_data_loader_tpu_torch.models import dlrm_for_data_spec, transformer_for_data_spec
from ray_shuffling_data_loader_tpu_torch.parallel import make_optimizer, make_train_step

NUM_ROWS, BATCH, REDUCERS, SEED = 2000, 300, 3, 7
FEATURES = [c for c in DATA_SPEC if c != LABEL_COLUMN]


def _q():
    return f"ck-{uuid.uuid4().hex[:8]}"


def _tiny_model():
    model = dlrm_for_data_spec(embed_dim=4, top_mlp=(8,), vocab_cap=16, compute_dtype=torch.float32, device="cpu")
    opt = make_optimizer(model)
    feats = {c: torch.zeros(4, dtype=torch.int32) for c in model.columns}
    make_train_step(model, opt)(feats, torch.ones(4))  # the optimizer's state exists
    return model, opt


# -- the manager -------------------------------------------------------------------------


def test_manager_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() is None and mgr.restore_cursor() is None
    assert mgr.restore(target={}) == (None, None)
    model, opt = _tiny_model()
    cursor = BatchCursor(epoch=3, batches_yielded=17, config={"seed": 1})
    path = mgr.save(42, cursor=cursor, state={"model": model.state_dict(), "optimizer": opt.state_dict()})
    assert os.path.basename(path) == "ckpt-0000000042" and sorted(os.listdir(path)) == ["cursor.json", "state.pt"]
    assert mgr.latest_step() == 42
    got = mgr.restore_cursor()
    assert (got.epoch, got.batches_yielded, got.step, got.config, got.run_id) == (3, 17, 42, {"seed": 1}, None)
    other, other_opt = _tiny_model()
    with torch.no_grad():
        for p in other.parameters():
            p.add_(1.0)
    restored, cursor2 = mgr.restore(target={"model": other, "optimizer": other_opt})
    assert restored["model"] is other and cursor2.step == 42
    for (name, a), b in zip(model.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), name
    want = opt.state_dict()["state"]
    for pid, entries in other_opt.state_dict()["state"].items():
        for key, value in entries.items():
            assert torch.equal(value, want[pid][key]), (pid, key)
    state = mgr.restore_state()
    assert set(state) == {"model", "optimizer"}


def test_in_place_restore_keeps_the_captured_tensors(tmp_path):
    """``in_place`` copies into the tensors the model and optimizer already
    hold, as a captured CUDA graph needs; without state to copy into it
    raises."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    model, opt = _tiny_model()
    mgr.save(1, state={"model": model.state_dict(), "optimizer": opt.state_dict()})
    other, other_opt = _tiny_model()
    with torch.no_grad():
        for p in other.parameters():
            p.mul_(3.0)
    ptrs = [p.data_ptr() for p in other.parameters()]
    state_ptrs = [t.data_ptr() for s in other_opt.state.values() for t in s.values()]
    other_opt.param_groups[0]["lr"] = 0.5
    mgr.restore(target={"model": other, "optimizer": other_opt}, in_place=True)
    assert [p.data_ptr() for p in other.parameters()] == ptrs
    assert [t.data_ptr() for s in other_opt.state.values() for t in s.values()] == state_ptrs
    assert other_opt.param_groups[0]["lr"] == 1e-3
    for a, b in zip(model.parameters(), other.parameters()):
        assert torch.equal(a, b)
    fresh = dlrm_for_data_spec(embed_dim=4, top_mlp=(8,), vocab_cap=16, compute_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="state made first"):
        mgr.restore(target={"model": fresh, "optimizer": make_optimizer(fresh)}, in_place=True)


def test_a_checkpoint_that_does_not_restore_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, cursor=BatchCursor())
    model, opt = _tiny_model()
    with pytest.raises(FileNotFoundError, match="state.pt"):
        mgr.restore(target={"model": model, "optimizer": opt})
    bigger = dlrm_for_data_spec(embed_dim=8, top_mlp=(8,), vocab_cap=16, compute_dtype=torch.float32, device="cpu")
    mgr.save(2, state={"model": model.state_dict()})
    with pytest.raises(RuntimeError):
        mgr.restore(target={"model": bigger})
    with pytest.raises(KeyError):
        mgr.restore(target={"model": model, "optimizer": opt})
    with open(os.path.join(mgr.directory, "ckpt-0000000002", "state.pt"), "wb") as f:
        f.write(b"torn")
    with pytest.raises(Exception):
        mgr.restore(target={"model": model})


def test_manager_retention_and_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for step in (5, 10, 15, 20):
        mgr.save(step, cursor=BatchCursor(epoch=0, batches_yielded=step))
    assert mgr.all_steps() == [15, 20]
    keep_all = CheckpointManager(str(tmp_path / "all"), max_to_keep=None)
    for step in (1, 2, 3, 4):
        keep_all.save(step, cursor=BatchCursor())
    assert keep_all.all_steps() == [1, 2, 3, 4]
    assert mgr.restore_cursor(15).batches_yielded == 15


def test_manager_atomic_no_partial_dirs(tmp_path):
    """A save that fails mid-write leaves no directory, published or
    staged; only rank 0 of a process group writes."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    with pytest.raises(Exception):
        mgr.save(7, cursor=BatchCursor(), state={"model": (lambda: None)})
    assert os.listdir(str(tmp_path / "ck")) == []
    assert mgr.latest_step() is None
    ckpt_mod_process_index = ckpt_mod._process_index
    try:
        ckpt_mod._process_index = lambda: 1
        path = mgr.save(8, cursor=BatchCursor())
    finally:
        ckpt_mod._process_index = ckpt_mod_process_index
    assert path.endswith("ckpt-0000000008") and not os.path.exists(path)


def test_torn_publish_debris_never_surfaces_and_ages_out(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, cursor=BatchCursor(epoch=0, batches_yielded=3))
    debris = tmp_path / "ck" / "ckpt-0000000009.tmp-dead0a"
    debris.mkdir()
    (debris / "cursor.json").write_text(json.dumps({"epoch": 9, "batches_yielded": 9, "step": 9}))
    assert mgr.all_steps() == [3] and mgr.latest_step() == 3
    assert mgr.restore_cursor().step == 3
    assert debris.is_dir()  # young: possibly a live writer's save
    old = time.time() - ckpt_mod._DEBRIS_GRACE_S - 5
    os.utime(debris, (old, old))
    assert mgr.all_steps() == [3]
    assert not debris.exists()
    assert mgr.restore_cursor().step == 3


def test_debris_prune_never_eats_published_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, cursor=BatchCursor(epoch=0, batches_yielded=1))
    published = tmp_path / "ck" / "ckpt-0000000001"
    old = time.time() - 10_000
    os.utime(published, (old, old))
    assert mgr.all_steps() == [1] and published.is_dir()


# -- the cursor ----------------------------------------------------------------------------


def test_cursor_refusal_paths_and_plan_family(monkeypatch):
    monkeypatch.delenv("RSDL_SHUFFLE_PLAN", raising=False)
    base = dict(seed=1, batch_size=10, num_trainers=2, num_reducers=4, num_files=3, drop_last=False)
    config = BatchCursor.stream_config(**base)
    assert config["plan"] == "rowwise"
    assert config == jax_checkpoint.BatchCursor.stream_config(**base)
    cursor = BatchCursor(config=config)
    cursor.validate(dict(config))
    for key, value in (("seed", 2), ("batch_size", 11), ("num_trainers", 1), ("num_reducers", 5),
                       ("num_files", 4), ("drop_last", True), ("plan", "block:2")):
        with pytest.raises(ValueError, match=key):
            cursor.validate({**config, key: value})
    # A cursor from before the plan family counts as rowwise.
    legacy = BatchCursor(config={k: v for k, v in config.items() if k != "plan"})
    legacy.validate(config)
    with pytest.raises(ValueError, match="plan"):
        legacy.validate({**config, "plan": "block:1"})
    BatchCursor().validate(config)  # an empty side never refuses
    for env, label in (("block", "block:1"), ("block:3", "block:3"), ("rowwise", "rowwise")):
        monkeypatch.setenv("RSDL_SHUFFLE_PLAN", env)
        assert BatchCursor.stream_config(**base)["plan"] == label
        assert jax_checkpoint.BatchCursor.stream_config(**base)["plan"] == label
    monkeypatch.setenv("RSDL_SHUFFLE_PLAN", "bogus")
    assert BatchCursor.stream_config(**base)["plan"] == "unknown"


def test_cursors_cross_between_the_packages(tmp_path):
    """``cursor.json`` has one schema: a cursor written by either package
    restores and validates in the other."""
    config = BatchCursor.stream_config(seed=7, batch_size=300, num_trainers=1, num_reducers=3, num_files=2,
                                       drop_last=True, plan="rowwise")
    jax_mgr = jax_checkpoint.CheckpointManager(str(tmp_path / "jax"))
    jax_mgr.save(12, cursor=jax_checkpoint.BatchCursor(epoch=1, batches_yielded=5, config=dict(config)))
    got = CheckpointManager(str(tmp_path / "jax")).restore_cursor()
    assert (got.epoch, got.batches_yielded, got.step) == (1, 5, 12)
    got.validate(config)
    port_mgr = CheckpointManager(str(tmp_path / "port"))
    port_mgr.save(9, cursor=BatchCursor(epoch=2, batches_yielded=3, config=dict(config)))
    back = jax_checkpoint.CheckpointManager(str(tmp_path / "port")).restore_cursor()
    assert (back.epoch, back.batches_yielded, back.step, back.run_id) == (2, 3, 9, None)
    back.validate(config)
    with pytest.raises(ValueError, match="seed"):
        back.validate({**config, "seed": 8})
    assert json.load(open(tmp_path / "port" / "ckpt-0000000009" / "cursor.json")).keys() == \
        json.load(open(tmp_path / "jax" / "ckpt-0000000012" / "cursor.json")).keys()


def test_cursor_joins_the_journal_run(tmp_path, monkeypatch):
    """With the journal loaded the cursor carries its run id; a save
    without one never imports it."""
    import sys

    from ray_shuffling_data_loader_tpu_torch.runtime import journal as jmod

    mgr = CheckpointManager(str(tmp_path / "ck"))
    monkeypatch.setenv("RSDL_JOURNAL", str(tmp_path / "journal"))
    j = jmod.begin_run({"v": 1})
    try:
        mgr.save(1, cursor=BatchCursor())
        assert mgr.restore_cursor().run_id == j.run_id
    finally:
        jmod.end_run(j)
    mgr.save(2, cursor=BatchCursor())
    assert mgr.restore_cursor().run_id is None
    monkeypatch.delitem(sys.modules, "ray_shuffling_data_loader_tpu_torch.runtime.journal")
    mgr.save(3, cursor=BatchCursor())
    assert "ray_shuffling_data_loader_tpu_torch.runtime.journal" not in sys.modules


# -- resumed streams against the JAX package's -------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    port_runtime.init(num_workers=2)
    names, _ = generate_data(NUM_ROWS, 2, 1, 0.0, str(tmp_path_factory.mktemp("data")))
    yield names
    port_runtime.shutdown()


def _keys(ds, epochs, skip=0):
    out = []
    for epoch in epochs:
        ds.set_epoch(epoch, skip_batches=skip if epoch == epochs[0] else 0)
        out.append([np.asarray(b["key"]) for b in ds])
    return out


@pytest.mark.parametrize("skip", [0, 2, 7])
def test_skip_batches_and_start_epoch_match_the_jax_stream(files, local_runtime, skip):
    """``set_epoch(e, skip_batches=k)`` (7: every batch) and a dataset
    started at epoch 1 give the JAX package's batches, bit for bit."""
    kw = dict(num_reducers=REDUCERS, seed=SEED)
    got = _keys(ShufflingDataset(files, 2, 1, BATCH, 0, queue_name=_q(), **kw), [0, 1], skip)
    want = _keys(JaxShufflingDataset(files, 2, 1, BATCH, 0, queue_name=_q(), **kw), [0, 1], skip)
    assert [len(e) for e in got] == [max(0, 7 - skip), 7]
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    # The batches after the skip are the uninterrupted epoch's tail.
    full = _keys(ShufflingDataset(files, 1, 1, BATCH, 0, queue_name=_q(), **kw), [0])[0]
    for a, b in zip(got[0], full[skip:]):
        np.testing.assert_array_equal(a, b)
    if skip == 2:
        late = _keys(ShufflingDataset(files, 2, 1, BATCH, 0, queue_name=_q(), start_epoch=1, **kw), [1], skip)
        jlate = _keys(JaxShufflingDataset(files, 2, 1, BATCH, 0, queue_name=_q(), start_epoch=1, **kw), [1], skip)
        for a, b, c in zip(late[0], jlate[0], want[1][skip:]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_end_to_end_preemption_replay(files, tmp_path):
    """Train, checkpoint after 3 steps, lose the rest; a fresh model,
    optimizer and dataset restore from the checkpoint and train the lost
    steps: every key once, and the uninterrupted run's losses and
    parameters, bit for bit on the CPU."""
    kw = dict(num_reducers=REDUCERS, seed=SEED, drop_last=True)
    config = BatchCursor.stream_config(seed=SEED, batch_size=BATCH, num_trainers=1, num_reducers=REDUCERS,
                                       num_files=len(files), drop_last=True)

    def fresh():
        model = dlrm_for_data_spec(embed_dim=4, top_mlp=(8,), vocab_cap=64, compute_dtype=torch.float32,
                                   device="cpu")
        opt = make_optimizer(model)
        return model, opt, make_train_step(model, opt)

    def train(ds, step, epoch, skip=0, on_step=None):
        ds.set_epoch(epoch, skip_batches=skip)
        keys, losses = [], []
        for i, b in enumerate(ds, start=skip):
            feats = {c: torch.from_numpy(np.array(b[c])) for c in FEATURES}
            losses.append(float(step(feats, torch.from_numpy(np.array(b[LABEL_COLUMN])))["loss"]))
            keys.append(np.asarray(b["key"]))
            if on_step is not None:
                on_step(i + 1)
        return keys, losses

    model, _, step = fresh()
    want_keys, want_losses = train(ShufflingDataset(files, 1, 1, BATCH, 0, queue_name=_q(), **kw), step, 0)
    want_params = {k: v.clone() for k, v in model.state_dict().items()}

    mgr = CheckpointManager(str(tmp_path / "ck"))
    model, opt, step = fresh()

    def save(done):
        if done == 3:
            mgr.save(done, cursor=BatchCursor(epoch=0, batches_yielded=done, config=config),
                     state={"model": model.state_dict(), "optimizer": opt.state_dict()})

    first_keys, first_losses = train(ShufflingDataset(files, 1, 1, BATCH, 0, queue_name=_q(), **kw), step, 0,
                                     on_step=save)
    model, opt, step = fresh()  # the preempted process is gone
    _, cursor = mgr.restore(target={"model": model, "optimizer": opt})
    cursor.validate(config)
    keys, losses = train(ShufflingDataset(files, 1, 1, BATCH, 0, queue_name=_q(), **kw), step, cursor.epoch,
                         skip=cursor.batches_yielded)
    all_keys = np.concatenate(first_keys[:3] + keys)
    assert np.unique(all_keys).size == all_keys.size == len(want_keys) * BATCH
    assert first_losses[:3] + losses == want_losses
    for name, value in model.state_dict().items():
        assert torch.equal(value, want_params[name]), name


# -- a JAX TrainState continued by the port ----------------------------------------------------


def _batch(seed, n=64):
    rng = np.random.default_rng(seed)
    feats = {c: rng.integers(0, DATA_SPEC[c][1], n).astype(np.int32) for c in FEATURES}
    return feats, rng.random(n).astype(np.float32)


def test_jax_train_state_checkpoint_continues_in_the_port(tmp_path):
    """A tiny fp32 DLRM trained two steps by the JAX package, saved and
    restored by its CheckpointManager, converted (parameters and Adam
    moments): the port's next 3 steps give the JAX package's losses and
    parameters within 1e-5."""
    jmodel = jax_dlrm.dlrm_for_data_spec(embed_dim=8, top_mlp=(32, 16), vocab_cap=1024,
                                         use_pallas_interaction=False).clone(compute_dtype=jnp.float32)
    feats0, _ = _batch(0)
    params = jmodel.init(jax.random.key(0), {k: jnp.asarray(v) for k, v in feats0.items()})
    opt = optax.adam(1e-3)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=opt.init(params))
    jstep = jax.jit(make_step_body(jmodel, opt))
    for s in range(2):
        f, l = _batch(10 + s)
        state, _ = jstep(state, {k: jnp.asarray(v) for k, v in f.items()}, jnp.asarray(l))
    mgr = jax_checkpoint.CheckpointManager(str(tmp_path / "jax"))
    mgr.save(2, cursor=jax_checkpoint.BatchCursor(epoch=0, batches_yielded=2), state=state)
    restored, _ = mgr.restore(target=state)
    host = jax.tree.map(np.asarray, restored)

    model = dlrm_for_data_spec(embed_dim=8, top_mlp=(32, 16), vocab_cap=1024, compute_dtype=torch.float32,
                               device="cpu")
    model.load_state_dict(dlrm_state_dict_from_jax(host.params))
    optimizer = make_optimizer(model, lr=1e-3)
    optimizer.load_state_dict(adam_state_dict_from_jax(host.opt_state, model))
    assert all(float(s["step"]) == 2.0 for s in optimizer.state.values())
    tstep = make_train_step(model, optimizer)
    for s in range(3):
        f, l = _batch(20 + s)
        state, metrics = jstep(state, {k: jnp.asarray(v) for k, v in f.items()}, jnp.asarray(l))
        got = float(tstep({k: torch.from_numpy(v) for k, v in f.items()}, torch.from_numpy(l))["loss"])
        assert abs(got - float(metrics["loss"])) <= 1e-5, s
    want = dlrm_state_dict_from_jax(jax.tree.map(np.asarray, state.params))
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)


def test_transformer_adam_state_converts(tmp_path):
    """The TabTransformer's Adam moments convert through its parameter
    mapping: after one JAX step, the port continues a second one within
    1e-5 of the JAX package (the key bias, whose true gradient is 0, to
    Adam's +-lr bound)."""
    embed, heads = 16, 2
    jmodel = jax_transformer.transformer_for_data_spec(embed_dim=embed, num_layers=1, num_heads=heads,
                                                       vocab_cap=64).clone(compute_dtype=jnp.float32)
    f0, l0 = _batch(1)
    params = jmodel.init(jax.random.key(0), {k: jnp.asarray(v) for k, v in f0.items()})
    opt = optax.adam(1e-3)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=opt.init(params))
    jstep = jax.jit(make_step_body(jmodel, opt))
    state, _ = jstep(state, {k: jnp.asarray(v) for k, v in f0.items()}, jnp.asarray(l0))
    host = jax.tree.map(np.asarray, state)
    model = transformer_for_data_spec(embed_dim=embed, num_layers=1, num_heads=heads, vocab_cap=64,
                                      compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(transformer_state_dict_from_jax(host.params))
    optimizer = make_optimizer(model, lr=1e-3)
    converted = adam_state_dict_from_jax(host.opt_state, model)
    names = [n for n, _ in model.named_parameters()]
    mu = transformer_state_dict_from_jax(host.opt_state[0].mu)
    for i, name in enumerate(names):
        assert torch.equal(converted["state"][i]["exp_avg"], mu[name]), name
    optimizer.load_state_dict(converted)
    f1, l1 = _batch(2)
    state, metrics = jstep(state, {k: jnp.asarray(v) for k, v in f1.items()}, jnp.asarray(l1))
    got = float(make_train_step(model, optimizer)({k: torch.from_numpy(v) for k, v in f1.items()},
                                                 torch.from_numpy(l1))["loss"])
    assert abs(got - float(metrics["loss"])) <= 1e-5
    want = transformer_state_dict_from_jax(jax.tree.map(np.asarray, state.params))
    for name, value in model.state_dict().items():
        g, w = value.numpy(), want[name].numpy()
        if name.endswith("qkv.bias"):
            keys = slice(embed, 2 * embed)
            assert np.abs(g[keys] - w[keys]).max() <= 2e-3 * (1 + 1e-5)
            g, w = np.delete(g, np.r_[keys]), np.delete(w, np.r_[keys])
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)
    with pytest.raises(KeyError):
        adam_state_dict_from_jax({"nothing": 1}, model)
