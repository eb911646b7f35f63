"""Vocab sharding over a model group against the JAX package's ``(data,
model)`` mesh: the sharding rule on the full-width models, the sharded
lookup's forward, the converters' shards and the gathered state, three
Adam steps of a 2 × 2 world against JAX's sharded ``make_train_step``,
and ``multirank --model-parallelism`` end to end. Ranks run as separate
processes on the CPU (``gloo``), each under a deadline and killed on
failure."""

import json
import os
import pickle
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_helpers as helpers
from ray_shuffling_data_loader_tpu.data_generation import DATA_SPEC, LABEL_COLUMN
from ray_shuffling_data_loader_tpu.models import dlrm as jax_dlrm
from ray_shuffling_data_loader_tpu.models import example_features as jax_example_features
from ray_shuffling_data_loader_tpu.models import transformer as jax_transformer
from ray_shuffling_data_loader_tpu.parallel.mesh import batch_sharding, param_shardings
from ray_shuffling_data_loader_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ray_shuffling_data_loader_tpu.parallel.mesh import param_spec as jax_param_spec
from ray_shuffling_data_loader_tpu.parallel.train import init_state
from ray_shuffling_data_loader_tpu.parallel.train import make_train_step as jax_make_train_step
from ray_shuffling_data_loader_tpu_torch import convert
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch.models import TabTransformer, TabularDLRM
from ray_shuffling_data_loader_tpu_torch.models import dlrm_for_data_spec
from ray_shuffling_data_loader_tpu_torch.parallel import (
    Mesh,
    make_mesh,
    make_optimizer,
    make_psum_train_step,
    make_train_step,
    param_spec,
    shard_model,
)
from ray_shuffling_data_loader_tpu_torch.parallel.sharded_embedding import sharded_tables

REPO = helpers.REPO
DEADLINE_S = 60
FEATURES = sorted(c for c in DATA_SPEC if c != LABEL_COLUMN)
FULL_VOCAB = {c: DATA_SPEC[c][1] for c in FEATURES}
STEPS, BATCH = 3, 64  # each global batch split over 2 data indices
# The port's update against JAX's, relative to its size, as in
# tests/test_torch_port_ranks.py; the losses within 1e-4, as there.
UPDATE_RTOL, LOSS_ATOL = 2e-4, 1e-4


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _fake_mesh(model_index, model_size, data_group=None):
    """A mesh for the code that cuts tables and needs no collective."""
    return Mesh(0, model_index, 1, model_size, data_group, None)


# -- (a) the rule --------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(100_000, 32), (100, 32), (100_001, 32), (16_384, 8), (16_383, 8),
                                   (941_792, 32), (83_332, 32), (88_999, 32), (779, 256), (100_000,)])
@pytest.mark.parametrize("model_size", [1, 2, 4])
def test_param_spec_is_jax_rule(shape, model_size):
    mesh = jax_make_mesh(model_parallelism=model_size)
    for threshold in (16_384, 512):
        want = tuple(jax_param_spec(shape, mesh, vocab_shard_threshold=threshold))
        assert param_spec(shape, model_size, threshold) == want, (shape, threshold)


def _full_width(kind):
    """``(JAX model, port model on the meta device)`` at full width."""
    if kind == "dlrm":
        jmodel = jax_dlrm.dlrm_for_data_spec()
        with torch.device("meta"):
            pmodel = TabularDLRM(FULL_VOCAB)
    else:
        jmodel = jax_transformer.transformer_for_data_spec()
        with torch.device("meta"):
            pmodel = TabTransformer(FULL_VOCAB)
    return jmodel, pmodel


@pytest.mark.parametrize("threshold", [16_384, 512])
@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("kind", ["dlrm", "transformer"])
def test_rule_selects_jax_tables_at_full_width(kind, model_size, threshold):
    """The port's rule, through the name map of ``convert``, selects exactly
    the parameters that JAX's ``param_shardings`` shards on ``eval_shape``
    of the same full-width model; ``shard_model`` cuts exactly those."""
    jmodel, pmodel = _full_width(kind)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jax_example_features(jmodel, 4))
    mesh = jax_make_mesh(model_parallelism=model_size)
    flat, _ = jax.tree_util.tree_flatten_with_path(param_shardings(shapes, mesh, threshold))
    jax_specs = {"/".join(k.key for k in path[1:]): tuple(sh.spec) for path, sh in flat}
    jax_leaves = {"/".join(k.key for k in path[1:]): tuple(x.shape)
                  for path, x in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    named = [(n, p.shape) for n, p in pmodel.named_parameters()]
    # The name map covers every parameter, with JAX's shapes.
    assert {convert.jax_name_and_shape(n, s) for n, s in named} == set(jax_leaves.items())
    want = {name for name, spec in jax_specs.items() if spec}
    got = convert.sharded_names(named, model_size, threshold)
    assert {convert.jax_name_and_shape(n, s)[0] for n, s in named if n in got} == want
    if kind == "dlrm" and threshold == 16_384:
        assert want == {"embed_embeddings_name12", "embed_embeddings_name14"}
    shard_model(pmodel, _fake_mesh(model_size - 1, model_size), threshold)
    tables = sharded_tables(pmodel)
    assert {f"{name}.weight" for name in tables} == set(got)
    for name, table in tables.items():
        vocab = FULL_VOCAB[name.split(".")[1]]
        assert table.weight.shape[0] == vocab // model_size and table.offset == vocab - vocab // model_size


def test_make_mesh_refuses_a_model_size_that_does_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(3, world=4)
    with pytest.raises(ValueError, match="does not divide"):
        jax_make_mesh(model_parallelism=3)


def test_what_the_sharded_path_refuses():
    model = dlrm_for_data_spec(**helpers.SMALL_DLRM, compute_dtype=torch.float32, device="cpu")
    # At 16 rows the rule selects the second dense kernel (32 × 16): not a table.
    with pytest.raises(NotImplementedError, match="mlp.1.weight"):
        shard_model(model, _fake_mesh(0, 2), vocab_shard_threshold=16)
    data_group = object()
    shard_model(model, _fake_mesh(0, 2, data_group), vocab_shard_threshold=512)
    opt = make_optimizer(model)
    with pytest.raises(ValueError, match="data group"):
        make_train_step(model, opt, group=object())
    with pytest.raises(ValueError, match="replicated"):
        make_psum_train_step(model, opt, data_group)
    from ray_shuffling_data_loader_tpu_torch import multirank, train_dlrm

    with pytest.raises(SystemExit):
        multirank.parse_args(["--backend", "gloo", "--model-parallelism", "2", "--step", "psum"])
    with pytest.raises(NotImplementedError, match="multirank --model-parallelism 2"):
        train_dlrm.main(["--model-parallelism", "2"])


def _grad_fns(tensor):
    """The names of the autograd nodes that ``tensor`` depends on."""
    seen, stack, names = set(), [tensor.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        stack.extend(next_fn for next_fn, _ in node.next_functions)
    return names


@pytest.mark.parametrize("mode", [(False, False), (True, True)])
def test_replicated_tables_of_a_sharded_model_sum_gradients_in_a_fixed_order(monkeypatch, mode):
    """In a sharded model the replicated tables take their gradient from
    the fixed-order lookup (CUDA's ``F.embedding`` backward sums repeated
    ids in a varying order, and model peers would then part), which equals
    ``F.embedding``'s here and leaves the caller's deterministic-algorithms
    setting as it found it."""
    import ray_shuffling_data_loader_tpu_torch.parallel.sharded_embedding as se

    # One process stands for model index 0 of a group whose other rank adds
    # zeros: every id below is under 40, in model index 0's rows.
    monkeypatch.setattr(se.dist, "all_reduce", lambda tensor, group=None: None)
    kwargs, threshold = helpers.MP_MODELS["dlrm"]
    model = dlrm_for_data_spec(**kwargs, compute_dtype=torch.float32, device="cpu")
    plain = dlrm_for_data_spec(**kwargs, compute_dtype=torch.float32, device="cpu")
    shard_model(model, _fake_mesh(0, 2), threshold)
    assert any(not isinstance(t, se.ShardedEmbedding) for t in model.embeddings.values())
    feats = {c: torch.from_numpy(np.random.default_rng(5).integers(0, 40, 64).astype(np.int32)) for c in FEATURES}
    torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
    try:
        logits = model(feats)
        assert {"_FixedOrderLookupBackward", "EmbeddingBackward0"} <= _grad_fns(logits)
        assert "EmbeddingBackward0" in _grad_fns(plain(feats)) and "_FixedOrderLookupBackward" not in _grad_fns(
            plain(feats))
        logits.sum().backward()
        plain(feats).sum().backward()
        assert (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled()) == mode
    finally:
        torch.use_deterministic_algorithms(False)
    for col, table in model.embeddings.items():
        if not isinstance(table, se.ShardedEmbedding):
            torch.testing.assert_close(table.weight.grad, plain.embeddings[col].weight.grad, rtol=0, atol=1e-6)


# -- the converters' shards -------------------------------------------------------------


def _jax_small(kind):
    kwargs, _ = helpers.MP_MODELS[kind]
    if kind == "dlrm":
        return jax_dlrm.dlrm_for_data_spec(**kwargs, use_pallas_interaction=False).clone(compute_dtype=jnp.float32)
    return jax_transformer.transformer_for_data_spec(**kwargs).clone(compute_dtype=jnp.float32)


def _convert(kind):
    return convert.dlrm_state_dict_from_jax if kind == "dlrm" else convert.transformer_state_dict_from_jax


def _jax_leaf(tree, name):
    """The JAX leaf of the port's parameter ``name``, in the port's layout."""
    leaf = tree["params"] if "params" in tree else tree
    jname, _ = convert.jax_name_and_shape(name, ())
    for key in jname.split("/"):
        leaf = leaf[key]
    leaf = np.asarray(leaf)
    return leaf.T if jname.endswith("/kernel") else leaf


@pytest.mark.parametrize("kind", ["dlrm", "transformer"])
def test_converted_shards_are_the_tables_rows(kind):
    """Each rank's converted shard holds its rows of every selected table,
    the other parameters whole; the shards put together are the JAX
    tables bit for bit."""
    _, threshold = helpers.MP_MODELS[kind]
    jmodel = _jax_small(kind)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0), jax_example_features(jmodel, 4)))
    full = _convert(kind)(params)
    for model_size in (2, 4):
        shards = [_convert(kind)(params, m, model_size, threshold) for m in range(model_size)]
        selected = convert.sharded_names(((k, v.shape) for k, v in full.items()), model_size, threshold)
        assert selected and all(k.startswith("embeddings.") for k in selected)
        for name, tensor in full.items():
            if name in selected:
                assert all(s[name].shape[0] == tensor.shape[0] // model_size for s in shards)
                got = torch.cat([s[name] for s in shards]).numpy()
            else:
                assert all(torch.equal(s[name], tensor) for s in shards)
                got = shards[-1][name].numpy()
            np.testing.assert_array_equal(got, _jax_leaf(params, name), err_msg=name)


def test_adam_moments_are_cut_like_the_tables():
    """``adam_state_dict_from_jax`` on a sharded model holds its rows of the
    JAX moments of each sharded table, and the rest whole."""
    kind = "dlrm"
    _, threshold = helpers.MP_MODELS[kind]
    jmodel = _jax_small(kind)
    feats = jax_example_features(jmodel, 16)
    params = jmodel.init(jax.random.key(0), feats)
    opt = optax.adam(helpers.MP_LR)
    opt_state = opt.init(params)
    grads = jax.grad(lambda p: jnp.mean(jmodel.apply(p, feats) ** 2))(params)
    _, opt_state = opt.update(grads, opt_state, params)
    opt_state = jax.tree.map(np.asarray, opt_state)
    mu, nu = opt_state[0].mu, opt_state[0].nu
    model = dlrm_for_data_spec(**helpers.MP_MODELS[kind][0], compute_dtype=torch.float32, device="cpu")
    shard_model(model, _fake_mesh(1, 2), threshold)
    state = convert.adam_state_dict_from_jax(opt_state, model, lr=helpers.MP_LR)
    tables = {f"{name}.weight": t for name, t in sharded_tables(model).items()}
    assert tables
    optimizer = make_optimizer(model, lr=helpers.MP_LR)
    optimizer.load_state_dict(state)
    for name, p in model.named_parameters():
        moments = optimizer.state[p]
        for got, tree in ((moments["exp_avg"], mu), (moments["exp_avg_sq"], nu)):
            want = _jax_leaf(tree, name)
            if name in tables:
                want = want[tables[name].offset : tables[name].offset + p.shape[0]]
            assert got.shape == p.shape
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


# -- ranks: the sharded forward, the gathered state, a 2 × 2 world against JAX -------------


def _wait_all(procs, deadline_s=DEADLINE_S):
    """Join every process under one deadline; kill them all on failure."""
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


def _inputs(rng):
    feats = {c: rng.integers(0, DATA_SPEC[c][1], (STEPS, BATCH)).astype(np.int32) for c in FEATURES}
    return feats, rng.random((STEPS, BATCH)).astype(np.float32)


def _jax_run(kind, feats, labels):
    """JAX's sharded ``init_state`` and three ``make_train_step`` steps on a
    ``(data 2, model 2)`` mesh of four devices: ``(initial params, initial
    Adam state, losses, final params, final moments)`` as numpy."""
    _, threshold = helpers.MP_MODELS[kind]
    mesh = jax_make_mesh(model_parallelism=2, devices=jax.devices()[:4])
    jmodel, opt = _jax_small(kind), optax.adam(helpers.MP_LR)
    first = {c: jnp.asarray(v[0]) for c, v in feats.items()}
    state, shardings = init_state(jmodel, opt, mesh, first, vocab_shard_threshold=threshold)
    table = state.params["params"]["embed_embeddings_name12"]
    assert table.sharding.spec == ("model", None)
    init_params = jax.tree.map(np.asarray, state.params)
    adam = state.opt_state[0]
    init_opt = {"count": np.asarray(adam.count), "mu": jax.tree.map(np.asarray, adam.mu),
                "nu": jax.tree.map(np.asarray, adam.nu)}
    step = jax_make_train_step(jmodel, opt, mesh, shardings, donate_state=False)
    bsh = batch_sharding(mesh, 1)
    losses = []
    for s in range(STEPS):
        batch = {c: jax.device_put(v[s], bsh) for c, v in feats.items()}
        state, metrics = step(state, batch, jax.device_put(labels[s], bsh))
        losses.append(float(metrics["loss"]))
    final = state.opt_state[0]
    return (init_params, init_opt, np.asarray(losses), jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, final.mu), jax.tree.map(np.asarray, final.nu))


@pytest.fixture(scope="module")
def mp_worlds(tmp_path_factory):
    """Run each world's ranks once, lazily: ``mp_worlds(n)`` -> ``(JAX
    results per model, [per-rank results])``. World 2 is one model group
    (forward, gather); world 4 is 2 data × 2 model (train)."""
    root = tmp_path_factory.mktemp("mp")
    rng = np.random.default_rng(0)
    spec_base, jax_results = {}, {}
    for kind in helpers.MP_MODELS:
        feats, labels = _inputs(rng)
        init_params, init_opt, losses, params, mu, nu = _jax_run(kind, feats, labels)
        jax_results[kind] = {"init": init_params, "losses": losses, "params": params, "mu": mu, "nu": nu}
        with open(root / f"{kind}-state.pkl", "wb") as f:
            pickle.dump({"params": init_params, "opt_state": init_opt}, f)
        np.savez(str(root / f"{kind}-inputs.npz"), labels=labels, **{f"feat_{c}": v for c, v in feats.items()})
        spec_base[f"{kind}_state"] = str(root / f"{kind}-state.pkl")
        spec_base[f"{kind}_inputs"] = str(root / f"{kind}-inputs.npz")
    cache = {}

    def run(world):
        if world in cache:
            return cache[world]
        out_dir = root / f"world{world}"
        out_dir.mkdir()
        cases = ["forward", "gather"] if world == 2 else ["train"]
        spec = {**spec_base, "world": world, "model_parallelism": 2, "cases": cases,
                "init_method": f"tcp://localhost:{_free_port()}", "out_dir": str(out_dir)}
        spec_path = str(out_dir / "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        helper = os.path.join(REPO, "tests", "torch_port_helpers.py")
        _wait_all([subprocess.Popen([sys.executable, helper, spec_path, str(r)], stderr=subprocess.PIPE, text=True)
                   for r in range(world)])
        cache[world] = (jax_results, [dict(np.load(str(out_dir / f"rank{r}.npz"))) for r in range(world)])
        return cache[world]

    return run


@pytest.mark.parametrize("kind", ["dlrm", "transformer"])
def test_sharded_forward_equals_unsharded_bit_for_bit(mp_worlds, kind):
    """Two ranks of one model group: the logits of the sharded model (its
    partial lookups summed over the group) equal the unsharded model's,
    fp32 on the CPU, bit for bit."""
    _, results = mp_worlds(2)
    for r, res in enumerate(results):
        assert len(res[f"{kind}_sharded"]) > 0
        np.testing.assert_array_equal(res[f"{kind}_forward_sharded"], res[f"{kind}_forward_full"], err_msg=f"rank {r}")


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ranks_load_no_jax(mp_worlds, world):
    """The ranks build, shard, train and gather without loading a module of
    JAX, flax, optax or the JAX package."""
    _, results = mp_worlds(world)
    assert all(res["loaded_jax"].size == 0 for res in results), [res["loaded_jax"] for res in results]


@pytest.mark.parametrize("kind", ["dlrm", "transformer"])
def test_jax_shard_gather_round_trip_is_exact(mp_worlds, kind):
    """JAX's initial parameters -> each rank's shard (``convert``) -> the
    state gathered over the model group -> JAX's parameters, bit for bit,
    on every rank."""
    jax_results, results = mp_worlds(2)
    init = jax_results[kind]["init"]
    prefix = f"{kind}_gathered_"
    for r, res in enumerate(results):
        names = [k[len(prefix):] for k in res if k.startswith(prefix)]
        assert len(names) == len(_convert(kind)(init))
        for name in names:
            np.testing.assert_array_equal(res[prefix + name], _jax_leaf(init, name), err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("kind", ["dlrm", "transformer"])
def test_data_model_steps_match_jax(mp_worlds, kind):
    """A 2 × 2 world, three Adam steps from JAX's initial state, data index
    d on rows [d·B/2, (d+1)·B/2) of each global batch: every rank logs
    JAX's sharded ``make_train_step`` loss of the global batch (within
    1e-4), all ranks the same."""
    jax_results, results = mp_worlds(4)
    for r, res in enumerate(results):
        np.testing.assert_allclose(res[f"{kind}_losses"], jax_results[kind]["losses"], atol=LOSS_ATOL, rtol=0,
                                   err_msg=f"rank {r}")
        np.testing.assert_array_equal(res[f"{kind}_losses"], results[0][f"{kind}_losses"])


def _update_error(got, want, start):
    """``|got - want| / |want - start|`` over every parameter."""
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    den = sum(float(np.sum((want[k] - start[k]) ** 2)) for k in want)
    return (num / den) ** 0.5


def _key_bias(name, embed_dim):
    """The key slice of a qkv bias: its true gradient is 0 (the softmax
    cancels a shift shared by a row's scores), so Adam moves it by up to
    about ``lr`` a step from rounding noise alone, differently in each
    framework."""
    return slice(embed_dim, 2 * embed_dim) if name.endswith("qkv.bias") else None


@pytest.mark.parametrize("kind", ["dlrm", "transformer"])
def test_data_model_parameters_match_jax(mp_worlds, kind):
    """After the three steps: the gathered parameters within the update
    tolerance of JAX's on every rank, bit-identical across ranks; the
    replicated parameters bit-identical on all four ranks and each shard
    across its data group."""
    jax_results, results = mp_worlds(4)
    want = {k: v.numpy() for k, v in _convert(kind)(jax_results[kind]["params"]).items()}
    start = {k: v.numpy() for k, v in _convert(kind)(jax_results[kind]["init"]).items()}
    embed_dim = helpers.MP_MODELS[kind][0]["embed_dim"]
    sharded = {f"{name}.weight" for name in results[0][f"{kind}_sharded"]}
    assert sharded
    for r, res in enumerate(results):
        got = {k: res[f"{kind}_param_{k}"] for k in want}
        compared = [dict(got), dict(want), dict(start)]
        for name in want:
            keys = _key_bias(name, embed_dim)
            if keys is not None:
                moved = np.abs(got[name][keys] - start[name][keys]).max()
                assert moved <= 1.01 * STEPS * helpers.MP_LR, (name, moved)
                for d in compared:
                    d[name] = np.delete(d[name], np.r_[keys])
        assert _update_error(*compared) < UPDATE_RTOL, f"rank {r}"
        for name in want:
            np.testing.assert_array_equal(res[f"{kind}_param_{name}"], results[0][f"{kind}_param_{name}"])
            shard = res[f"{kind}_shard_{name}"]
            peer = results[r ^ 2][f"{kind}_shard_{name}"]  # the same model index, the other data index
            np.testing.assert_array_equal(shard, peer, err_msg=f"rank {r} {name}")
            if name not in sharded:
                np.testing.assert_array_equal(shard, results[0][f"{kind}_shard_{name}"])


@pytest.mark.parametrize("kind", ["dlrm", "transformer"])
def test_adam_moments_sharded_like_their_tables(mp_worlds, kind):
    """Each rank's Adam moments of a sharded table are its rows of JAX's
    moments (within the update tolerance, relative to their size); the
    other parameters' moments are whole."""
    jax_results, results = mp_worlds(4)
    sharded = {f"{name}.weight" for name in results[0][f"{kind}_sharded"]}
    for r, res in enumerate(results):
        model_index = r % 2
        for name in sharded:
            full = _jax_leaf(jax_results[kind]["params"], name)
            rows = full.shape[0] // 2
            for moment, tree in (("exp_avg", jax_results[kind]["mu"]), ("exp_avg_sq", jax_results[kind]["nu"])):
                got = res[f"{kind}_{moment}_{name}"]
                want = _jax_leaf(tree, name)[model_index * rows : (model_index + 1) * rows]
                assert got.shape == (rows, full.shape[1])
                err = np.linalg.norm(got - want) / np.linalg.norm(want)
                assert err < UPDATE_RTOL, (r, name, moment, err)
        whole = [k for k in res if k.startswith(f"{kind}_exp_avg_") and k[len(f"{kind}_exp_avg_"):] not in sharded
                 and not k.startswith(f"{kind}_exp_avg_sq_")]
        assert whole
        for key in whole:
            name = key[len(f"{kind}_exp_avg_"):]
            assert res[key].shape == _jax_leaf(jax_results[kind]["params"], name).shape


# -- (e) multirank --model-parallelism end to end ------------------------------------


def test_multirank_model_parallel_with_uneven_shards(tmp_path):
    """Two data indices × two model ranks, five reducers (shards of 7 and 4
    batches, so one model group idles): the launcher's checks hold
    (exactly once over the leads, every peer trains its lead's batches,
    equal losses, replicated parameters equal on every rank, shards across
    their data group, the gathered state on every rank)."""
    from ray_shuffling_data_loader_tpu_torch import multirank

    port_runtime.shutdown()
    args = multirank.parse_args([
        "--num-trainers", "2", "--model-parallelism", "2", "--vocab-shard-threshold", "512", "--backend", "gloo",
        "--step", "ddp", "--epochs", "1", "--device", "cpu", "--num-rows", "12000", "--num-files", "3",
        "--row-groups", "1", "--batch-size", "1000", "--num-reducers", "5", "--vocab-cap", "1000",
        "--embed-dim", "8", "--compute-dtype", "float32", "--num-workers", "2", "--data-dir", str(tmp_path),
        "--timeout", str(DEADLINE_S),
    ])
    out = multirank.run(args)
    assert out["returncode"] == 0, out["problems"]
    ranks = out["ranks"]
    assert [(r["data_index"], r["model_index"]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    full = [r["epochs"][0]["rows_read"] // 1000 for r in ranks[::2]]
    assert min(full) < max(full)  # a shorter shard: its model group idles
    assert all(r["steps"] == max(full) for r in ranks)
    # Both ranks of a model group train the lead's batches, idle alike.
    assert [r["epochs"][0]["steps"] - r["epochs"][0]["idle"] for r in ranks] == [full[0], full[0], full[1], full[1]]
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    # The tables the rule selects at 1000 rows, and only they, are sharded.
    sharded = ranks[0]["sharded"]
    assert sharded and all(r["sharded"] == sharded for r in ranks)
    assert all(name.startswith("embeddings.") for name in sharded)
    assert ranks[0]["param_count"] < _dlrm_param_count(vocab_cap=1000, embed_dim=8)
    assert ranks[0]["lookup_sum_bytes"] == 1000 * len(sharded) * 8 * 4
    for r in ranks:
        assert set(r["startup_s"]) >= {"imports", "runtime", "groups", "model", "optimizer", "step_made",
                                       "first_batch", "last_step", "reported", "teardown"}
    assert "pool_ready" in ranks[0]["startup_s"]


def _dlrm_param_count(**kwargs):
    model = dlrm_for_data_spec(**kwargs, compute_dtype=torch.float32, device="cpu")
    return sum(p.numel() for p in model.parameters())
