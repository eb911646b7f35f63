"""Trainer ranks as processes against the JAX package: each rank's row
stream, the explicit mean step, Adasum and the bf16 wire, with ranks in
separate processes on the CPU (``gloo``). Every child process runs under
a deadline and is killed on failure."""

import json
import os
import select
import signal
import socket
import subprocess
import sys
import threading
import time
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_port_helpers as helpers
from ray_shuffling_data_loader_tpu import dataset as jax_dataset
from ray_shuffling_data_loader_tpu.jax_compat import shard_map
from ray_shuffling_data_loader_tpu.models import dlrm as jax_dlrm
from ray_shuffling_data_loader_tpu.parallel.mesh import DATA_AXIS, batch_sharding
from ray_shuffling_data_loader_tpu.parallel.train import TrainState
from ray_shuffling_data_loader_tpu.parallel.train import adasum_reduce as jax_adasum_reduce
from ray_shuffling_data_loader_tpu.parallel.train import make_psum_train_step as jax_psum_step
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch import data_generation as port_gen
from ray_shuffling_data_loader_tpu_torch.batch_queue import BatchQueue, ProducerDiedError
from ray_shuffling_data_loader_tpu_torch.convert import dlrm_state_dict_from_jax
from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset
from ray_shuffling_data_loader_tpu_torch.parallel import init_data_parallel, make_psum_train_step

REPO = helpers.REPO
DEADLINE_S = 60
MEAN_BATCH, MEAN_STEPS = 96, 3  # 96 rows split evenly over 2, 3 and 4 ranks
LEAF_SHAPES = ((7, 3), (5,), (4, 4))
# world size -> the cases its ranks compute
WORLD_CASES = {2: ("mean", "adasum", "bf16", "steps", "ddp_loss"), 3: ("adasum", "steps", "idle"), 4: ("mean", "adasum"),
               5: ("adasum",)}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


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


# -- (a) each rank's row stream ---------------------------------------------------


RANK_SCRIPT = """
import sys
import numpy as np
sys.path.insert(0, {repo!r})
from ray_shuffling_data_loader_tpu_torch import runtime
from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset

runtime.init()
ds = ShufflingDataset({files!r}, 2, 2, {batch}, 1, queue_name={queue!r}, **{kwargs!r})
for epoch in range(2):
    ds.set_epoch(epoch)
    batches = list(ds)
    np.savez({out!r} + f"-{{epoch}}.npz", sizes=[b.num_rows for b in batches],
             **{{k: np.concatenate([b[k] for b in batches]) for k in batches[0]}})
runtime.shutdown()
"""


def _stream(ds, epochs=2):
    out = []
    for epoch in range(epochs):
        ds.set_epoch(epoch)
        batches = [{k: np.array(v) for k, v in b.items()} for b in ds]
        out.append(batches)
    return out


def test_rank_streams_across_processes_match_jax(tmp_path, local_runtime):
    port_runtime.shutdown()
    ctx = port_runtime.init(num_workers=2)
    try:
        files, _ = port_gen.generate_data(6000, 3, 2, 0.0, str(tmp_path / "data"))
        kwargs = dict(num_reducers=5, seed=9, narrow_to_32=True)
        batch = 700
        queue = f"ranks-{uuid.uuid4().hex[:8]}"
        rank0 = ShufflingDataset(files, 2, 2, batch, 0, queue_name=queue, **kwargs)
        env = dict(os.environ, RSDL_RUNTIME_DIR=ctx.runtime_dir)
        script = RANK_SCRIPT.format(repo=REPO, files=files, batch=batch, queue=queue, kwargs=kwargs,
                                    out=str(tmp_path / "rank1"))
        rank1 = subprocess.Popen([sys.executable, "-c", script], env=env, stderr=subprocess.PIPE, text=True)
        try:
            got0 = _stream(rank0)
        finally:
            _wait_all([rank1])
        rank0.join(timeout=DEADLINE_S)
        assert port_runtime.store_stats().num_objects == 0  # every ref freed
    finally:
        port_runtime.shutdown()

    # The JAX package's two ranks, as threads of this process.
    jax_queue = f"ranks-jax-{uuid.uuid4().hex[:8]}"
    jax_ranks = [jax_dataset.ShufflingDataset(files, 2, 2, batch, r, queue_name=jax_queue, **kwargs) for r in (0, 1)]
    want = [None, None]
    threads = [threading.Thread(target=lambda r=r: want.__setitem__(r, _stream(jax_ranks[r])), daemon=True)
               for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DEADLINE_S)
    assert want[0] is not None and want[1] is not None

    for epoch in range(2):
        # Rank 0: batch for batch.
        assert len(got0[epoch]) == len(want[0][epoch]) > 0
        for g, w in zip(got0[epoch], want[0][epoch]):
            assert list(g) == list(w)
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        # Rank 1, from the other process: the same batches, concatenated.
        got1 = np.load(str(tmp_path / f"rank1-{epoch}.npz"))
        assert list(got1["sizes"]) == [len(b["key"]) for b in want[1][epoch]]
        for k in want[1][epoch][0]:
            np.testing.assert_array_equal(got1[k], np.concatenate([b[k] for b in want[1][epoch]]), err_msg=k)
        # Exactly once: the ranks' rows are every row.
        keys = np.concatenate([np.concatenate([b["key"] for b in got0[epoch]]), got1["key"]])
        np.testing.assert_array_equal(np.sort(keys), np.arange(6000))


# -- (b) a producer killed mid-epoch ------------------------------------------------


PRODUCER_SCRIPT = """
import sys, time
sys.path.insert(0, {repo!r})
from ray_shuffling_data_loader_tpu_torch import runtime
from ray_shuffling_data_loader_tpu_torch.batch_queue import BatchQueue

runtime.init()
q = BatchQueue(2, 1, 1, name={queue!r})
q.new_epoch(0)
q.put_batch(0, 0, ["first half of epoch 0"])
print("READY", flush=True)
time.sleep(300)  # dies mid-epoch when the test kills it
"""


def test_producer_killed_mid_epoch_raises_in_the_consumer(monkeypatch):
    monkeypatch.setenv("RSDL_PRODUCER_LIVENESS_S", "0.2")
    port_runtime.shutdown()
    ctx = port_runtime.init(num_workers=1)
    queue = f"dying-{uuid.uuid4().hex[:8]}"
    producer = subprocess.Popen(
        [sys.executable, "-c", PRODUCER_SCRIPT.format(repo=REPO, queue=queue)],
        env=dict(os.environ, RSDL_RUNTIME_DIR=ctx.runtime_dir), stdout=subprocess.PIPE, text=True,
    )
    try:
        ready, _, _ = select.select([producer.stdout], [], [], DEADLINE_S)
        assert ready and producer.stdout.readline().strip() == "READY"
        consumer = BatchQueue(2, 1, 1, name=queue, connect=True)
        assert consumer.get_batch(0, 0) == ["first half of epoch 0"]
        producer.send_signal(signal.SIGKILL)
        producer.wait(DEADLINE_S)
        start = time.monotonic()
        with pytest.raises(ProducerDiedError) as info:
            consumer.get_batch(0, 0)
        assert time.monotonic() - start < 30  # bounded, not a hang
        assert (info.value.epoch, info.value.rank) == (0, 0)
    finally:
        if producer.poll() is None:
            producer.kill()
            producer.wait()
        port_runtime.shutdown()


# -- (c), (d), (e): the gradient plane against JAX ------------------------------


def _mean_inputs(rng):
    columns = sorted(c for c in port_gen.DATA_SPEC if c != port_gen.LABEL_COLUMN)
    feats = {
        c: rng.integers(0, port_gen.DATA_SPEC[c][1], (MEAN_STEPS, MEAN_BATCH)).astype(np.int32) for c in columns
    }
    labels = rng.random((MEAN_STEPS, MEAN_BATCH)).astype(np.float32)
    bf16_labels = (rng.random(MEAN_BATCH) > 0.5).astype(np.float32)
    return columns, feats, labels, bf16_labels


def _adasum_inputs(rng, world):
    """Per-rank gradients of every case, ``{case}_{leaf}: [world, *shape]``."""
    sizes = [int(np.prod(s)) for s in LEAF_SHAPES]
    flat_ortho = np.zeros((world, sum(sizes)), np.float32)
    for r in range(world):  # disjoint supports: mutually orthogonal
        flat_ortho[r, r::world] = rng.standard_normal(len(range(r, sum(sizes), world)))
    same = rng.standard_normal(sum(sizes)).astype(np.float32)
    out = {}
    for i, shape in enumerate(LEAF_SHAPES):
        lo = sum(sizes[:i])
        out[f"random_{i}"] = rng.standard_normal((world, *shape)).astype(np.float32)
        out[f"orthogonal_{i}"] = flat_ortho[:, lo : lo + sizes[i]].reshape(world, *shape)
        out[f"identical_{i}"] = np.broadcast_to(same[lo : lo + sizes[i]].reshape(shape), (world, *shape)).copy()
        out[f"zeros_{i}"] = np.zeros((world, *shape), np.float32)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Run each world size's ranks once, lazily: ``worlds(n)`` ->
    ``(inputs, params, [per-rank results])``."""
    root = tmp_path_factory.mktemp("worlds")
    rng = np.random.default_rng(0)
    columns, feats, labels, bf16_labels = _mean_inputs(rng)
    jmodel = _jax_model()
    params = jmodel.init(jax.random.key(0), {c: jnp.asarray(v[0]) for c, v in feats.items()})
    state_path = str(root / "state.pt")
    torch.save(dlrm_state_dict_from_jax(jax.tree.map(np.asarray, params)), state_path)
    inputs_path = str(root / "inputs.npz")
    np.savez(inputs_path, labels=labels, bf16_labels=bf16_labels, columns=np.asarray(columns),
             **{f"feat_{c}": v for c, v in feats.items()})
    cache = {}

    def run(world):
        if world in cache:
            return cache[world]
        out_dir = root / f"world{world}"
        out_dir.mkdir()
        grads = _adasum_inputs(np.random.default_rng(world), world)
        grads_path = str(out_dir / "grads.npz")
        np.savez(grads_path, **grads)
        spec = {"world": world, "cases": list(WORLD_CASES[world]), "init_method": f"tcp://localhost:{_free_port()}",
                "inputs": inputs_path, "state": state_path, "grads": grads_path, "num_leaves": len(LEAF_SHAPES),
                "out_dir": str(out_dir)}
        spec_path = str(out_dir / "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        helper = os.path.join(REPO, "tests", "torch_port_helpers.py")
        procs = [subprocess.Popen([sys.executable, helper, spec_path, str(r)], stderr=subprocess.PIPE, text=True)
                 for r in range(world)]
        _wait_all(procs)
        results = [dict(np.load(str(out_dir / f"rank{r}.npz"))) for r in range(world)]
        cache[world] = ({"feats": feats, "labels": labels, "bf16_labels": bf16_labels, "grads": grads}, params, results)
        return cache[world]

    run.inputs_path, run.state_path = inputs_path, state_path
    return run


def _jax_model():
    # The plain interaction: the Pallas kernel is the CPU tests' concern
    # elsewhere, not the gradient plane's.
    return jax_dlrm.dlrm_for_data_spec(**helpers.SMALL_DLRM, use_pallas_interaction=False).clone(
        compute_dtype=jnp.float32
    )


def _data_mesh(world):
    return Mesh(np.array(jax.devices()[:world]).reshape(world, 1), (DATA_AXIS, "model"))


@pytest.mark.parametrize("world", [2, 4])
def test_mean_step_matches_jax_psum_step(worlds, world):
    inputs, params, results = worlds(world)
    mesh = _data_mesh(world)
    jmodel, opt = _jax_model(), optax.adam(1e-3)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=opt.init(params))
    state = jax.device_put(state, NamedSharding(mesh, P()))
    step = jax_psum_step(jmodel, opt, mesh, donate_state=False)
    bsh = batch_sharding(mesh, 1)
    want = []
    for s in range(MEAN_STEPS):
        feats = {c: jax.device_put(v[s], bsh) for c, v in inputs["feats"].items()}
        state, metrics = step(state, feats, jax.device_put(inputs["labels"][s], bsh))
        want.append(float(metrics["loss"]))
    for res in results:  # every rank returns the mean over the ranks
        np.testing.assert_allclose(res["mean_losses"], want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shards", helpers.SHARDS)
def test_ddp_step_reports_the_global_batch_loss(worlds, shards):
    """The DDP step reports the loss of the global batch, as the explicit
    mean step and the JAX package's data-parallel step do: at 2 ranks, on
    equal shards and with rank 1 idle (rank 0's shard alone), every rank
    logs the same loss, within 1e-4 of JAX's ``make_psum_train_step``
    on the same weights and shards."""
    world = 2
    inputs, params, results = worlds(world)
    n = 1 if shards == "uneven" else world
    rows = slice(0, MEAN_BATCH // world) if shards == "uneven" else slice(None)
    mesh = _data_mesh(n)
    jmodel, opt = _jax_model(), optax.adam(1e-3)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=opt.init(params))
    state = jax.device_put(state, NamedSharding(mesh, P()))
    step = jax_psum_step(jmodel, opt, mesh, donate_state=False)
    bsh = batch_sharding(mesh, 1)
    want = []
    for s in range(MEAN_STEPS):
        feats = {c: jax.device_put(v[s, rows], bsh) for c, v in inputs["feats"].items()}
        state, metrics = step(state, feats, jax.device_put(inputs["labels"][s, rows], bsh))
        want.append(float(metrics["loss"]))
    for r, res in enumerate(results):
        ddp, mean = res[f"loss_ddp_{shards}"], res[f"loss_mean_{shards}"]
        np.testing.assert_allclose(ddp, want, atol=1e-4, rtol=0, err_msg=f"rank {r}")
        np.testing.assert_allclose(ddp, mean, atol=1e-6, rtol=0, err_msg=f"rank {r}")
        np.testing.assert_array_equal(ddp, results[0][f"loss_ddp_{shards}"])


@pytest.mark.parametrize("world", [2, 3, 4, 5])
def test_adasum_matches_jax_and_its_limits(worlds, world):
    inputs, _, results = worlds(world)
    mesh = Mesh(np.array(jax.devices()[:world]), (DATA_AXIS,))
    fn = jax.jit(shard_map(
        lambda tree: jax.tree.map(lambda g: g[None], jax_adasum_reduce(jax.tree.map(lambda g: g[0], tree), DATA_AXIS,
                                                                        world)),
        mesh=mesh, in_specs=(P(DATA_AXIS),), out_specs=P(DATA_AXIS), check_vma=False,
    ))
    grads = inputs["grads"]
    for case in helpers.ADASUM_CASES:
        leaves = [grads[f"{case}_{i}"] for i in range(len(LEAF_SHAPES))]
        want = [np.asarray(x) for x in fn(leaves)]
        for r, res in enumerate(results):
            for i, shape in enumerate(LEAF_SHAPES):
                got = res[f"adasum_{case}_{i}"].reshape(shape)
                np.testing.assert_allclose(got, want[i][r], rtol=1e-5, atol=1e-6, err_msg=f"{case} rank {r}")
                # Every rank holds the same bits.
                np.testing.assert_array_equal(got, results[0][f"adasum_{case}_{i}"].reshape(shape))
        # The operator's limits: orthogonal gradients add, identical ones
        # return themselves, zeros stay zeros.
        got = [results[0][f"adasum_{case}_{i}"].reshape(s) for i, s in enumerate(LEAF_SHAPES)]
        for i, leaf in enumerate(leaves):
            if case == "orthogonal":
                np.testing.assert_allclose(got[i], leaf.sum(axis=0), rtol=1e-6, atol=1e-7)
            elif case == "identical":
                np.testing.assert_allclose(got[i], leaf[0], rtol=1e-6, atol=1e-7)
            elif case == "zeros":
                assert np.all(got[i] == 0)


def test_adasum_ranks_agree_when_their_dot_products_round_differently(tmp_path):
    """Two ranks on different thread counts sum the same dot products in
    other orders; the butterfly must still leave both with the same bits."""
    world, n = 2, 2_000_003
    rng = np.random.default_rng(1)
    grads = {f"{case}_0": rng.standard_normal((world, n)).astype(np.float32) for case in helpers.ADASUM_CASES}
    grads_path = str(tmp_path / "grads.npz")
    np.savez(grads_path, **grads)
    spec = {"world": world, "cases": ["adasum"], "init_method": f"tcp://localhost:{_free_port()}",
            "grads": grads_path, "num_leaves": 1, "out_dir": str(tmp_path), "threads": [1, 4]}
    spec_path = str(tmp_path / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    helper = os.path.join(REPO, "tests", "torch_port_helpers.py")
    _wait_all([subprocess.Popen([sys.executable, helper, spec_path, str(r)], stderr=subprocess.PIPE, text=True)
               for r in range(world)])
    results = [np.load(str(tmp_path / f"rank{r}.npz")) for r in range(world)]
    for case in helpers.ADASUM_CASES:
        np.testing.assert_array_equal(results[0][f"adasum_{case}_0"], results[1][f"adasum_{case}_0"], err_msg=case)


def test_adam_ranks_agree_when_their_vector_math_takes_other_paths(worlds, tmp_path):
    """Two ranks whose MKL takes different code paths (one process held to
    MKL's compatible path, as a host or a racing first call can make it)
    must still end every Adam step with the same bits."""
    spec = {"world": 2, "cases": ["adam"], "init_method": f"tcp://localhost:{_free_port()}",
            "inputs": worlds.inputs_path, "state": worlds.state_path, "out_dir": str(tmp_path),
            "threads": [2, 2]}
    spec_path = str(tmp_path / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    helper = os.path.join(REPO, "tests", "torch_port_helpers.py")
    envs = [dict(os.environ), dict(os.environ, MKL_CBWR="COMPATIBLE")]
    _wait_all([subprocess.Popen([sys.executable, helper, spec_path, str(r)], stderr=subprocess.PIPE, text=True,
                                env=envs[r]) for r in range(2)])
    results = [np.load(str(tmp_path / f"rank{r}.npz")) for r in range(2)]
    assert len(results[0].files) > 2
    for key in results[0].files:
        np.testing.assert_array_equal(results[0][key], results[1][key], err_msg=key)


def test_bf16_wire_tracks_fp32(worlds):
    _, _, results = worlds(2)
    for res in results:
        a, b = res["bf16_wire_f32"], res["bf16_wire_bf16"]
        assert a[-1] < a[0] and b[-1] < b[0]
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-3)
        # The wire dtype is the wire's only: parameters stay fp32.
        assert str(res["bf16_wire_bf16_dtype"]) == "torch.float32"


# The port's update against JAX's, relative to its size: within 3e-5 for
# both wires at 2 and 3 ranks; the fp32 wire is 2.5e-3 from JAX's bf16 one.
UPDATE_RTOL = 2e-4


def _update_error(got, want, start):
    """``|got - want| / |want - start|`` over every parameter: how far the
    port's update is from JAX's, relative to the update's size."""
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    den = sum(float(np.sum((want[k] - start[k]) ** 2)) for k in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("reduce", ["mean", "adasum"])
def test_wire_dtype_and_reduce_steps_match_jax(worlds, world, reduce):
    """The bf16 wire and Adasum steps against JAX ``make_psum_train_step``
    with the same ``grad_dtype`` and ``grad_reduce`` on the same mesh,
    weights and shards: three SGD steps, their mean losses and the
    parameters after them. The tolerance on the update is one that the
    fp32 wire fails against JAX's bf16 wire. SGD, not Adam: Adam's first
    steps move each weight by about ``lr`` whatever the gradient's
    rounding, which would hide the wire."""
    inputs, params, results = worlds(world)
    mesh = _data_mesh(world)
    bsh = batch_sharding(mesh, 1)
    start = {k: v.numpy() for k, v in dlrm_state_dict_from_jax(jax.tree.map(np.asarray, params)).items()}
    want = {}
    for wire in (None, jnp.bfloat16):
        jmodel, opt = _jax_model(), optax.sgd(helpers.STEP_LR)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=opt.init(params))
        state = jax.device_put(state, NamedSharding(mesh, P()))
        step = jax_psum_step(jmodel, opt, mesh, grad_dtype=wire, grad_reduce=reduce, donate_state=False)
        batches = [({c: jax.device_put(v[s], bsh) for c, v in inputs["feats"].items()},
                    jax.device_put(inputs["labels"][s], bsh)) for s in range(MEAN_STEPS)]
        # XLA may keep a value wider than its cast says where nothing else
        # reads the narrow one ("excess precision"); without it, JAX's bf16
        # wire rounds where its program casts, as the port's does.
        step = step.lower(state, *batches[0]).compile({"xla_allow_excess_precision": False})
        losses = []
        for feats, labels in batches:
            state, metrics = step(state, feats, labels)
            losses.append(float(metrics["loss"]))
        final = dlrm_state_dict_from_jax(jax.tree.map(np.asarray, state.params))
        want["bfloat16" if wire else "float32"] = (losses, {k: v.numpy() for k, v in final.items()})
    for r, res in enumerate(results):
        for wire, (losses, final) in want.items():
            case = f"step_{reduce}_{wire}"
            np.testing.assert_allclose(res[f"{case}_losses"], losses, atol=1e-4, rtol=0, err_msg=f"{case} rank {r}")
            got = {k: res[f"{case}_param_{k}"] for k in final}
            assert _update_error(got, final, start) < UPDATE_RTOL, f"{case} rank {r}"
            # Every rank holds the same parameters.
            for k in final:
                np.testing.assert_array_equal(got[k], results[0][f"{case}_param_{k}"])
        # The tolerance tells the wires apart: the fp32 wire misses JAX's bf16.
        fp32_wire = {k: res[f"step_{reduce}_float32_param_{k}"] for k in start}
        assert _update_error(fp32_wire, want["bfloat16"][1], start) > 5 * UPDATE_RTOL


@pytest.mark.parametrize("kind", helpers.IDLE_STEPS)
def test_idle_ranks_add_nothing_to_the_step(worlds, kind):
    """Three ranks, of which only rank 0 brings a batch: the DDP and the
    explicit steps make the update of the JAX step on rank 0's shard
    alone, on every rank."""
    world = 3
    inputs, params, results = worlds(world)
    mesh = _data_mesh(1)
    rows = slice(0, MEAN_BATCH // world)
    opt = optax.sgd(helpers.STEP_LR)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=opt.init(params))
    step = jax_psum_step(_jax_model(), opt, mesh, grad_reduce="mean" if kind == "ddp" else kind, donate_state=False)
    for s in range(MEAN_STEPS):
        state, _ = step(state, {c: v[s, rows] for c, v in inputs["feats"].items()}, inputs["labels"][s, rows])
    want = {k: v.numpy() for k, v in dlrm_state_dict_from_jax(jax.tree.map(np.asarray, state.params)).items()}
    start = {k: v.numpy() for k, v in dlrm_state_dict_from_jax(jax.tree.map(np.asarray, params)).items()}
    for r, res in enumerate(results):
        got = {k: res[f"idle_{kind}_param_{k}"] for k in want}
        assert _update_error(got, want, start) < UPDATE_RTOL, f"rank {r}"
        for k in want:
            np.testing.assert_array_equal(got[k], results[0][f"idle_{kind}_param_{k}"])


# -- (f) what raises ------------------------------------------------------------------


def test_nccl_on_a_shared_device_and_unknown_reduce_raise():
    with pytest.raises(ValueError, match="one CUDA device per rank"):
        init_data_parallel(0, 2, "nccl", "tcp://localhost:1")
    with pytest.raises(ValueError, match="backend must be"):
        init_data_parallel(0, 1, "mpi", "tcp://localhost:1")
    model = torch.nn.Linear(2, 1)
    with pytest.raises(ValueError, match="grad_reduce"):
        make_psum_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1), object(), grad_reduce="sum")
    with pytest.raises(ValueError, match="process group"):
        make_psum_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1), None)
    from ray_shuffling_data_loader_tpu_torch import multirank

    with pytest.raises(SystemExit):  # the backend is never chosen quietly
        multirank.parse_args(["--num-trainers", "2"])


# -- the multi-rank trainer end to end --------------------------------------------


def _three_uneven_ranks(tmp_path, step_args):
    """Three rank processes, five reducers (shards of unequal length): the
    launcher's checks hold (exactly once, each rank its full batches, every
    batch trained, equal parameters, finite losses); returns the ranks'
    results."""
    from ray_shuffling_data_loader_tpu_torch import multirank

    port_runtime.shutdown()
    args = multirank.parse_args([
        "--num-trainers", "3", "--backend", "gloo", *step_args,
        "--epochs", "1", "--device", "cpu", "--num-rows", "12000", "--num-files", "3", "--row-groups", "1",
        "--batch-size", "1000", "--num-reducers", "5", "--vocab-cap", "1000", "--embed-dim", "8",
        "--compute-dtype", "float32", "--num-workers", "2", "--data-dir", str(tmp_path), "--timeout", str(DEADLINE_S),
    ])
    out = multirank.run(args)
    assert out["returncode"] == 0, out["problems"]
    ranks = out["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1, 2]
    full = [r["epochs"][0]["rows_read"] // 1000 for r in ranks]
    assert min(full) < max(full)  # a shorter shard: its rank idles
    # Every rank stepped until the last ran out, and trained each of its batches.
    assert all(r["steps"] == max(full) for r in ranks)
    assert [r["epochs"][0]["steps"] - r["epochs"][0]["idle"] for r in ranks] == full
    # One loss per step, the global batch's: the same on every rank.
    assert [len(r["losses"]) for r in ranks] == [max(full)] * 3
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    assert sum(r["epochs"][0]["keys"] for r in ranks) == sum(full) * 1000
    return ranks


def test_multirank_trains_three_uneven_ranks_with_adasum(tmp_path):
    """Adasum with bf16 on the wire."""
    ranks = _three_uneven_ranks(
        tmp_path, ["--step", "psum", "--grad-reduce", "adasum", "--grad-dtype", "bfloat16"]
    )
    # Rank 0 ran the shuffle: its pool and the store's peak are reported.
    assert ranks[0]["pool_ready_s"] > 0 and ranks[0]["store_peak_bytes"] > 0
    assert ranks[1]["pool_ready_s"] is None


def test_multirank_trains_three_uneven_ranks_with_ddp(tmp_path):
    """DistributedDataParallel: an idle rank still joins its all-reduce."""
    _three_uneven_ranks(tmp_path, ["--step", "ddp"])
