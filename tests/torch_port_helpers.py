"""Code that the port's process tests run in other processes: tasks for
the worker pool, an actor class, the trainer rank of the gradient tests
and the rank of the sequence-parallel op tests (``python
tests/torch_port_helpers.py <spec.json> <rank>``).

Pool workers and actors import this module, so it imports ``torch`` only
inside the rank's function.
"""

import asyncio
import contextlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def loaded_modules():
    return sorted(sys.modules)


def fail(message):
    raise ValueError(message)


def square(x):
    return x * x


def sleep_then(x, seconds):
    """``x`` after ``seconds``: a task that is still running when its
    neighbour dies."""
    import time

    time.sleep(seconds)
    return x


def sleep_in_phase(stage, seconds):
    """Sleep ``seconds`` inside a ``stage`` phase of the port's phase
    registry (what the sampling profiler tags a stack with); returns the
    worker's pid."""
    import time

    from ray_shuffling_data_loader_tpu_torch import telemetry

    with telemetry.stage_profiler(stage, epoch=5).phase("nap"):
        time.sleep(seconds)
    return os.getpid()


def die():
    """The worker running this task is killed by SIGKILL."""
    import signal

    os.kill(os.getpid(), signal.SIGKILL)


def fire_fault(site):
    """Fire ``site`` of the port's fault plane in the worker (role
    ``task``); returns the worker's pid when nothing fired."""
    from ray_shuffling_data_loader_tpu_torch.runtime import faults

    faults.fire(site)
    return os.getpid()


def fault_role():
    from ray_shuffling_data_loader_tpu_torch.runtime import faults

    return faults.role()


def probe_task(tag):
    """The trace context live in a pool worker, inside a span of its own."""
    from ray_shuffling_data_loader_tpu_torch import telemetry

    with telemetry.trace_span("probe:task-inner", tag=tag):
        return dict(telemetry.current_context())


class ProbeActor:
    """The trace context live inside an actor's method, in a span of its own."""

    def work(self, tag):
        from ray_shuffling_data_loader_tpu_torch import telemetry

        with telemetry.trace_span("probe:inner", tag=tag):
            return dict(telemetry.current_context())


def emitting_task(payload):
    """Emits an event in a pool worker and does not flush it: the task-done
    path must."""
    from ray_shuffling_data_loader_tpu_torch import telemetry

    telemetry.emit_event("test.worker_event", payload=payload)
    return payload * 2


def raise_lost(pkg, object_id):
    """Raise ``pkg``'s ``ObjectLostError`` for ``object_id``."""
    import importlib

    root = "ray_shuffling_data_loader_tpu" if pkg == "jax" else "ray_shuffling_data_loader_tpu_torch"
    raise importlib.import_module(f"{root}.runtime.store").ObjectLostError(object_id)


class Mailbox:
    """An actor with one asyncio queue: ``get`` blocks until a ``put``."""

    def __init__(self):
        self._q = asyncio.Queue()

    async def get(self):
        return await self._q.get()

    async def put(self, item):
        await self._q.put(item)

    def boom(self):
        raise KeyError("no such thing")


class Blob:
    """An actor whose ``get`` replies out of band: ``n`` int64s after a
    pickled header."""

    def get(self, n):
        from ray_shuffling_data_loader_tpu_torch.runtime.transport import OutOfBand

        data = np.arange(n, dtype=np.int64)
        return OutOfBand({"n": n}, [b"head:", data], keepalive=data)

    def echo(self, x):
        return x


# -- the trainer rank of the gradient tests ------------------------------------

SMALL_DLRM = dict(embed_dim=8, top_mlp=(32, 16), vocab_cap=1000)
ADASUM_CASES = ("random", "orthogonal", "identical", "zeros")


def _mean_losses(torch, port, group, spec, rank, world):
    """Three explicit mean steps (Adam 1e-3) on this rank's shards."""
    data = np.load(spec["inputs"])
    model = port.dlrm_for_data_spec(**SMALL_DLRM, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(torch.load(spec["state"]))
    step = port.make_psum_train_step(model, port.make_optimizer(model, lr=1e-3), group)
    shard = data["labels"].shape[1] // world
    rows = slice(rank * shard, (rank + 1) * shard)
    losses = []
    for s in range(data["labels"].shape[0]):
        feats = {c: torch.from_numpy(data[f"feat_{c}"][s, rows]) for c in model.columns}
        losses.append(float(step(feats, torch.from_numpy(data["labels"][s, rows]))["loss"]))
    return np.asarray(losses)


def _bf16_losses(torch, port, group, spec, rank, world):
    """Ten SGD steps with the fp32 and the bf16 wire from the same
    weights; the second model's parameter dtype."""
    data = np.load(spec["inputs"])
    shard = data["labels"].shape[1] // world
    rows = slice(rank * shard, (rank + 1) * shard)
    feats = {c: torch.from_numpy(data[f"feat_{c}"][0, rows]) for c in data["columns"]}
    labels = torch.from_numpy(data["bf16_labels"][rows])
    out = {}
    for name, wire in (("f32", None), ("bf16", torch.bfloat16)):
        model = port.dlrm_for_data_spec(**SMALL_DLRM, compute_dtype=torch.float32, device="cpu")
        model.load_state_dict(torch.load(spec["state"]))
        step = port.make_psum_train_step(model, torch.optim.SGD(model.parameters(), lr=0.05), group, grad_dtype=wire)
        out[f"bf16_wire_{name}"] = np.asarray([float(step(feats, labels)["loss"]) for _ in range(10)])
        out[f"bf16_wire_{name}_dtype"] = np.asarray(str(model.mlp[0].weight.dtype))
    return out


# The step cases held against the JAX step: (gradient reduction, wire dtype).
STEP_CASES = (("mean", None), ("mean", "bfloat16"), ("adasum", None), ("adasum", "bfloat16"))
STEP_LR = 0.1


def _sgd_steps(torch, port, group, spec, rank, world):
    """For each step case: the mean losses of three SGD steps on this
    rank's shards, and the parameters after them."""
    data = np.load(spec["inputs"])
    shard = data["labels"].shape[1] // world
    rows = slice(rank * shard, (rank + 1) * shard)
    out = {}
    for reduce, wire in STEP_CASES:
        case = f"{reduce}_{wire or 'float32'}"
        model = port.dlrm_for_data_spec(**SMALL_DLRM, compute_dtype=torch.float32, device="cpu")
        model.load_state_dict(torch.load(spec["state"]))
        step = port.make_psum_train_step(
            model, torch.optim.SGD(model.parameters(), lr=STEP_LR), group,
            grad_dtype=getattr(torch, wire) if wire else None, grad_reduce=reduce,
        )
        losses = []
        for s in range(data["labels"].shape[0]):
            feats = {c: torch.from_numpy(data[f"feat_{c}"][s, rows]) for c in model.columns}
            losses.append(float(step(feats, torch.from_numpy(data["labels"][s, rows]))["loss"]))
        out[f"step_{case}_losses"] = np.asarray(losses)
        for name, tensor in model.state_dict().items():
            out[f"step_{case}_param_{name}"] = tensor.numpy()
    return out


IDLE_STEPS = ("ddp", "mean", "adasum")


def _idle_steps(torch, port, group, spec, rank, world):
    """Three SGD steps in which only rank 0 brings a batch (its shard) and
    every other rank idles on its own: the parameters after them."""
    data = np.load(spec["inputs"])
    shard = data["labels"].shape[1] // world
    rows = slice(rank * shard, (rank + 1) * shard)
    out = {}
    for kind in IDLE_STEPS:
        model = port.dlrm_for_data_spec(**SMALL_DLRM, compute_dtype=torch.float32, device="cpu")
        model.load_state_dict(torch.load(spec["state"]))
        opt = torch.optim.SGD(model.parameters(), lr=STEP_LR)
        if kind == "ddp":
            step = port.make_train_step(model, opt, group)
        else:
            step = port.make_psum_train_step(model, opt, group, grad_reduce=kind)
        for s in range(data["labels"].shape[0]):
            feats = {c: torch.from_numpy(data[f"feat_{c}"][s, rows]) for c in model.columns}
            step(feats, torch.from_numpy(data["labels"][s, rows]), 1, idle=rank != 0)
        for name, tensor in model.state_dict().items():
            out[f"idle_{kind}_param_{name}"] = tensor.numpy()
    return out


SHARDS = ("equal", "uneven")


def _ddp_losses(torch, port, group, spec, rank, world):
    """The losses that the DDP and the explicit mean step report, from the
    same weights: three Adam (1e-3) steps on equal shards, then, from the
    weights again, three in which only rank 0 brings a batch (its shard)
    and every other rank idles on its own."""
    data = np.load(spec["inputs"])
    shard = data["labels"].shape[1] // world
    rows = slice(rank * shard, (rank + 1) * shard)
    out = {}
    for kind in ("ddp", "mean"):
        for shards in SHARDS:
            model = port.dlrm_for_data_spec(**SMALL_DLRM, compute_dtype=torch.float32, device="cpu")
            model.load_state_dict(torch.load(spec["state"]))
            opt = port.make_optimizer(model, lr=1e-3)
            step = port.make_train_step(model, opt, group) if kind == "ddp" else port.make_psum_train_step(model, opt, group)
            losses = []
            for s in range(data["labels"].shape[0]):
                feats = {c: torch.from_numpy(data[f"feat_{c}"][s, rows]) for c in model.columns}
                labels = torch.from_numpy(data["labels"][s, rows])
                res = step(feats, labels) if shards == "equal" else step(feats, labels, 1, idle=rank != 0)
                losses.append(float(res["loss"]))
            out[f"loss_{kind}_{shards}"] = np.asarray(losses)
    return out


def _adam_params(torch, port, group, spec, rank, world):
    """The parameters after three Adam (1e-3) steps on this rank's shards,
    with the DDP and with the explicit mean step, from the same weights."""
    data = np.load(spec["inputs"])
    shard = data["labels"].shape[1] // world
    rows = slice(rank * shard, (rank + 1) * shard)
    out = {}
    for kind in ("ddp", "mean"):
        model = port.dlrm_for_data_spec(**SMALL_DLRM, compute_dtype=torch.float32, device="cpu")
        model.load_state_dict(torch.load(spec["state"]))
        opt = port.make_optimizer(model, lr=1e-3)
        step = port.make_train_step(model, opt, group) if kind == "ddp" else port.make_psum_train_step(model, opt, group)
        for s in range(data["labels"].shape[0]):
            feats = {c: torch.from_numpy(data[f"feat_{c}"][s, rows]) for c in model.columns}
            step(feats, torch.from_numpy(data["labels"][s, rows]))
        for name, tensor in model.state_dict().items():
            out[f"adam_{kind}_param_{name}"] = tensor.numpy()
    return out


def grad_rank_main(spec_path, rank):
    import torch

    sys.path.insert(0, REPO)
    import ray_shuffling_data_loader_tpu_torch as port

    with open(spec_path) as f:
        spec = json.load(f)
    world = spec["world"]
    torch.set_num_threads(spec.get("threads", [1] * world)[rank])
    group = port.init_data_parallel(rank, world, "gloo", spec["init_method"])
    out = {}
    if "mean" in spec["cases"]:
        out["mean_losses"] = _mean_losses(torch, port, group, spec, rank, world)
    if "bf16" in spec["cases"]:
        out.update(_bf16_losses(torch, port, group, spec, rank, world))
    if "steps" in spec["cases"]:
        out.update(_sgd_steps(torch, port, group, spec, rank, world))
    if "idle" in spec["cases"]:
        out.update(_idle_steps(torch, port, group, spec, rank, world))
    if "adam" in spec["cases"]:
        out.update(_adam_params(torch, port, group, spec, rank, world))
    if "ddp_loss" in spec["cases"]:
        out.update(_ddp_losses(torch, port, group, spec, rank, world))
    if "adasum" in spec["cases"]:
        grads = np.load(spec["grads"])
        for case in ADASUM_CASES:
            leaves = [torch.from_numpy(grads[f"{case}_{i}"][rank]).reshape(-1) for i in range(spec["num_leaves"])]
            reduced = port.adasum_reduce(leaves, group)
            for i, g in enumerate(reduced):
                out[f"adasum_{case}_{i}"] = g.numpy()
    np.savez(os.path.join(spec["out_dir"], f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    return 0


# -- the trainer rank of the model-parallel tests -------------------------------

# The models of the model-parallel tests, each with the arguments of the
# port's constructor and its vocab-shard threshold: the small DLRM of
# tests/test_models_parallel.py and the TabTransformer of
# tests/test_transformer.py's sharded step, both in float32.
MP_MODELS = {
    "dlrm": (dict(SMALL_DLRM), 512),
    "transformer": (dict(embed_dim=16, num_layers=1, num_heads=2, vocab_cap=2048), 512),
}
MP_LR = 1e-3
FORBIDDEN_TOP_LEVELS = {"jax", "flax", "optax", "ray_shuffling_data_loader_tpu"}


def _mp_model(torch, port, kind, params, mesh=None):
    """The port's model ``kind`` with the JAX weights ``params``, sharded
    over ``mesh`` when given (its state converted as rank
    ``mesh.model_index``'s shard)."""
    kwargs, threshold = MP_MODELS[kind]
    build = port.dlrm_for_data_spec if kind == "dlrm" else port.transformer_for_data_spec
    convert = port.dlrm_state_dict_from_jax if kind == "dlrm" else port.transformer_state_dict_from_jax
    model = build(**kwargs, compute_dtype=torch.float32, device="cpu")
    if mesh is None:
        model.load_state_dict(convert(params))
        return model
    port.shard_model(model, mesh, threshold)
    model.load_state_dict(convert(params, mesh.model_index, mesh.model_size, threshold))
    return model


def mp_rank_main(spec, rank):
    """Rank ``rank`` of a ``(data, model)`` world: for each model kind, the
    sharded forward against the unsharded one (``forward``), the gathered
    initial state (``gather``), and three Adam steps from the JAX
    package's initial state on data index ``d``'s rows of each global
    batch (``train``)."""
    import pickle

    import torch

    sys.path.insert(0, REPO)
    import ray_shuffling_data_loader_tpu_torch as port
    from ray_shuffling_data_loader_tpu_torch.convert import adam_state_dict_from_jax, gather_state_dict
    from ray_shuffling_data_loader_tpu_torch.parallel.sharded_embedding import sharded_tables

    torch.set_num_threads(1)
    port.init_data_parallel(rank, spec["world"], "gloo", spec["init_method"])
    mesh = port.make_mesh(spec["model_parallelism"])
    out = {}
    for kind in MP_MODELS:
        with open(spec[f"{kind}_state"], "rb") as f:
            state = pickle.load(f)
        data = np.load(spec[f"{kind}_inputs"])
        columns = sorted(c[len("feat_"):] for c in data.files if c.startswith("feat_"))
        model = _mp_model(torch, port, kind, state["params"], mesh)
        out[f"{kind}_sharded"] = np.asarray(sorted(sharded_tables(model)))
        if "forward" in spec["cases"]:
            full = _mp_model(torch, port, kind, state["params"])
            feats = {c: torch.from_numpy(data[f"feat_{c}"][0]) for c in columns}
            with torch.no_grad():
                out[f"{kind}_forward_sharded"] = model(feats).numpy()
                out[f"{kind}_forward_full"] = full(feats).numpy()
        if "gather" in spec["cases"]:
            for name, tensor in gather_state_dict(model).items():
                out[f"{kind}_gathered_{name}"] = tensor.numpy()
        if "train" in spec["cases"]:
            opt = port.make_optimizer(model, lr=MP_LR)
            opt.load_state_dict(adam_state_dict_from_jax(state["opt_state"], model, lr=MP_LR))
            step = port.make_train_step(model, opt, mesh.data_group)
            shard = data["labels"].shape[1] // mesh.data_size
            rows = slice(mesh.data_index * shard, (mesh.data_index + 1) * shard)
            losses = []
            for s in range(data["labels"].shape[0]):
                feats = {c: torch.from_numpy(data[f"feat_{c}"][s, rows]) for c in columns}
                losses.append(float(step(feats, torch.from_numpy(data["labels"][s, rows]))["loss"]))
            out[f"{kind}_losses"] = np.asarray(losses)
            for name, tensor in gather_state_dict(model).items():
                out[f"{kind}_param_{name}"] = tensor.numpy()
            for name, p in model.named_parameters():
                out[f"{kind}_shard_{name}"] = p.detach().numpy()
                out[f"{kind}_exp_avg_{name}"] = opt.state[p]["exp_avg"].numpy()
                out[f"{kind}_exp_avg_sq_{name}"] = opt.state[p]["exp_avg_sq"].numpy()
    out["loaded_jax"] = np.asarray(sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN_TOP_LEVELS))
    np.savez(os.path.join(spec["out_dir"], f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    return 0


# -- the ranks of the sequence-parallel op tests ----------------------------------


def sp_rank_main(spec, rank):
    """Rank ``rank`` of a sequence-parallel group over the world: for each
    case ``(name, schedule, causal, use_flash)``, the output of this rank's
    sequence chunk of the global q, k, v and the chunk's gradients of
    ``sum(out ** 2)``; and whether Ulysses refuses heads that do not divide
    by the group."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    import ray_shuffling_data_loader_tpu_torch as port

    torch.set_num_threads(1)
    world = spec["world"]
    port.init_data_parallel(rank, world, "gloo", spec["init_method"])
    group = dist.group.WORLD
    data = np.load(spec["inputs"])
    tl = data["q"].shape[1] // world
    out = {}
    for name, schedule, causal, use_flash in spec["sp_cases"]:
        if schedule == "ring":
            fn = port.make_ring_attention(group, causal=causal, use_flash=use_flash)
        else:
            fn = port.make_ulysses_attention(group, causal=causal, kv_chunk=spec["kv_chunk"], use_flash=use_flash)
        q, k, v = (torch.from_numpy(data[x][:, rank * tl:(rank + 1) * tl]).requires_grad_(True) for x in "qkv")
        result = fn(q, k, v)
        (result ** 2).sum().backward()
        out[f"{name}_out"] = result.detach().numpy()
        for x, t in zip("qkv", (q, k, v)):
            out[f"{name}_d{x}"] = t.grad.numpy()
    if spec.get("ulysses_mismatch"):
        q = torch.from_numpy(data["q"][:, rank * tl:(rank + 1) * tl])
        try:
            port.make_ulysses_attention(group)(q, q, q)
            out["mismatch_error"] = np.asarray("")
        except ValueError as e:
            out["mismatch_error"] = np.asarray(str(e))
    out["loaded_jax"] = np.asarray(sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN_TOP_LEVELS))
    np.savez(os.path.join(spec["out_dir"], f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
    return 0


# -- both packages' audited sessions (the audit and replay tests) -------------------

AUDIT_KNOBS = ("RSDL_AUDIT", "RSDL_AUDIT_DIR", "RSDL_AUDIT_STRICT", "RSDL_AUDIT_KEY", "RSDL_AUDIT_SAMPLE",
               "RSDL_JOURNAL", "RSDL_RESUME", "RSDL_SHUFFLE_PLAN", "RSDL_INDEX_SHUFFLE", "RSDL_SELECTIVE_READS",
               "RSDL_DECODE_PUSHDOWN", "RSDL_DEVICE_DIRECT", "RSDL_PLAN", "RSDL_FAULTS")


class Drain:
    """A consumer that frees what it is given; ``pieces``: the most refs one
    reducer's delivery held (more than 1: a packed output)."""

    def __init__(self, rt):
        self.rt = rt
        self.pieces = 0

    def consume(self, rank, epoch, batches):
        self.pieces = max(self.pieces, len(batches))
        self.rt.get_context().store.free(batches)

    def producer_done(self, rank, epoch):
        pass

    def wait_until_ready(self, epoch):
        pass

    def wait_until_all_epochs_done(self):
        pass


class AuditedSessions:
    """Both packages' sessions, spawned with the audit on, each with a
    spool of its own, over one generated dataset."""

    def __init__(self, files, spools, shape):
        self.files, self.spools, self.shape = files, spools, shape

    def modules(self, pkg):
        """``(runtime, shuffle function, audit module)`` of ``pkg``."""
        import importlib

        root = "ray_shuffling_data_loader_tpu" if pkg == "jax" else "ray_shuffling_data_loader_tpu_torch"
        return tuple(importlib.import_module(f"{root}.{m}") for m in ("runtime", "shuffle", "telemetry.audit"))

    @contextlib.contextmanager
    def use(self, pkg):
        """Point the audit at ``pkg``'s spool for the block (the driver
        reads it at every flush; the workers took it at their spawn)."""
        os.environ["RSDL_AUDIT_DIR"] = self.spools[pkg]
        try:
            yield
        finally:
            os.environ["RSDL_AUDIT_DIR"] = self.spools["port"]

    def run(self, pkg, num_epochs=2, consumer=None, **kwargs):
        """One shuffle of the dataset (``shape``'s reducers, trainers and
        seed) into ``consumer`` (default: a :class:`Drain`); returns the
        verdicts and the consumer."""
        rt, shuffle, audit = self.modules(pkg)
        consumer = consumer if consumer is not None else Drain(rt)
        with self.use(pkg):
            shuffle.shuffle(self.files, consumer, num_epochs, self.shape["reducers"], self.shape["trainers"],
                            seed=self.shape["seed"], **kwargs)
        return audit.verdicts(), consumer


def audited_sessions(tmp_path_factory, rows, files, row_groups, reducers, trainers, seed):
    """The body of a module fixture: :class:`AuditedSessions`, torn down
    with the environment and both audit modules put back."""
    from ray_shuffling_data_loader_tpu_torch.data_generation import generate_data

    saved = {k: os.environ.pop(k, None) for k in AUDIT_KNOBS}
    spools = {pkg: str(tmp_path_factory.mktemp(f"spool-{pkg}")) for pkg in ("jax", "port")}
    shape = dict(reducers=reducers, trainers=trainers, seed=seed)
    sessions = AuditedSessions(None, spools, shape)
    os.environ["RSDL_AUDIT"] = "1"
    for pkg in ("jax", "port"):
        rt, _, audit = sessions.modules(pkg)
        audit.refresh_from_env()
        audit.clear_faults()
        os.environ["RSDL_AUDIT_DIR"] = spools[pkg]
        rt.init(num_workers=2)
        rt.get_context().pool  # the workers spawn here, audited, with the package's spool
    sessions.files, _ = generate_data(rows, files, row_groups, 0.0, str(tmp_path_factory.mktemp("data")), seed=seed)
    try:
        yield sessions
    finally:
        for pkg in ("port", "jax"):
            sessions.modules(pkg)[0].shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for pkg in ("jax", "port"):
            audit = sessions.modules(pkg)[2]
            audit.reset()
            audit.clear_faults()
            audit.refresh_from_env()


# -- the two-host run of the cluster tests ----------------------------------------------


def _rank_keys(ds, num_epochs):
    """Every epoch's ``key`` column as this rank iterated it, joined."""
    out = {}
    for epoch in range(num_epochs):
        ds.set_epoch(epoch)
        out[f"epoch{epoch}"] = np.concatenate([np.asarray(b["key"]) for b in ds])
    return out


def cluster_rank_main(spec):
    """Rank 1 of the cluster tests' dataset, in a process of its own that
    joins its host's session by directory (``RSDL_RUNTIME_DIR``): it finds
    rank 0's queue through the registry and pulls the reducer outputs of
    the other host; writes its keys to ``spec["rank1_out"]``."""
    from ray_shuffling_data_loader_tpu_torch import runtime
    from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset

    runtime.init()
    ds = ShufflingDataset(spec["files"], spec["epochs"], 2, spec["batch_size"], 1, num_reducers=spec["reducers"],
                          seed=spec["seed"], queue_name=spec["queue"])
    np.savez(spec["rank1_out"], **_rank_keys(ds, spec["epochs"]))
    runtime.shutdown()
    return 0


def cluster_head_main(spec):
    """Rank 0 and the shuffle's driver of the cluster tests: a cluster's
    head (``spec["mode"] == "cluster"``: waits for the joined host, whose
    session runs rank 1) or one host alone (``"single"``: rank 1 joins this
    session). Writes rank 0's keys, the audit's verdicts, each agent's
    tasks, each store server's bytes served and the shuffle's host-kernel
    calls."""
    import subprocess
    import tempfile
    import time

    from ray_shuffling_data_loader_tpu_torch import runtime
    from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset
    from ray_shuffling_data_loader_tpu_torch.runtime.actor import ActorHandle
    from ray_shuffling_data_loader_tpu_torch.telemetry import audit

    cluster = spec["mode"] == "cluster"
    if cluster:
        ctx = runtime.init_cluster(advertise_host="127.0.0.1", num_workers=2)
        with open(spec["addr_file"] + ".tmp", "w") as f:
            f.write(ctx.cluster.address)
        os.rename(spec["addr_file"] + ".tmp", spec["addr_file"])
        deadline = time.time() + 60
        while len(runtime.cluster_hosts()) < 2:
            if time.time() > deadline:
                raise RuntimeError("the second host never joined")
            time.sleep(0.1)
        other = runtime.cluster_hosts()[1]
        rank1_env = {"RSDL_RUNTIME_DIR": os.path.join(tempfile.gettempdir(), other.split(":", 1)[1]),
                     "RSDL_SHM_DIR": spec["rank1_shm"], "RSDL_SPILL_DIR": spec["rank1_spill"]}
    else:
        ctx = runtime.init(num_workers=2)
        rank1_env = {"RSDL_RUNTIME_DIR": ctx.runtime_dir}
    ds = ShufflingDataset(spec["files"], spec["epochs"], 2, spec["batch_size"], 0, num_reducers=spec["reducers"],
                          seed=spec["seed"], queue_name=spec["queue"])
    rank1 = subprocess.Popen([sys.executable, os.path.abspath(__file__), spec["spec_path"], "rank1"],
                             env={**os.environ, **rank1_env})
    keys = _rank_keys(ds, spec["epochs"])
    ds.join()
    if rank1.wait(timeout=120) != 0:
        raise RuntimeError(f"rank 1 exited {rank1.returncode}")
    out = {"verdicts": audit.verdicts(), "native_calls": ds.shuffle_stats.get("native_calls"), "agents": {},
           "served": {}}
    if cluster:
        for host, info in ctx.cluster.registry.call("hosts").items():
            out["agents"][host] = ActorHandle(tuple(info["agent"])).call("agent_stats")["completed"]
            out["served"][host] = ActorHandle(tuple(info["store"])).call("fetch_stats")["bytes"]
        out["queue_in_registry"] = ctx.cluster.lookup_named_actor(spec["queue"]) is not None
        # Placement: an actor spawned on the joined host runs in its session.
        from ray_shuffling_data_loader_tpu_torch.runtime.cluster import PlacementProbe

        probe = runtime.spawn_actor(PlacementProbe, host_id=other, name="placement-probe")
        out["probe"] = {"runtime_dir": probe.call("info")["runtime_dir"], "want": rank1_env["RSDL_RUNTIME_DIR"],
                        "named": runtime.resolve_actor("placement-probe").address == probe.address}
    np.savez(spec["rank0_out"], **keys)
    with open(spec["result"], "w") as f:
        json.dump(out, f)
    runtime.shutdown()
    return 0


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    if spec.get("cluster_test"):
        sys.exit(cluster_rank_main(spec) if sys.argv[2] == "rank1" else cluster_head_main(spec))
    if "sp_cases" in spec:
        sys.exit(sp_rank_main(spec, int(sys.argv[2])))
    if "model_parallelism" in spec:
        sys.exit(mp_rank_main(spec, int(sys.argv[2])))
    sys.exit(grad_rank_main(sys.argv[1], int(sys.argv[2])))
