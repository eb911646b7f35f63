"""Load weights from a flax parameter tree into the port's modules.

Leaves arrive as numpy arrays (or anything ``np.asarray`` takes); a tree
may be wrapped in ``{"params": ...}``. Flax's ``Dense`` keeps its kernel as
``[in, out]`` and torch's ``nn.Linear`` its weight as ``[out, in]``, so
kernels are transposed; a LayerNorm's ``scale`` becomes ``weight``. A name
the module does not have raises.

* DLRM: ``embed_<col>`` tables ``[vocab, D]`` and ``Dense_<i>`` layers, the
  last being ``Dense_<len(top_mlp)>``.
* TabTransformer: ``embed_<col>``, ``col_embed``, ``block_<i>`` with
  ``ln_attn``, ``ln_mlp`` and the dense layers ``qkv``, ``proj``,
  ``mlp_up``, ``mlp_down``; then ``ln_out`` and ``head``.
* CausalLM: ``token_embed``, ``pos_embed``, ``block_<i>`` as above, and
  ``ln_out``.

:func:`adam_state_dict_from_jax` turns optax Adam's state (``count``,
``mu``, ``nu``, trees like the parameters) into ``torch.optim.Adam``'s
``state_dict`` for the same model, through the same name mapping.

**Vocab sharding.** The DLRM's and TabTransformer's converters take a
rank's place on the model axis (``model_index`` of ``model_size``) and
return its shard: each table that the JAX package's rule
(:func:`~.parallel.mesh.param_spec`, applied to the JAX name and shape
that :func:`jax_name_and_shape` gives) selects is cut to that rank's
rows. :func:`adam_state_dict_from_jax` cuts the moments as the model's
tables are cut, and :func:`gather_state_dict` puts the full state back
together on every rank.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ray_shuffling_data_loader_tpu_torch.parallel.mesh import DEFAULT_VOCAB_SHARD_THRESHOLD, param_spec
from ray_shuffling_data_loader_tpu_torch.parallel.sharded_embedding import shard_rows, sharded_tables

_EMBED_PREFIX = "embed_"
_DENSE_PREFIX = "Dense_"
_BLOCK_PREFIX = "block_"
_BLOCK_NORMS = ("ln_attn", "ln_mlp")
_BLOCK_DENSES = ("qkv", "proj", "mlp_up", "mlp_down")


def _unwrap(params: Mapping[str, Any]) -> Mapping[str, Any]:
    return params["params"] if "params" in params else params


def _tensor(leaf) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, dtype=np.float32))


def _dense(state: Dict[str, torch.Tensor], prefix: str, leaf: Mapping[str, Any]) -> None:
    if set(leaf) != {"kernel", "bias"}:
        raise KeyError(f"unexpected dense parameters {sorted(leaf)} under {prefix!r}")
    state[f"{prefix}.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.array(leaf["kernel"], dtype=np.float32).T)
    )
    state[f"{prefix}.bias"] = _tensor(leaf["bias"])


def _norm(state: Dict[str, torch.Tensor], prefix: str, leaf: Mapping[str, Any]) -> None:
    if set(leaf) != {"scale", "bias"}:
        raise KeyError(f"unexpected LayerNorm parameters {sorted(leaf)} under {prefix!r}")
    state[f"{prefix}.weight"] = _tensor(leaf["scale"])
    state[f"{prefix}.bias"] = _tensor(leaf["bias"])


def _block(state: Dict[str, torch.Tensor], name: str, leaf: Mapping[str, Any]) -> None:
    prefix = f"blocks.{int(name[len(_BLOCK_PREFIX):])}"
    for sub, sub_leaf in leaf.items():
        if sub in _BLOCK_NORMS:
            _norm(state, f"{prefix}.{sub}", sub_leaf)
        elif sub in _BLOCK_DENSES:
            _dense(state, f"{prefix}.{sub}", sub_leaf)
        else:
            raise KeyError(f"unexpected encoder block parameter {name}/{sub}")


def jax_name_and_shape(name: str, shape) -> Tuple[str, Tuple[int, ...]]:
    """The JAX package's name (its path under ``params``, joined by ``/``)
    and shape of the port's parameter ``name`` of ``shape``: a dense
    kernel is the transpose of an ``nn.Linear`` weight."""
    parts = name.split(".")
    shape = tuple(shape)
    if parts[0] == "embeddings" and len(parts) == 3:
        return f"{_EMBED_PREFIX}{parts[1]}", shape
    if parts[0] in ("col_embed", "token_embed", "pos_embed") and len(parts) == 1:
        return parts[0], shape
    if parts[0] == "mlp" and len(parts) == 3:
        prefix, dense, leaf = f"{_DENSE_PREFIX}{parts[1]}", True, parts[2]
    elif parts[0] == "blocks" and len(parts) == 4:
        prefix, dense, leaf = f"{_BLOCK_PREFIX}{parts[1]}/{parts[2]}", parts[2] in _BLOCK_DENSES, parts[3]
    elif parts[0] in ("ln_out", "head") and len(parts) == 2:
        prefix, dense, leaf = parts[0], parts[0] == "head", parts[1]
    else:
        raise KeyError(f"no JAX name for parameter {name!r}")
    if leaf == "bias":
        return f"{prefix}/bias", shape
    return (f"{prefix}/kernel", shape[::-1]) if dense else (f"{prefix}/scale", shape)


def sharded_names(named_shapes, model_size: int, vocab_shard_threshold: int = DEFAULT_VOCAB_SHARD_THRESHOLD):
    """The names among ``(name, shape)`` pairs of the port's parameters
    that the JAX package's rule shards over ``model_size`` ranks. Only
    embedding tables can be sharded here: any other selected parameter
    raises ``NotImplementedError``."""
    names = []
    for name, shape in named_shapes:
        if param_spec(jax_name_and_shape(name, shape)[1], model_size, vocab_shard_threshold):
            if not (name.startswith("embeddings.") and name.endswith(".weight")):
                raise NotImplementedError(f"the vocab-sharding rule selects {name!r}, which is not an embedding "
                                          "table; only tables can be sharded")
            names.append(name)
    return names


def _shard(state: Dict[str, torch.Tensor], model_index: int, model_size: int, threshold: int):
    """``state`` with each table the rule selects cut to rank
    ``model_index``'s rows."""
    for name in sharded_names(((k, v.shape) for k, v in state.items()), model_size, threshold):
        state[name] = shard_rows(state[name], model_index, model_size)
    return state


def dlrm_state_dict_from_jax(
    params: Mapping[str, Any],
    model_index: int = 0,
    model_size: int = 1,
    vocab_shard_threshold: int = DEFAULT_VOCAB_SHARD_THRESHOLD,
) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for :class:`~.models.dlrm.TabularDLRM`; with
    ``model_size`` > 1, rank ``model_index``'s shard of it."""
    state: Dict[str, torch.Tensor] = {}
    for name, leaf in _unwrap(params).items():
        if name.startswith(_EMBED_PREFIX):
            state[f"embeddings.{name[len(_EMBED_PREFIX):]}.weight"] = _tensor(leaf)
        elif name.startswith(_DENSE_PREFIX):
            _dense(state, f"mlp.{int(name[len(_DENSE_PREFIX):])}", leaf)
        else:
            raise KeyError(f"unexpected DLRM parameter {name!r}")
    return _shard(state, model_index, model_size, vocab_shard_threshold)


def transformer_state_dict_from_jax(
    params: Mapping[str, Any],
    model_index: int = 0,
    model_size: int = 1,
    vocab_shard_threshold: int = DEFAULT_VOCAB_SHARD_THRESHOLD,
) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for :class:`~.models.transformer.TabTransformer`;
    with ``model_size`` > 1, rank ``model_index``'s shard of it."""
    state: Dict[str, torch.Tensor] = {}
    for name, leaf in _unwrap(params).items():
        if name.startswith(_EMBED_PREFIX):
            state[f"embeddings.{name[len(_EMBED_PREFIX):]}.weight"] = _tensor(leaf)
        elif name == "col_embed":
            state["col_embed"] = _tensor(leaf)
        elif name.startswith(_BLOCK_PREFIX):
            _block(state, name, leaf)
        elif name == "ln_out":
            _norm(state, "ln_out", leaf)
        elif name == "head":
            _dense(state, "head", leaf)
        else:
            raise KeyError(f"unexpected TabTransformer parameter {name!r}")
    return _shard(state, model_index, model_size, vocab_shard_threshold)


def lm_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for :class:`~.models.lm.CausalLM`."""
    state: Dict[str, torch.Tensor] = {}
    for name, leaf in _unwrap(params).items():
        if name in ("token_embed", "pos_embed"):
            state[name] = _tensor(leaf)
        elif name.startswith(_BLOCK_PREFIX):
            _block(state, name, leaf)
        elif name == "ln_out":
            _norm(state, "ln_out", leaf)
        else:
            raise KeyError(f"unexpected CausalLM parameter {name!r}")
    return state


def _adam_moments(opt_state) -> Tuple[Any, Any, Any]:
    """``(count, mu, nu)`` of optax Adam's ``ScaleByAdamState``, found in
    the state of ``optax.adam`` (a chain: a tuple, or after a msgpack
    restore without a target a dict ``{"0": ..., "1": ...}``)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.count, opt_state.mu, opt_state.nu
    if isinstance(opt_state, Mapping):
        if {"count", "mu", "nu"} <= set(opt_state):
            return opt_state["count"], opt_state["mu"], opt_state["nu"]
        parts = list(opt_state.values())
    elif isinstance(opt_state, (tuple, list)):
        parts = list(opt_state)
    else:
        parts = []
    for part in parts:
        try:
            return _adam_moments(part)
        except KeyError:
            continue
    raise KeyError("no Adam state (count, mu, nu) in this optimizer state")


def adam_state_dict_from_jax(opt_state, model: torch.nn.Module, lr: float = 1e-3) -> Dict[str, Any]:
    """``torch.optim.Adam``'s ``state_dict`` for ``model`` (a DLRM,
    TabTransformer or CausalLM of the port) from optax ``adam``'s state:
    the moments go through the parameter mapping of the matching
    ``*_state_dict_from_jax``, ``count`` becomes every parameter's
    ``step``. The moments of a sharded table are cut to the model's rows
    of it. The parameter groups are those of
    :func:`~.parallel.train.make_optimizer` with ``lr`` (optax's state
    does not hold the learning rate)."""
    from ray_shuffling_data_loader_tpu_torch.models import CausalLM, TabTransformer
    from ray_shuffling_data_loader_tpu_torch.parallel.train import make_optimizer

    count, mu, nu = _adam_moments(opt_state)
    convert = (
        transformer_state_dict_from_jax if isinstance(model, TabTransformer)
        else lm_state_dict_from_jax if isinstance(model, CausalLM)
        else dlrm_state_dict_from_jax
    )
    mu_t, nu_t = convert(mu), convert(nu)
    for prefix, table in sharded_tables(model).items():
        for moments in (mu_t, nu_t):
            name = f"{prefix}.weight"
            moments[name] = shard_rows(moments[name], table.mesh.model_index, table.mesh.model_size)
    names = [name for name, _ in model.named_parameters()]
    if set(names) != set(mu_t):
        raise KeyError(f"Adam moments do not match the model's parameters: {sorted(set(names) ^ set(mu_t))}")
    step = float(np.asarray(count))
    state = {
        i: {"step": torch.tensor(step, dtype=torch.float32), "exp_avg": mu_t[name], "exp_avg_sq": nu_t[name]}
        for i, name in enumerate(names)
    }
    return {"state": state, "param_groups": make_optimizer(model, lr=lr).state_dict()["param_groups"]}


def gather_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's full ``state_dict``, on every rank: each sharded table's
    shards all-gathered over its model group (a collective: every rank of
    the mesh calls it), the rest as the rank holds it."""
    state = dict(model.state_dict())
    for prefix, table in sharded_tables(model).items():
        shard = table.weight.detach()
        parts = [torch.empty_like(shard) for _ in range(table.mesh.model_size)]
        dist.all_gather(parts, shard, group=table.mesh.model_group)
        state[f"{prefix}.weight"] = torch.cat(parts)
    return state
