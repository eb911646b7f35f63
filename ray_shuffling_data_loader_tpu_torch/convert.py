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
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

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


def dlrm_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for :class:`~.models.dlrm.TabularDLRM`."""
    state: Dict[str, torch.Tensor] = {}
    for name, leaf in _unwrap(params).items():
        if name.startswith(_EMBED_PREFIX):
            state[f"embeddings.{name[len(_EMBED_PREFIX):]}.weight"] = _tensor(leaf)
        elif name.startswith(_DENSE_PREFIX):
            _dense(state, f"mlp.{int(name[len(_DENSE_PREFIX):])}", leaf)
        else:
            raise KeyError(f"unexpected DLRM parameter {name!r}")
    return state


def transformer_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for :class:`~.models.transformer.TabTransformer`."""
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
    return state


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
    ``step``. The parameter groups are those of
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
    names = [name for name, _ in model.named_parameters()]
    if set(names) != set(mu_t):
        raise KeyError(f"Adam moments do not match the model's parameters: {sorted(set(names) ^ set(mu_t))}")
    step = float(np.asarray(count))
    state = {
        i: {"step": torch.tensor(step, dtype=torch.float32), "exp_avg": mu_t[name], "exp_avg_sq": nu_t[name]}
        for i, name in enumerate(names)
    }
    return {"state": state, "param_groups": make_optimizer(model, lr=lr).state_dict()["param_groups"]}
