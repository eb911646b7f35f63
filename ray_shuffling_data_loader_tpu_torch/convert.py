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
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

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
