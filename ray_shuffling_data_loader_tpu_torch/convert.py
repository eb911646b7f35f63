"""Load DLRM weights from a flax parameter tree into the port's module.

The tree holds ``embed_<col>`` tables ``[vocab, D]`` and ``Dense_<i>``
layers with ``kernel`` ``[in, out]`` and ``bias`` ``[out]``, the last
layer being ``Dense_<len(top_mlp)>``. Torch's ``nn.Linear`` keeps its
weight as ``[out, in]``, so kernels are transposed. Leaves arrive as numpy
arrays (or anything ``np.asarray`` takes); the tree may be wrapped in
``{"params": ...}``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_EMBED_PREFIX = "embed_"
_DENSE_PREFIX = "Dense_"


def dlrm_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for :class:`~.models.dlrm.TabularDLRM`."""
    if "params" in params:
        params = params["params"]
    state: Dict[str, torch.Tensor] = {}
    for name, leaf in params.items():
        if name.startswith(_EMBED_PREFIX):
            col = name[len(_EMBED_PREFIX):]
            state[f"embeddings.{col}.weight"] = torch.from_numpy(
                np.array(leaf, dtype=np.float32)
            )
        elif name.startswith(_DENSE_PREFIX):
            i = int(name[len(_DENSE_PREFIX):])
            state[f"mlp.{i}.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.array(leaf["kernel"], dtype=np.float32).T)
            )
            state[f"mlp.{i}.bias"] = torch.from_numpy(np.array(leaf["bias"], dtype=np.float32))
        else:
            raise KeyError(f"unexpected DLRM parameter {name!r}")
    return state
