"""The epoch permutation of the device-resident loader, bit for bit the
JAX package's.

The JAX package draws each epoch's order as
``jax.random.permutation(jax.random.fold_in(jax.random.key(seed), epoch),
n)``. This module recomputes that draw with plain tensor operations: the
threefry2x32 hash, the key derivation of ``key``, ``fold_in`` and
``split``, the 32 random bits per element, and the rounds of stable sorts
that ``jax._src.random._shuffle`` runs.

Every 32-bit word lives in an int64 tensor masked to its low 32 bits, so
no operation depends on unsigned integer support.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ray_shuffling_data_loader_tpu_torch.utils.device import DeviceLike, resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# jax._src.random._shuffle: rounds = ceil(3 ln n / ln(2^32 - 1)).
_SHUFFLE_EXPONENT = 3
_UINT32_MAX = float(_MASK)

Key = Tuple[int, int]


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def _threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 of the counter words ``(x0, x1)`` under ``key``: 20
    rounds in five groups of four, a key injection after each group."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _hash_words(key: Key, hi: int, lo: int) -> Key:
    """threefry2x32 of one counter pair, as two Python ints."""
    y0, y1 = _threefry2x32(key, torch.tensor([hi], dtype=torch.int64), torch.tensor([lo], dtype=torch.int64))
    return int(y0), int(y1)


def _split(key: Key) -> Tuple[Key, Key]:
    """``jax.random.split(key)`` under the partitionable threefry: the
    hashes of the counters 0 and 1; row 0 is the new key, row 1 the
    subkey."""
    return _hash_words(key, 0, 0), _hash_words(key, 0, 1)


def epoch_permutation(seed: int, epoch: int, n: int, device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.permutation(jax.random.fold_in(jax.random.key(seed),
    epoch), n)`` as an int64 tensor on ``device`` (default ``cuda``).

    It follows the partitionable threefry (``jax_threefry_partitionable``,
    JAX's default since 0.5): ``key(seed) = (0, seed mod 2^32)``,
    ``fold_in(k, e)`` hashes the counter ``(0, e)``, ``split`` hashes the
    counters 0 and 1, and the random bits of element ``i`` are the XOR of
    the two words of the hash of counter ``i``. Each of the
    ``ceil(3 ln n / ln(2^32 - 1))`` rounds splits the key and sorts the
    order so far by fresh bits, stably. Under the older, non-partitionable
    threefry JAX draws other bits, and the orders differ."""
    dev = resolve_device(device)
    if n < 0:
        raise ValueError(f"epoch_permutation: n must be >= 0, got {n}")
    key = _hash_words((0, int(seed) & _MASK), 0, int(epoch) & _MASK)
    order = torch.arange(n, dtype=torch.int64, device=dev)
    rounds = math.ceil(_SHUFFLE_EXPONENT * math.log(max(1, n)) / math.log(_UINT32_MAX))
    if rounds == 0:
        return order
    counters = torch.arange(n, dtype=torch.int64, device=dev)
    zeros = torch.zeros_like(counters)
    for _ in range(rounds):
        key, subkey = _split(key)
        b0, b1 = _threefry2x32(subkey, zeros, counters)
        sort_keys = b0 ^ b1
        perm = torch.sort(sort_keys, stable=True).indices
        order = order[perm]
    return order
