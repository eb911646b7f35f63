"""The resident loader's epoch permutation against
``jax.random.permutation(fold_in(key(seed), epoch), n)``, bit for bit."""

import jax
import numpy as np
import pytest
import torch

from ray_shuffling_data_loader_tpu_torch.utils.prng import epoch_permutation

# (seed, epoch, n): 0, 1, 2 and 3 rounds of sorting; negative and largest
# int32 seeds; odd and tiny lengths.
CASES = [
    (0, 0, 10),
    (29, 1, 1024),
    (7, 3, 100_000),
    (0, 1, 10**6),
    (123, 0, 3 * 10**6),
    (-1, 0, 1000),
    (2**31 - 1, 5, 4097),
    (3, 0, 1),
    (3, 0, 2),
    (3, 9, 65_537),
]


@pytest.mark.parametrize("seed,epoch,n", CASES)
def test_epoch_permutation_is_jax_permutation(seed, epoch, n):
    # The port follows the partitionable threefry, JAX's default since 0.5.
    assert jax.config.jax_threefry_partitionable
    want = np.asarray(jax.random.permutation(jax.random.fold_in(jax.random.key(seed), epoch), n))
    got = epoch_permutation(seed, epoch, n, device="cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_stable_sort_keeps_the_order_of_ties():
    # The rounds sort by 32-bit words; at n in the millions words collide,
    # and JAX's sort keeps tied elements in order. Forced ties here.
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 32, 64, dtype=np.int64)[rng.integers(0, 64, 200_000)]
    got = torch.sort(torch.from_numpy(keys), stable=True).indices.numpy()
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))


def test_epoch_permutation_rejects_a_negative_length():
    with pytest.raises(ValueError, match="n must be"):
        epoch_permutation(0, 0, -1, device="cpu")
