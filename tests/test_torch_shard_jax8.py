"""PyTorch port, one synced step of the row-band sharded resident step
against the JAX package's on D = 8 shards (the JAX step on all eight
virtual CPU devices of conftest.py), without and with a force field; the
check and its bounds are test_torch_shard_jax.py's, which runs D = 2."""

import pytest
import torch

from test_torch_shard_jax import check_synced_step


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test lane runs several workers on
    the same cores, where torch's OpenMP pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("has_ff", [False, True])
def test_synced_step_matches_jax_on_8(has_ff):
    check_synced_step(8, has_ff)
