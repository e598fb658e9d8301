"""PyTorch port, one synced step of the slab-sharded step in pallas mode
against the JAX package's at D = 2 (test_torch_shard_slab.py's case and
bounds). The JAX step runs its two Pallas kernels in interpret mode on
slab-local grids (a slab's 40 columns and two halo columns each side:
44 wide, padded to 128), about 20 s; the port's runs their plain
versions on the CPU.

The JAX package's slab step builds its ``shard_map`` with ``check_vma``
on, which this JAX refuses around a ``pallas_call`` (its out shapes carry
no vma); its row-band step turns the check off for that reason. The test
builds the JAX slab step the same way, by wrapping ``jax.shard_map`` for
the call, and changes nothing else of the JAX step.
"""

import functools

import jax
import pytest
import torch

from test_torch_shard_slab import check_synced, synced_case


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test lane runs several workers on
    the same cores, where torch's OpenMP pools oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_synced_pallas_step_matches_jax(monkeypatch):
    monkeypatch.setattr(jax, "shard_map",
                        functools.partial(jax.shard_map, check_vma=False))
    case = synced_case(2, "pallas")
    check_synced(case)
    assert int(case["tstats"]["n_valid"].sum()) == 512
    assert case["crossing"] > 0
