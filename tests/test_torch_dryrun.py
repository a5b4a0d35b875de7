"""The port's entry points (``rustyhgi_tpu_torch.dryrun``) against
``__graft_entry__.py`` on the CPU."""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from rustyhgi_tpu_torch import dryrun


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu_places(n):
    dryrun.dryrun_multichip(n, [torch.device("cpu")] * n)


def test_dryrun_odd_place_count_runs_one_mesh():
    dryrun.dryrun_multichip(3, [torch.device("cpu")] * 3)


def test_dryrun_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(ValueError, match="need 4 devices"):
        dryrun.dryrun_multichip(4, [torch.device("cpu")] * 2)


def test_entry_forward_matches_jax():
    forward, (example,) = dryrun.entry(device="cpu")
    jforward, (jexample,) = graft.entry()
    assert np.array_equal(example.numpy(), np.asarray(jexample))
    grid, recon = forward(example)
    jgrid, jrecon = jforward(jexample)
    assert np.array_equal(grid.numpy(), np.asarray(jgrid))
    assert np.array_equal(recon.numpy(), np.asarray(jrecon))


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.entry()
