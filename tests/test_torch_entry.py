"""The port's entry points (bayesian_optimization_tpu_torch/entry.py)
against the JAX repository's __graft_entry__.py on the CPU: the batched
likelihood and its gradient on the same problem, and the mesh dry run on
8 CPU entries."""
import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from bayesian_optimization_tpu_torch import entry as te

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def test_entry_matches_graft_entry():
    """Values and gradients over the 8 theta vectors, float32 in both,
    within 1e-4 relative (the gradient relative to its largest entry)."""
    fn_j, args_j = ge.entry()
    vals_j, grads_j = (np.asarray(a, np.float64) for a in jax.jit(fn_j)(*args_j))
    fn_t, args_t = te.entry(device="cpu")
    assert all(a.dtype == torch.float32 for a in args_t)
    for a_t, a_j in zip(args_t, args_j):  # the same numpy draws
        assert np.array_equal(a_t.numpy(), np.asarray(a_j))
    vals_t, grads_t = (a.double().numpy() for a in fn_t(*args_t))
    assert vals_t.shape == (8,) and grads_t.shape == (8, 4)
    assert np.max(np.abs(vals_t - vals_j) / np.abs(vals_j)) < 1e-4
    assert np.max(np.abs(grads_t - grads_j)) < 1e-4 * np.max(np.abs(grads_j))


def test_entry_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError):
        te.entry()


def test_dryrun_multidevice_on_8_cpu_entries(capsys):
    te.dryrun_multidevice(8, devices=["cpu"] * 8)
    out = capsys.readouterr().out
    assert "dryrun_multidevice(8): OK" in out and "16 MLE restarts + 32 CMA chains" in out
