"""The port's bandwidth anchors (multigrid_feanet_torch/ops/membench.py,
kernels B1 and B2's plain versions) against the JAX pallas_membench kernels
in interpret mode, on the CPU: copy (x + 1) and triad (a + 0.5 b) are exact
in float32 arithmetic (0.5 b is exact), so they agree bitwise.
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.ops import pallas_membench as jmb

from multigrid_feanet_torch.ops import membench as mb


def _fields(seed, count, shape=(64, 128)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(count)]


def test_copy_matches_pallas_bitwise():
    (x,) = _fields(0, 1)
    want = np.asarray(jmb._run_copy(jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)), R=32,
                                    interpret=True))
    np.testing.assert_array_equal(mb.copy_plain(torch.from_numpy(x)).numpy(), want)


def test_triad_matches_pallas_bitwise():
    a, b = _fields(1, 2)
    want = np.asarray(jmb._run_triad(jnp.asarray(a), jnp.asarray(b), jnp.zeros_like(jnp.asarray(a)),
                                     R=32, interpret=True))
    out = torch.empty(a.shape)
    got = mb.triad_plain(torch.from_numpy(a), torch.from_numpy(b), out=out)
    assert got is out
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn", [mb.copy_gbps, mb.triad_gbps], ids=["copy", "triad"])
def test_rates_on_the_cpu(fn):
    """On the CPU the rate comes from the host clock around the plain
    versions: a finite positive number."""
    rate = fn(64, 64, reps=10, device="cpu")
    assert math.isfinite(rate) and rate > 0


def test_wrappers_refuse_cpu_tensors(monkeypatch):
    """The kernel wrappers refuse CPU tensors before any build or launch;
    the rates default to CUDA and raise without it."""
    x = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        mb.copy_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        mb.triad_cuda(x, x)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mb.copy_gbps(8, 8)
    assert [k.name for k in mb.KERNELS.values()] == ["B1_copy", "B2_triad"]
