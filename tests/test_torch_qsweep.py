"""The port's Q-stream sweep (multigrid_feanet_torch/ops/qsweep.py, kernel
F1's plain version) against the JAX pallas_qsweep kernel in interpret mode,
on the CPU.

Inputs are made with numpy from a seed and handed to both sides; the JAX
buffers use PallasLevel's layout (rows=32, as tests/test_pallas_sweep.py
does) and are unpadded for comparison.  Tolerance: 1e-6 relative to
max(1, max|ref|): the two order the apply's sums differently.  The Q-stream
sweep and the port's A1 sweep in plain form share their arithmetic, so they
agree bitwise (bf16 holds the pair (1, 20) exactly).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core import geometry
from multigrid_feanet_tpu.ops import pallas_qsweep as jqs
from multigrid_feanet_tpu.ops.pallas_sweep import PallasLevel

from multigrid_feanet_torch.ops import qsweep as qs
from multigrid_feanet_torch.ops import sweep as sw
from multigrid_feanet_torch.ops.sweep import SweepLevel

N = 64
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((N + 1, N + 1)).astype(np.float32)
    f = rng.standard_normal((N + 1, N + 1)).astype(np.float32)
    return geometry.circle_phase(2.0, N), u, f


@pytest.mark.parametrize("dt", list(DTYPES))
def test_qsweep_matches_pallas(dt):
    phase, u, f = _inputs()
    jl = PallasLevel(N, stride=1, phase=phase, coefficients=(1.0, 20.0), rows=32,
                     interpret=True, dform=False)
    jdt, tdt = DTYPES[dt]
    want = np.asarray(jl.unpad(jqs.qsweep(jl, jl.pad(jnp.asarray(u)), jl.pad(jnp.asarray(f)),
                                         jqs.make_q_pad(jl, phase, (1.0, 20.0), dtype=jdt))))
    q = qs.make_q(phase, (1.0, 20.0), dtype=tdt, device="cpu")
    got = qs.qsweep(SweepLevel(N, phase=phase, dform=False, device="cpu"), torch.from_numpy(u),
                    torch.from_numpy(f), q).numpy()
    assert np.max(np.abs(got - want)) <= 1e-6 * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_qsweep_equals_a1_plain_sweep(dt):
    phase, u, f = _inputs(1)
    tu, tf, ph = torch.from_numpy(u), torch.from_numpy(f), torch.from_numpy(phase)
    want, _ = sw.sweep_plain(tu, tf, ph, a0=1.0, da=19.0, omega=2.0 / 3.0, dform=False)
    q = qs.make_q(phase, dtype=DTYPES[dt][1], device="cpu")
    out = torch.empty_like(tu)
    got = qs.qsweep_plain(tu, tf, q, omega=2.0 / 3.0, out=out)
    assert got is out
    assert torch.equal(got, want)


def test_make_q_and_wrapper_checks(monkeypatch):
    """make_q gives a0 + (a1 - a0) phase in the asked type; the F1 wrapper
    refuses CPU tensors, and other types of Q, before any build or launch;
    make_q defaults to CUDA."""
    phase, u, f = _inputs()
    q = qs.make_q(phase, (2.0, 5.0), dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(q.numpy(), np.where(phase == 1, 5.0, 2.0).astype(np.float32))
    assert qs.make_q(phase, device="cpu").dtype == torch.bfloat16
    tu, tf = torch.from_numpy(u), torch.from_numpy(f)
    with pytest.raises(ValueError, match="CUDA"):
        qs.qsweep_cuda(tu, tf, q, omega=2 / 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        qs.make_q(phase)
