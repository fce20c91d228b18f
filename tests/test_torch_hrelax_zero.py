"""The port's zero-guess H-MG legs E4 and E5 (multigrid_feanet_torch/ops/
hrelax.py: zhswrr, zphrelax) against the JAX pallas_hrelax kernels in
interpret mode, on the CPU, at the cases and tolerance of
tests/test_torch_hrelax.py (kept in a file of their own so that the two
halves of the interpret-mode matrix run on separate test workers).
"""

import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.ops import pallas_hrelax as phx

from multigrid_feanet_torch.ops import hrelax as hx

from test_torch_hrelax import CASES, R, TOL, _few_threads, _levels, _rel_err  # noqa: F401


@pytest.mark.parametrize(**CASES)
def test_e4_e5_match_pallas(n, stride, bim, L, dform):
    """E4 (zhswrr: f_c) and E5 (zphrelax: u3)."""
    jl, jc, tl, _, f, uc, params = _levels(n, stride, bim, L, seed=1)
    fp, ucp, jp = jl.pad(jnp.asarray(f)), jc.pad(jnp.asarray(uc)), jnp.asarray(params)
    tf, tuc, tp = map(torch.from_numpy, (f, uc, params))
    fc_w = phx.zhswrr(jl, fp, jp, dform=dform)
    assert _rel_err(hx.zhswrr(tl, tf, tp, dform=dform), jc.unpad(fc_w)) < TOL
    u3_w = phx.zphrelax(jl, fp, ucp, jp, R_up=R, dform=dform)
    assert _rel_err(hx.zphrelax(tl, tf, tuc, tp, dform=dform), jl.unpad(u3_w)) < TOL


@pytest.mark.parametrize("dform", [False, True], ids=["plain", "dform"])
@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_zero_guess_legs_equal_their_compositions(bim, dform):
    """zhswrr == hswrr from a zero iterate (its f_c); zphrelax == phrelax of
    that iterate."""
    _, _, tl, _, f, uc, params = _levels(64, 1, bim, 3, seed=2)
    tf, tuc, tp = map(torch.from_numpy, (f, uc, params))
    u1, fc, _ = hx.hswrr(tl, torch.zeros_like(tf), tf, tp, dform=dform)
    assert _rel_err(hx.zhswrr(tl, tf, tp, dform=dform), fc) < 1e-6
    assert _rel_err(hx.zphrelax(tl, tf, tuc, tp, dform=dform),
                    hx.phrelax(tl, u1, tf, tuc, tp, dform=dform)) < 1e-6
