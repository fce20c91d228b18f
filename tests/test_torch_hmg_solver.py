"""The port's fused H-MG solve (multigrid_feanet_torch/solvers/hmg.py::
HMGHierarchy) against the JAX PallasHMG in interpret mode, on the CPU.

Both sides run on the identical operator (the port's hierarchy is built with
hierarchy_from_arrays from the JAX solver's own hierarchy and coarse
inverse) with the repository's H-Net checkpoints.  The bands are those of
tests/test_torch_mg2.py: the same cycle count (+-1 near eps), the first
residual to 1e-4 relative, every history ratio within [0.8, 1.25], and the
solution to 1e-3 of its scale.  Each JAX solver is built once per module.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core.problem import Problem as JProblem
from multigrid_feanet_tpu.solvers.hmg import PallasHMG

from multigrid_feanet_torch.core.convert import hierarchy_from_arrays
from multigrid_feanet_torch.core.problem import Problem
from multigrid_feanet_torch.solvers.hmg import HMGHierarchy
from multigrid_feanet_torch.utils import checkpoint

CKPT_DIR = Path(__file__).resolve().parent.parent / "results" / "learn_iterator"
CIRCLE = ("circle", (0.0, 0.0), 0.5)
N = 64


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _net(name):
    return checkpoint.load(CKPT_DIR / name)[0]


@functools.lru_cache(maxsize=None)
def _jax_solver(inclusion, num_levels, direct, h_levels, zero_legs, dform):
    return PallasHMG(JProblem(n=N, inclusion=inclusion), num_levels=num_levels,
                     pallas_threshold=16, rows=32, interpret=True, direct_coarse=direct,
                     h_levels=h_levels, coarse_zero_legs=zero_legs, dform=dform)


def _pair(inclusion, num_levels=4, direct=True, h_levels=None, zero_legs=True, dform=False):
    """The JAX solver and the port's, on the same hierarchy (port on CPU)."""
    jh = _jax_solver(inclusion, num_levels, direct, h_levels, zero_legs, dform)
    jp = JProblem(n=N, inclusion=inclusion)
    arrays = [dict(n=lv.n, h=lv.h, a0=lv.a0, a1=lv.a1, table=np.asarray(lv.table),
                   pid=None if lv.pid is None else np.asarray(lv.pid),
                   geo=np.asarray(lv.geo), diag=np.asarray(lv.diag), phase=jp.phase(lv.n))
              for lv in jh.hier.levels]
    inv = None if jh.coarse_inv is None else np.asarray(jh.coarse_inv)
    th = HMGHierarchy(Problem(n=N, inclusion=inclusion), kernel_threshold=16,
                      direct_coarse=direct, h_levels=h_levels, coarse_zero_legs=zero_legs,
                      dform=dform, hier=hierarchy_from_arrays(arrays, inv, device="cpu"),
                      device="cpu")
    assert th.K == jh.K
    return jh, th


# The RHS cases stop at 3e-3: nearer the f32 residual floor of this RHS at
# n = 64, the two sides' rounding decides the cycle count.
CASES = {
    # name: (inclusion, checkpoint, solver options, solve options)
    "hom_decay_L1": (None, "hnet_decay_L1_hlNone.npz", {},
                     dict(eps=1e-5, max_cycles=40, decay=True)),
    "bim_rhs_L3": (CIRCLE, "hnet_decay.npz", {}, dict(eps=3e-3, max_cycles=40)),
    "bim_dform": (CIRCLE, "hnet_decay_L1_hlNone.npz", dict(dform=True),
                  dict(eps=3e-3, max_cycles=40)),
    "hl2_zero_legs": (CIRCLE, "hnet_decay_L1_hl2.npz", dict(h_levels=2),
                      dict(eps=3e-3, max_cycles=40)),
    "hl2_nonzero_legs": (CIRCLE, "hnet_decay_L1_hl2.npz", dict(h_levels=2, zero_legs=False),
                         dict(eps=3e-3, max_cycles=40)),
    "plain_subtree": (CIRCLE, "hnet_decay_L1_hlNone.npz", dict(num_levels=None, direct=False),
                      dict(eps=3e-3, max_cycles=40)),
    "bim_bc": (CIRCLE, "hnet_decay_L1_hlNone.npz", {},
               dict(eps=3e-3, max_cycles=40, bc_value=0.7)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_solve_matches_pallas_hmg(case):
    inclusion, net, opts, kw = CASES[case]
    kw = dict(kw)
    jh, th = _pair(inclusion, **opts)
    params = _net(net)
    rng = np.random.default_rng(0)
    if kw.pop("decay", False):
        # the f = 0 decay protocol from a seeded random iterate
        f = np.zeros((N + 1, N + 1), np.float32)
        kw["u0"] = (150000.0 * rng.uniform(size=(N + 1, N + 1))).astype(np.float32)
    else:
        f = rng.standard_normal((N + 1, N + 1)).astype(np.float32)
    jkw = {k: jnp.asarray(v) if k == "u0" else v for k, v in kw.items()}
    uj, hj = jh.solve(jnp.asarray(params), jnp.asarray(f), **jkw)
    ut, ht = th.solve(params, f, **kw)
    hj, uj = np.asarray(hj), np.asarray(uj)
    assert ut.device == torch.device("cpu") and ut.dtype == torch.float32
    assert abs(len(hj) - len(ht)) <= 1
    assert len(hj) < kw["max_cycles"] and len(ht) < kw["max_cycles"]  # converged, not capped
    assert abs(ht[0] - hj[0]) / hj[0] < 1e-4
    m = min(len(hj), len(ht))
    ratio = ht[:m] / hj[:m]
    assert np.all(ratio > 0.8) and np.all(ratio < 1.25), ratio
    assert float(np.max(np.abs(ut.numpy() - uj))) / float(np.max(np.abs(uj))) < 1e-3
    if "bc_value" in kw:
        np.testing.assert_allclose(ut.numpy()[0, :], kw["bc_value"], atol=1e-6)


def test_history_convention_and_one_sync_per_chunk():
    """history[j] is the residual after cycle j+1, read back once per chunk:
    chunk only changes how many extra cycles the returned u carries."""
    n = 32
    th = HMGHierarchy(Problem(n=n, inclusion=CIRCLE), num_levels=3, kernel_threshold=8,
                      direct_coarse=True, device="cpu")
    params = _net("hnet_decay_L1_hlNone.npz")
    f = np.random.default_rng(5).standard_normal((n + 1, n + 1)).astype(np.float32)
    _, h1 = th.solve(params, f, eps=1e-3, max_cycles=40, chunk=1)
    _, h3 = th.solve(params, f, eps=1e-3, max_cycles=40, chunk=3)
    np.testing.assert_array_equal(h1, h3)
    assert h1[-1] <= 1e-3 < h1[-2]
    _, hc = th.solve(params, f, eps=0.0, max_cycles=5)
    assert len(hc) == 4


def test_hierarchy_refuses_bad_configurations():
    prob = Problem(n=32, inclusion=CIRCLE)
    with pytest.raises(ValueError, match="kernel_threshold"):
        HMGHierarchy(prob, num_levels=3, kernel_threshold=64, device="cpu")
    th = HMGHierarchy(prob, num_levels=3, kernel_threshold=16, device="cpu")
    f = np.zeros((33, 33), np.float32)
    with pytest.raises(ValueError, match="odd"):
        th.solve(np.zeros((2, 3, 3), np.float32), f)
    with pytest.raises(ValueError, match=r"\(L, 3, 3\)"):
        th.solve(np.zeros((3, 3), np.float32), f)
