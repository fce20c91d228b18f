"""The port's core modules against the JAX package on the CPU.

Level assembly and the dense coarse inverse are host numpy on both sides
and must agree bitwise; the plain PyTorch applies and transfers agree with
their JAX forms to 1e-6 (f32, same order of operations up to reassociation
inside the backends).  Also pins the port's device default (CUDA, raising
without it) and its independence from JAX.
"""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multigrid_feanet_tpu.core import geometry as jgeo
from multigrid_feanet_tpu.core.problem import Problem as JProblem
from multigrid_feanet_tpu.core.problem import GridHierarchy as JHierarchy
from multigrid_feanet_tpu.core.problem import build_level as j_build_level
from multigrid_feanet_tpu.ops import stencil as jst
from multigrid_feanet_tpu.ops import transfer as jtr
from multigrid_feanet_tpu.solvers import coarse as jco
from multigrid_feanet_tpu.solvers import common as jcommon
from multigrid_feanet_tpu.solvers import jacobi as jjac

from multigrid_feanet_torch import _build
from multigrid_feanet_torch.core import geometry as tgeo
from multigrid_feanet_torch.core.convert import hierarchy_from_arrays
from multigrid_feanet_torch.core.problem import GridHierarchy, Problem, build_level
from multigrid_feanet_torch.ops import stencil as tst
from multigrid_feanet_torch.ops import transfer as ttr
from multigrid_feanet_torch.ops.sweep import SweepLevel, sweep_cuda
from multigrid_feanet_torch.solvers import coarse as tco
from multigrid_feanet_torch.solvers import common as tcommon
from multigrid_feanet_torch.solvers import jacobi as tjac
from multigrid_feanet_torch.solvers.mg2 import HierarchyV2

ROOT = Path(__file__).resolve().parents[1]
INCLUSIONS = {"hom": None, "circle": ("circle", (0.0, 0.0), 0.5),
              "rect": ("rect", (0.1, -0.2), 0.4)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def level_arrays(jlevel, jproblem):
    """The numpy fields of a JAX level, as hierarchy_from_arrays takes them."""
    return dict(n=jlevel.n, h=jlevel.h, a0=jlevel.a0, a1=jlevel.a1,
                table=np.asarray(jlevel.table),
                pid=None if jlevel.pid is None else np.asarray(jlevel.pid),
                geo=np.asarray(jlevel.geo), diag=np.asarray(jlevel.diag),
                phase=jproblem.phase(jlevel.n))


@pytest.mark.parametrize("inc", list(INCLUSIONS))
@pytest.mark.parametrize("n", [16, 64, 128])
def test_build_level_matches_jax_bitwise(n, inc):
    jl = j_build_level(JProblem(n=n, inclusion=INCLUSIONS[inc]), n)
    tl = build_level(Problem(n=n, inclusion=INCLUSIONS[inc]), n)
    assert (tl.n, tl.h, tl.a0, tl.a1) == (jl.n, jl.h, jl.a0, jl.a1)
    for name in ("table", "geo", "diag"):
        np.testing.assert_array_equal(_np(getattr(tl, name)), np.asarray(getattr(jl, name)))
        assert getattr(tl, name).dtype == torch.float32
    if inc == "hom":
        assert tl.pid is None and tl.phase is None
    else:
        np.testing.assert_array_equal(_np(tl.pid), np.asarray(jl.pid))
        assert tl.pid.dtype == torch.int8 and tl.phase.dtype == torch.int8
        phase = JProblem(n=n, inclusion=INCLUSIONS[inc]).phase(n)
        np.testing.assert_array_equal(_np(tl.phase), phase)


def test_geometry_matches_jax():
    np.testing.assert_array_equal(tgeo.circle_phase(2.0, 64), jgeo.circle_phase(2.0, 64))
    np.testing.assert_array_equal(tgeo.rect_phase(2.0, 64, (0.1, 0.0), 0.3),
                                  jgeo.rect_phase(2.0, 64, (0.1, 0.0), 0.3))
    for a, b in zip(tgeo.element_centroids(2.0, 16), jgeo.element_centroids(2.0, 16)):
        np.testing.assert_array_equal(a, b)
    geo = tgeo.interior_mask(17)
    np.testing.assert_array_equal(_np(geo), np.asarray(jgeo.interior_mask(17, jnp.float32)))
    u = _f32(np.random.default_rng(0), (17, 17))
    np.testing.assert_array_equal(
        _np(tgeo.reset_boundary(torch.from_numpy(u), geo, 0.7)),
        np.asarray(jgeo.reset_boundary(jnp.asarray(u), jnp.asarray(_np(geo)), 0.7)))


@pytest.mark.parametrize("inc", ["hom", "circle"])
@pytest.mark.parametrize("n", [8, 16])
def test_coarse_inverse_matches_jax_bitwise(n, inc):
    jl = j_build_level(JProblem(n=n, inclusion=INCLUSIONS[inc]), n)
    tl = build_level(Problem(n=n, inclusion=INCLUSIONS[inc]), n)
    np.testing.assert_array_equal(tco.dense_interior_matrix(tl), jco.dense_interior_matrix(jl))
    tinv = tco.coarse_inverse(tl)
    np.testing.assert_array_equal(_np(tinv), np.asarray(jco.coarse_inverse(jl)))
    f = _f32(np.random.default_rng(1), (n + 1, n + 1))
    np.testing.assert_allclose(
        _np(tco.coarse_solve(tinv, torch.from_numpy(f))),
        np.asarray(jco.coarse_solve(jco.coarse_inverse(jl), jnp.asarray(f))),
        rtol=0, atol=1e-6 * np.abs(f).max() * np.abs(_np(tinv)).sum(1).max())


def test_transfers_match_jax():
    rng = np.random.default_rng(2)
    r = _f32(rng, (65, 65))
    np.testing.assert_allclose(_np(ttr.restrict_full_weighting(torch.from_numpy(r))),
                               np.asarray(jtr.restrict_full_weighting(jnp.asarray(r))),
                               rtol=0, atol=1e-6)
    v = _f32(rng, (33, 33))
    geo = np.array(jgeo.interior_mask(65, jnp.float32))
    for g in (None, geo):
        want = jtr.prolong_bilinear(jnp.asarray(v), None if g is None else jnp.asarray(g))
        got = ttr.prolong_bilinear(torch.from_numpy(v), None if g is None else torch.from_numpy(g))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("inc", ["hom", "circle"])
def test_applies_and_jacobi_match_jax(inc):
    n = 64
    jp, tp = JProblem(n=n, inclusion=INCLUSIONS[inc]), Problem(n=n, inclusion=INCLUSIONS[inc])
    jl, tl = j_build_level(jp, n), build_level(tp, n)
    rng = np.random.default_rng(3)
    u, f = _f32(rng, (n + 1, n + 1)), _f32(rng, (n + 1, n + 1))
    tu, tf = torch.from_numpy(u), torch.from_numpy(f)
    want = np.asarray(jl.apply(jnp.asarray(u)))
    close = dict(rtol=0, atol=1e-6 * max(1.0, float(np.abs(want).max())))
    np.testing.assert_allclose(_np(tl.apply(tu)), want, **close)
    if inc == "circle":
        table = tst.make_stencil_table_np((1.0, 20.0))
        np.testing.assert_array_equal(table, jst.make_stencil_table_np((1.0, 20.0)))
        np.testing.assert_array_equal(tst.pattern_ids_np(jp.phase(n)), jst.pattern_ids_np(jp.phase(n)))
        got = tst.apply_stencil(tl.table, tl.pid, tu)
        want = jst.apply_stencil(jl.table, jl.pid, jnp.asarray(u))
        np.testing.assert_allclose(_np(got), np.asarray(want), **close)
        np.testing.assert_array_equal(_np(tst.stencil_diagonal(tl.table, tl.pid)),
                                      np.asarray(jst.stencil_diagonal(jl.table, jl.pid)))
    else:
        np.testing.assert_array_equal(
            _np(tst.stencil_diagonal(tl.table, None, (n + 1, n + 1))),
            np.asarray(jst.stencil_diagonal(jl.table, None, (n + 1, n + 1))))
    np.testing.assert_allclose(_np(tst.apply_mass(tf, tl.h)),
                               np.asarray(jst.apply_mass(jnp.asarray(f), jl.h)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        _np(tjac.relax(tl, tu, tf, 2, 0.3)),
        np.asarray(jjac.relax(jl, jnp.asarray(u), jnp.asarray(f), 2, 0.3)), **close)
    np.testing.assert_allclose(float(tjac.interior_norm(tf)),
                               float(jjac.interior_norm(jnp.asarray(f))), rtol=1e-6)


def test_trim_history_matches_jax():
    hist = np.array([3.0, 1.0, 0.2, 0.05, 0.01, -1.0, -1.0], np.float32)
    for eps in (0.5, 0.05, 1e-3, 10.0):
        np.testing.assert_array_equal(tcommon.trim_history(hist, eps),
                                      jcommon.trim_history(hist, eps))


def test_hierarchy_from_arrays_carries_every_field():
    jp = JProblem(n=32, inclusion=INCLUSIONS["circle"])
    jh = JHierarchy.create(jp, 3)
    inv = np.asarray(jco.coarse_inverse(jh.levels[-1]))
    th = hierarchy_from_arrays([level_arrays(lv, jp) for lv in jh.levels], inv, device="cpu")
    assert th.num_levels == 3 and th.device == torch.device("cpu")
    for jl, tl in zip(jh.levels, th.levels):
        assert (tl.n, tl.h, tl.a0, tl.a1) == (jl.n, jl.h, jl.a0, jl.a1)
        for name in ("table", "pid", "geo", "diag"):
            np.testing.assert_array_equal(_np(getattr(tl, name)), np.asarray(getattr(jl, name)))
        np.testing.assert_array_equal(_np(tl.phase), jp.phase(jl.n))
    np.testing.assert_array_equal(_np(th.coarse_inv), inv)
    # identical to assembling the port's own hierarchy
    own = GridHierarchy.create(Problem(n=32, inclusion=INCLUSIONS["circle"]), 3, device="cpu")
    for a, b in zip(own.levels, th.levels):
        np.testing.assert_array_equal(_np(a.diag), _np(b.diag))


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = Problem(n=16, inclusion=INCLUSIONS["circle"])
    with pytest.raises(RuntimeError, match="CUDA"):
        GridHierarchy.create(prob)
    with pytest.raises(RuntimeError, match="CUDA"):
        HierarchyV2(prob, kernel_threshold=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        SweepLevel(16)
    with pytest.raises(RuntimeError, match="CUDA"):
        hierarchy_from_arrays([])
    assert GridHierarchy.create(prob, device="cpu").device == torch.device("cpu")


def test_cuda_wrappers_refuse_cpu_tensors():
    u = torch.zeros(17, 17)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sweep_cuda(u, u, None, None, a0=1.0, da=0.0, omega=2 / 3, dform=True)


def _port_sources():
    files = sorted((ROOT / "multigrid_feanet_torch").rglob("*.py"))
    names = {p.relative_to(ROOT / "multigrid_feanet_torch").as_posix() for p in files}
    assert {"ops/sweep.py", "ops/general.py", "ops/boxmg.py", "ops/adaptive_transfer.py",
            "solvers/mg2.py", "solvers/boxmg.py", "core/convert.py", "ops/hrelax.py",
            "models/hnet.py", "utils/checkpoint.py", "solvers/hmg.py", "ops/stencil_sweep.py",
            "solvers/mg.py", "solvers/multigrid.py"} <= names
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax():
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "optax", "multigrid_feanet_tpu"), (
                    f"{path.relative_to(ROOT)} imports {name}")
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
               for p in _port_sources()[:-1]]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'multigrid_feanet_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_library_hash_covers_every_source(tmp_path, monkeypatch):
    """The built library is named by a hash of every source and header, so
    an edit to any of them (not only the first) rebuilds it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    cu = sorted(csrc.glob("*.cu"))
    names = ["elastic.cu", "general.cu", "hrelax.cu", "stencil.cu", "sweep.cu"]
    assert [p.name for p in cu] == names
    assert [p.name for p in _build.sources()] == names
    seen = {_build.library_path()}
    for path in (*cu[::-1], csrc / "common.cuh"):
        path.write_bytes(path.read_bytes() + b"\n")
        seen.add(_build.library_path())
    assert len(seen) == 7
    assert _build.library_path() == _build.library_path()
