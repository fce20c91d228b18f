"""The port's utilities (multigrid_feanet_torch/utils/{vtk,plot,profiling}.py
and core/geometry.py::node_coords) against the JAX package's, on the CPU.

The VTK file equals the JAX writer's line for line but the title line,
which names the package; node_coords and stencil_roofline give JAX's numbers
exactly; the plot functions render tensors and arrays under Agg; ``trace``
is a no-op for None and writes a Chrome trace otherwise.
"""

import json

import numpy as np
import pytest
import torch

from multigrid_feanet_tpu.core import geometry as jgeo
from multigrid_feanet_tpu.utils import profiling as jprof
from multigrid_feanet_tpu.utils import vtk as jvtk

from multigrid_feanet_torch.core import geometry as tgeo
from multigrid_feanet_torch.ops import stencil as tst
from multigrid_feanet_torch.utils import profiling, vtk


@pytest.mark.parametrize("n,size", [(8, 2.0), (5, 1.0)])
def test_node_coords_match_jax(n, size):
    for got, want in zip(tgeo.node_coords(size, n), jgeo.node_coords(size, n)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("fields", ["both", "points", "none"])
def test_vtk_file_matches_jax(tmp_path, fields):
    n = 8
    u = np.random.default_rng(0).standard_normal((n + 1, n + 1))
    phase = tgeo.circle_phase(2.0, n)
    kw = {"both": dict(point_data={"u": u, "r": 2.0 * u}, cell_data={"Phase": phase}),
          "points": dict(point_data={"u": u}), "none": {}}[fields]
    jvtk.write_quad_mesh(str(tmp_path / "jax.vtk"), n, **kw)
    t_kw = {k: {name: torch.as_tensor(v) for name, v in d.items()} for k, d in kw.items()}
    vtk.write_quad_mesh(str(tmp_path / "port.vtk"), n, **t_kw)
    want = (tmp_path / "jax.vtk").read_text().splitlines()
    got = (tmp_path / "port.vtk").read_text().splitlines()
    assert got[1] == "multigrid_feanet_torch" and want[1] == "multigrid_feanet_tpu"
    assert got[:1] + got[2:] == want[:1] + want[2:]
    assert ("CELL_DATA 64" in got) == (fields == "both")


@pytest.mark.parametrize("n,secs,bpn", [(4096, 1.3e-4, 13.0), (64, 2e-6, 9.0)])
def test_stencil_roofline_matches_jax(n, secs, bpn):
    got = profiling.stencil_roofline(n, secs, bpn, name="A1")
    want = jprof.stencil_roofline(n, secs, bpn, name="A1")
    assert got.as_dict() == want.as_dict()


@pytest.mark.parametrize("res,diverged", [(1.0, False), (0.0, False), (float("inf"), True),
                                          (float("nan"), True), (-float("inf"), True)])
def test_divergence_guard(res, diverged):
    assert profiling.divergence_guard(res) is diverged
    assert jprof.divergence_guard(res) is diverged


def test_time_callable_on_the_host_clock():
    calls = []

    def fn(x):
        calls.append(1)
        return (x + 1, {"y": x * 2})

    secs = profiling.time_callable(fn, torch.ones(4), iters=5, warmup=2)
    assert secs > 0.0 and len(calls) == 7


def test_plot_utils_render_tensors_and_arrays(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from multigrid_feanet_torch.utils import plot

    n = 8
    u = torch.as_tensor(np.random.default_rng(0).standard_normal((1, 1, n + 1, n + 1)))
    pid = tst.pattern_ids(torch.as_tensor(tgeo.circle_phase(2.0, n)))
    ax = plot.plot_field(u, limit=(-1.0, 1.0), fname=str(tmp_path / "f.png"))
    assert ax.images[0].get_array().shape == (n + 1, n + 1)
    ax = plot.plot_pattern(pid, key=0, fname=str(tmp_path / "p.png"))
    assert np.array_equal(np.asarray(ax.images[0].get_array()), (pid.numpy() == 0).astype(float))
    ax = plot.plot_residual_history({"jac": torch.tensor([1.0, 0.5, 0.1]), "mg": [1.0, 0.1]},
                                    fname=str(tmp_path / "h.png"))
    assert [line.get_label() for line in ax.get_lines()] == ["jac", "mg"]
    for name in ("f.png", "p.png", "h.png"):
        assert (tmp_path / name).stat().st_size > 0
    plt.close("all")


def test_trace_none_is_a_no_op(tmp_path):
    with profiling.trace(None) as prof:
        assert prof is None
        torch.ones(3).sum()
    assert list(tmp_path.iterdir()) == []


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        torch.ones(64).cumsum(0)
    data = json.loads((logdir / "trace.json").read_text())
    assert any("cumsum" in ev.get("name", "") for ev in data["traceEvents"])
