"""Minimal legacy-VTK writer for the structured quad mesh and its fields.

Port of ``multigrid_feanet_tpu/utils/vtk.py``: a dependency-free ASCII VTK
legacy file (in place of the reference's meshio ``save_mesh``), enough for
ParaView to show solution fields, phase maps and residuals.  numpy only;
fields may be arrays or CPU tensors.
"""

from __future__ import annotations

import numpy as np

from multigrid_feanet_torch.core.geometry import node_coords


def write_quad_mesh(path: str, n: int, size: float = 2.0,
                    point_data: dict | None = None,
                    cell_data: dict | None = None) -> None:
    """Write the (n+1)^2-node uniform quad mesh on [-size/2, size/2]^2.

    ``point_data``: name -> (n+1, n+1) nodal field; ``cell_data``: name ->
    (n, n) per-element field (e.g. the phase map)."""
    H = n + 1
    yy, xx = node_coords(size, n)
    with open(path, "w") as fh:
        fh.write("# vtk DataFile Version 3.0\nmultigrid_feanet_torch\nASCII\n")
        fh.write("DATASET STRUCTURED_GRID\n")
        fh.write(f"DIMENSIONS {H} {H} 1\n")
        fh.write(f"POINTS {H * H} float\n")
        for i in range(H):
            for j in range(H):
                fh.write(f"{xx[i, j]:.7g} {yy[i, j]:.7g} 0\n")
        for header, k, fields in (("POINT_DATA", H, point_data), ("CELL_DATA", n, cell_data)):
            if not fields:
                continue
            fh.write(f"{header} {k * k}\n")
            for name, field in fields.items():
                arr = np.asarray(field).reshape(k, k)
                fh.write(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n")
                for i in range(k):
                    for j in range(k):
                        fh.write(f"{arr[i, j]:.7g}\n")
