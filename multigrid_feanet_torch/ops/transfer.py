"""Inter-grid transfers: full-weighting restriction, bilinear prolongation.

Port of ``multigrid_feanet_tpu/ops/transfer.py`` with the same separable
single-axis passes and the same order of operations.  The fused kernels of
``ops/sweep.py`` carry their own transfers; these plain forms serve the
plain subtree of ``solvers/mg2.py`` and the tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _fw_1d_last(x: torch.Tensor) -> torch.Tensor:
    """[1, 2, 1]/4 filter + stride-2 downsample along the last axis at the
    coarse-interior indices J = 1..n/2-1."""
    n = x.shape[-1] - 1
    t = (x[..., :-2] + 2.0 * x[..., 1:-1] + x[..., 2:]) * 0.25
    return t[..., 1 : n - 2 : 2]


def restrict_full_weighting(r: torch.Tensor) -> torch.Tensor:
    """(..., n+1, n+1) -> (..., n/2+1, n/2+1), zero boundary ring."""
    out = _fw_1d_last(r)
    out = _fw_1d_last(out.transpose(-1, -2)).transpose(-1, -2)
    return F.pad(out, (1, 1, 1, 1))


def _up_1d_last(v: torch.Tensor) -> torch.Tensor:
    """Align-corners linear upsample along the last axis: (..., m) ->
    (..., 2m-1); even = injection, odd = midpoint."""
    mid = 0.5 * (v[..., :-1] + v[..., 1:])
    body = torch.stack([v[..., :-1], mid], dim=-1).flatten(-2)
    return torch.cat([body, v[..., -1:]], dim=-1)


def prolong_bilinear(v: torch.Tensor, geo_fine=None) -> torch.Tensor:
    """(..., m, m) -> (..., 2m-1, 2m-1) bilinear (align_corners) upsample,
    masked by ``geo_fine`` when given."""
    out = _up_1d_last(v)
    out = _up_1d_last(out.transpose(-1, -2)).transpose(-1, -2)
    if geo_fine is not None:
        out = out * geo_fine
    return out
