"""Carry operator state and weights across from host arrays.

What carries over between the JAX package and the port is the operator data
of each level and the learned H-Net's kernels.
:func:`hierarchy_from_arrays` builds the port's :class:`GridHierarchy` from
per-level numpy fields (for example those of a JAX ``GridHierarchy``),
:func:`elastic_hierarchy_from_arrays` the elastic levels (those of a JAX
``build_elastic_hierarchy``) in the same container,
:func:`boxmg_setup_from_arrays` the BoxMG transfers and Galerkin operators
and :func:`elastic_boxmg_setup_from_arrays` the block-BoxMG ones, so that
both sides run on the identical operator,
:func:`hnet_params_from_arrays` the H-Net's (L, 3, 3) kernels (for example
a JAX parameter array, or a leaf of a ``.npz`` checkpoint read by
``utils/checkpoint.py``), :func:`hnet_elastic_params_from_arrays` the
elastic H-Net's (L, 2, 2, 3, 3) kernels, and
:func:`intergrid_params_from_arrays` the learned inter-grid operators
(:func:`intergrid_params_from_npz` reads them from the repository's
``.npz`` files, with plain keys or in ``utils/checkpoint``'s form).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from multigrid_feanet_torch.core.device import resolve_device
from multigrid_feanet_torch.core.problem import GridHierarchy, Level
from multigrid_feanet_torch.models.intergrid import IntergridParams
from multigrid_feanet_torch.solvers.elastic import ElasticLevel


def _tensor(x, device, dtype=None):
    """A copy of array ``x`` on ``device`` (None stays None)."""
    return None if x is None else torch.tensor(np.asarray(x), dtype=dtype, device=device)


def hierarchy_from_arrays(levels: Sequence[Mapping], coarse_inv=None,
                          device=None) -> GridHierarchy:
    """Build a hierarchy from finest-to-coarsest level mappings.

    Each mapping holds ``n``, ``h``, ``a0``, ``a1`` (floats or None) and the
    arrays ``table``, ``pid`` (None if homogeneous), ``geo``, ``diag`` and
    the (n, n) element ``phase`` (None if homogeneous), and optionally the
    phase-affine operator's (3, 3) ``base`` and float ``bit_scale`` (a heat
    system level, ``ops/heat.py``).  Float fields keep their dtype; ``pid``
    and ``phase`` become int8.  ``coarse_inv``, the
    dense inverse of the coarsest interior operator, is carried along for
    the direct coarse solve when given.  ``device=None`` means CUDA."""
    device = resolve_device(device)

    def dev(x, dtype=None):
        return _tensor(x, device, dtype)

    out = []
    for lv in levels:
        out.append(Level(
            n=int(lv["n"]), h=float(lv["h"]),
            a0=None if lv["a0"] is None else float(lv["a0"]),
            a1=None if lv["a1"] is None else float(lv["a1"]),
            table=dev(lv["table"]), pid=dev(lv["pid"], torch.int8),
            geo=dev(lv["geo"]), diag=dev(lv["diag"]),
            phase=dev(lv["phase"], torch.int8), base=dev(lv.get("base")),
            bit_scale=None if lv.get("bit_scale") is None else float(lv["bit_scale"])))
    return GridHierarchy(levels=tuple(out), coarse_inv=dev(coarse_inv))


def elastic_hierarchy_from_arrays(levels: Sequence[Mapping], coarse_inv=None,
                                  device=None) -> GridHierarchy:
    """Build a hierarchy of ``ElasticLevel``s from finest-to-coarsest level
    mappings.

    Each mapping holds ``n``, ``h``, ``E``, ``nu``, ``plane``, ``a0`` and
    ``a1`` (floats or None) and the arrays ``table`` (16, 3, 3, 2, 2),
    ``pid`` (None if homogeneous), ``geo``, ``dinv`` (n+1, n+1, 2, 2) and the
    (n, n) element ``phase`` (None if homogeneous).  Float fields keep their
    dtype; ``pid`` and ``phase`` become int8.  ``coarse_inv``, the dense
    inverse of the coarsest interior operator (node-major interleaved), is
    carried along for the direct coarse solve when given.  ``device=None``
    means CUDA."""
    device = resolve_device(device)

    def dev(x, dtype=None):
        return _tensor(x, device, dtype)

    out = []
    for lv in levels:
        out.append(ElasticLevel(
            n=int(lv["n"]), h=float(lv["h"]), E=float(lv["E"]), nu=float(lv["nu"]),
            plane=str(lv["plane"]),
            a0=None if lv["a0"] is None else float(lv["a0"]),
            a1=None if lv["a1"] is None else float(lv["a1"]),
            table=dev(lv["table"]), pid=dev(lv["pid"], torch.int8), geo=dev(lv["geo"]),
            dinv=dev(lv["dinv"]), phase=dev(lv["phase"], torch.int8)))
    return GridHierarchy(levels=tuple(out), coarse_inv=dev(coarse_inv))


def boxmg_setup_from_arrays(setup: Sequence, device=None, dtype=None) -> list:
    """The BoxMG setup ``[(W4_0, Sc_1), (W4_1, Sc_2), ...]`` (for example
    the JAX ``boxmg_setup`` output as numpy arrays) as the port's tensors on
    ``device``, in ``dtype`` (default: each array's own), so that both
    solvers run on the identical operator.  ``device=None`` means CUDA."""
    device = resolve_device(device)
    return [tuple(torch.tensor(np.asarray(x), dtype=dtype, device=device) for x in pair)
            for pair in setup]


def elastic_boxmg_setup_from_arrays(setup: Sequence, device=None, dtype=None) -> list:
    """The block-BoxMG setup ``[(W4E_0, Sc_1), (W4E_1, Sc_2), ...]`` (for
    example the JAX ``boxmg_elastic_setup`` output as numpy arrays: W4E
    (H, W, 2, 2, 2, 2), Sc (m, m, 3, 3, 2, 2)) as the port's tensors on
    ``device``, in ``dtype`` (default: each array's own), for
    ``ElasticBoxMG(levels, setup=...)``.  ``device=None`` means CUDA."""
    return boxmg_setup_from_arrays(setup, device, dtype)


def _kernels(params, tail: tuple, what: str, device) -> torch.Tensor:
    """``params`` as a contiguous float32 tensor of shape (L, *tail), L >= 1."""
    out = torch.tensor(np.asarray(params), dtype=torch.float32, device=resolve_device(device))
    if out.dim() != 1 + len(tail) or tuple(out.shape[1:]) != tail or out.shape[0] < 1:
        raise ValueError(f"{what} params must be (L, {', '.join(map(str, tail))}), "
                         f"not {tuple(out.shape)}")
    return out.contiguous()


def hnet_params_from_arrays(params, device=None) -> torch.Tensor:
    """The H-Net's (L, 3, 3) kernels (numpy or any array) as the contiguous
    float32 tensor on ``device`` that the fused legs take.  ``device=None``
    means CUDA."""
    return _kernels(params, (3, 3), "H-Net", device)


def hnet_elastic_params_from_arrays(params, device=None) -> torch.Tensor:
    """The elastic H-Net's (L, 2, 2, 3, 3) kernels (out channel, in channel,
    3 x 3; for example a JAX ``init_params_elastic`` or ``train_elastic``
    result) as a contiguous float32 tensor on ``device``.  ``device=None``
    means CUDA."""
    return _kernels(params, (2, 2, 3, 3), "elastic H-Net", device)


def intergrid_params_from_arrays(conv, deconv, w=None, device=None) -> IntergridParams:
    """The learned inter-grid operators from arrays: ``conv`` and ``deconv``
    (C, 3, 3), channel = pid, and ``w`` (2,) (None: the reference's frozen
    [4, 1]), as float32 parameters on ``device``.  ``device=None`` means
    CUDA."""
    device = resolve_device(device)
    conv, deconv = (torch.tensor(np.asarray(x), dtype=torch.float32, device=device)
                    for x in (conv, deconv))
    if conv.dim() != 3 or tuple(conv.shape[1:]) != (3, 3) or deconv.shape != conv.shape:
        raise ValueError(f"conv and deconv must both be (C, 3, 3), not {tuple(conv.shape)} "
                         f"and {tuple(deconv.shape)}")
    w = torch.tensor(np.asarray([4.0, 1.0] if w is None else w), dtype=torch.float32,
                     device=device)
    if w.shape != (2,):
        raise ValueError(f"w must be (2,), not {tuple(w.shape)}")
    return IntergridParams(conv, deconv, w)


def intergrid_params_from_npz(path, device=None) -> IntergridParams:
    """The inter-grid operators of a ``.npz`` file: plain ``conv``,
    ``deconv`` and optional ``w`` keys, or the leaves conv, deconv, w of a
    JAX ``IntergridParams`` saved by ``utils/checkpoint``.  ``device=None``
    means CUDA."""
    from multigrid_feanet_torch.utils import checkpoint

    with np.load(path) as data:
        if "conv" in data.files:
            return intergrid_params_from_arrays(
                data["conv"], data["deconv"], data["w"] if "w" in data.files else None, device)
    return intergrid_params_from_arrays(*checkpoint.load(path), device=device)
