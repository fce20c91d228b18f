"""Launch geometry of H1 (``ops/torus.py`` ``h1_tiles``, ``h1_one_pass_tiles``,
``h1_launch_tiles``): the Python side of what the wrapper passes to
``csrc/torus.cu``, checked without a card.

For every n from 2 to 64 (odd n too) and for n in {128, 2048, 4096}: the
row-streaming bands and strips (and the one-pass tiles) cover each node of
the torus exactly once; every staged row's 16-byte chunks stay inside the
field's allocation and cover the window; the window a thread sweeps, with
the torus seam's rows (row n - 1 above row 0, row 0 below row n - 1) and
the two wrap cells (column n - 1 left of column 0, column 0 right of column
n - 1), holds each owned node's 3 x 3 neighbourhood mod n; the partial-sum
buffer holds two floats per block; and the geometry the wrapper launches is
``row_strip``'s choice above ``H1_ONE_PASS_MAX_N`` and the one-pass tile up
to it.  The index arithmetic mirrors ``h1_torus_relax``'s ``stage`` and
step; ``chip_smoke.py`` holds the kernel itself at ragged sizes on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multigrid_feanet_torch.ops import hrelax as hx
from multigrid_feanet_torch.ops import sweep as sw
from multigrid_feanet_torch.ops import torus as tt
from test_torch_sweep_tiles import _check_windows, _cover_once

SIZES = list(range(2, 65)) + [128, 2048, 4096]
STRIPS = (2, 32, sw.A12_STRIP_MAX)
CSRC = Path(tt.__file__).resolve().parent.parent / "csrc"
RT, RC = sw.A12_THREADS, sw.A12_COLUMNS
RB = RT * RC
RW = RB + 2
RSLOT = (RW + 6) // 4 * 4


def _steps(tiles, y0):
    return min(tiles.strip, tiles.n - y0) + tt.H1_HALO_STEPS


def _wrap(r, n):
    """csrc/torus.cu's row correction: one step of n either way."""
    return r + n if r < 0 else r - n if r >= n else r


@pytest.mark.parametrize("n", SIZES)
def test_bands_and_strips_cover_each_node_once(n):
    for strip in STRIPS:
        tiles = tt.h1_tiles(n, strip)
        assert tiles.band == RB and tiles.strip == strip
        assert _cover_once(np.arange(tiles.gx) * RB, RB, n)
        assert _cover_once(np.arange(tiles.gy) * strip, strip, n)
    one = tt.h1_one_pass_tiles(n)
    assert (one.band, one.strip) == (32, 8)
    assert _cover_once(np.arange(one.gx) * 32, 32, n)
    assert _cover_once(np.arange(one.gy) * 8, 8, n)


@pytest.mark.parametrize("n", SIZES)
def test_staging_windows_stay_inside_the_allocation(n):
    for strip in STRIPS:
        tiles = tt.h1_tiles(n, strip)
        u_rows, f_rows, cols = [], [], []
        for by in range(tiles.gy):
            y0 = by * strip
            s = np.arange(_steps(tiles, y0))
            u = np.array([_wrap(r, n) for r in y0 - 1 + s])
            # the seam: the strip at row 0 stages row n - 1 above, the last
            # strip row 0 below; every staged u row lies on the torus
            assert (u >= 0).all() and (u < n).all()
            assert list(u) == [(y0 - 1 + k) % n for k in s]
            for bx in range(tiles.gx):
                u_rows.append(u)
                f_rows.append(y0 - 2 + s)
                cols.append(np.full(len(s), bx * RB - 1))
        u_rows, f_rows, cols = map(np.concatenate, (u_rows, f_rows, cols))
        _check_windows(((u_rows, cols, n, n, n * n, 4, RSLOT, RW),
                        (f_rows, cols, n, n, n * n, 4, RSLOT, RW)))
    assert RSLOT // 4 <= RT  # one chunk of a row per thread


@pytest.mark.parametrize("n", SIZES)
def test_windows_hold_each_nodes_wrapped_neighbourhood(n):
    # the node each window position of a staged u row holds: the compact
    # layout's element (row R, column col + x), or none off the field; the
    # first band's position 0 then takes the wrap cell u[R, n - 1] and the
    # last band's position n - col the cell u[R, 0]; a thread's node e
    # reads positions RC t + e .. RC t + e + 2 of rows i - 1, i, i + 1
    tiles = tt.h1_tiles(n, tt.h1_tiles(n).strip)
    src = (CSRC / "torus.cu").read_text()
    assert "const int er = n - col - RC * t;" in src
    for bx in range(tiles.gx):
        x0 = bx * RB
        col = x0 - 1
        left, right = x0 == 0, x0 + RB >= n
        for i in {0, 1, n // 2, n - 2, n - 1}:
            i %= n
            rows = {}
            for di in (-1, 0, 1):
                R = _wrap(i + di, n)
                q = R * n + col + np.arange(RW)
                node = np.where((q >= 0) & (q < n * n), q, -1)
                rows_c = np.where(node >= 0, node % n, -1)
                rows_r = np.where(node >= 0, node // n, -1)
                if left:
                    rows_r[0], rows_c[0] = R, n - 1
                if right:
                    rows_r[n - col], rows_c[n - col] = R, 0
                rows[di] = (rows_r, rows_c)
            for t in range(RT):
                for e in range(RC):
                    j = x0 + RC * t + e
                    if j >= n:
                        continue
                    for di in (-1, 0, 1):
                        rr, cc = rows[di]
                        for dj in (-1, 0, 1):
                            p = RC * t + e + 1 + dj
                            assert (rr[p], cc[p]) == ((i + di) % n, (j + dj) % n), (n, t, e)


@pytest.mark.parametrize("n", SIZES)
def test_partial_buffer_holds_two_sums_per_block(n):
    for tiles in [tt.h1_tiles(n, s) for s in STRIPS] + [tt.h1_one_pass_tiles(n)]:
        ws = {}
        partial, done = hx.row_scratch(tiles, 2, torch.device("cpu"), ws)
        assert partial.numel() == 2 * tiles.blocks and partial.dtype == torch.float32
        assert done.dtype == torch.int32 and int(done) == 0
        again = hx.row_scratch(tiles, 2, torch.device("cpu"), ws)
        assert again[0] is partial and again[1] is done


class _Props:
    multi_processor_count = 132


@pytest.mark.parametrize("n", SIZES + [96, 130, 512, 514, 1024])
def test_wrapper_takes_the_size_choice(n, monkeypatch):
    asked = []

    def occupancy(symbol, *args):
        asked.append(symbol)
        return 9

    monkeypatch.setattr(tt, "occupancy", occupancy)
    monkeypatch.setattr(tt, "_H1_TILES", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    dev = torch.device("cuda", 0)
    tiles = tt.h1_launch_tiles(n, dev)
    if n <= tt.H1_ONE_PASS_MAX_N:
        assert tiles == tt.h1_one_pass_tiles(n) and tiles.leg == "H1_tile" and not asked
        return
    want = hx.row_strip(lambda s: tt.h1_tiles(n, s), tt.H1_HALO_STEPS, 9 * 132, 132)
    assert tiles == tt.h1_tiles(n, want) and tiles.leg == "H1"
    assert asked == ["mg_torus_occupancy"]
    assert tt.h1_launch_tiles(n, dev) is tiles and len(asked) == 1


def test_block_shape_matches_the_kernel():
    common = (CSRC / "common.cuh").read_text()
    src = (CSRC / "torus.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", common).group(1))

    assert (const("RT"), const("RC"), const("TX"), const("TY")) == (RT, RC, 32, 8)
    body = src[src.index("inline bool h1_grid_ok("):]
    body = body[:body.index("\n}\n")]
    assert "gx == (n + RB - 1) / RB" in body and "torus_grid(n)" in body
    entry = src[src.index("int mg_torus("):]
    assert entry[:entry.index("\n}\n")].count("h1_grid_ok(n, one_pass != 0, strip, gx, gy)") == 1
    with pytest.raises(ValueError):
        tt.h1_tiles(8, 5)
