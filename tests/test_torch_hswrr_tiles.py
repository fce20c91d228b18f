"""Launch geometry of the row-streaming E2 (``ops/hrelax.py`` ``e2_tiles``,
``e2_one_pass_tiles``, ``e2_halo_steps``, ``e2_launch_tiles``): the Python
side of what the wrapper passes to ``csrc/hrelax.cu``'s
``e2_h_descent_rows``, checked without a card.

For every even n from 2 to 64 and for the sizes around each one-pass
threshold and up to 4096, with chain depths L = 1 and 3: the bands and
strips own each fine node (u1, the norm) and each coarse node (f_c) exactly
once, and the one-pass tiles each coarse node once; every staged row's
16-byte chunks (u, f and the phases) stay inside the allocation and cover
the window, which holds the chain's halo of L + 3 nodes; the chain's stages
read only rows finished at earlier steps, and the f / phase ring still
holds every row the residual reads; the restriction's row parity completes
each coarse row of the strip once, from the residual rows around it, and
its columns each coarse column of the band once, inside the columns where
the residual is valid; the partial buffer holds one float per block; and
the wrapper takes the one-pass tile up to ``E2_ONE_PASS_MAX_N[L]`` and
``row_strip``'s strip above it.  The index arithmetic mirrors the kernel's;
``chip_smoke.py`` holds the kernel itself at ragged sizes on the card.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multigrid_feanet_torch.ops import hrelax as hx
from multigrid_feanet_torch.ops import sweep as sw
from test_torch_sweep_tiles import _check_windows, _cover_once

DEPTHS = (1, 3)
THRESHOLDS = set(hx.E2_ONE_PASS_MAX_N.values())
SIZES = sorted(set(range(2, 65, 2)) | {126, 128, 1000, 2048, 4096}
               | {t + d for t in THRESHOLDS for d in (-2, 0, 2)})
STRIPS = (2, 8, 30, 32, sw.A12_STRIP_MAX)
CSRC = Path(hx.__file__).resolve().parent.parent / "csrc"
RT, RC = sw.A12_THREADS, sw.A12_COLUMNS
RB = RT * RC
RW, RWQ = RB + 2, RB + 1
RSLOT, RSLOTQ = (RW + 6) // 4 * 4, (RWQ + 30) // 16 * 16
RD, UNR = 2, 6  # rows staged ahead; steps per trip of the main loop


def _bw(L):
    return RB - 2 * L - 4


def _nf(L):
    """Slots of the f / phase ring: a power of two of at least 2L + 6."""
    return 8 if L == 1 else 16


def _strip_rows(n, y0, strip, L):
    """(rows_out, staged, steps) of the strip at y0: the fine rows it
    restricts, the steps that stage rows and all its steps."""
    rows_out = min(strip, n + 2 - y0)
    return rows_out, rows_out + 2 * L + 5, rows_out + hx.e2_halo_steps(L)


@pytest.mark.parametrize("n", SIZES)
def test_bands_and_strips_own_each_node_once(n):
    H, Hc = n + 1, n // 2 + 1
    for L in DEPTHS:
        for strip in STRIPS:
            tiles = hx.e2_tiles(n, L, strip)
            assert (tiles.leg, tiles.band, tiles.strip) == ("E2", _bw(L), strip)
            fine, coarse = np.zeros((H, H), np.uint8), np.zeros((Hc, Hc), np.uint8)
            for by in range(tiles.gy):
                y0 = by * strip
                assert y0 % 2 == 0 and y0 < H
                for bx in range(tiles.gx):
                    x0 = bx * tiles.band
                    fine[y0:y0 + strip, x0:x0 + tiles.band] += 1
                    coarse[y0 // 2:(y0 + strip) // 2, x0 // 2:(x0 + tiles.band) // 2] += 1
            assert (fine == 1).all() and (coarse == 1).all(), tiles
    one = hx.e2_one_pass_tiles(n)
    assert (one.leg, one.band, one.strip) == ("E2_tile", 32, 16)
    assert _cover_once(np.arange(one.gx) * 16, 16, Hc) and _cover_once(np.arange(one.gy) * 8, 8, Hc)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("L", DEPTHS)
def test_staging_windows_stay_inside_the_allocation(n, L):
    H = n + 1
    for strip in STRIPS:
        tiles = hx.e2_tiles(n, L, strip)
        u_rows, f_rows, cols = [], [], []
        for by in range(tiles.gy):
            y0 = by * strip
            rows_out, staged, _ = _strip_rows(n, y0, strip, L)
            rows = y0 - L - 3 + np.arange(staged)
            for bx in range(tiles.gx):
                x0 = bx * tiles.band
                u_rows.append(rows)  # u row base + s
                f_rows.append(rows - 1)  # f and phase row base + s - 1
                cols.append(np.full(staged, x0 - L - 3))
                # the window holds the chain's halo: u over columns
                # x0 - L - 3 .. x0 + band + L + 2 and rows y0 - L - 3 ..
                # y0 + rows_out + L + 1; f over the Jacobi rows; the phases
                # over the element rows and columns one below those
                assert x0 + tiles.band + L + 2 < x0 - L - 3 + RW
                assert x0 + tiles.band + L + 1 < x0 - L - 3 + RWQ
            assert rows[0] == y0 - L - 3 and rows[-1] == y0 + rows_out + L + 1
        u_rows, f_rows, cols = map(np.concatenate, (u_rows, f_rows, cols))
        _check_windows(((u_rows, cols, H, H, H * H, 4, RSLOT, RW),
                        (f_rows, cols, H, H, H * H, 4, RSLOT, RW),
                        (f_rows, cols, n, n, n * n, 16, RSLOTQ, RWQ)))
    assert RSLOT // 4 <= RT and RSLOTQ // 16 <= RT


@pytest.mark.parametrize("L", DEPTHS)
@pytest.mark.parametrize("rows_out", [2, 4, 8, 30, 32, sw.A12_STRIP_MAX])
def test_chain_reads_only_rows_of_earlier_steps(L, rows_out):
    # rows relative to the strip's first row y0 = 0; step s: u row
    # R = base + s staged (stage s), Jacobi row i = R - 1, conv layer l row
    # i - 2l, u1 row q = i - 2L (from layer L's row and the jac row of step
    # s - 2L), r1 row rho = q - 2 (from u1 rows rho - 1 .. rho + 1)
    base = -L - 3
    staged, steps = rows_out + 2 * L + 5, rows_out + hx.e2_halo_steps(L)
    NF = _nf(L)
    made = {}  # (stage, row) -> step; stage 0 is jac / x0, l the conv layers, "u1", "r1"
    for s in range(steps):
        R = base + s
        i = R - 1
        for l in range(L, 0, -1):
            r = i - 2 * l
            for need in (r - 1, r, r + 1):  # x_{l-1} rows of earlier steps
                if (l - 1, need) in made:
                    assert made[(l - 1, need)] < s
            made[(l, r)] = s
        q = i - 2 * L
        if (0, q) in made:
            assert made[(0, q)] == s - 2 * L  # the jac ring of 2L rows returns it
        made[("u1", q)] = s
        rho = q - 2
        for need in (rho - 1, rho, rho + 1):
            if ("u1", need) in made and need != q:
                assert made[("u1", need)] < s
        made[("r1", rho)] = s
        made[(0, i)] = s
        # f row i and element row i come with stage s; f row rho and
        # element rows rho - 1, rho with stages s - 2L - 2 and s - 2L - 3,
        # whose slots no later stage started by step s (stages up to s + RD,
        # the one of this step included) has overwritten
        assert i - base + 1 == s
        for m in (s - 2 * L - 2, s - 2 * L - 3):
            if m >= 0:
                assert all((m2 - m) % NF for m2 in range(m + 1, s + RD + 1))
                assert m == (rho if m == s - 2 * L - 2 else rho - 1) - base + 1
    # the Jacobi rows the chain needs are staged: u rows i - 1 .. i + 1
    for r in range(-L - 2, rows_out + L + 1):
        assert r + 1 - base < staged and (0, r) in made
    # every conv row, u1 row and r1 row the strip needs is made
    for l in range(1, L + 1):
        assert all((l, r) in made for r in range(-2 - (L - l), rows_out + 1 + (L - l)))
    assert all(("u1", r) in made for r in range(-2, rows_out + 1))
    assert all(("r1", r) in made for r in range(-1, rows_out))
    assert made[("r1", rows_out - 1)] == steps - 1
    # the ring holds the rows of 2L + 6 consecutive stages
    assert NF >= 2 * L + 6 and NF & (NF - 1) == 0


@pytest.mark.parametrize("n", SIZES)
def test_restriction_completes_each_coarse_row_once(n):
    # the kernel's parity: r1 row rho = y0 - 3L - 6 + s is odd when
    # (s mod UNR) + L is (y0 and UNR even); an odd rho ends the (1, 2, 1)
    # sum of coarse row (rho - 1) / 2, written at the next step (or after
    # the loop) once s >= 3L + 6
    H, Hc = n + 1, n // 2 + 1
    for L in DEPTHS:
        for strip in STRIPS:
            tiles = hx.e2_tiles(n, L, strip)
            done = np.zeros(Hc, np.int64)
            for by in range(tiles.gy):
                y0 = by * strip
                steps = _strip_rows(n, y0, strip, L)[2]
                started, rows = {}, []
                for s in range(steps):
                    odd = ((s % UNR) + L) & 1 == 1
                    rho = y0 - 3 * L - 6 + s
                    assert (rho % 2 == 1) == odd
                    if odd:
                        if s >= 3 * L + 6:
                            Ic = (rho - 1) // 2
                            assert started[Ic] == (2 * Ic - 1, 2 * Ic + 1)
                            rows.append(Ic)
                        started[(rho + 1) // 2] = (rho, rho + 2)
                assert rows == list(range(y0 // 2, min((y0 + strip) // 2, Hc)))
                # the row finished after the loop
                assert (y0 - L - 3 + steps - 1 - 2 * L - 4) >> 1 == rows[-1]
                done[rows] += 1
            assert (done == 1).all()
            # columns: the threads' even owned columns own the band's coarse
            # columns once, and the (1, 2, 1) reads at p - 1 .. p + 1 stay
            # inside the columns where r1 is valid (positions L + 1 ..
            # RB - L - 2 of the block's RB computed columns)
            cols = np.zeros(Hc, np.int64)
            for bx in range(tiles.gx):
                x0 = bx * tiles.band
                for t in range(RT):
                    for e in range(RC):
                        p = RC * t + e
                        c = x0 - L - 2 + p
                        own = L + 2 <= p < L + 2 + tiles.band and c < H
                        if c % 2 == 0 and own:
                            cols[c // 2] += 1
                            assert L + 1 <= p - 1 and p + 1 <= RB - L - 2
            assert (cols == 1).all()


@pytest.mark.parametrize("n", SIZES)
def test_partial_buffer_holds_one_sum_per_block(n):
    geoms = [hx.e2_tiles(n, L, s) for L in DEPTHS for s in STRIPS] + [hx.e2_one_pass_tiles(n)]
    keys = set()
    for tiles in geoms:
        ws = {}
        partial, done = hx.row_scratch(tiles, 1, torch.device("cpu"), ws)
        assert partial.numel() == tiles.blocks and partial.dtype == torch.float32
        assert done.dtype == torch.int32 and int(done) == 0
        again = hx.row_scratch(tiles, 1, torch.device("cpu"), ws)
        assert again[0] is partial and again[1] is done
        keys |= set(ws)
    # E2's keys differ by depth, from its tile's and from E1's, whose tile
    # has the same grid
    assert len(keys) == len(geoms)
    others = {("row_scratch", t) for t in (hx.e1_one_pass_tiles(n), hx.e1_tiles(n, 1),
                                           hx.e1_tiles(n, 3))}
    others |= {sw._partials_key(which, n) for which in (0, 1, 2)}
    assert not keys & others


class _Props:
    multi_processor_count = 132


@pytest.mark.parametrize("n", SIZES + [130, 1024])
def test_wrapper_takes_the_size_choice(n, monkeypatch):
    # the geometry e2_launch_tiles gives the wrapper on a card of 132 SMs
    # whose library reports 5 (L = 1) or 4 (L = 3) resident blocks
    asked = []

    def occupancy(symbol, *args):
        asked.append((symbol, args))
        return 5 if args[2] == 1 else 4

    monkeypatch.setattr(hx, "occupancy", occupancy)
    monkeypatch.setattr(hx, "_E2_TILES", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    dev = torch.device("cuda", 0)
    for L in DEPTHS:
        for bim, dform in ((False, False), (True, True), (True, False)):
            tiles = hx.e2_launch_tiles(n, L, bim, dform, dev)
            if n <= hx.E2_ONE_PASS_MAX_N[L]:
                assert tiles == hx.e2_one_pass_tiles(n) and tiles.leg == "E2_tile"
                continue
            slots = 132 * (5 if L == 1 else 4)
            want = hx.row_strip(lambda s, L=L: hx.e2_tiles(n, L, s), hx.e2_halo_steps(L), slots,
                                132)
            assert tiles == hx.e2_tiles(n, L, want) and tiles.leg == "E2"
            assert asked[-1] == ("mg_hswrr_occupancy", (int(bim), int(dform), L))
            count = len(asked)
            assert hx.e2_launch_tiles(n, L, bim, dform, dev) is tiles
            assert len(asked) == count
    assert not asked if n <= min(hx.E2_ONE_PASS_MAX_N.values()) else asked


def test_block_shape_matches_the_kernel():
    # the kernel refuses a grid computed for another block shape; the
    # constants here must be csrc/common.cuh's and csrc/hrelax.cu's
    common = (CSRC / "common.cuh").read_text()
    src = (CSRC / "hrelax.cu").read_text()

    def const(name, text):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert (const("RT", common), const("RC", common), const("RD", common)) == (RT, RC, RD)
    assert const("RS_STRIP_MAX", common) == sw.A12_STRIP_MAX
    assert const("E2_UNR", src) == UNR
    body = src[src.index("e2_descent_rows("):]
    body = body[:body.index("\n}\n")]
    assert "constexpr int BW = RB - 2 * L - 4;" in body
    assert "constexpr int NF = L == 1 ? 8 : 16;" in body
    assert "c0 = x0 - L - 2 + RC * t, col = x0 - L - 3, base = y0 - L - 3;" in body
    assert "const int rows_out = SLAB ? min(strip, HR - y0) : min(strip, H + 1 - y0);" in body
    assert "staged = rows_out + 2 * L + 5, steps = rows_out + 3 * L + 6;" in body
    assert "pending = odd && s >= 3 * L + 6;" in body
    assert "constexpr bool odd = ((I + L) & 1) != 0;" in body
    assert "col_own[e] = p >= L + 2 && p < L + 2 + BW && c < H;" in body
    grid = src[src.index("inline bool e2_grid_ok("):]
    grid = grid[:grid.index("\n}\n")]
    assert "return descent_grid_ok(n, L, one_pass, strip, gx, gy);" in grid
    grid = common[common.index("inline bool descent_grid_ok("):]
    grid = grid[:grid.index("\n}\n")]
    assert "bw = (RB - 2 * L - 4) / 2" in grid and "gx == (Hc + bw - 1) / bw" in grid
    assert "coarse_grid(n)" in grid
    entry = src[src.index("int mg_hswrr("):]
    assert entry[:entry.index("\n}\n")].count("e2_grid_ok(n, L, one_pass != 0, strip, gx, gy)") == 1
    for L in DEPTHS:
        assert hx.e2_halo_steps(L) == 3 * L + 6
    # the wrapper refuses fields off a 16-byte boundary before it launches
    assert '_check_aligned(("u", u), ("f", f), ("phase", ph))' in inspect.getsource(hx.hswrr_cuda)
    with pytest.raises(ValueError):
        hx.e2_tiles(8, 1, 3)
    with pytest.raises(ValueError):
        hx.e2_tiles(8, 3, sw.A12_STRIP_MAX + 2)
