"""Launch geometry of the row-streaming G4 and A5 (``ops/elastic.py``
``g4_tiles`` / ``g4_one_pass_tiles`` / ``g4_halo_steps`` /
``g4_launch_tiles``, ``ops/sweep.py`` ``a5_tiles`` / ``a5_one_pass_tiles`` /
``a5_launch_tiles``): the Python side of what the wrappers pass to
``csrc/elastic.cu``'s ``g4_el_zdescent_rows`` and ``csrc/sweep.cu``'s
``a5_resid_restrict_rows``, checked without a card.

For every even n from 2 to 64, around each one-pass threshold and at 126,
1000, 1024, 2048 and 4096: the bands and strips own each fine and coarse
node exactly once, and the one-pass tiles each coarse node once; every
staged row's 16-byte chunks (both components of G4's f, counted from the
field's base as ``stage_plane`` stages them, and G4's element rows; A5's u,
f and phase rows, staged together by ``stage_uf``, in f32 and bf16
storage) stay inside the allocation and their plane and cover their
windows, which hold every column the threads read; each stage reads only
rows staged or finished at an earlier step (or by the step's own stage)
that its ring still holds, and a strip takes ``g4_halo_steps`` /
``A5_HALO_STEPS`` steps beyond the fine rows it restricts; the
restriction's row parity completes each coarse row of a strip once and its
columns each coarse column of a band once; A5's partial buffer holds one
float per block under a key of its own; the wrappers take the one-pass tile
up to ``G4_ONE_PASS_MAX_N[bim]`` / ``A5_ONE_PASS_MAX_N[bim]`` and
``row_strip``'s strip above it, for the occupancy the card reports; and
the block shape and formulas here are the kernels'.  ``chip_smoke.py``
holds the kernels themselves at ragged sizes on the card.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multigrid_feanet_torch.ops import elastic as eg
from multigrid_feanet_torch.ops import hrelax as hx
from multigrid_feanet_torch.ops import sweep as sw
from test_torch_elastic_tiles import _check_stack
from test_torch_sweep_tiles import _check_windows, _cover_once, _slot_sizes

THRESHOLDS = set(eg.G4_ONE_PASS_MAX_N.values()) | set(sw.A5_ONE_PASS_MAX_N.values())
SIZES = sorted(set(range(2, 65, 2)) | {126, 1000, 1024, 2048, 4096}
               | {t + d for t in THRESHOLDS for d in (-2, 0, 2) if t + d >= 2})
STRIPS = (2, 8, 30, 32, sw.A12_STRIP_MAX)
CSRC = Path(eg.__file__).resolve().parent.parent / "csrc"
RT, RC = sw.A12_THREADS, sw.A12_COLUMNS  # common.cuh's RT, RC; sweep.cu's ST, SC
RB = RT * RC
BW = RB - 2                  # owned columns of a band, both legs
RW = RB + 2                  # G4's staged f window (floats); A5's u / f window (SW)
G4_RWQ = RB + 3              # G4's staged element window (bytes)
G4_SLOTQ = (G4_RWQ + 30) // 16 * 16
SWQ = RB + 1                 # A5's staged phase window (bytes)
RD, RNS, UNR = 2, 3, 6       # rows staged ahead, ring slots, steps per trip (both legs)
LEGS = {"G4": (eg.g4_tiles, eg.g4_one_pass_tiles, eg.g4_halo_steps()),
        "A5": (sw.a5_tiles, sw.a5_one_pass_tiles, sw._HALO_STEPS["A5"])}


class Geo:
    """One row-streaming block of G4 or A5 as the kernel computes it: step s
    stages row ``base + s`` (G4: both f components and the element row; A5:
    u, f and the phase row), a thread's first column is ``c00 + RC t``."""

    def __init__(self, leg, n, strip, x0, y0):
        H = n + 1
        self.leg, self.n, self.strip, self.x0, self.y0 = leg, n, strip, x0, y0
        self.rows_out = min(strip, H + 1 - y0)  # fine rows the strip restricts
        self.steps = self.rows_out + LEGS[leg][2]
        self.c00, self.col = x0 - 1, x0 - 2
        self.qcol = x0 - 3 if leg == "G4" else x0 - 2
        self.base = y0 - 3 if leg == "G4" else y0 - 2  # rho, step s's r1 row: base + s - 1

    def rows(self):
        return self.base + np.arange(self.steps)


def _geos(leg, n, strip):
    tiles = LEGS[leg][0](n, strip)
    for by in range(tiles.gy):
        for bx in range(tiles.gx):
            yield Geo(leg, n, strip, bx * tiles.band, by * strip)


@pytest.mark.parametrize("n", SIZES)
def test_bands_and_strips_own_each_node_once(n):
    H, Hc = n + 1, n // 2 + 1
    for leg, (tiles_of, one_of, _) in LEGS.items():
        for strip in STRIPS:
            tiles = tiles_of(n, strip)
            assert (tiles.leg, tiles.band, tiles.strip) == (leg, BW, strip)
            assert _cover_once(np.arange(tiles.gx) * BW, BW, H)
            assert _cover_once(np.arange(tiles.gy) * strip, strip, H)
            assert _cover_once(np.arange(tiles.gx) * BW // 2, BW // 2, Hc)
            assert _cover_once(np.arange(tiles.gy) * strip // 2, strip // 2, Hc)
        one = one_of(n)
        assert (one.leg, one.band, one.strip) == (leg + "_tile", 32, 16)
        assert one == hx.coarse_tiles(leg + "_tile", n)
        assert _cover_once(np.arange(one.gx) * 16, 16, Hc)
        assert _cover_once(np.arange(one.gy) * 8, 8, Hc)
    # a block's threads: owned positions p = RC t + e in [1, 1 + BW) are the
    # band [x0, x0 + BW); the residual's positions [0, RB) reach one column
    # past it on each side, G4's u1 (one more on each side of a thread's
    # columns) two
    p = np.arange(RB)
    own = (p >= 1) & (p < 1 + BW)
    assert own.sum() == BW and p[own][0] - 1 == 0
    assert p.min() - 1 == -1 and p.max() - 1 == BW  # r1 at x0 - 1 .. x0 + BW
    assert p.min() - 2 == -2 and p.max() - 1 + 1 == BW + 1  # u1 at x0 - 2 .. x0 + BW + 1


@pytest.mark.parametrize("n", SIZES)
def test_staging_windows_stay_inside_the_allocation(n):
    H = n + 1
    # the largest levels with a ragged strip and the tallest only: their
    # thousands of blocks repeat the smaller levels' cases
    for strip in STRIPS if n <= 1024 else (30, sw.A12_STRIP_MAX):
        g4 = list(_geos("G4", n, strip))
        rows = np.concatenate([g.rows() for g in g4])
        # both components of f from col = x0 - 2 (the threads' u1 columns
        # x0 - 2 .. x0 + RB - 1), counted from the field's base
        cols = np.concatenate([np.full(g.steps, g.col) for g in g4])
        _check_stack(2, rows, cols, H, H, 4, _slot_sizes(4)[0], RW)
        # the element rows from qcol = x0 - 3 (the zero guesses' elements
        # x0 - 3 .. x0 + RB - 1)
        qcols = np.concatenate([np.full(g.steps, g.qcol) for g in g4])
        _check_windows(((rows, qcols, n, n, n * n, 16, G4_SLOTQ, G4_RWQ),))
        a5 = list(_geos("A5", n, strip))
        rows = np.concatenate([g.rows() for g in a5])
        cols = np.concatenate([np.full(g.steps, g.col) for g in a5])
        for elems in (4, 8):  # f32 and bf16 node fields
            slot_f, slot_q = _slot_sizes(elems)
            _check_windows(((rows, cols, H, H, H * H, elems, slot_f, RW),
                            (rows, cols, n, n, n * n, 16, slot_q, SWQ)))
    # the windows hold every column the threads read: G4 f at positions
    # RC t .. RC t + RC + 1 and elements RC t .. RC t + RC + 2; A5 u at
    # SC t .. SC t + SC + 1, f at SC t + 1 .. SC t + SC, elements SC t ..
    # SC t + SC
    t = RT - 1
    assert RC * t + RC + 1 < RW and RC * t + RC + 2 < G4_RWQ
    assert RC * t + RC + 1 < RW and RC * t + RC < SWQ
    assert G4_SLOTQ // 16 <= RT and _slot_sizes(4)[0] // 4 <= 96 and _slot_sizes(4)[1] // 16 <= 32


def _ring_holds(stage, s, nf):
    """Whether slot ``stage mod nf`` still holds stage ``stage`` at step s: no
    stage issued by then (those of steps up to s + RD) reuses it."""
    return stage >= 0 and all((m - stage) % nf for m in range(stage + 1, s + RD + 1))


@pytest.mark.parametrize("rows_out", [2, 4, 8, 30, 32, sw.A12_STRIP_MAX])
def test_g4_reads_only_rows_of_earlier_steps(rows_out):
    # rows relative to y0 = 0; step s stages f and the element row R = base
    # + s (stage s, slot s mod RNS), reads the element row R and f of row R
    # into its rings (3 and 2 rows), builds u1 at row R (s >= 1) from f row
    # R and element rows R - 1, R, and computes r1 at rho = R - 1 (s >= 3)
    # from u1 rows R - 2 .. R, element rows R - 2, R - 1 and f row R - 1
    g = Geo("G4", 10 ** 6, rows_out, 0, 0)
    assert g.steps == rows_out + eg.g4_halo_steps() == rows_out + 4
    read, built, out = {}, {}, {}
    for s in range(g.steps):
        R = g.base + s
        assert _ring_holds(s, s, RNS)  # this step's stage is in its slot
        read[("q", R)] = read[("f", R)] = s
        if s >= 1:
            assert s - read[("q", R - 1)] == 1  # the element ring holds it
            built[R] = s
        if s >= 3:
            rho = R - 1
            for m in (rho - 1, rho, rho + 1):
                assert s - built[m] <= 2  # the u1 ring's three rows
            assert s - read[("q", rho - 1)] <= 2 and s - read[("q", rho)] <= 2
            assert s - read[("f", rho)] == 1  # f's two-row ring
            out[rho] = s
    # every r1 row the restriction reads (y0 - 1 .. y0 + rows_out - 1) is
    # made, the last at the last step, and u1 at every row those read
    assert sorted(out) == list(range(-1, rows_out)) and out[rows_out - 1] == g.steps - 1
    assert sorted(built) == list(range(-2, rows_out + 1))
    assert UNR % RNS == 0 and UNR % 3 == 0 and UNR % 2 == 0


@pytest.mark.parametrize("rows_out", [2, 4, 8, 30, 32, sw.A12_STRIP_MAX])
def test_a5_reads_only_rows_of_earlier_steps(rows_out):
    # rows relative to y0 = 0; step s stages u, f and the phase row R =
    # base + s (stage s, slot s mod RNS), reads them into its rings (u and
    # elements 3 rows, f 2) and computes r at rho = R - 1 (s >= 2) from u
    # rows R - 2 .. R, element rows R - 2, R - 1 and f row R - 1
    g = Geo("A5", 10 ** 6, rows_out, 0, 0)
    assert g.steps == rows_out + sw._HALO_STEPS["A5"] == rows_out + 3
    read, out = {}, {}
    for s in range(g.steps):
        R = g.base + s
        assert _ring_holds(s, s, RNS)
        for field in ("u", "f", "q"):
            read[(field, R)] = s
        if s >= 2:
            rho = R - 1
            assert [s - read[("u", m)] for m in (rho - 1, rho, rho + 1)] == [2, 1, 0]
            assert s - read[("q", rho - 1)] == 2 and s - read[("q", rho)] == 1
            assert s - read[("f", rho)] == 1
            out[rho] = s
    assert sorted(out) == list(range(-1, rows_out)) and out[rows_out - 1] == g.steps - 1
    # the rows staged: -2 .. rows_out, each by its own step
    assert g.rows()[0] == -2 and g.rows()[-1] == rows_out


@pytest.mark.parametrize("n", SIZES)
def test_restriction_completes_each_coarse_node_once(n):
    # the kernels' parity: r1 row rho = base + s - 1 (G4: y0 - 4 + s, odd at
    # odd s; A5: y0 - 3 + s, odd at even s; s has the parity of the unrolled
    # step I = s mod UNR); an odd rho ends the (1, 2, 1) sum of coarse row
    # (rho - 1) / 2, written at the next step (or after the loop) from step
    # 5 (G4) or 4 (A5) on
    H, Hc = n + 1, n // 2 + 1
    for leg, (tiles_of, _, _) in LEGS.items():
        first = 5 if leg == "G4" else 4
        for strip in STRIPS:
            tiles = tiles_of(n, strip)
            done = np.zeros(Hc, np.int64)
            for by in range(tiles.gy):
                g = Geo(leg, n, strip, 0, by * strip)
                started, rows = {}, []
                for s in range(g.steps):
                    I = s % UNR
                    odd = (I & 1) != 0 if leg == "G4" else (I & 1) == 0
                    rho = g.base + s - 1
                    assert (rho % 2 == 1) == odd
                    if odd:
                        if s >= first:
                            Ic = (rho - 1) // 2
                            assert started[Ic] == (2 * Ic - 1, 2 * Ic + 1)
                            rows.append(Ic)
                        started[(rho + 1) // 2] = (rho, rho + 2)
                assert rows == list(range(g.y0 // 2, min((g.y0 + strip) // 2, Hc)))
                assert (g.y0 + g.rows_out - 2) >> 1 == rows[-1]  # finished after the loop
                done[rows] += 1
            assert (done == 1).all(), (leg, strip)
            # columns: a thread's even owned column (c0 + 1, c0 = x0 - 1 + RC t
            # odd) owns the band's coarse column once, from r1 at positions p -
            # 1 .. p + 1 inside the block's [0, RB)
            cols = np.zeros(Hc, np.int64)
            for bx in range(tiles.gx):
                x0 = bx * BW
                for t in range(RT):
                    for e in range(RC):
                        c, p = x0 - 1 + RC * t + e, RC * t + e
                        if c % 2 == 0 and 1 <= p < 1 + BW and c < H:
                            cols[c // 2] += 1
                            assert 0 <= p - 1 and p + 1 <= RB - 1
            assert (cols == 1).all(), (leg, strip)


@pytest.mark.parametrize("n", SIZES)
def test_a5_partial_buffer_holds_one_sum_per_block(n):
    geoms = [sw.a5_tiles(n, s) for s in STRIPS] + [sw.a5_one_pass_tiles(n)]
    keys = set()
    for tiles in geoms:
        ws = {}
        partial, done = sw._tile_scratch(tiles, torch.device("cpu"), ws)
        assert partial.numel() == tiles.blocks and partial.dtype == torch.float32
        assert done.dtype == torch.int32 and int(done) == 0
        again = sw._tile_scratch(tiles, torch.device("cpu"), ws)
        assert again[0] is partial and again[1] is done
        keys |= set(ws)
    # A5's keys differ from each other's, from A1's, A2's and the row-streaming
    # A6's and from the A6 tile's partials, which have the one-pass grid
    assert len(keys) == len(geoms)
    others = {sw._tiles_key(fn(n, s)) for s in STRIPS for fn in (sw.a1_tiles, sw.a2_tiles,
                                                                  sw.a6_tiles)}
    others |= {sw._partials_key(which, n) for which in (0, 1, 2)}
    assert not keys & others


class _Props:
    multi_processor_count = 132


@pytest.mark.parametrize("n", SIZES + [130, 258])
def test_wrappers_take_the_size_choice(n, monkeypatch):
    # the geometry g4_launch_tiles and a5_launch_tiles give the wrappers on a
    # card of 132 SMs whose library reports 5 resident G4 blocks and 6 + bim
    # + bf16 A5 blocks
    asked = []

    def occupancy(symbol, *args):
        asked.append((symbol, args))
        if symbol == "mg_el_zrr_occupancy":
            return 5
        assert symbol == "mg_rr_occupancy"
        return 6 + args[0] + args[2]

    monkeypatch.setattr(hx, "occupancy", occupancy)
    monkeypatch.setattr(eg, "_G4_TILES", {})
    monkeypatch.setattr(sw, "_A5_TILES", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    dev = torch.device("cuda", 0)
    for bim in (False, True):
        before = len(asked)
        tiles = eg.g4_launch_tiles(n, bim, dev)
        if n <= eg.G4_ONE_PASS_MAX_N[bim]:
            assert tiles == eg.g4_one_pass_tiles(n) and tiles.leg == "G4_tile"
            assert len(asked) == before
        else:
            want = hx.row_strip(lambda s: eg.g4_tiles(n, s), eg.g4_halo_steps(), 132 * 5, 132)
            assert tiles == eg.g4_tiles(n, want) and tiles.leg == "G4"
            assert asked[before:] == [("mg_el_zrr_occupancy", (int(bim),))]
            assert eg.g4_launch_tiles(n, bim, dev) is tiles and len(asked) == before + 1
        for form, bf16 in ((1, 0), (0, 1), (2, 0)):
            before = len(asked)
            tiles = sw.a5_launch_tiles(n, bim, form, dev, bf16)
            if n <= sw.A5_ONE_PASS_MAX_N[bim]:
                assert tiles == sw.a5_one_pass_tiles(n) and tiles.leg == "A5_tile"
                assert len(asked) == before
                continue
            slots = 132 * (6 + int(bim) + bf16)
            want = hx.row_strip(lambda s: sw.a5_tiles(n, s), sw._HALO_STEPS["A5"], slots, 132)
            assert tiles == sw.a5_tiles(n, want) and tiles.leg == "A5"
            assert asked[before:] == [("mg_rr_occupancy", (int(bim), form, bf16))]
            assert sw.a5_launch_tiles(n, bim, form, dev, bf16) is tiles
            assert len(asked) == before + 1


def _const(name, text):
    return re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)


def _body(text, name):
    body = text[text.index(name + "("):]
    return body[:body.index("\n}\n")]


def test_block_shape_matches_the_kernels():
    # the kernels refuse a grid computed for another block shape; the
    # constants and formulas here must be csrc/common.cuh's, elastic.cu's and
    # sweep.cu's
    common = (CSRC / "common.cuh").read_text()
    el = (CSRC / "elastic.cu").read_text()
    sweep = (CSRC / "sweep.cu").read_text()
    assert (int(_const("RT", common)), int(_const("RC", common))) == (RT, RC)
    assert (int(_const("RD", common)), _const("RNS", common)) == (RD, "RD + 1")
    assert (int(_const("ST", sweep)), int(_const("SC", sweep)), int(_const("SD", sweep))) == (
        RT, RC, RD)
    assert _const("RW", common) == "RB + 2" and _const("SW", sweep) == "SB + 2"
    assert _const("SWQ", sweep) == "SB + 1"
    # G4
    assert int(_const("G4_UNR", el)) == UNR and _const("G4_RWQ", el) == "RB + 3"
    assert _const("G4_SLOTQ", el) == "(G4_RWQ + 15 + 15) / 16 * 16"
    g4 = _body(el, "g4_el_zdescent_rows")
    assert "constexpr int BW = RB - 2;" in g4
    assert "const int c0 = x0 - 1 + RC * t, col = x0 - 2, qcol = x0 - 3, base = y0 - 3;" in g4
    assert "const int rows_out = min(strip, H + 1 - y0);" in g4
    assert "const int steps = rows_out + 4;" in g4
    assert "constexpr bool odd = (I & 1) != 0;" in g4 and "pending = odd && s >= 5;" in g4
    assert "if (s >= 1 && busy) {" in g4 and "if (s >= 3 && busy) {" in g4
    assert "col_own[e] = p >= 1 && p < 1 + BW && c < H;" in g4
    assert "const bool busy = x0 - 1 + RC * (t & ~31) < H;" in g4
    assert "stage_window<1, G4_RWQ>" in g4 and g4.count("stage_plane<4, RW>") == 1
    grid = _body(el, "inline bool g4_grid_ok")
    assert "bw = (RB - 2) / 2, sh = strip / 2" in grid and "coarse_grid(n)" in grid
    assert "gx == (Hc + bw - 1) / bw" in grid and "gy == (Hc + sh - 1) / sh" in grid
    assert _body(el, "int mg_el_zrr").count("g4_grid_ok(n, one_pass != 0, strip, gx, gy)") == 1
    # A5
    assert _const("A5_BW", sweep) == "SB - 2" and int(_const("A5_HALO_STEPS", sweep)) == 3
    assert sw._HALO_STEPS["A5"] == 3 and int(_const("UNR", sweep)) == UNR
    a5 = _body(sweep, "a5_resid_restrict_rows")
    assert "c0 = x0 - 1 + SC * t;" in a5 and "const int col = x0 - 2, base = y0 - 2;" in a5
    assert "const int rows_out = min(strip, H + 1 - y0);" in a5
    assert "const int steps = rows_out + A5_HALO_STEPS;" in a5
    assert "constexpr bool odd = (I & 1) == 0;" in a5 and "pending = odd && s >= 4;" in a5
    assert "if (s >= 2) {" in a5 and "col_own[e] = p >= 1 && p < A5_BW + 1 && c < H;" in a5
    assert "finish_norm(rr, partial, done, rsq);" in a5
    assert "stage_uf(zc, u, f, ph, R + SD, n, col, (slot + SD) % SNS, s + SD < steps);" in a5
    grid = _body(sweep, "inline bool a5_grid_ok")
    assert "bw = A5_BW / 2, sh = strip / 2" in grid
    # one launch per row-streaming A5 call (its norm finished in its last
    # block); the one-pass tile's partials take the second pass
    entry = _body(sweep, "int mg_rr")
    assert "a5_grid_ok(n, strip, gx, gy)" in entry
    assert "  if (one_pass) reduce_kernel<<<1, NT, 0, st>>>(partial, (int)(g.x * g.y), rsq);" in entry
    assert entry.count("reduce_kernel") == 1
    assert "partial[blockIdx.y * gridDim.x + blockIdx.x] = rr;" in _body(sweep, "a5_resid_restrict")
    # the wrappers refuse fields off a 16-byte boundary before they launch
    assert '_check_aligned(("f", f), ("phase", ph))' in inspect.getsource(eg.el_zrr_cuda)
    assert '_check_aligned(("u", u), ("f", f), ("phase", ph))' in inspect.getsource(sw.rr_cuda)
    # the ctypes signatures: G4 f, ph, out; n and the nine constants, bim;
    # one_pass, strip, gx, gy; stream.  A5 u, f, ph, fc, partial, done, rsq;
    # n; a0, da, mp, ms, mo; bim, form, bf16, one_pass, strip, gx, gy; stream
    assert len(eg.KERNELS["G4"]._argtypes) == 3 + 11 + 4 + 1
    assert len(sw.KERNELS["A5"]._argtypes) == 7 + 1 + 5 + 7 + 1
    for limit in (eg.G4_ONE_PASS_MAX_N, sw.A5_ONE_PASS_MAX_N):
        assert set(limit) == {True, False}
    for tiles_of in (eg.g4_tiles, sw.a5_tiles):
        with pytest.raises(ValueError):
            tiles_of(8, 3)
        with pytest.raises(ValueError):
            tiles_of(8, sw.A12_STRIP_MAX + 2)
