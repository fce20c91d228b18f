"""Launch geometry of the row-streaming A6 (``ops/sweep.py`` ``a6_tiles``,
``a6_one_pass_tiles``, ``a6_launch_tiles``): the Python side of what the
wrapper passes to ``csrc/sweep.cu``'s ``a6_cross_cycle_rows``, checked
without a card.

For every even n from 2 to 64 and for n in {126, 128, 510, 512, 514, 1000,
2048, 4096}: the bands and strips own each fine node (u4, the norm) and
each coarse node (f_c) exactly once, and the one-pass tiles each coarse
node once; every staged row's 16-byte chunks, u1, f and the phases, stay
inside the allocation and cover the window, in float32 and bfloat16
storage; the staged coarse rows hold every coarse value the prolongation
reads and the clamp never moves a row a live step reads; the chain's
layers read only rows finished at earlier steps; the restriction's row
parity completes each coarse row of the strip once, from the r4 rows
around it, and its columns each coarse column of the band once; the
partial buffer holds one float per block; and the wrapper takes the
one-pass tile up to ``A6_ONE_PASS_MAX_N`` and ``balanced_strip``'s strip
above it.  The index arithmetic mirrors the kernel's; ``chip_smoke.py``
holds the kernel itself at ragged sizes on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multigrid_feanet_torch.ops import sweep as sw
from test_torch_sweep_tiles import _check_windows, _cover_once, _slot_sizes

SIZES = list(range(2, 65, 2)) + [126, 128, 510, 512, 514, 1000, 2048, 4096]
STRIPS = (2, 8, 30, sw.A12_STRIP, sw.A12_STRIP_MAX)
SOURCE = Path(sw.__file__).resolve().parent.parent / "csrc" / "sweep.cu"
ST, SC = sw.A12_THREADS, sw.A12_COLUMNS
SB = ST * SC
BW = SB - 6               # owned columns of a band
SCW = SB // 2 + 3         # staged coarse columns
UNR, NQ = 6, 6            # steps per trip; element / f rows kept in registers
HALO = sw._HALO_STEPS["A6"]


def _strip_rows(n, y0, strip):
    """(rows_out, staged, steps) of the strip at y0: the fine rows it
    restricts, the steps that stage a u1 row and all its steps."""
    rows_out = min(strip, n + 2 - y0)
    return rows_out, rows_out + HALO - 2, rows_out + HALO


@pytest.mark.parametrize("n", SIZES)
def test_bands_and_strips_own_each_node_once(n):
    H, Hc = n + 1, n // 2 + 1
    for strip in STRIPS:
        tiles = sw.a6_tiles(n, strip)
        assert (tiles.leg, tiles.band, tiles.strip) == ("A6", BW, strip)
        fine, coarse = np.zeros((H, H), np.uint8), np.zeros((Hc, Hc), np.uint8)
        for by in range(tiles.gy):
            y0 = by * strip
            assert y0 % 2 == 0 and y0 < H
            for bx in range(tiles.gx):
                x0 = bx * BW
                fine[y0:y0 + strip, x0:x0 + BW] += 1
                coarse[y0 // 2:(y0 + strip) // 2, x0 // 2:(x0 + BW) // 2] += 1
        assert (fine == 1).all() and (coarse == 1).all(), tiles
    one = sw.a6_one_pass_tiles(n)
    assert (one.leg, one.band, one.strip) == ("A6_tile", 32, 16)
    assert _cover_once(np.arange(one.gx) * 16, 16, Hc) and _cover_once(np.arange(one.gy) * 8, 8, Hc)


def _staged_rows(tiles):
    """(u1 row, f and phase row, window column) of every staging step."""
    us, fs, cols = [], [], []
    for by in range(tiles.gy):
        y0 = by * tiles.strip
        s = np.arange(_strip_rows(tiles.n, y0, tiles.strip)[1])
        for bx in range(tiles.gx):
            us.append(y0 - 4 + s)
            fs.append(y0 - 5 + s)
            cols.append(np.full(len(s), bx * BW - 4))
    return np.concatenate(us), np.concatenate(fs), np.concatenate(cols)


@pytest.mark.parametrize("n", SIZES)
def test_staging_windows_stay_inside_the_allocation(n):
    H = n + 1
    for strip in (2, sw.A12_STRIP):
        u_rows, f_rows, cols = _staged_rows(sw.a6_tiles(n, strip))
        for elems in (4, 8):  # float32 and bf16 node fields
            slot_f, slot_q = _slot_sizes(elems)
            _check_windows(((u_rows, cols, H, H, H * H, elems, slot_f, SB + 2),
                            (f_rows, cols, H, H, H * H, elems, slot_f, SB + 2),
                            (f_rows, cols, n, n, n * n, 16, slot_q, SB + 1)))


@pytest.mark.parametrize("n", SIZES)
def test_coarse_rows_hold_what_the_prolongation_reads(n):
    # step s widens u1 row R = y0 - 4 + s: staged coarse row s >> 1 is
    # coarse row R >> 1 (and s >> 1 + 1 the next, for odd R), columns t .. t
    # + 2 for thread t; the kernel clamps the row to CR - 1 - (s & 1), which
    # must not move a row a staging step reads
    H, Hc = n + 1, n // 2 + 1
    for strip in STRIPS:
        tiles = sw.a6_tiles(n, strip)
        CR = strip // 2 + 4
        for by in range(tiles.gy):
            y0 = by * strip
            ci0 = y0 // 2 - 2
            staged = _strip_rows(n, y0, strip)[1]
            for s in range(_strip_rows(n, y0, strip)[2]):
                R = y0 - 4 + s
                r = min(s >> 1, CR - 1 - (s & 1))
                assert 0 <= r and r + (s & 1) < CR
                if s < staged:
                    assert r == (R >> 1) - ci0
                    if 1 <= R <= H - 2:  # an interior row reads coarse rows on the grid
                        assert 0 <= ci0 + r and ci0 + r + (R & 1) < Hc
        for bx in range(tiles.gx):
            cj0 = bx * BW // 2 - 2
            t = np.arange(ST)
            c0 = bx * BW - 3 + SC * t
            assert ((c0 - 1) // 2 - cj0 == t).all()  # the thread's first coarse column
            assert t.max() + 2 < SCW
    # the largest strip's coarse rows with the static shared memory fit the SM
    static = 4 * (2 * 3 * (SB + 2 + 6) + 2 * 2 * (SB + 2) + 2 * SB + ST // 32) + 3 * 272 + 8 * ST
    assert 4 * (sw.A12_STRIP_MAX // 2 + 4) * SCW + static <= 227 * 1024


@pytest.mark.parametrize("rows_out", [2, 4, 8, 30, 32, sw.A12_STRIP_MAX])
def test_chain_reads_only_rows_of_earlier_steps(rows_out):
    # step s: u2 row R (pointwise), u3 row R - 1 (from u2 rows R - 2 .. R,
    # own registers), u4 row R - 3 (u3 rows R - 4 .. R - 2: row R - 2 from
    # the ring, written at step s - 1), r4 row R - 5 (u4 rows R - 6 .. R - 4)
    y0 = 0
    steps = rows_out + HALO
    made = {"u2": {}, "u3": {}, "u4": {}}
    for s in range(steps):
        R = y0 - 4 + s
        for layer, row, src, lag in (("r4", R - 5, "u4", R - 4), ("u4", R - 3, "u3", R - 2)):
            for need in (lag - 2, lag - 1, lag):
                if need >= y0 - 4 + 1:  # rows from the first one the strip computes
                    assert made[src].get(need, s) < s, (layer, row, need)
            if layer == "u4":
                made["u4"][row] = s
        made["u2"][R] = s
        for need in (R - 2, R - 1, R):
            assert made["u2"].get(need, -1) <= s
        made["u3"][R - 1] = s
    # every owned u4 row and every r4 row the restriction needs is made
    for i in range(y0, y0 + rows_out):
        assert i in made["u4"]
    for rho in range(y0 - 1, y0 + rows_out):
        assert all(r in made["u4"] for r in (rho - 1, rho, rho + 1))


@pytest.mark.parametrize("n", SIZES)
def test_restriction_completes_each_coarse_row_once(n):
    # the kernel's parity: r4 row rho = y0 - 9 + s is odd at even steps (the
    # unrolled step's I = s mod UNR has s's parity); an odd rho ends the
    # (1, 2, 1) sum of coarse row (rho - 1) / 2, written at the next step
    # (or after the loop), from step 10 on
    Hc = n // 2 + 1
    for strip in STRIPS:
        tiles = sw.a6_tiles(n, strip)
        done = np.zeros(Hc, np.int64)
        for by in range(tiles.gy):
            y0 = by * strip
            steps = _strip_rows(n, y0, strip)[2]
            started, rows = {}, []
            for s in range(steps):
                odd = ((s % UNR) & 1) == 0
                rho = y0 - 9 + s
                assert (rho % 2 == 1) == odd
                if odd:
                    if s >= 10:
                        Ic = (rho - 1) // 2
                        assert started[Ic] == (2 * Ic - 1, 2 * Ic + 1)
                        rows.append(Ic)
                    started[(rho + 1) // 2] = (rho, rho + 2)
            assert rows == list(range(y0 // 2, min((y0 + strip) // 2, Hc)))
            assert (y0 - 4 + steps - 7) >> 1 == rows[-1]  # the row finished after the loop
            done[rows] += 1
        assert (done == 1).all()
        # columns: the threads' even columns in [x0, x0 + BW) own the band's
        # coarse columns once, and the (1, 2, 1) reads at p - 1 .. p + 1 stay
        # inside the r4 columns the block computes ([x0 - 1, x0 + SB - 6])
        cols = np.zeros(Hc, np.int64)
        for bx in range(tiles.gx):
            x0 = bx * BW
            for t in range(ST):
                for e in range(SC):
                    c, p = x0 - 3 + SC * t + e, SC * t + e
                    own = 3 <= p < BW + 3 and c < n + 1
                    if c % 2 == 0 and own:
                        cols[c // 2] += 1
                        assert x0 - 1 <= c - 1 and c + 1 <= x0 + SB - 6
        assert (cols == 1).all()


@pytest.mark.parametrize("n", SIZES)
def test_partial_buffer_holds_one_sum_per_block(n):
    for strip in (8, sw.A12_STRIP_MAX):
        tiles = sw.a6_tiles(n, strip)
        ws = {}
        partial, done = sw._tile_scratch(tiles, torch.device("cpu"), ws)
        assert partial.numel() == tiles.blocks and partial.dtype == torch.float32
        assert done.dtype == torch.int32 and int(done) == 0
        again = sw._tile_scratch(tiles, torch.device("cpu"), ws)
        assert again[0] is partial and again[1] is done
        keys = {sw._tiles_key(t(n, strip)) for t in (sw.a1_tiles, sw.a2_tiles)}
        assert sw._tiles_key(tiles) not in keys | {sw._partials_key(1, n)}


class _Props:
    multi_processor_count = 132


class _Lib:
    def __init__(self):
        self.asked = []

        def occupancy(*args):
            self.asked.append(args)
            return 4

        self.mg_a12_occupancy = occupancy


@pytest.mark.parametrize("n", SIZES + [130, 256, 258])
def test_wrapper_takes_the_size_choice(n, monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(sw._build, "load", lambda: lib)
    monkeypatch.setattr(sw, "_LAUNCH_TILES", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    dev = torch.device("cuda", 0)
    for bim, form, bf16 in ((True, 1, 0), (False, 0, 1), (True, 2, 0)):
        tiles = sw.a6_launch_tiles(n, bim, form, dev, bf16)
        if n <= sw.A6_ONE_PASS_MAX_N:
            assert tiles == sw.a6_one_pass_tiles(n) and not lib.asked
            continue
        want = sw.balanced_strip("A6", n, lambda s: 4 * 132, 132)
        assert tiles == sw.a6_tiles(n, want)
        assert {a[:5] for a in lib.asked} == {(6, int(bim), form, 0, bf16)}
        lib.asked.clear()


def test_block_shape_matches_the_kernel():
    src = SOURCE.read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = (SB|\d+)(?: - (\d+))?;", src)
        return (SB if m.group(1) == "SB" else int(m.group(1))) - int(m.group(2) or 0)

    assert (const("ST"), const("SC"), const("UNR")) == (ST, SC, UNR)
    assert const("A6_BW") == BW and const("A6_HALO_STEPS") == HALO
    body = src[src.index("a6_cross_cycle_rows("):]
    body = body[:body.index("\n}\n")]
    assert "c0 = x0 - 3 + SC * t" in body and "col = x0 - 4, base = y0 - 4" in body
    assert "CR = strip / 2 + 4" in body and "constexpr int NQ = 6;" in body
    assert "const int rows_out = min(strip, H + 1 - y0);" in body
    assert "pending = odd && s >= 10;" in body
    assert "inline size_t a6_coarse_smem(int strip) { return sizeof(float) * (strip / 2 + 4) * SCW; }" in src
    grid = src[src.index("inline bool a6_grid_ok("):]
    grid = grid[:grid.index("\n}\n")]
    assert "bw = A6_BW / 2" in grid and "gx == (Hc + bw - 1) / bw" in grid
    entry = src[src.index("int mg_pswrr("):]
    entry = entry[:entry.index("\n}\n")]
    assert entry.count("a6_grid_ok(n, strip, gx, gy)") == 1 and "coarse_grid(n)" in entry
    with pytest.raises(ValueError):
        sw.a6_tiles(8, 3)
