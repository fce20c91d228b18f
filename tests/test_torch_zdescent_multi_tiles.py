"""Launch geometry of the row-streaming E4 (``ops/hrelax.py`` ``e4_tiles``,
``e4_one_pass_tiles``, ``e4_halo_steps``, ``e4_launch_tiles``) and C2
(``ops/stencil_sweep.py`` ``c2_tiles``, ``c2_one_pass_tiles``,
``c2_halo_steps``, ``c2_launch_tiles``): the Python side of what the
wrappers pass to ``csrc/hrelax.cu``'s ``e4_h_zdescent_rows`` and
``csrc/stencil.cu``'s ``c2_stencil_multi_rows``, checked without a card.

For every even n from 2 to 64, each side of each one-pass threshold, and
1000, 2048 and 4096, with E4's chain depths L = 1 and 3 and every number of
sweeps C2 streams: E4's bands and strips own each coarse node of f_c once,
C2's each fine node of its output and its norm once, and the one-pass tiles
each node once; every staged row's 16-byte chunks (f, u, the phases and the
pattern ids) stay inside the allocation and cover the window, which holds
the chain's halo; each stage reads only rows finished at earlier steps, and
the f / phase (E4) and f / id (C2) rings still hold every row its last
reader needs; E4's restriction completes each coarse row of its strip once;
C2's partial buffer holds one float per block in both designs; and the
wrappers take the one-pass tile up to ``E4_ONE_PASS_MAX_N[L]`` /
``C2_ONE_PASS_MAX_N[(bim, k)]`` (C2: and for every deeper k) and ``row_strip``'s
strip above.  The index arithmetic mirrors the kernels'; ``chip_smoke.py``
holds the kernels themselves at ragged sizes on the card.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multigrid_feanet_torch.ops import hrelax as hx
from multigrid_feanet_torch.ops import stencil_sweep as ss
from multigrid_feanet_torch.ops import sweep as sw
from test_torch_sweep_tiles import _check_windows, _cover_once

DEPTHS = (1, 3)
KS = tuple(range(1, ss.C2_STREAM_MAX_K + 1))
THRESHOLDS = set(hx.E4_ONE_PASS_MAX_N.values()) | set(ss.C2_ONE_PASS_MAX_N.values())
SIZES = sorted(set(range(2, 65, 2)) | {1000, 2048, 4096}
               | {t + d for t in THRESHOLDS for d in (-2, 0, 2)})
STRIPS = (2, 30, sw.A12_STRIP_MAX)
CSRC = Path(hx.__file__).resolve().parent.parent / "csrc"
RT, RC = sw.A12_THREADS, sw.A12_COLUMNS
RB = RT * RC
RW, RWQ = RB + 2, RB + 1
RSLOT, RSLOTQ = (RW + 6) // 4 * 4, (RWQ + 30) // 16 * 16
RD, UNR = 2, 6  # rows staged ahead; steps per trip of the main loop


def _unique(rows, cols):
    """The distinct (row, column) windows of the staged rows of every
    block (neighbouring strips stage the same halo rows)."""
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    key = np.unique((rows.astype(np.int64) + 8) * (1 << 20) + cols + 4096)
    return key // (1 << 20) - 8, key % (1 << 20) - 4096


def _e4_bw(L):
    return RB - 2 * L - 4


def _e4_nf(L):
    """Slots of E4's f / phase ring: a power of two of at least 2L + 6."""
    return 8 if L == 1 else 16


def _e4_rows(n, y0, strip, L):
    """(rows_out, staged, steps) of E4's strip at y0: the fine rows it
    restricts, the steps that stage rows and all its steps."""
    rows_out = min(strip, n + 2 - y0)
    return rows_out, rows_out + 2 * L + 4, rows_out + hx.e4_halo_steps(L)


def _c2_bw(k):
    return RB - 2 * (k - 1)


def _c2_nf(k):
    """Slots of C2's f / id ring: a power of two of at least 2k + 1."""
    return 4 if k <= 1 else 8 if k <= 3 else 16


def _c2_rows(n, y0, strip, k):
    """(rows_out, staged, steps) of C2's strip at y0."""
    rows_out = min(strip, n + 1 - y0)
    return rows_out, rows_out + 2 * k, rows_out + ss.c2_halo_steps(k)


# ---------------------------------------------------------------------------
# E4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_e4_bands_and_strips_own_each_coarse_node_once(n):
    Hc = n // 2 + 1
    for L in DEPTHS:
        for strip in STRIPS:
            tiles = hx.e4_tiles(n, L, strip)
            assert (tiles.leg, tiles.band, tiles.strip) == ("E4", _e4_bw(L), strip)
            assert tiles.band % 2 == 0
            coarse = np.zeros((Hc, Hc), np.uint8)
            for by in range(tiles.gy):
                y0 = by * strip
                for bx in range(tiles.gx):
                    x0 = bx * tiles.band
                    coarse[y0 // 2:(y0 + strip) // 2, x0 // 2:(x0 + tiles.band) // 2] += 1
            assert (coarse == 1).all(), tiles
    one = hx.e4_one_pass_tiles(n)
    assert (one.leg, one.band, one.strip) == ("E4_tile", 32, 16)
    assert _cover_once(np.arange(one.gx) * 16, 16, Hc) and _cover_once(np.arange(one.gy) * 8, 8, Hc)


@pytest.mark.parametrize("n", SIZES)
def test_e4_staging_windows_stay_inside_the_allocation(n):
    H = n + 1
    for L in DEPTHS:
        f_rows, cols = [], []
        for strip in STRIPS:
            tiles = hx.e4_tiles(n, L, strip)
            for by in range(tiles.gy):
                y0 = by * strip
                rows_out, staged, _ = _e4_rows(n, y0, strip, L)
                rows = y0 - L - 3 + np.arange(staged)  # f and phase row base + s
                # the rows cover the chain's halo: g0 from y0 - L - 2 (u1 at
                # y0 - 2) to y0 + rows_out + L (u1 at y0 + rows_out), the
                # element row under the first
                assert rows[0] == y0 - L - 3 and rows[-1] == y0 + rows_out + L
                for bx in range(tiles.gx):
                    x0 = bx * tiles.band
                    # g0 is computed at the RB columns from x0 - L - 2: its f
                    # at window positions 1 .. RB, its elements at 0 .. RB,
                    # and the owned columns lie L + 2 inside them
                    assert x0 + tiles.band + L + 1 <= x0 - L - 3 + RB
                    f_rows.append(rows)
                    cols.append(np.full(staged, x0 - L - 3))
        f_rows, cols = _unique(f_rows, cols)
        _check_windows(((f_rows, cols, H, H, H * H, 4, RSLOT, RW),
                        (f_rows, cols, n, n, n * n, 16, RSLOTQ, RWQ)))
    assert RSLOT // 4 <= RT and RSLOTQ // 16 <= RT


@pytest.mark.parametrize("L", DEPTHS)
@pytest.mark.parametrize("rows_out", [2, 4, 8, 30, sw.A12_STRIP_MAX])
def test_e4_chain_reads_only_rows_of_earlier_steps(L, rows_out):
    # rows relative to the strip's first row y0 = 0; step s: f and phase row
    # g = base + s staged (stage s), g0 at row g, conv layer l at g - 2l, u1
    # at q = g - 2L (from layer L's row and the g0 row of step s - 2L), r1
    # at rho = q - 2 (from u1 rows rho - 1 .. rho + 1)
    base = -L - 3
    staged, steps = rows_out + 2 * L + 4, rows_out + hx.e4_halo_steps(L)
    NF = _e4_nf(L)
    made = {}  # (stage, row) -> step; stage 0 is g0, l the conv layers, "u1", "r1"
    for s in range(steps):
        g = base + s
        # 2. r1 at rho from the u1 rows of earlier steps (rho + 1: step s - 1)
        q = g - 2 * L
        rho = q - 2
        for need in (rho - 1, rho, rho + 1):
            if ("u1", need) in made:
                assert made[("u1", need)] < s
        made[("r1", rho)] = s
        # 3. conv layers L .. 1 from x_{l-1} rows of earlier steps
        for l in range(L, 0, -1):
            r = g - 2 * l
            for need in (r - 1, r, r + 1):
                if (l - 1, need) in made:
                    assert made[(l - 1, need)] < s
            made[(l, r)] = s
        if (0, q) in made:
            assert made[(0, q)] == s - 2 * L  # the g0 ring of 2L rows returns it
        made[("u1", q)] = s
        # 4. g0 at row g from this step's f row and element rows g - 1, g
        made[(0, g)] = s
        assert g - base == s
        # f row rho and element rows rho - 1, rho come with stages
        # s - 2L - 2 and s - 2L - 3, whose slots no later stage started by
        # step s (stages up to s + RD, the one of this step included) has
        # overwritten
        for m in (s - 2 * L - 2, s - 2 * L - 3):
            if m >= 0:
                assert all((m2 - m) % NF for m2 in range(m + 1, s + RD + 1))
                assert m == (rho if m == s - 2 * L - 2 else rho - 1) - base
    # every g0 row the chain needs is staged (and its element row below)
    for r in range(-L - 2, rows_out + L + 1):
        assert r - base < staged and (0, r) in made and r - 1 - base >= 0
    # every conv row, u1 row and r1 row the strip needs is made
    for l in range(1, L + 1):
        assert all((l, r) in made for r in range(-2 - (L - l), rows_out + 1 + (L - l)))
    assert all(("u1", r) in made for r in range(-2, rows_out + 1))
    assert all(("r1", r) in made for r in range(-1, rows_out))
    assert made[("r1", rows_out - 1)] == steps - 1
    assert NF >= 2 * L + 6 and NF & (NF - 1) == 0


@pytest.mark.parametrize("n", SIZES)
def test_e4_restriction_completes_each_coarse_row_once(n):
    # the kernel's parity: r1 row rho = y0 - 3L - 5 + s is odd when
    # (s mod UNR) + L + 1 is (y0 and UNR even); an odd rho ends the (1, 2, 1)
    # sum of coarse row (rho - 1) / 2, written at the next step (or after
    # the loop) once s >= 3L + 5
    H, Hc = n + 1, n // 2 + 1
    for L in DEPTHS:
        for strip in STRIPS:
            tiles = hx.e4_tiles(n, L, strip)
            done = np.zeros(Hc, np.int64)
            for by in range(tiles.gy):
                y0 = by * strip
                rows_out, _, steps = _e4_rows(n, y0, strip, L)
                started, rows, pending = {}, [], False
                for s in range(steps):
                    odd = ((s % UNR) + L + 1) & 1 == 1
                    rho = y0 - 3 * L - 5 + s
                    assert (rho % 2 == 1) == odd
                    if pending:
                        assert (rho - 2) >> 1 == rows[-1]
                    pending = odd and s >= 3 * L + 5
                    if pending:
                        Ic = (rho - 1) // 2
                        assert started[Ic] == (2 * Ic - 1, 2 * Ic + 1)
                        rows.append(Ic)
                    if odd:
                        started[(rho + 1) // 2] = (rho, rho + 2)
                assert pending and (y0 + rows_out - 2) >> 1 == rows[-1]
                assert rows == list(range(y0 // 2, min((y0 + strip) // 2, Hc)))
                done[rows] += 1
            assert (done == 1).all()
            # columns: the threads' even owned columns own the band's coarse
            # columns once, and the (1, 2, 1) reads at p - 1 .. p + 1 stay
            # inside the columns where r1 is valid (positions L + 1 ..
            # RB - L - 2: g0 on all RB, one column eaten by each conv layer
            # and by the apply)
            cols = np.zeros(Hc, np.int64)
            for bx in range(tiles.gx):
                x0 = bx * tiles.band
                for p in range(RB):
                    c = x0 - L - 2 + p
                    own = L + 2 <= p < L + 2 + tiles.band and c < H
                    if c % 2 == 0 and own:
                        cols[c // 2] += 1
                        assert L + 1 <= p - 1 and p + 1 <= RB - L - 2
            assert (cols == 1).all()


class _Props:
    multi_processor_count = 132


@pytest.mark.parametrize("n", SIZES + [130, 1024])
def test_e4_wrapper_takes_the_size_choice(n, monkeypatch):
    # the geometry e4_launch_tiles gives the wrapper on a card of 132 SMs
    # whose library reports 5 (L = 1) or 4 (L = 3) resident blocks
    asked = []

    def occupancy(symbol, *args):
        asked.append((symbol, args))
        return 5 if args[2] == 1 else 4

    monkeypatch.setattr(hx, "occupancy", occupancy)
    monkeypatch.setattr(hx, "_E4_TILES", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    dev = torch.device("cuda", 0)
    for L in DEPTHS:
        for bim, dform in ((False, False), (True, True), (True, False)):
            tiles = hx.e4_launch_tiles(n, L, bim, dform, dev)
            if n <= hx.E4_ONE_PASS_MAX_N[L]:
                assert tiles == hx.e4_one_pass_tiles(n) and tiles.leg == "E4_tile"
                continue
            slots = 132 * (5 if L == 1 else 4)
            want = hx.row_strip(lambda s, L=L: hx.e4_tiles(n, L, s), hx.e4_halo_steps(L), slots,
                                132)
            assert tiles == hx.e4_tiles(n, L, want) and tiles.leg == "E4"
            assert asked[-1] == ("mg_zhswrr_occupancy", (int(bim), int(dform), L))
            count = len(asked)
            assert hx.e4_launch_tiles(n, L, bim, dform, dev) is tiles
            assert len(asked) == count
    assert not asked if n <= min(hx.E4_ONE_PASS_MAX_N.values()) else asked


def test_e4_block_shape_matches_the_kernel():
    # the kernel refuses a grid computed for another block shape; the
    # constants here must be csrc/common.cuh's and csrc/hrelax.cu's
    common = (CSRC / "common.cuh").read_text()
    src = (CSRC / "hrelax.cu").read_text()

    def const(name, text):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert (const("RT", common), const("RC", common), const("RD", common)) == (RT, RC, RD)
    assert const("RS_STRIP_MAX", common) == sw.A12_STRIP_MAX
    assert const("E4_UNR", src) == UNR
    body = src[src.index("e4_h_zdescent_rows("):]
    body = body[:body.index("\n}\n")]
    assert "constexpr int BW = RB - 2 * L - 4;" in body
    assert "constexpr int NF = L == 1 ? 8 : 16;" in body
    assert "c0 = x0 - L - 2 + RC * t, col = x0 - L - 3, base = y0 - L - 3;" in body
    assert "const int rows_out = min(strip, H + 1 - y0);" in body
    assert "staged = rows_out + 2 * L + 4, steps = rows_out + 3 * L + 5;" in body
    assert "pending = odd && s >= 3 * L + 5;" in body
    assert "constexpr bool odd = ((I + L + 1) & 1) != 0;" in body
    assert "col_own[e] = p >= L + 2 && p < L + 2 + BW && c < H;" in body
    assert "frho = (s - 2 * L - 2) & (NF - 1)" in body
    assert "fsouth = (s - 2 * L - 3) & (NF - 1)" in body
    assert "restrict_finish(fc, (y0 + rows_out - 2) >> 1" in body
    grid = src[src.index("inline bool e4_grid_ok("):]
    grid = grid[:grid.index("\n}\n")]
    assert "return descent_grid_ok(n, L, one_pass, strip, gx, gy);" in grid
    entry = src[src.index("int mg_zhswrr("):]
    assert entry[:entry.index("\n}\n")].count("e4_grid_ok(n, L, one_pass != 0, strip, gx, gy)") == 1
    for L in DEPTHS:
        assert hx.e4_halo_steps(L) == 3 * L + 5
    # the wrapper refuses fields off a 16-byte boundary before it launches
    assert '_check_aligned(("f", f), ("phase", ph))' in inspect.getsource(hx.zhswrr_cuda)
    with pytest.raises(ValueError):
        hx.e4_tiles(8, 1, 3)


# ---------------------------------------------------------------------------
# C2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_c2_bands_and_strips_own_each_node_once(n):
    H = n + 1
    for k in KS:
        for strip in STRIPS:
            tiles = ss.c2_tiles(n, k, strip)
            assert (tiles.leg, tiles.band, tiles.strip) == ("C2", _c2_bw(k), strip)
            assert _cover_once(np.arange(tiles.gx) * tiles.band, tiles.band, H)
            assert _cover_once(np.arange(tiles.gy) * strip, strip, H)
            # the threads' owned positions K - 1 .. K - 2 + band of the RB
            # they compute own the band's columns once
            for bx in range(tiles.gx):
                x0 = bx * tiles.band
                owned = [x0 - k + 1 + p for p in range(RB) if k - 1 <= p < k - 1 + tiles.band]
                assert owned == list(range(x0, x0 + tiles.band))
    one = ss.c2_one_pass_tiles(n)
    assert (one.leg, one.band, one.strip) == ("C2_tile", 32, 32)
    assert _cover_once(np.arange(one.gx) * 32, 32, H) and _cover_once(np.arange(one.gy) * 32, 32, H)


@pytest.mark.parametrize("n", SIZES)
def test_c2_staging_windows_stay_inside_the_allocation(n):
    # u and f: float rows of (n+1) values from column x0 - k; the pattern
    # ids: rows of (n+1) bytes from column x0 - k + 1, RB of them, in slots
    # of RSLOTQ bytes
    H = n + 1
    for k in KS:
        u_rows, cols = [], []
        for strip in STRIPS:
            tiles = ss.c2_tiles(n, k, strip)
            for by in range(tiles.gy):
                y0 = by * strip
                rows_out, staged, _ = _c2_rows(n, y0, strip, k)
                rows = y0 - k + np.arange(staged)  # u row base + s
                # u rows y0 - k .. y0 + rows_out + k - 1: k above and below
                assert rows[0] == y0 - k and rows[-1] == y0 + rows_out + k - 1
                for bx in range(tiles.gx):
                    u_rows.append(rows)
                    cols.append(np.full(staged, bx * tiles.band - k))
        u_rows, cols = _unique(u_rows, cols)
        _check_windows(((u_rows, cols, H, H, H * H, 4, RSLOT, RW),
                        (u_rows - 1, cols, H, H, H * H, 4, RSLOT, RW),
                        (u_rows - 1, cols + 1, H, H, H * H, 16, RSLOTQ, RB)))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("rows_out", [1, 2, 3, 8, 30, sw.A12_STRIP_MAX])
def test_c2_sweeps_read_only_rows_of_earlier_steps(k, rows_out):
    # rows relative to y0 = 0; step s: u row R = base + s staged (stage s),
    # f and id row i = R - 1 (stage s), sweep 1 at row i (from s = 2), sweep
    # m at row i - 2(m - 1) from u_{m-1} rows of earlier steps, with f and
    # the ids of stage s - 2(m - 1)
    base = -k
    staged, steps = rows_out + 2 * k, rows_out + ss.c2_halo_steps(k)
    NF = _c2_nf(k)
    made = {}  # (sweep, row) -> step; sweep 0: the staged u rows
    for s in range(steps):
        R = base + s
        i = R - 1
        if s < staged:
            made[(0, R)] = s  # read by sweep 1 at this step, after the wait
        for m in range(k, 0, -1):
            r = i - 2 * (m - 1)
            if m == 1 and s < 2:
                continue
            for need in (r - 1, r, r + 1):
                if (m - 1, need) in made:
                    assert made[(m - 1, need)] < s or (m == 1 and made[(0, need)] <= s)
            made[(m, r)] = s
            # its f and id row came with stage s - 2(m - 1), whose slot no
            # later stage started by step s has overwritten
            st = s - 2 * (m - 1)
            assert st == r - base + 1
            if st >= 0:
                assert all((m2 - st) % NF for m2 in range(st + 1, s + RD + 1))
    # every row each sweep needs is made from rows that were made, and its
    # f and id row was staged
    for m in range(1, k + 1):
        need = range(-(k - m), rows_out + (k - m))
        assert all((m, r) in made for r in need)
        for r in need:
            assert all((m - 1, x) in made for x in (r - 1, r, r + 1))
            assert 0 <= r - base + 1 < staged
    assert made[(k, rows_out - 1)] == steps - 1
    assert NF >= 2 * k + 1 and NF & (NF - 1) == 0


@pytest.mark.parametrize("n", SIZES)
def test_c2_partial_buffer_holds_one_sum_per_block(n):
    geoms = ([ss.c2_tiles(n, k, s) for k in KS for s in STRIPS]
             + [ss.c2_one_pass_tiles(n)])
    keys = set()
    for tiles in geoms:
        ws = {}
        partial, done = hx.row_scratch(tiles, 1, torch.device("cpu"), ws)
        assert partial.numel() == tiles.blocks and partial.dtype == torch.float32
        assert done.dtype == torch.int32 and int(done) == 0
        again = hx.row_scratch(tiles, 1, torch.device("cpu"), ws)
        assert again[0] is partial and again[1] is done
        keys |= set(ws)
    # C2's keys differ by k, from its tile's and from C1's
    assert len(keys) == len(geoms)
    others = {("row_scratch", t) for t in (ss.c1_tiles(n), ss.c1_one_pass_tiles(n))}
    others |= {sw._partials_key(which, n) for which in (0, 1, 2)}
    assert not keys & others


@pytest.mark.parametrize("n", SIZES + [130, 510, 514, 1024])
def test_c2_wrapper_takes_the_size_choice(n, monkeypatch):
    # the geometry c2_launch_tiles gives the wrapper on a card of 132 SMs
    # whose library reports 6 resident blocks: the one-pass tile up to
    # C2_ONE_PASS_MAX_N[(bim, k)] and for every k above C2_STREAM_MAX_K, else
    # row_strip's height, computed once per shape
    asked = []

    def occupancy(symbol, *args):
        asked.append((symbol, *args))
        return 6

    monkeypatch.setattr(ss, "occupancy", occupancy)
    monkeypatch.setattr(ss, "_C2_TILES", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    dev = torch.device("cuda", 0)
    for k in range(1, ss.MAX_FUSED + 1):
        for bim in (False, True):
            tiles = ss.c2_launch_tiles(n, k, bim, dev)
            if k > ss.C2_STREAM_MAX_K or n <= ss.C2_ONE_PASS_MAX_N[(bim, k)]:
                assert tiles == ss.c2_one_pass_tiles(n)
                continue
            want = hx.row_strip(lambda s, k=k: ss.c2_tiles(n, k, s), ss.c2_halo_steps(k),
                                6 * 132, 132)
            assert tiles == ss.c2_tiles(n, k, want) and tiles.leg == "C2"
            assert asked[-1] == ("st_multi_occupancy", int(bim), k)
            count = len(asked)
            assert ss.c2_launch_tiles(n, k, bim, dev) is tiles
            assert len(asked) == count
    streamed = [key for key, limit in ss.C2_ONE_PASS_MAX_N.items() if n > limit]
    assert sorted(ss.C2_ONE_PASS_MAX_N) == [(bim, k) for bim in (False, True) for k in KS]
    assert len(asked) == len(streamed)


def test_c2_block_shape_matches_the_kernel():
    common = (CSRC / "common.cuh").read_text()
    src = (CSRC / "stencil.cu").read_text()

    def const(name, text):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert (const("RT", common), const("RC", common)) == (RT, RC)
    assert re.search(r"constexpr int MX = 32, MY = 32;", common)
    assert const("C2_STREAM_MAX_K", src) == ss.C2_STREAM_MAX_K
    assert const("C1_UNR", src) == UNR
    body = src[src.index("c2_stencil_multi_rows("):]
    body = body[:body.index("\n}\n")]
    assert "constexpr int BW = RB - 2 * (K - 1);" in body
    assert "c0 = x0 - K + 1 + RC * t, col = x0 - K, base = y0 - K;" in body
    assert "const int rows_out = min(strip, H - y0);" in body
    assert "staged = rows_out + 2 * K, steps = rows_out + 3 * K - 1;" in body
    assert "col_own[e] = p >= K - 1 && p < K - 1 + BW && c < H;" in body
    assert "pid, base + s - 1, H, H, col + 1, live);" in body
    assert "(s - 2 * (m - 1)) & (NF - 1)" in body
    assert "finish_sums<RT, 1>(sums, partial, done, outs);" in body
    for k in KS:
        assert f"c2_nf({k})" not in body and ss.c2_halo_steps(k) == 3 * k - 1
    assert "return K <= 1 ? 4 : K <= 3 ? 8 : 16;" in src
    # the tile finishes its norm in its last block too: no C2 launch is
    # followed by reduce_kernel
    tile = src[src.index("c2_stencil_multi(const"):]
    tile = tile[:tile.index("\n}\n")]
    assert "finish_sums<NT, 1>(sums, partial, done, outs);" in tile
    assert "reduce_kernel" not in src.split("}  // namespace")[1]
    grid = src[src.index("inline bool c2_grid_ok("):]
    grid = grid[:grid.index("\n}\n")]
    assert "bw = RB - 2 * (kk - 1)" in grid and "gx == (H + bw - 1) / bw" in grid
    assert "multi_grid(n)" in grid and "kk <= C2_STREAM_MAX_K" in grid
    entry = src[src.index("int st_multi("):]
    assert entry[:entry.index("\n}\n")].count(
        "c2_grid_ok(n, kk, one_pass != 0, strip, gx, gy)") == 1
    assert '_check_aligned(("u", u), ("f", f), ("pid", pid))' in inspect.getsource(ss.multi_cuda)
    with pytest.raises(ValueError):
        ss.c2_tiles(8, 2, 5)
