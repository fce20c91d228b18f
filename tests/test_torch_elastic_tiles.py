"""Launch geometry of the row-streaming elastic legs G1 and G5
(``ops/elastic.py`` ``g1_tiles`` / ``g5_tiles``, their one-pass tiles, halo
steps and launch geometry): the Python side of what the wrappers pass to
``csrc/elastic.cu``'s ``g1_el_relax_rows`` and ``g5_el_zascent_rows``,
checked without a card.

For every even n from 2 to 64, around each one-pass threshold and at 126,
1000, 2048 and 4096: the bands and strips own each node exactly once, and
the one-pass tiles too; every staged row's 16-byte chunks (both components
of G1's u and f and of G5's f, counted from the field's base as
``stage_plane`` stages them, the phases, and both planes of G5's coarse
rows of uc, counted from the coarse field's base as ``stage_coarse`` stages
them) stay inside the allocation and their plane and cover their windows,
which hold the columns the kernels read; the staged coarse rows cover every
read of the prolongation at the fine nodes the owned outputs depend on, and
G5's prolongation, mirrored here on those staged rows, equals the plain
version's bitwise in both components; each stage reads only rows finished
at an earlier step (or staged by the step's own stage), G5's f ring still
holding the rows its sweep reads, and a strip takes ``g1_halo_steps`` /
``g5_halo_steps`` steps beyond its rows; G1's partial buffer holds one float
per block under a key of its own; the wrappers take the one-pass tile up to
``G1_ONE_PASS_MAX_N[bim]`` / ``G5_ONE_PASS_MAX_N[bim]`` and ``row_strip``'s
strip above it, for the occupancy the card reports (G5's at each strip
height); and the block shape and formulas here are the kernels'.
``chip_smoke.py`` holds the kernels themselves at ragged sizes on the card.
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
from test_torch_descent_tiles import _plane_chunks, _slot
from test_torch_sweep_tiles import _check_windows, _cover_once

LEGS = ("G1", "G5")
THRESHOLDS = set(eg.G1_ONE_PASS_MAX_N.values()) | set(eg.G5_ONE_PASS_MAX_N.values())
SIZES = sorted(set(range(2, 65, 2)) | {126, 1000, 2048, 4096}
               | {t + d for t in THRESHOLDS for d in (-2, 0, 2)})
STRIPS = (2, 8, 30, 32, sw.A12_STRIP_MAX)
CSRC = Path(eg.__file__).resolve().parent.parent / "csrc"
RT, RC = sw.A12_THREADS, sw.A12_COLUMNS
RB = RT * RC
RW, RWQ = RB + 2, RB + 1
RSLOTQ = (RWQ + 30) // 16 * 16
RCW = RB // 2 + 2  # staged coarse window (floats)
RCSLOT = (RCW + 6) // 4 * 4
RD, UNR, NF, RNS = 2, 6, 6, 3  # rows staged ahead; steps a trip; G5's f ring; G1's ring


class Geo:
    """One row-streaming block of G1 or G5 as the kernel computes it."""

    def __init__(self, leg, n, strip, x0, y0):
        H = n + 1
        self.leg, self.n, self.strip, self.x0, self.y0 = leg, n, strip, x0, y0
        self.rows_out = min(strip, H - y0)
        if leg == "G1":
            self.bw, self.c00, self.col, self.base = RB, x0, x0 - 1, y0 - 1
            self.steps = self.rows_out + eg.g1_halo_steps()
            self.staged = self.steps  # u row base + s, f and phase rows one above
            self.lo = 0  # first owned position RC t + e
        else:
            self.bw, self.c00, self.col, self.base = RB - 2, x0 - 1, x0 - 2, y0 - 2
            self.staged, self.steps = self.rows_out + 3, self.rows_out + eg.g5_halo_steps()
            self.lo = 1
        self.ci0, self.cr, self.cj0 = (y0 - 1) >> 1, strip // 2 + 3, (x0 - 1) >> 1

    def f_rows(self):
        """The f (and phase) row of each staged step."""
        s = np.arange(self.staged)
        return self.base + s - (1 if self.leg == "G1" else 0)


def _geos(leg, n, strip):
    tiles = (eg.g1_tiles if leg == "G1" else eg.g5_tiles)(n, strip)
    for by in range(tiles.gy):
        for bx in range(tiles.gx):
            yield Geo(leg, n, strip, bx * tiles.band, by * strip)


@pytest.mark.parametrize("n", SIZES)
def test_bands_and_strips_own_each_node_once(n):
    H = n + 1
    for strip in STRIPS:
        for leg, tiles_of, bw in (("G1", eg.g1_tiles, RB), ("G5", eg.g5_tiles, RB - 2)):
            tiles = tiles_of(n, strip)
            assert (tiles.leg, tiles.band, tiles.strip) == (leg, bw, strip)
            assert tiles.band % 2 == 0
            assert _cover_once(np.arange(tiles.gx) * tiles.band, tiles.band, H)
            assert _cover_once(np.arange(tiles.gy) * strip, strip, H)
            # the owned positions of a block's threads are its band, and each
            # owned column has its window's columns among the block's threads'
            g = Geo(leg, n, strip, 0, 0)
            p = np.arange(RB)
            own = (p >= g.lo) & (p < g.lo + g.bw)
            assert own.sum() == tiles.band and g.c00 + g.lo == g.x0
            if leg == "G5":  # u2 is built at the threads' columns: the sweep's window too
                assert p[own].min() >= 1 and p[own].max() <= RB - 2
    for leg, one_of in (("G1_tile", eg.g1_one_pass_tiles), ("G5_tile", eg.g5_one_pass_tiles)):
        one = one_of(n)
        assert (one.leg, one.band, one.strip) == (leg, 32, 16)
        assert one == hx.coarse_tiles(leg, n)
        assert _cover_once(np.arange(one.gx) * 32, 32, H)
        assert _cover_once(np.arange(one.gy) * 16, 16, H)


def _check_stack(planes, rows_, cols, rows, row_len, elems, slot, width):
    """Every plane's staged windows ``[col, col + width)`` of rows ``rows_``
    stay inside the stack of ``planes`` rows x row_len planes and inside
    their own plane, and cover the window (as ``stage_plane`` and
    ``stage_coarse`` copy them, chunks counted from the stack's base)."""
    size = rows * row_len
    rows_, cols = np.unique(np.stack([rows_, cols]), axis=1)  # each window once
    for p in range(planes):
        start, valid, used, off = _plane_chunks(p, rows_, cols, width, row_len, rows, elems,
                                                slot)
        copied = valid > 0
        assert (start[copied] >= 0).all() and (start[copied] + valid[copied] <= planes * size).all()
        assert (start[copied] + valid[copied] <= (p + 1) * size).all()
        assert (off >= 0).all() and (off < elems).all() and (off + width <= slot).all()
        a = (p * rows + rows_) * row_len + cols
        first = start[:, 0]
        last = first + elems * used.sum(axis=1)
        assert (last >= a + width).all()
        on = (rows_ >= 0) & (rows_ < rows)
        want = np.clip(np.minimum(last, (p + 1) * size) - np.maximum(first, 0), 0, None)
        assert (valid.sum(axis=1)[on] == want[on]).all()
        assert (valid[~on] == 0).all()


@pytest.mark.parametrize("n", SIZES)
def test_staging_windows_stay_inside_the_allocation(n):
    H, Hc = n + 1, n // 2 + 1
    # the largest levels with a ragged strip and the tallest only: their
    # thousands of blocks repeat the smaller levels' cases
    for strip in STRIPS if n <= 1024 else (30, sw.A12_STRIP_MAX):
        u_rows, f_rows, cols, f_cols, c_rows, c_cols = [], [], [], [], [], []
        for leg in LEGS:
            for g in _geos(leg, n, strip):
                fr = g.f_rows()
                f_rows.append(fr)
                f_cols.append(np.full(fr.size, g.col))
                if leg == "G1":
                    u_rows.append(g.base + np.arange(g.staged))
                    cols.append(np.full(g.staged, g.col))
                    # u over the threads' windows c0 - 1 .. c0 + RC, f over
                    # their own columns, the phases over their elements
                    # c0 - 1 .. c0 + RC - 1
                    assert g.col == g.x0 - 1 and g.x0 + RB == g.col + RW - 1
                    assert g.x0 + RB - 1 == g.col + RWQ - 1
                else:
                    # f over the threads' columns x0 - 1 .. x0 + RB - 2, the
                    # phases over their elements x0 - 2 .. x0 + RB - 2
                    assert g.col + 1 == g.x0 - 1 and g.x0 + RB - 2 <= g.col + RW - 1
                    assert g.x0 + RB - 2 == g.col + RWQ - 1
                    c_rows.append(g.ci0 + np.arange(g.cr))
                    c_cols.append(np.full(g.cr, g.cj0))
        cat = np.concatenate
        _check_stack(2, cat(u_rows), cat(cols), H, H, 4, _slot(4), RW)
        _check_stack(2, cat(f_rows), cat(f_cols), H, H, 4, _slot(4), RW)
        _check_windows(((cat(f_rows), cat(f_cols), n, n, n * n, 16, RSLOTQ, RWQ),))
        _check_stack(2, cat(c_rows), cat(c_cols), Hc, Hc, 4, RCSLOT, RCW)
    assert _slot(4) // 4 <= RT and RSLOTQ // 16 <= RT and RCSLOT % 4 == 0


def _prolong_rows(g, uc, plane, rows):
    """G5's prolongation (common.cuh prolong_row) of fine rows ``rows`` of
    component ``plane`` at every thread's own columns, read from the block's
    staged coarse rows as stage_coarse lays them out for that plane of the
    (2, Hc, Hc) stack; (values, columns)."""
    Hc = uc.shape[-1]
    flat = uc.reshape(-1)
    t = np.arange(RT)[:, None]
    c = g.c00 + RC * t + np.arange(RC)[None, :]
    x = t + np.arange(2)[None, :]  # the thread's coarse window positions
    out = []
    for R in rows:
        odd = R & 1
        r = min(max((R >> 1) - g.ci0, 0), g.cr - 2)

        def staged(rr):
            I = g.ci0 + rr
            a = (plane * Hc + I) * Hc + g.cj0 + x
            ok = (0 <= I < Hc) & (a >= 0) & (a < (plane + 1) * Hc * Hc)
            return np.where(ok, flat[np.clip(a, 0, 2 * Hc * Hc - 1)], np.float32(0))

        a, b = staged(r), staged(r + 1)
        row = np.float32(0.5) * (a + b) if odd else a
        k = 1 + np.arange(RC)  # the threads' columns start on an odd column
        mid = np.float32(0.5) * (row[:, k >> 1] + row[:, np.minimum((k >> 1) + 1, 1)])
        out.append(np.where((k & 1)[None, :] == 1, mid, row[:, k >> 1]))
    return np.stack(out), c


@pytest.mark.parametrize("n", [2, 6, 30, 64, 126, 300, 514])
def test_staged_coarse_rows_cover_every_prolong_read(n):
    # the fine rows whose u2 the owned outputs read: y0 - 1 .. y0 + rows_out;
    # at their interior nodes the prolongation reads coarse rows R >> 1 (and
    # the next at odd R) and columns c >> 1 (and the next at odd c), which
    # lie inside the staged rows without the clamp and inside each thread's
    # window positions, and the kernel's sums on them are the plain
    # version's, in both components
    H, Hc = n + 1, n // 2 + 1
    uc = np.random.default_rng(n).standard_normal((2, Hc, Hc)).astype(np.float32)
    want = eg._prolong(torch.from_numpy(uc)).numpy()
    for strip in (2, 8, 32, sw.A12_STRIP_MAX):
        for g in _geos("G5", n, strip):
            rows = np.arange(g.y0 - 1, g.y0 + g.rows_out + 1)
            live = rows[(rows >= 1) & (rows <= H - 2)]
            for R in live:
                I = R >> 1
                assert g.ci0 <= I and I + 1 <= g.ci0 + g.cr - 1  # the clamp leaves it alone
            t = np.arange(RT)[:, None]
            c = g.c00 + RC * t + np.arange(RC)[None, :]
            inside = (c >= 1) & (c <= H - 2)
            J = (c >> 1) - g.cj0
            assert ((J >= t) & (J + (c & 1) < t + 2))[inside].all()
            assert (J + (c & 1) < RCW)[inside].all()
            if live.size:
                for plane in (0, 1):
                    got, cols = _prolong_rows(g, uc, plane, live)
                    sel = np.broadcast_to(inside, got.shape)
                    ref = want[plane][live][:, np.clip(cols, 0, H - 1)]
                    assert np.array_equal(got[sel], ref[sel])


def _ring_holds(stage, s, nf):
    """Whether the slot of ``stage`` still holds it at step s: no stage issued
    by then (up to s + RD) reused its slot."""
    return stage >= 0 and all((m - stage) % nf for m in range(stage + 1, s + RD + 1))


@pytest.mark.parametrize("rows_out", [1, 2, 3, 8, 31, 32, sw.A12_STRIP_MAX])
def test_g1_reads_only_rows_of_earlier_steps(rows_out):
    # rows relative to y0 = 0; step s stages u row R = base + s and the f and
    # element rows R - 1 (stage s, slot s mod RNS), rolls u row R into the
    # windows and element row R - 1 into the 2-row ring, and from step 2 on
    # computes row i = R - 1 from u rows i - 1 .. i + 1 (rolled at steps
    # s - 2 .. s), element rows i - 1 (step s - 1) and i (s) and f row i
    # (stage s)
    g = Geo("G1", 10 ** 6, rows_out, 0, 0)
    assert g.steps == rows_out + 2 == rows_out + eg.g1_halo_steps()
    rolled, out = {}, {}
    for s in range(g.steps):
        R = g.base + s
        i = R - 1
        rolled[("u", R)] = rolled[("q", i)] = s
        if s >= 2:
            assert [rolled[("u", m)] for m in (i - 1, i, i + 1)] == [s - 2, s - 1, s]
            assert rolled[("q", i - 1)] == s - 1 and rolled[("q", i)] == s
            assert _ring_holds(s, s, RNS)  # f row i, staged with u row R
            out[i] = s
    assert sorted(out) == list(range(rows_out)) and out[rows_out - 1] == g.steps - 1
    # the rows staged: u rows -1 .. rows_out, f and element rows -2 .. rows_out - 1
    assert g.base == -1 and g.f_rows()[0] == -2 and g.f_rows()[-1] == rows_out - 1
    assert UNR % RNS == 0


@pytest.mark.parametrize("rows_out", [1, 2, 3, 8, 31, 32, sw.A12_STRIP_MAX])
def test_g5_reads_only_rows_of_earlier_steps(rows_out):
    # rows relative to y0 = 0; step s stages f and the element row R = base +
    # s into slot s mod NF; then rolls element row R into the 4-row ring (R -
    # 3 .. R) and u2 row R - 1 (built at step s - 1) into the windows, sweeps
    # row i = R - 2 (s >= 4) from u2 rows i - 1 .. i + 1, element rows i - 1,
    # i and f row i (stage s - 2), and builds u2 at row R (1 <= s < staged)
    # from f row R and element rows R - 1, R
    g = Geo("G5", 10 ** 6, rows_out, 0, 0)
    assert g.steps == rows_out + 4 == rows_out + eg.g5_halo_steps()
    assert g.staged == rows_out + 3
    built, q_rolled, out = {}, {}, {}
    for s in range(g.steps):
        R = g.base + s
        i = R - 2
        q_rolled[R] = s
        if s >= 4:
            for m in (i - 1, i, i + 1):
                assert built[m] < s  # u2 rows of earlier steps
            assert s - 4 < q_rolled[i - 1] < q_rolled[i] <= s  # still in the ring
            assert _ring_holds(s - 2, s, NF)  # f row i
            out[i] = s
        if 1 <= s < g.staged:
            assert q_rolled[R - 1] == s - 1 and _ring_holds(s, s, NF)
            built[R] = s
    assert sorted(out) == list(range(rows_out)) and out[rows_out - 1] == g.steps - 1
    # u2 is built at every row the owned outputs read, and no further
    assert sorted(built) == list(range(-1, rows_out + 1))
    assert NF >= RD + 3 and UNR % NF == 0 and UNR % 2 == 0


@pytest.mark.parametrize("n", SIZES)
def test_partial_buffer_holds_one_sum_per_block(n):
    geoms = [eg.g1_tiles(n, s) for s in STRIPS] + [eg.g1_one_pass_tiles(n)]
    keys = set()
    for tiles in geoms:
        ws = {}
        partial, done = hx.row_scratch(tiles, 1, torch.device("cpu"), ws)
        assert partial.numel() == tiles.blocks and partial.dtype == torch.float32
        assert done.dtype == torch.int32 and int(done) == 0
        again = hx.row_scratch(tiles, 1, torch.device("cpu"), ws)
        assert again[0] is partial and again[1] is done
        keys |= set(ws)
    # G1's keys differ from each other's and from those of G2's and E2's
    # one-pass tiles, which have the same grid
    assert len(keys) == len(geoms)
    others = {("row_scratch", t) for t in (eg.g2_one_pass_tiles(n), hx.e2_one_pass_tiles(n),
                                           eg.g2_tiles(n, 32))}
    others |= {sw._partials_key(which, n) for which in (0, 1, 2)}
    assert not keys & others


class _Props:
    multi_processor_count = 132


def _g5_blocks(strip):
    """A card's G5 occupancy that falls with the strip's coarse rows."""
    return 5 if strip <= 32 else 3 if strip <= 96 else 2


@pytest.mark.parametrize("n", SIZES + [130, 1024])
def test_wrappers_take_the_size_choice(n, monkeypatch):
    # the geometry g1_launch_tiles and g5_launch_tiles give the wrappers on a
    # card of 132 SMs whose library reports 5 resident G1 blocks in sweep
    # mode and 6 in residual mode, and G5 blocks by strip (_g5_blocks)
    asked = []

    def occupancy(symbol, *args):
        asked.append((symbol, args))
        if symbol == "mg_el_sweep_occupancy":
            return 5 + args[1]
        assert symbol == "mg_el_zpsweep_occupancy"
        return _g5_blocks(args[1])

    monkeypatch.setattr(hx, "occupancy", occupancy)
    monkeypatch.setattr(eg, "_G1_TILES", {})
    monkeypatch.setattr(eg, "_G5_TILES", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    dev = torch.device("cuda", 0)
    for bim in (False, True):
        for mode in (0, 1):
            before = len(asked)
            tiles = eg.g1_launch_tiles(n, bim, mode, dev)
            if n <= eg.G1_ONE_PASS_MAX_N[bim]:
                assert tiles == eg.g1_one_pass_tiles(n) and tiles.leg == "G1_tile"
                assert len(asked) == before
                continue
            want = hx.row_strip(lambda s: eg.g1_tiles(n, s), eg.g1_halo_steps(),
                                132 * (5 + mode), 132)
            assert tiles == eg.g1_tiles(n, want) and tiles.leg == "G1"
            assert asked[before:] == [("mg_el_sweep_occupancy", (int(bim), mode))]
            assert eg.g1_launch_tiles(n, bim, mode, dev) is tiles
            assert len(asked) == before + 1
        before = len(asked)
        tiles = eg.g5_launch_tiles(n, bim, dev)
        if n <= eg.G5_ONE_PASS_MAX_N[bim]:
            assert tiles == eg.g5_one_pass_tiles(n) and tiles.leg == "G5_tile"
            assert len(asked) == before
            continue
        want = hx.row_strip(lambda s: eg.g5_tiles(n, s), eg.g5_halo_steps(),
                            lambda s: 132 * _g5_blocks(s), 132)
        assert tiles == eg.g5_tiles(n, want) and tiles.leg == "G5"
        assert {a[0] for a in asked[before:]} == {"mg_el_zpsweep_occupancy"}
        assert {a[1][0] for a in asked[before:]} == {int(bim)}
        assert {a[1][1] for a in asked[before:]} == set(range(2, sw.A12_STRIP_MAX + 1, 2))
        count = len(asked)
        assert eg.g5_launch_tiles(n, bim, dev) is tiles
        assert len(asked) == count


def _const(name, text):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _body(text, name):
    body = text[text.index(name + "("):]
    return body[:body.index("\n}\n")]


def test_block_shape_matches_the_kernels():
    # the kernels refuse a grid computed for another block shape; the
    # constants and formulas here must be csrc/common.cuh's and
    # csrc/elastic.cu's
    common = (CSRC / "common.cuh").read_text()
    src = (CSRC / "elastic.cu").read_text()
    assert (_const("RT", common), _const("RC", common), _const("RD", common)) == (RT, RC, RD)
    assert _const("RS_STRIP_MAX", common) == sw.A12_STRIP_MAX
    assert "constexpr int RCW = RB / 2 + 2;" in common
    assert "constexpr int RCSLOT = (RCW + 3 + 3) / 4 * 4;" in common
    assert (_const("G1_UNR", src), _const("G5_UNR", src), _const("G5_NF", src)) == (UNR, UNR, NF)
    g1 = _body(src, "g1_el_relax_rows")
    assert "const int x0 = blockIdx.x * RB, y0 = blockIdx.y * strip, c0 = x0 + RC * t;" in g1
    assert "const int col = x0 - 1, base = y0 - 1;" in g1
    assert "const int steps = min(strip, H - y0) + 2;" in g1
    assert "if (s >= 2) {" in g1 and "const int R = base + s, i = R - 1;" in g1
    assert "finish_sums<RT, 1>(sums, partial, done, outs);" in g1
    g5 = _body(src, "g5_el_zascent_rows")
    assert "constexpr int BW = RB - 2;" in g5
    assert "const int c0 = x0 - 1 + RC * t, col = x0 - 2, base = y0 - 2;" in g5
    assert "const int staged = rows_out + 3, steps = rows_out + 4;" in g5
    assert "const int ci0 = (y0 - 1) >> 1, CR = g5_coarse_rows(strip), cj0 = (x0 - 1) >> 1;" in g5
    assert "return strip / 2 + 3;" in _body(src, "g5_coarse_rows")
    assert "stage_coarse(ucs + CR * RCSLOT, uc, Hc, ci0, CR, cj0, 1);" in g5
    assert "prolong_row<RC, true>(py, ucs + CR * RCSLOT, R, odd, ci0, CR, Hc, cj0, t, 1);" in g5
    assert "col_own[e] = p >= 1 && p < 1 + BW && c0 + e < H;" in g5
    assert "const int R = base + s, i = R - 2;" in g5 and "if (s >= 4) {" in g5
    assert "if (s >= 1 && s < staged) {" in g5
    # both legs and G2 run the one sweep stage
    for name in ("g1_el_relax_rows", "g2_el_descent_rows", "g5_el_zascent_rows"):
        assert _body(src, name).count("el_sweep_row<BIM>(") == 1
    grid = _body(src, "inline bool el_fine_grid_ok")
    assert "gx == (H + bw - 1) / bw" in grid and "gy == (H + strip - 1) / strip" in grid
    assert "coarse_grid(n)" in grid
    g1_entry, g5_entry = _body(src, "int mg_el_sweep"), _body(src, "int mg_el_zpsweep")
    assert g1_entry.count("el_fine_grid_ok(n, RB, one_pass != 0, strip, gx, gy)") == 1
    assert g5_entry.count("el_fine_grid_ok(n, RB - 2, one_pass != 0, strip, gx, gy)") == 1
    # no G1 launch runs a second norm pass: both designs finish it
    assert "reduce_kernel" not in src
    assert "finish_sums<NT, 1>(sums, partial, done, outs);" in _body(src, "g1_el_relax")
    # the wrappers refuse fields off a 16-byte boundary before they launch
    assert '_check_aligned(("u", u), ("f", f), ("phase", ph))' in inspect.getsource(
        eg.el_sweep_cuda)
    assert '_check_aligned(("f", f), ("phase", ph), ("uc", uc))' in inspect.getsource(
        eg.el_zpsweep_cuda)
    # the ctypes signatures: pointers, n and the nine constants, bim, (G1:
    # mode,) one_pass, strip, gx, gy, stream
    assert len(eg.KERNELS["G1"]._argtypes) == 7 + 11 + 5 + 1
    assert len(eg.KERNELS["G5"]._argtypes) == 4 + 11 + 4 + 1
    for limit in (eg.G1_ONE_PASS_MAX_N, eg.G5_ONE_PASS_MAX_N):
        assert set(limit) == {True, False}
    for tiles_of in (eg.g1_tiles, eg.g5_tiles):
        with pytest.raises(ValueError):
            tiles_of(8, 3)
        with pytest.raises(ValueError):
            tiles_of(8, sw.A12_STRIP_MAX + 2)
