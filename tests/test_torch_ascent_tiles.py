"""Launch geometry of the row-streaming H-MG ascent legs E3 and E5
(``ops/hrelax.py`` ``e3_tiles`` / ``e5_tiles``, their one-pass tiles, halo
steps and launch geometry): the Python side of what the wrappers pass to
``csrc/hrelax.cu``'s ``e3_h_ascent_rows`` and ``e5_h_zascent_rows``, checked
without a card.

For every even n from 2 to 64 and for the sizes around each one-pass
threshold and up to 4096, with chain depths L = 1 and 3: the bands and
strips own each fine node exactly once, and the one-pass tiles too; every
staged row's 16-byte chunks (E3's u1, f and phases, E5's f and phases, and
both legs' coarse rows of uc) stay inside the allocation and cover their
windows, which hold the columns the chains read; the staged coarse rows
cover every read of ``prolong()`` at the fine nodes the owned outputs
depend on, and the kernels' prolongation, mirrored here on those staged
rows, equals the plain version's bitwise; each stage of each chain reads
only rows finished at an earlier step (E5's f / phase ring still holding
the rows its Jacobi stage reads), and a strip takes ``e3_halo_steps`` /
``e5_halo_steps`` steps beyond its rows; the wrappers take the one-pass
tile up to ``E3_ONE_PASS_MAX_N[L]`` / ``E5_ONE_PASS_MAX_N[L]`` and
``row_strip``'s strip above it, for the occupancy the card reports at each
strip height; and the block shape and formulas here are the kernels'.
``chip_smoke.py`` holds the kernels themselves at ragged sizes on the card.
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
LEGS = ("E3", "E5")
THRESHOLDS = set(hx.E3_ONE_PASS_MAX_N.values()) | set(hx.E5_ONE_PASS_MAX_N.values())
SIZES = sorted(set(range(2, 65, 2)) | {126, 128, 1000, 2048, 4096}
               | {t + d for t in THRESHOLDS for d in (-2, 0, 2)})
STRIPS = (2, 8, 30, 32, sw.A12_STRIP_MAX)
CSRC = Path(hx.__file__).resolve().parent.parent / "csrc"
RT, RC = sw.A12_THREADS, sw.A12_COLUMNS
RB = RT * RC
RW, RWQ = RB + 2, RB + 1
RSLOT, RSLOTQ = (RW + 6) // 4 * 4, (RWQ + 30) // 16 * 16
RCW = RB // 2 + 2  # staged coarse window (floats)
RCSLOT = (RCW + 6) // 4 * 4
RD, UNR = 2, 6  # rows staged ahead; steps per trip of the main loop


class Geo:
    """One row-streaming block of E3 or E5 as the kernel computes it."""

    def __init__(self, leg, n, L, strip, x0, y0):
        H = n + 1
        self.leg, self.n, self.L, self.strip, self.x0, self.y0 = leg, n, L, strip, x0, y0
        self.rows_out = min(strip, H - y0)
        if leg == "E3":
            self.bw, self.c00, self.col = RB - 2 * L - 2, x0 - L - 1, x0 - L - 2
            self.base = y0 - L - 1
            self.staged = self.rows_out + 2 * L + 2
            self.steps = self.staged + L
            self.cj0 = (x0 - L - 2) >> 1
            self.lo = L + 1  # first owned position RC t + e
        else:
            self.bw, self.c00, self.col = RB - 4 * L - 2, x0 - 2 * L - 1, x0 - 2 * L - 2
            self.base = y0 - 2 * L - 2
            self.staged, self.steps = self.rows_out + 4 * L + 3, self.rows_out + 6 * L + 4
            self.cj0 = (x0 - 2 * L - 1) >> 1
            self.lo = 2 * L + 1
        self.ci0, self.cr = (y0 - L - 1) >> 1, strip // 2 + L + 2

    def prolonged_columns(self):
        """(thread t, fine column) of every column a thread prolongs: E3
        its u2 window c0 - 1 .. c0 + RC, E5 its own columns c0 .. c0 + RC - 1."""
        t = np.arange(RT)[:, None]
        c0 = self.c00 + RC * t
        e = np.arange(-1, RC + 1) if self.leg == "E3" else np.arange(RC)
        return np.broadcast_to(t, (RT, e.size)), c0 + e[None, :]


def _geos(leg, n, L, strip):
    tiles = (hx.e3_tiles if leg == "E3" else hx.e5_tiles)(n, L, strip)
    for by in range(tiles.gy):
        for bx in range(tiles.gx):
            yield Geo(leg, n, L, strip, bx * tiles.band, by * strip)


@pytest.mark.parametrize("n", SIZES)
def test_bands_and_strips_own_each_node_once(n):
    H = n + 1
    for L in DEPTHS:
        for strip in STRIPS:
            for leg, tiles_of, bw in (("E3", hx.e3_tiles, RB - 2 * L - 2),
                                      ("E5", hx.e5_tiles, RB - 4 * L - 2)):
                tiles = tiles_of(n, L, strip)
                assert (tiles.leg, tiles.band, tiles.strip) == (leg, bw, strip)
                assert tiles.band % 2 == 0
                assert _cover_once(np.arange(tiles.gx) * tiles.band, tiles.band, H)
                assert _cover_once(np.arange(tiles.gy) * strip, strip, H)
                # the owned positions of a block's threads are its band
                g = Geo(leg, n, L, strip, 0, 0)
                assert g.bw == tiles.band and g.lo + g.bw <= RB - g.lo
    for leg, one_of in (("E3_tile", hx.e3_one_pass_tiles), ("E5_tile", hx.e5_one_pass_tiles)):
        one = one_of(n)
        assert (one.leg, one.band, one.strip) == (leg, 32, 16)
        assert _cover_once(np.arange(one.gx) * 32, 32, H)
        assert _cover_once(np.arange(one.gy) * 16, 16, H)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("L", DEPTHS)
def test_staging_windows_stay_inside_the_allocation(n, L):
    H, Hc = n + 1, n // 2 + 1
    # the largest levels with a ragged strip and the tallest only: their
    # thousands of blocks repeat the smaller levels' cases
    for strip in STRIPS if n <= 1024 else (30, sw.A12_STRIP_MAX):
        u_rows, f_rows, q_rows, cols, c_rows, c_cols = [], [], [], [], [], []
        for leg in LEGS:
            for g in _geos(leg, n, L, strip):
                s = np.arange(g.staged)
                rows = g.base + s
                if leg == "E3":
                    u_rows.append(rows)  # u1 row base + s, f and phase rows one above
                    f_rows.append(rows - 1)
                    q_rows.append(rows - 1)
                    # the u window holds the Jacobi stage's columns: owned
                    # columns and the chain's halo of L + 1, one more for
                    # the apply
                    assert g.col == g.x0 - L - 2 and g.x0 + g.bw + L + 1 == g.col + RW - 1
                else:
                    f_rows.append(rows)  # f and phase rows base + s
                    q_rows.append(rows)
                    # g0 at the owned columns and 2L + 1 on each side (f at
                    # window positions 1 ..), its elements one column left
                    assert g.col + 1 == g.x0 - 2 * L - 1 and g.x0 + g.bw + 2 * L <= g.col + RW - 1
                    assert g.x0 + g.bw + 2 * L <= g.col + RWQ - 1
                cols.append(np.full(g.staged, g.col))
                c_rows.append(g.ci0 + np.arange(g.cr))
                c_cols.append(np.full(g.cr, g.cj0))
        cat = np.concatenate
        u_cols = cat(cols[:len(u_rows)])  # E3's blocks come first
        _check_windows(((cat(u_rows), u_cols, H, H, H * H, 4, RSLOT, RW),
                        (cat(f_rows), cat(cols), H, H, H * H, 4, RSLOT, RW),
                        (cat(q_rows), cat(cols), n, n, n * n, 16, RSLOTQ, RWQ),
                        (cat(c_rows), cat(c_cols), Hc, Hc, Hc * Hc, 4, RCSLOT, RCW)))
    assert RSLOT // 4 <= RT and RSLOTQ // 16 <= RT


def _prolong_rows(g, uc, rows):
    """The kernel's prolongation (common.cuh prolong_row) of fine rows
    ``rows`` at every column its threads prolong, read from the block's
    staged coarse rows as stage_coarse lays them out; (values, columns)."""
    Hc = uc.shape[0]
    flat = uc.reshape(-1)
    # slot r holds coarse row ci0 + r from its aligned-down start: window
    # position x of row I is flat element I Hc + cj0 + x (zero off the rows)
    t, c = g.prolonged_columns()
    nl = {True: 3, False: 2}[g.leg == "E3"]
    x = t[:, :1] + np.arange(nl)[None, :]  # the thread's coarse window positions
    out = []
    for R in rows:
        odd = R & 1
        r = min(max((R >> 1) - g.ci0, 0), g.cr - 2)

        def staged(rr):
            I = g.ci0 + rr
            a = I * Hc + g.cj0 + x
            ok = (0 <= I < Hc) & (a >= 0) & (a < Hc * Hc)
            return np.where(ok, flat[np.clip(a, 0, Hc * Hc - 1)], np.float32(0))

        a, b = staged(r), staged(r + 1)
        row = np.float32(0.5) * (a + b) if odd else a
        k = 1 + np.arange(c.shape[1])  # both legs start on an odd column
        mid = np.float32(0.5) * (row[:, k >> 1] + row[:, np.minimum((k >> 1) + 1, nl - 1)])
        out.append(np.where((k & 1)[None, :] == 1, mid, row[:, k >> 1]))
    return np.stack(out), c


@pytest.mark.parametrize("n", [2, 6, 30, 64, 126, 300])
@pytest.mark.parametrize("L", DEPTHS)
def test_staged_coarse_rows_cover_every_prolong_read(n, L):
    # the fine rows whose u2 the owned outputs depend on: y0 - L - 1 ..
    # y0 + rows_out + L (E3's Jacobi window, E5's u2 rows alike); at their
    # interior nodes prolong() reads coarse rows R >> 1 (and the next at odd
    # R) and columns c >> 1 (and the next at odd c), which lie inside the
    # staged rows without the clamp and inside each thread's window
    # positions, and the kernel's sums on them are the plain version's
    H, Hc = n + 1, n // 2 + 1
    uc = np.random.default_rng(n).standard_normal((Hc, Hc)).astype(np.float32)
    want = sw._prolong(torch.from_numpy(uc)).numpy()
    for leg in LEGS:
        for strip in (2, 8, 32, sw.A12_STRIP_MAX):
            for g in _geos(leg, n, L, strip):
                rows = np.arange(g.y0 - L - 1, g.y0 + g.rows_out + L + 1)
                for R in rows[(rows >= 1) & (rows <= H - 2)]:
                    I = R >> 1
                    assert g.ci0 <= I and I + (R & 1) < g.ci0 + g.cr
                    assert I + 1 <= g.ci0 + g.cr - 1  # the clamp leaves the row alone
                t, c = g.prolonged_columns()
                inside = (c >= 1) & (c <= H - 2)
                J = (c >> 1) - g.cj0
                assert ((J >= t) & (J + (c & 1) < t + (3 if leg == "E3" else 2)))[inside].all()
                assert (J + (c & 1) < RCW)[inside].all()
                live = rows[(rows >= 1) & (rows <= H - 2)]
                if live.size:
                    got, cols = _prolong_rows(g, uc, live)
                    sel = np.broadcast_to(inside, got.shape)
                    ref = want[live][:, np.clip(cols, 0, H - 1)]
                    assert np.array_equal(got[sel], ref[sel])


def _ring_holds(stage, s, nf):
    """Whether the f / phase slot of ``stage`` still holds it at step s: no
    stage issued by then (up to s + RD) reused its slot."""
    return stage >= 0 and all((m - stage) % nf for m in range(stage + 1, s + RD + 1))


@pytest.mark.parametrize("L", DEPTHS)
@pytest.mark.parametrize("rows_out", [1, 2, 3, 8, 31, 32, sw.A12_STRIP_MAX])
def test_e3_chain_reads_only_rows_of_earlier_steps(L, rows_out):
    # rows relative to y0 = 0; step s: u1 row R = base + s staged (stage s),
    # u2 row R formed as it is read, Jacobi row i = R - 1 (s >= 2), conv
    # layer l row i - 2l (s >= 2), the output row i - 2L from layer L and
    # the jac row of step s - 2L
    base = -L - 1
    staged, steps = rows_out + 2 * L + 2, rows_out + hx.e3_halo_steps(L)
    made, out = {}, {}
    for s in range(steps):
        R = base + s
        i = R - 1
        if s >= 2:
            for l in range(L, 0, -1):
                r = i - 2 * l
                for need in (r - 1, r, r + 1):
                    if (l - 1, need) in made:
                        assert made[(l - 1, need)] < s
                made[(l, r)] = s
                if l == L:
                    out[r] = s
                    if (0, r) in made:
                        assert made[(0, r)] == s - 2 * L  # the jac ring
        made[("u2", R)] = s
        if s >= 2:
            for need in (i - 1, i, i + 1):  # u2 rows of this step and the two before
                assert made[("u2", need)] <= s
            made[(0, i)] = s
    # the rows the owned outputs need: u2 rows -L - 1 .. rows_out + L staged
    for r in range(-L - 1, rows_out + L + 1):
        assert r - base < staged and ("u2", r) in made
    for l in range(0, L + 1):
        assert all((l, r) in made for r in range(-(L - l), rows_out + (L - l)))
    assert all(r in out for r in range(rows_out)) and out[rows_out - 1] == steps - 1
    assert hx.e3_halo_steps(L) == 3 * L + 2


@pytest.mark.parametrize("L", DEPTHS)
@pytest.mark.parametrize("rows_out", [1, 2, 3, 8, 31, 32, sw.A12_STRIP_MAX])
def test_e5_chain_reads_only_rows_of_earlier_steps(L, rows_out):
    # rows relative to y0 = 0; step s stages the f and element rows
    # g = base + s into slot s mod NF; then the second chain (layer l row
    # i - 2l, the output row i - 2L from layer L and the jac of step s - 2L),
    # the Jacobi stage at row i = g - 2L - 2 (s >= 2L + 3), the first chain
    # (layer l row g - 2l; u1 = u2 less P at row q = g - 2L from layer L and
    # the g0 of step s - 2L) and g0 at row g (its element rows g - 1, kept
    # from step s - 1, and g)
    base, nf = -2 * L - 2, (8 if L == 1 else 16)
    staged, steps = rows_out + 4 * L + 3, rows_out + hx.e5_halo_steps(L)
    made, deps = {}, {}

    def make(key, s, needs):
        made[key], deps[key] = s, needs

    for s in range(steps):
        g = base + s
        q, i = g - 2 * L, g - 2 * L - 2
        if s >= 2 * L + 3:
            for l in range(L, 0, -1):
                r = i - 2 * l
                make(("x2", l, r), s, [(("x2", l - 1, m), "earlier") for m in (r - 1, r, r + 1)]
                     + ([(("jac", r), s - 2 * L)] if l == L else []))
            fi, fs = s - 2 * L - 2, s - 2 * L - 3
            make(("jac", i), s, [(("u2", m), "earlier") for m in (i - 1, i, i + 1)]
                 + [(("f", i), ("ring", fi)), (("q", i), ("ring", fi)),
                    (("q", i - 1), ("ring", fs))])
            made[("x2", 0, i)], deps[("x2", 0, i)] = s, [(("jac", i), s)]
        for l in range(L, 0, -1):
            r = g - 2 * l
            make(("x1", l, r), s, [(("x1", l - 1, m), "earlier") for m in (r - 1, r, r + 1)])
        make(("u2", q), s, [(("x1", L, q), s), (("x1", 0, q), s - 2 * L)])
        make(("x1", 0, g), s, [(("f", g), ("ring", s)), (("q", g), ("ring", s)),
                                (("q", g - 1), ("kept", s - 1))])
        if s < staged:
            made[("f", g)] = made[("q", g)] = s
    # walk back from the owned output rows: every dependency was made at an
    # earlier step (or the step the kernel's ring names) and is itself sound
    seen = set()

    def check(key, s):
        if key in seen:
            return
        seen.add(key)
        for need, when in deps.get(key, []):
            assert need in made, (key, need)
            if when == "earlier":
                assert made[need] < s, (key, need)
            elif isinstance(when, tuple) and when[0] == "ring":
                assert made[need] == when[1] and _ring_holds(when[1], s, nf), (key, need)
            elif isinstance(when, tuple):
                assert made[need] == when[1] >= 0, (key, need)
            else:
                assert made[need] == when, (key, need)
            if need in deps:
                check(need, made[need])

    for r in range(rows_out):
        key = ("x2", L, r)
        assert key in made and r == base + made[key] - 4 * L - 2
        check(key, made[key])
    assert made[("x2", L, rows_out - 1)] == steps - 1
    # the rows staged reach exactly the first chain's halo below
    assert max(key[1] for key in made if key[0] == "f") == rows_out + 2 * L
    assert nf >= 2 * L + 6 and nf & (nf - 1) == 0
    assert hx.e5_halo_steps(L) == 6 * L + 4


class _Props:
    multi_processor_count = 132


@pytest.mark.parametrize("n", SIZES + [130, 1024])
def test_wrapper_takes_the_size_choice(n, monkeypatch):
    # the geometry each wrapper launches with on a card of 132 SMs whose
    # library reports, at each strip height, fewer blocks for the taller
    # strips' coarse rows (6 / 5 / 4 at L = 1, one fewer at L = 3)
    asked = []

    def occupancy(symbol, *args):
        asked.append((symbol, args))
        bim, dform, L, strip = args
        return (6 if strip <= 32 else 5 if strip <= 96 else 4) - (L == 3)

    monkeypatch.setattr(hx, "occupancy", occupancy)
    monkeypatch.setattr(hx, "_ASCENT_TILES", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    dev = torch.device("cuda", 0)
    for leg, launch, limit, tiles_of, one_of, halo, symbol in (
            ("E3", hx.e3_launch_tiles, hx.E3_ONE_PASS_MAX_N, hx.e3_tiles, hx.e3_one_pass_tiles,
             hx.e3_halo_steps, "mg_phrelax_occupancy"),
            ("E5", hx.e5_launch_tiles, hx.E5_ONE_PASS_MAX_N, hx.e5_tiles, hx.e5_one_pass_tiles,
             hx.e5_halo_steps, "mg_zphrelax_occupancy")):
        for L in DEPTHS:
            for bim, dform in ((False, False), (True, True), (True, False)):
                before = len(asked)
                tiles = launch(n, L, bim, dform, dev)
                if n <= limit[L]:
                    assert tiles == one_of(n) and tiles.leg == leg + "_tile"
                    assert len(asked) == before
                    continue

                def slots(s, L=L):
                    return 132 * ((6 if s <= 32 else 5 if s <= 96 else 4) - (L == 3))

                want = hx.row_strip(lambda s, L=L: tiles_of(n, L, s), halo(L), slots, 132)
                assert tiles == tiles_of(n, L, want) and tiles.leg == leg
                assert {a[0] for a in asked[before:]} == {symbol}
                assert {a[1][:3] for a in asked[before:]} == {(int(bim), int(dform), L)}
                assert {a[1][3] for a in asked[before:]} <= set(range(2, sw.A12_STRIP_MAX + 1, 2))
                count = len(asked)
                assert launch(n, L, bim, dform, dev) is tiles
                assert len(asked) == count


def test_row_strip_takes_a_number_or_a_function_of_the_strip():
    for n in (64, 1000, 4096):
        tiles_of = lambda s, n=n: hx.e1_tiles(n, 1, s)
        assert hx.row_strip(tiles_of, 5, 660, 132) == hx.row_strip(tiles_of, 5, lambda s: 660, 132)


def test_block_shape_matches_the_kernel():
    # the kernels refuse a grid computed for another block shape; the
    # constants and formulas here must be csrc/common.cuh's and
    # csrc/hrelax.cu's
    common = (CSRC / "common.cuh").read_text()
    src = (CSRC / "hrelax.cu").read_text()

    def const(name, text):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    def body(name, text=src):
        b = text[text.index(name + "("):]
        return b[:b.index("\n}\n")]

    assert (const("RT", common), const("RC", common), const("RD", common)) == (RT, RC, RD)
    assert const("RS_STRIP_MAX", common) == sw.A12_STRIP_MAX
    assert const("E1_UNR", src) == UNR
    assert "constexpr int RCW = RB / 2 + 2;" in common
    assert "constexpr int RCSLOT = (RCW + 3 + 3) / 4 * 4;" in common
    assert "return strip / 2 + L + 2;" in body("coarse_rows", common)
    e3 = body("e3_ascent_rows")
    assert "constexpr int BW = RB - 2 * L - 2;" in e3
    assert "c0 = x0 - L - 1 + RC * t, col = x0 - L - 2, base = y0 - L - 1;" in e3
    assert "const int staged = rows_out + 2 * L + 2, steps = staged + L;" in e3
    assert ("ci0 = ((y0 - L - 1) >> 1) + CRO, CR = coarse_rows(strip, L), cj0 = (x0 - L - 2) >> 1;"
            in e3)
    assert "prolong_row<RC + 2, true>(pc, ucs, R + 2 * CRO, odd, ci0, CR, Hc, cj0, t);" in e3
    assert "col_own[e] = p >= L + 1 && p < L + 1 + BW && c0 + e < H;" in e3
    e5 = body("e5_h_zascent_rows")
    assert "constexpr int BW = RB - 4 * L - 2;" in e5
    assert "constexpr int NF = L == 1 ? 8 : 16;" in e5
    assert "c0 = x0 - 2 * L - 1 + RC * t, col = x0 - 2 * L - 2, base = y0 - 2 * L - 2;" in e5
    assert "const int staged = rows_out + 4 * L + 3, steps = rows_out + 6 * L + 4;" in e5
    assert ("ci0 = (y0 - L - 1) >> 1, CR = coarse_rows(strip, L), cj0 = (x0 - 2 * L - 1) >> 1;"
            in e5)
    assert "prolong_row<RC, true>(pc, ucs, q, odd, ci0, CR, Hc, cj0, t);" in e5
    assert "if (s >= 2 * L + 3) {" in e5
    assert "const int g = base + s, q = g - 2 * L, i = q - 2;" in e5
    assert "col_own[e] = p >= 2 * L + 1 && p < 2 * L + 1 + BW && c0 + e < H;" in e5
    assert "ascent_grid_ok(n, RB - 2 * L - 2, one_pass, strip, gx, gy)" in body("e3_grid_ok")
    assert "ascent_grid_ok(n, RB - 4 * L - 2, one_pass, strip, gx, gy)" in body("e5_grid_ok")
    grid = body("inline bool ascent_grid_ok")
    assert "gx == (H + bw - 1) / bw" in grid and "gy == (H + strip - 1) / strip" in grid
    assert "h_fine_grid(n)" in grid
    for entry, check in (("int mg_phrelax", "e3_grid_ok"), ("int mg_zphrelax", "e5_grid_ok")):
        assert body(entry).count(f"{check}(n, L, one_pass != 0, strip, gx, gy)") == 1
    # the one-pass tiles' grid is h_fine_grid: one block per 16 x 32 fine nodes
    assert "dim3((n + 1 + OX - 1) / OX, (n + 1 + OY - 1) / OY)" in src
    # the wrappers refuse fields off a 16-byte boundary before they launch
    assert ('_check_aligned(("u", u), ("f", f), ("phase", ph), ("uc", uc))'
            in inspect.getsource(hx.phrelax_cuda))
    assert ('_check_aligned(("f", f), ("phase", ph), ("uc", uc))'
            in inspect.getsource(hx.zphrelax_cuda))
    # the ctypes signatures: pointers, n, a0, da, omega, bim, dform, L,
    # one_pass, strip, gx, gy, stream
    assert len(hx.KERNELS["E3"]._argtypes) == 6 + 7 + 4 + 1
    assert len(hx.KERNELS["E5"]._argtypes) == 5 + 7 + 4 + 1
    for limit in (hx.E3_ONE_PASS_MAX_N, hx.E5_ONE_PASS_MAX_N):
        assert set(limit) == set(hx.SUPPORTED_DEPTHS)
    for tiles_of in (hx.e3_tiles, hx.e5_tiles):
        with pytest.raises(ValueError):
            tiles_of(8, 1, 3)
        with pytest.raises(ValueError):
            tiles_of(8, 3, sw.A12_STRIP_MAX + 2)
