"""Launch geometry of the row-streaming G2 and D2 (``ops/elastic.py``
``g2_tiles``, ``g2_one_pass_tiles``, ``g2_launch_tiles`` and
``ops/general.py``'s ``d2_*`` twins, on ``ops/hrelax.py``'s
``descent_tiles``, ``coarse_tiles``, ``e2_halo_steps`` and
``launch_tiles``): the Python side of what the wrappers pass to
``csrc/elastic.cu``'s ``g2_el_descent_rows`` and ``csrc/general.cu``'s
``d2_gen_descent_rows``, checked without a card.

For every even n from 2 to 64, around each one-pass threshold and at 1000,
2048 and 4096: the bands and strips own each fine node (u1, the norm) and
each coarse node (f_c) exactly once, and the one-pass tiles each coarse
node once; every staged row's 16-byte chunks stay inside the allocation and
cover the window, which holds the chain's halo: both components of G2's u
and f (the y planes counted from the field's base, as ``stage_plane``
stages them), D2's u, f, the phases, the 9 coefficient planes and the 4 W4
planes in f32 and bf16 (w10 and w11 only on odd rows); the chain reads only
rows finished at earlier steps and the f / operator ring still holds every
row the residual reads, the W4 ring every row of the residual's; the
restriction's row parity completes each coarse row of the strip once and
its columns each coarse column of the band once, from residual columns the
block computed; the streamed W4 restriction, mirrored here in its order of
operations, is bitwise the plain ``_w4_restrict``, and it reads w01 only
at odd columns, w10 at odd rows and w11 at both; the partial buffer holds
one float per block; and the wrappers take the one-pass tile up to
``G2_ONE_PASS_MAX_N[bim]`` / ``D2_ONE_PASS_MAX_N`` and ``row_strip``'s
strip above.  The index arithmetic mirrors the kernels'; ``chip_smoke.py`` holds
the kernels themselves at ragged sizes on the card.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multigrid_feanet_torch.ops import elastic as eg
from multigrid_feanet_torch.ops import general as gen
from multigrid_feanet_torch.ops import hrelax as hx
from multigrid_feanet_torch.ops import sweep as sw
from test_torch_sweep_tiles import _check_windows, _cover_once

LEGS = {"G2": (eg.g2_tiles, eg.g2_one_pass_tiles), "D2": (gen.d2_tiles, gen.d2_one_pass_tiles)}
HALO = hx.e2_halo_steps(0)  # E2's chain without conv layers
THRESHOLDS = {*eg.G2_ONE_PASS_MAX_N.values(), gen.D2_ONE_PASS_MAX_N}
SIZES = sorted(set(range(2, 65, 2)) | {1000, 2048, 4096}
               | {t + d for t in THRESHOLDS for d in (-2, 0, 2)})
STRIPS = (2, 8, 30, 32, sw.A12_STRIP_MAX)
CSRC = Path(sw.__file__).resolve().parent.parent / "csrc"
RT, RC = sw.A12_THREADS, sw.A12_COLUMNS
RB = RT * RC
BW = RB - 4  # owned columns of a band
RW, RWQ = RB + 2, RB + 1
RSLOTQ = (RWQ + 30) // 16 * 16
RD, UNR, NF, RNS = 2, 6, 6, 3  # rows staged ahead; steps per trip; f / operator and u / W4 slots


def _slot(es):
    """Elements of a staged row slot of ``es``-byte elements: the window
    from its aligned-down 16-byte start, whole chunks."""
    per = 16 // es
    return (RW + 2 * (per - 1)) // per * per


def _strip_rows(n, y0, strip):
    """(rows_out, staged, steps) of the strip at y0: the fine rows it
    restricts, the steps that stage u, f and the operator, and all its
    steps (the W4 rows are staged up to the last)."""
    rows_out = min(strip, n + 2 - y0)
    return rows_out, rows_out + 5, rows_out + 6


def _plane_chunks(plane, row, col, width, row_len, rows, elems, slot):
    """The 16-byte chunks that stage the window ``[col, col + width)`` of
    ``row`` of plane ``plane`` of a stack of ``rows`` x ``row_len`` planes,
    counted from the stack's base, as ``stage_plane`` copies them.  Returns
    (start, valid, used, offset) as ``_staged_chunks``."""
    row, col = np.broadcast_arrays(np.asarray(row, np.int64), np.asarray(col, np.int64))
    a = (plane * rows + row) * row_len + col
    start0 = a & ~(elems - 1)
    nch = (a - start0 + width + elems - 1) // elems
    k = np.arange(slot // elems)
    start = start0[..., None] + elems * k
    used = k < nch[..., None]
    inside = (row[..., None] >= 0) & (row[..., None] < rows) & (start >= 0)
    end = (plane + 1) * rows * row_len
    valid = np.where(used & inside, np.clip(end - start, 0, elems), 0)
    return start, valid, used, a - start0


def _check_planes(planes, rows_, cols, H, elems, slot, odd_only=()):
    """Every plane's staged windows (plane p's rows ``rows_``; the planes in
    ``odd_only`` at odd rows only) stay inside the stack of ``planes`` H x H
    planes and inside their own plane, and cover the window."""
    total = planes * H * H
    rows_, cols = np.unique(np.stack([rows_, cols]), axis=1)  # each window once
    for p in range(planes):
        keep = rows_ % 2 == 1 if p in odd_only else np.ones(rows_.shape, bool)
        r, c = rows_[keep], cols[keep]
        start, valid, used, off = _plane_chunks(p, r, c, RW, H, H, elems, slot)
        copied = valid > 0
        assert (start[copied] >= 0).all() and (start[copied] + valid[copied] <= total).all()
        assert (start[copied] + valid[copied] <= (p + 1) * H * H).all()
        assert (off >= 0).all() and (off < elems).all() and (off + RW <= slot).all()
        a = (p * H + r) * H + c
        first = start[:, 0]
        last = first + elems * used.sum(axis=1)
        assert (last >= a + RW).all()
        on = (r >= 0) & (r < H)
        want = np.clip(np.minimum(last, (p + 1) * H * H) - np.maximum(first, 0), 0, None)
        assert (valid.sum(axis=1)[on] == want[on]).all()
        assert (valid[~on] == 0).all()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("leg", LEGS)
def test_bands_and_strips_own_each_node_once(leg, n):
    tiles_of, one_pass_of = LEGS[leg]
    H, Hc = n + 1, n // 2 + 1
    for strip in STRIPS:
        tiles = tiles_of(n, strip)
        assert (tiles.leg, tiles.band, tiles.strip) == (leg, BW, strip)
        fine, coarse = np.zeros((H, H), np.uint8), np.zeros((Hc, Hc), np.uint8)
        for by in range(tiles.gy):
            y0 = by * strip
            assert y0 % 2 == 0 and y0 < H
            for bx in range(tiles.gx):
                x0 = bx * tiles.band
                assert x0 < H
                fine[y0:y0 + strip, x0:x0 + tiles.band] += 1
                coarse[y0 // 2:(y0 + strip) // 2, x0 // 2:(x0 + tiles.band) // 2] += 1
        assert (fine == 1).all() and (coarse == 1).all(), tiles
    one = one_pass_of(n)
    assert (one.leg, one.band, one.strip) == (f"{leg}_tile", 32, 16)
    assert _cover_once(np.arange(one.gx) * 16, 16, Hc) and _cover_once(np.arange(one.gy) * 8, 8, Hc)


def _staged(tiles_of, n, strip):
    """Every block's staged rows: (u rows, f / operator rows, W4 rows, their
    window columns), the W4 rows only at the steps that stage them."""
    tiles = tiles_of(n, strip)
    us, fs, ws, cols, wcols = [], [], [], [], []
    for by in range(tiles.gy):
        y0 = by * strip
        rows_out, staged, steps = _strip_rows(n, y0, strip)
        rows = y0 - 3 + np.arange(staged)
        assert rows[0] == y0 - 3 and rows[-1] == y0 + rows_out + 1
        wrows = y0 - 3 + np.arange(5, steps) - 3  # rho of steps 5 .. steps - 1
        assert wrows[0] == y0 - 1 and wrows[-1] == y0 + rows_out - 1
        for bx in range(tiles.gx):
            x0 = bx * tiles.band
            # the window holds the chain's halo: u0 over columns x0 - 3 ..
            # x0 + band + 2, f and the operator over the sweep's columns
            # x0 - 2 .. x0 + band + 1, the phases over the element columns
            # one left of those, the weights over the residual's x0 - 1 ..
            # x0 + band
            assert x0 + tiles.band + 2 < x0 - 3 + RW and x0 + tiles.band + 1 < x0 - 3 + RWQ
            us.append(rows)
            fs.append(rows - 1)
            cols.append(np.full(staged, x0 - 3))
            ws.append(wrows)
            wcols.append(np.full(wrows.size, x0 - 3))
    return tuple(map(np.concatenate, (us, fs, ws, cols, wcols)))


def _staged_all(tiles_of, n):
    """``_staged`` over every strip of STRIPS, each window once."""
    parts = [_staged(tiles_of, n, strip) for strip in STRIPS]
    u, f, w, cols, wcols = (np.concatenate(x) for x in zip(*parts))
    (u, ucols), (f, fcols), (w, wcols) = (np.unique(np.stack(x), axis=1)
                                          for x in ((u, cols), (f, cols), (w, wcols)))
    return u, ucols, f, fcols, w, wcols


@pytest.mark.parametrize("n", SIZES)
def test_g2_staging_windows_stay_inside_the_allocation(n):
    H = n + 1
    u_rows, ucols, f_rows, fcols, _, _ = _staged_all(eg.g2_tiles, n)
    # both components of u and f: planes of the (2, H, H) field
    _check_planes(2, u_rows, ucols, H, 4, _slot(4))
    _check_planes(2, f_rows, fcols, H, 4, _slot(4))
    _check_windows(((f_rows, fcols, n, n, n * n, 16, RSLOTQ, RWQ),))
    assert _slot(4) // 4 <= RT and RSLOTQ // 16 <= RT


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("es", (4, 2))
def test_d2_staging_windows_stay_inside_the_allocation(n, es):
    H = n + 1
    elems, slot = 16 // es, _slot(es)
    assert slot % elems == 0 and slot // elems <= RT
    u_rows, ucols, f_rows, fcols, w_rows, wcols = _staged_all(gen.d2_tiles, n)
    _check_windows(((u_rows, ucols, H, H, H * H, 4, _slot(4), RW),
                    (f_rows, fcols, H, H, H * H, 4, _slot(4), RW),
                    (f_rows, fcols, n, n, n * n, 16, RSLOTQ, RWQ)))
    # the general operator's 9 planes with f; the W4 planes of the
    # residual's rows, w10 and w11 at odd rows only
    _check_planes(9, f_rows, fcols, H, elems, slot)
    _check_planes(4, w_rows, wcols, H, elems, slot, odd_only=(2, 3))


def _ring_holds(stage, s, nf):
    """Whether slot ``stage mod nf`` still holds stage ``stage`` at step s:
    no stage started since (those of steps up to s + RD) reuses it."""
    return all((m - stage) % nf for m in range(stage + 1, s + RD + 1))


@pytest.mark.parametrize("rows_out", [2, 4, 8, 30, 32, sw.A12_STRIP_MAX])
def test_chain_reads_only_rows_of_earlier_steps(rows_out):
    # rows relative to the strip's first row y0 = 0; step s: u row
    # R = base + s staged (stage s), sweep row i = R - 1 (u1 from u0 rows
    # i - 1 .. i + 1), residual row rho = i - 2 (from u1 rows rho - 1 ..
    # rho + 1); f and the operator row i come with stage s, the W4 rows of
    # rho with stage s as well
    base = -3
    _, staged, steps = _strip_rows(10 ** 6, 0, rows_out)
    assert steps == rows_out + HALO == rows_out + 6
    made = {}
    for s in range(steps):
        R = base + s
        i, rho = R - 1, R - 3
        for need in (rho - 1, rho, rho + 1):
            if ("u1", need) in made:
                assert made[("u1", need)] < s
        made[("r1", rho)] = s
        made[("u1", i)] = s
        for need in (i - 1, i, i + 1):  # u0 rows staged by step s
            assert need - base <= s
        # f row rho of stage s - 2 (the general operator's plane rows with
        # it) is still in the NF-slot ring; the W4 rows of rho (stage s) in
        # the RNS-slot one, and the u0 row of stage s in the u ring; the
        # element rows rho - 1 and rho are those the sweep read at steps
        # s - 3 and s - 2, which the 4-row register ring, rolled once a step
        # before the sweep, still holds
        if s >= 2:
            assert _ring_holds(s - 2, s, NF)
        assert _ring_holds(s, s, RNS) and i - base + 1 == s
        for row, m in ((rho - 1, s - 3), (rho, s - 2)):
            assert row == base + m - 1 and s - 4 <= m <= s - 1
    assert NF >= RD + 4 and UNR % NF == 0 and UNR % RNS == 0 and UNR % 2 == 0
    # every u1 row and r1 row the strip needs is made, from staged u0 rows
    assert all(("u1", r) in made for r in range(-2, rows_out + 1))
    assert all(("r1", r) in made for r in range(-1, rows_out))
    assert all(r + 1 - base < staged for r in range(-2, rows_out + 1))
    assert made[("r1", rows_out - 1)] == steps - 1
    # the W4 rows are staged from step 5 (rho = -1, the first the
    # restriction reads) to the last
    assert base + 5 - 3 == -1


@pytest.mark.parametrize("n", SIZES)
def test_restriction_completes_each_coarse_node_once(n):
    # the kernels' parity: r1 row rho = y0 - 6 + s is odd when s mod UNR is
    # (y0 and UNR even); an odd rho ends the sum of coarse row (rho - 1) / 2,
    # written at the next step (or after the loop) once s >= 6
    H, Hc = n + 1, n // 2 + 1
    for leg, (tiles_of, _) in LEGS.items():
        for strip in STRIPS:
            tiles = tiles_of(n, strip)
            done = np.zeros(Hc, np.int64)
            for by in range(tiles.gy):
                y0 = by * strip
                steps = _strip_rows(n, y0, strip)[2]
                started, rows = {}, []
                for s in range(steps):
                    odd = (s % UNR) & 1 == 1
                    rho = y0 - 6 + s
                    assert (rho % 2 == 1) == odd
                    if odd:
                        if s >= 6:
                            Ic = (rho - 1) // 2
                            assert started[Ic] == (2 * Ic - 1, 2 * Ic + 1)
                            rows.append(Ic)
                        started[(rho + 1) // 2] = (rho, rho + 2)
                assert rows == list(range(y0 // 2, min((y0 + strip) // 2, Hc)))
                assert (y0 - 3 + steps - 5) >> 1 == rows[-1]  # finished after the loop
                done[rows] += 1
            assert (done == 1).all(), (leg, strip)
            # columns: thread t computes columns c0, c0 + 1 (c0 = x0 - 2 + RC t,
            # positions p of 0 .. RB - 1); r1 is valid at positions 1 .. RB - 2
            # (u1 at 0 .. RB - 1); the owned even columns own the band's coarse
            # columns once, each from r1 at p - 1 .. p + 1 (G2: the (1, 2, 1)
            # column sums of its neighbours; D2: the left sum of thread t - 1's
            # odd column, its own even column and its odd column's right sum)
            cols = np.zeros(Hc, np.int64)
            for bx in range(tiles.gx):
                x0 = bx * tiles.band
                for t in range(RT):
                    c0 = x0 - 2 + RC * t
                    assert c0 % 2 == 0
                    own = 2 <= RC * t < 2 + BW and c0 < H
                    if own:
                        cols[c0 // 2] += 1
                        assert 1 <= RC * t - 1 and RC * t + 1 <= RB - 2 and t >= 1
            assert (cols == 1).all(), (leg, strip)


def _streamed_w4_restrict(r, w4):
    """The W4 restriction as d2_gen_descent_rows streams it (restrict_rows_w4
    and restrict_finish_w4), in f32: per fine row rho the three row sums of
    each thread (even column: w00 / w10; odd column, right sum: w00 / w10;
    odd column, left sum: w01 / w11), an odd rho ending coarse row
    (rho - 1) / 2, then (left + mid) + right, zero on the coarse boundary."""
    H = r.shape[0]
    Hc = (H - 1) // 2 + 1
    w00, w01, w10, w11 = w4
    even = np.arange(0, H, 2)
    acc = np.zeros((3, even.size), np.float32)
    out = np.zeros((Hc, Hc), np.float32)
    zero = np.zeros((1, H), np.float32)
    rp, w0p, w1p = (np.concatenate([x, zero]) for x in (r, w00, w10))
    w01p, w11p = np.concatenate([w01, zero]), np.concatenate([w11, zero])
    # odd column c0 + 1 beyond the grid reads zero residual
    col1 = np.minimum(even + 1, H)

    def at(x, row, c):
        return np.concatenate([x[row], np.zeros(1, np.float32)])[c]

    for rho in range(0, H + 1):
        rr = (at(rp, rho, even), at(rp, rho, col1), at(rp, rho, col1))
        w0 = (at(w0p, rho, even), at(w0p, rho, col1), at(w01p, rho, col1))
        w1 = (at(w1p, rho, even), at(w1p, rho, col1), at(w11p, rho, col1))
        if rho % 2:
            dn = [acc[e] + w0[e] * rr[e] for e in range(3)]
            acc = np.stack([w1[e] * rr[e] for e in range(3)])
            Ic = (rho - 1) // 2
            left = np.concatenate([np.zeros(1, np.float32), dn[2][:-1]])
            fc = (left + dn[0]) + dn[1]
            out[Ic, :] = fc[:Hc]
        else:
            acc = np.stack([acc[e] + w0[e] * rr[e] for e in range(3)])
    out[0, :] = out[-1, :] = out[:, 0] = out[:, -1] = 0.0
    return out


@pytest.mark.parametrize("n", [2, 4, 10, 32])
def test_streamed_w4_restriction_is_the_plain_one(n):
    rng = np.random.default_rng(n)
    H = n + 1
    geo = np.zeros((H, H), np.float32)
    geo[1:-1, 1:-1] = 1.0
    r = (rng.standard_normal((H, H)) * geo).astype(np.float32)
    w4 = rng.standard_normal((4, H, H)).astype(np.float32)
    want = gen._w4_restrict(torch.from_numpy(r), torch.from_numpy(w4)).numpy()
    got = _streamed_w4_restrict(r, w4)
    np.testing.assert_array_equal(got, want)
    # the weights the restriction reads: w00 everywhere, w01 at odd columns,
    # w10 at odd rows, w11 at odd rows and columns; the others change nothing
    w4b = w4.copy()
    w4b[1][:, 0::2] = np.nan
    w4b[2][0::2, :] = np.nan
    w4b[3][0::2, :] = np.nan
    w4b[3][:, 0::2] = np.nan
    np.testing.assert_array_equal(_streamed_w4_restrict(r, np.nan_to_num(w4b, nan=7.0)), want)


@pytest.mark.parametrize("n", SIZES)
def test_partial_buffer_holds_one_sum_per_block(n):
    geoms = [fn(n, s) for fn in (eg.g2_tiles, gen.d2_tiles) for s in STRIPS]
    geoms += [eg.g2_one_pass_tiles(n), gen.d2_one_pass_tiles(n)]
    keys = set()
    for tiles in geoms:
        ws = {}
        partial, done = hx.row_scratch(tiles, 1, torch.device("cpu"), ws)
        assert partial.numel() == tiles.blocks and partial.dtype == torch.float32
        assert done.dtype == torch.int32 and int(done) == 0
        again = hx.row_scratch(tiles, 1, torch.device("cpu"), ws)
        assert again[0] is partial and again[1] is done
        keys |= set(ws)
    # G2's and D2's keys differ from each other's, from their tiles' and from
    # E2's, whose one-pass tile has the same grid
    assert len(keys) == len(geoms)
    others = {("row_scratch", t) for t in (hx.e2_one_pass_tiles(n), hx.e2_tiles(n, 1))}
    others |= {sw._partials_key(which, n) for which in (0, 1, 2)}
    assert not keys & others


class _Props:
    multi_processor_count = 132


@pytest.mark.parametrize("n", SIZES + [130, 1024])
def test_wrappers_take_the_size_choice(n, monkeypatch):
    # the geometry g2_launch_tiles and d2_launch_tiles give the wrappers on a
    # card of 132 SMs whose library reports 4 (G2) or 5 (D2) resident blocks
    asked = []

    def occupancy(symbol, *args):
        asked.append((symbol, args))
        return 4 if symbol == "mg_el_swrr_occupancy" else 5

    monkeypatch.setattr(hx, "occupancy", occupancy)
    monkeypatch.setattr(eg, "_G2_TILES", {})
    monkeypatch.setattr(gen, "_D2_TILES", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    dev = torch.device("cuda", 0)
    cases = [("G2", eg.G2_ONE_PASS_MAX_N.__getitem__,
              lambda bim, bf16: eg.g2_launch_tiles(n, bim, dev), "mg_el_swrr_occupancy", 4)]
    cases += [("D2", lambda bim: gen.D2_ONE_PASS_MAX_N,
               lambda bim, bf16: gen.d2_launch_tiles(n, bim, bf16, dev), "mg_gswrr_occupancy", 5)]
    for leg, limit, launch, symbol, blocks in cases:
        tiles_of, one_pass_of = LEGS[leg]
        for bim in (False, True):
            for bf16 in (False, True):
                tiles = launch(bim, bf16)
                if n <= limit(bim):
                    assert tiles == one_pass_of(n) and tiles.leg == f"{leg}_tile"
                    continue
                want = hx.row_strip(lambda s: tiles_of(n, s), HALO, 132 * blocks, 132)
                assert tiles == tiles_of(n, want) and tiles.leg == leg
                args = (int(bim),) if leg == "G2" else (int(bim), int(bf16))
                assert asked[-1] == (symbol, args)
                count = len(asked)
                assert launch(bim, bf16) is tiles
                assert len(asked) == count
    assert not asked if n <= min(THRESHOLDS) else asked


def _const(name, text):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _body(text, name):
    body = text[text.index(name + "("):]
    return body[:body.index("\n}\n")]


def test_block_shape_matches_the_kernels():
    # the kernels refuse a grid computed for another block shape; the
    # constants here must be csrc/common.cuh's, csrc/elastic.cu's and
    # csrc/general.cu's
    common = (CSRC / "common.cuh").read_text()
    assert (_const("RT", common), _const("RC", common), _const("RD", common)) == (RT, RC, RD)
    assert _const("RS_STRIP_MAX", common) == sw.A12_STRIP_MAX
    for leg, path in (("G2", "elastic.cu"), ("D2", "general.cu")):
        src = (CSRC / path).read_text()
        assert (_const(f"{leg}_UNR", src), _const(f"{leg}_NF", src)) == (UNR, NF)
        body = _body(src, "g2_el_descent_rows" if leg == "G2" else "d2_gen_descent_rows")
        assert "constexpr int BW = RB - 4;" in body
        assert "c0 = x0 - 2 + RC * t, col = x0 - 3, base = y0 - 3;" in body
        assert "const int rows_out = min(strip, H + 1 - y0);" in body
        assert "staged = rows_out + 5, steps = rows_out + 6;" in body
        assert "pending = odd && s >= 6;" in body
        assert "constexpr bool odd = (I & 1) != 0;" in body
        assert "p >= 2 && p < 2 + BW &&" in body
        entry = _body(src, "int mg_el_swrr" if leg == "G2" else "int mg_gswrr")
        assert entry.count("descent_grid_ok(n, 0, one_pass != 0, strip, gx, gy)") == 1
        assert "reduce_kernel" not in entry
    # the grid check the entry points share with E2's, at L = 0
    grid = _body(common, "inline bool descent_grid_ok")
    assert "bw = (RB - 2 * L - 4) / 2" in grid and "gx == (Hc + bw - 1) / bw" in grid
    assert "coarse_grid(n)" in grid
    d2 = _body((CSRC / "general.cu").read_text(), "d2_gen_descent_rows")
    assert "const bool live = s < staged, wlive = s >= 5 && s < steps;" in d2
    assert "p < ((SJ & 1) ? 4 : 2)" in d2 and "base + s - 3" in d2
    # the wrappers refuse fields off a 16-byte boundary before they launch
    assert '_check_aligned(("u", u), ("f", f), ("phase", ph))' in inspect.getsource(
        eg.el_swrr_cuda)
    assert '_check_aligned(("u", u), ("f", f), ("operator", op), ("w4", w4))' in \
        inspect.getsource(gen.gswrr_cuda)
    for tiles_of in (eg.g2_tiles, gen.d2_tiles):
        with pytest.raises(ValueError):
            tiles_of(8, 3)
        with pytest.raises(ValueError):
            tiles_of(8, sw.A12_STRIP_MAX + 2)
