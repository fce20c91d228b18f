"""Launch geometry of the row-streaming A1-A4 kernels (``ops/sweep.py``
``a1_tiles`` ... ``a4_tiles``, ``balanced_strip``): the Python side of what
the wrappers pass to ``csrc/sweep.cu``, checked without a card.

For every even n from 2 to 64 and for n in {126, 128, 2048, 4096}:
the bands and strips cover each output node (and A2's and A3's coarse
nodes) exactly once, A3 and A4 at every strip the wrappers can pick; every
staged row's 16-byte chunks, from the window's aligned-down start, stay
inside the field's allocation and cover the window; ``balanced_strip``
picks the cheapest height under each leg's cost; the partial-sum buffer
holds one float per block; and the scratch's workspace key differs from
those of C1/D1 and A5/A6/D2.  The staging windows are computed here with
the index arithmetic of ``csrc/sweep.cu``'s ``stage_step`` and
``stage_z``; the card checks of ``chip_smoke.py`` hold the kernels
themselves at ragged sizes.  The bf16 storage form stages the same windows
of 2-byte elements, 8 to a chunk (``test_bf16_*``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multigrid_feanet_torch.ops import sweep as sw

SIZES = list(range(2, 65, 2)) + [126, 128, 2048, 4096]
STRIPS = (8, sw.A12_STRIP, sw.A12_STRIP_MAX)
SOURCE = Path(sw.__file__).resolve().parent.parent / "csrc" / "sweep.cu"


def _all_tiles(n):
    """A1's and A2's geometry at a short, the default and the tallest strip."""
    return [fn(n, strip) for strip in STRIPS for fn in (sw.a1_tiles, sw.a2_tiles)]


def _owned(tiles):
    """Per-block owned fine ranges (rows, columns) and, for A2, coarse."""
    H, Hc = tiles.n + 1, tiles.n // 2 + 1
    for by in range(tiles.gy):
        for bx in range(tiles.gx):
            y0, x0 = by * tiles.strip, bx * tiles.band
            fine = (range(y0, min(y0 + tiles.strip, H)), range(x0, min(x0 + tiles.band, H)))
            coarse = (range(y0 // 2, min((y0 + tiles.strip) // 2, Hc)),
                      range(x0 // 2, min((x0 + tiles.band) // 2, Hc)))
            yield fine, coarse


@pytest.mark.parametrize("n", SIZES)
def test_bands_and_strips_cover_each_node_once(n):
    H, Hc = n + 1, n // 2 + 1
    for tiles in _all_tiles(n):
        assert tiles.band % 2 == 0 and tiles.strip % 2 == 0
        fine, coarse = np.zeros((H, H), np.uint8), np.zeros((Hc, Hc), np.uint8)
        for (rows, cols), (crows, ccols) in _owned(tiles):
            fine[rows.start:rows.stop, cols.start:cols.stop] += 1
            coarse[crows.start:crows.stop, ccols.start:ccols.stop] += 1
        assert (fine == 1).all(), tiles
        if tiles.leg == "A2":
            assert (coarse == 1).all(), tiles
        # no block row or column lies wholly off the grid
        assert (tiles.gx - 1) * tiles.band < H and (tiles.gy - 1) * tiles.strip < H


# csrc/sweep.cu's staging: a block's windows start COL0 columns left of its
# band; step s stages u row y0 + ROW0 + s and f and phase row y0 + ROW0 + s - 1
COL0 = ROW0 = {"A1": -1, "A2": -3}


def _steps(tiles, by):
    """Rows block row ``by`` stages (the ragged last strip stages fewer)."""
    H, y0 = tiles.n + 1, by * tiles.strip
    if tiles.leg == "A1":
        return min(tiles.strip, H - y0) + 2
    return min(tiles.strip, H + 1 - y0) + 5


def _slot_sizes(elems=4):
    """(elements of a u or f slot, bytes of a phase slot) of the kernels'
    shared ring: a window of threads x columns + 2 (+ 1) elements after an
    offset of up to one chunk, in whole 16-byte chunks of ``elems`` node
    values (4 floats, 8 bf16)."""
    w = sw.A12_THREADS * sw.A12_COLUMNS
    return (w + 2 + 2 * (elems - 1)) // elems * elems, (w + 1 + 30) // 16 * 16


def _staged_chunks(row, col, width, row_len, rows, total, elems, slot):
    """The 16-byte chunks that stage the window ``[col, col + width)`` of
    ``row`` of a compact field of ``rows`` rows of ``row_len`` elements
    (``total`` in all, ``elems`` elements per chunk), as ``stage_step``
    copies them; ``row`` and ``col`` broadcast.  Returns (start, valid,
    used, offset): each chunk slot's first element index, the elements it
    copies (0: zero-filled), whether the window uses it, and the window's
    offset in its first chunk."""
    row, col = np.broadcast_arrays(np.asarray(row, np.int64), np.asarray(col, np.int64))
    a = row * row_len + col
    start0 = a & ~(elems - 1)
    nch = (a - start0 + width + elems - 1) // elems
    k = np.arange(slot // elems)
    start = start0[..., None] + elems * k
    used = k < nch[..., None]
    inside = (row[..., None] >= 0) & (row[..., None] < rows) & (start >= 0)
    valid = np.where(used & inside, np.clip(total - start, 0, elems), 0)
    return start, valid, used, a - start0


def _staged_rows(tiles):
    """(u row, f and phase row, window column) of every step of every block."""
    us, fs, cols = [], [], []
    for by in range(tiles.gy):
        steps = np.arange(_steps(tiles, by))
        for bx in range(tiles.gx):
            u_rows = by * tiles.strip + ROW0[tiles.leg] + steps
            us.append(u_rows)
            fs.append(u_rows - 1)
            cols.append(np.full_like(steps, bx * tiles.band + COL0[tiles.leg]))
    return np.concatenate(us), np.concatenate(fs), np.concatenate(cols)


def _check_windows(fields):
    """Each (rows, cols, row_len, nrows, total, elems, slot, win) staged
    window's chunks stay inside the field and cover the window."""
    for rows, cols, row_len, nrows, total, elems, slot, win in fields:
        start, valid, used, off = _staged_chunks(rows, cols, win, row_len, nrows, total,
                                                 elems, slot)
        copied = valid > 0
        # every chunk that copies lies inside [0, total) and starts aligned
        assert (start[copied] >= 0).all() and (start[copied] + valid[copied] <= total).all()
        assert (start[used] % elems == 0).all()
        # the window fits its slot after the offset
        assert (off >= 0).all() and (off < elems).all()
        assert (off + win <= slot).all()
        # on the grid's rows, the used chunks copy every element of the
        # window that lies inside the field, and only rows off it copy nothing
        a = rows * row_len + cols
        on = (rows >= 0) & (rows < nrows)
        first = start[:, 0]
        last = first + elems * used.sum(axis=1)
        assert (last >= a + win).all()
        want = np.clip(np.minimum(last, total) - np.maximum(first, 0), 0, None)
        assert (valid.sum(axis=1)[on] == want[on]).all()
        assert (valid[~on] == 0).all()


@pytest.mark.parametrize("n", SIZES)
def test_staging_windows_stay_inside_the_allocation(n):
    H = n + 1
    slot_f, slot_q = _slot_sizes()
    width = sw.A12_THREADS * sw.A12_COLUMNS
    for tiles in (sw.a1_tiles(n), sw.a2_tiles(n)):
        u_rows, f_rows, cols = _staged_rows(tiles)
        _check_windows(((u_rows, cols, H, H, H * H, 4, slot_f, width + 2),
                        (f_rows, cols, H, H, H * H, 4, slot_f, width + 2),
                        (f_rows, cols, n, n, n * n, 16, slot_q, width + 1)))


@pytest.mark.parametrize("n", SIZES)
def test_bf16_staging_windows_stay_inside_the_allocation(n):
    # bf16 rows: 8 values per 16-byte chunk and offsets of up to 7 values,
    # in slots of 272 (csrc/sweep.cu's Ring<__nv_bfloat16>); row starts fall
    # on every 2-byte offset, and the last partial chunk holds an odd
    # number of values
    H = n + 1
    slot_u, slot_q = _slot_sizes(8)
    assert slot_u == 272 and slot_u % 8 == 0
    width = sw.A12_THREADS * sw.A12_COLUMNS
    for tiles in (sw.a1_tiles(n), sw.a2_tiles(n)):
        u_rows, f_rows, cols = _staged_rows(tiles)
        _check_windows(((u_rows, cols, H, H, H * H, 8, slot_u, width + 2),
                        (f_rows, cols, H, H, H * H, 8, slot_u, width + 2),
                        (f_rows, cols, n, n, n * n, 16, slot_q, width + 1)))


# csrc/sweep.cu's A3 and A4 (stage_z): f and phase row y0 + A34_ROW0 + s at
# step s, the f window from column x0 + A34_COL0, the phase window
# A34_QOFF columns further
A34_ROW0, A34_COL0, A34_QOFF = {"A3": -3, "A4": -2}, {"A3": -3, "A4": -1}, {"A3": 0, "A4": -1}


def _a34_staged_rows(tiles):
    """(f and phase row, f window column) of every step of every block of
    A3 (``staged`` steps: its last step stages nothing) or A4."""
    H, leg = tiles.n + 1, tiles.leg
    rows, cols = [], []
    for by in range(tiles.gy):
        y0 = by * tiles.strip
        staged = (min(tiles.strip, H + 1 - y0) + 4 if leg == "A3"
                  else min(tiles.strip, H - y0) + 3)
        r = y0 + A34_ROW0[leg] + np.arange(staged)
        for bx in range(tiles.gx):
            rows.append(r)
            cols.append(np.full_like(r, bx * tiles.band + A34_COL0[leg]))
    return np.concatenate(rows), np.concatenate(cols)


@pytest.mark.parametrize("n", SIZES)
def test_a34_staging_windows_stay_inside_the_allocation(n):
    H, width = n + 1, sw.A12_THREADS * sw.A12_COLUMNS
    for tiles_of in (sw.a3_tiles, sw.a4_tiles):
        for strip in (2, sw.A12_STRIP):
            tiles = tiles_of(n, strip)
            slot_f, slot_q = _slot_sizes()
            rows, cols = _a34_staged_rows(tiles)
            # one chunk per thread: the f chunks on warps 0-2, the phase
            # chunks on warp 3
            assert slot_f // 4 <= sw.A12_THREADS - 32 and slot_q // 16 <= 32
            _check_windows(((rows, cols, H, H, H * H, 4, slot_f, width + 2),
                            (rows, cols + A34_QOFF[tiles.leg], n, n, n * n, 16, slot_q,
                             width + 1)))


@pytest.mark.parametrize("n", SIZES)
def test_bf16_a34_staging_windows_stay_inside_the_allocation(n):
    H, width = n + 1, sw.A12_THREADS * sw.A12_COLUMNS
    slot_u, slot_q = _slot_sizes(8)
    # one chunk per thread: 34 bf16 f chunks on warps 0-2, the phase chunks
    # on warp 3
    assert slot_u // 8 <= sw.A12_THREADS - 32 and slot_q // 16 <= 32
    for tiles_of in (sw.a3_tiles, sw.a4_tiles):
        for strip in (2, sw.A12_STRIP):
            tiles = tiles_of(n, strip)
            rows, cols = _a34_staged_rows(tiles)
            _check_windows(((rows, cols, H, H, H * H, 8, slot_u, width + 2),
                            (rows, cols + A34_QOFF[tiles.leg], n, n, n * n, 16, slot_q,
                             width + 1)))


def _cover_once(starts, width, total):
    """Ranges [start, start + width) clipped to [0, total) cover it once."""
    count = np.zeros(total + 1, np.int64)
    np.add.at(count, np.minimum(starts, total), 1)
    np.add.at(count, np.minimum(starts + width, total), -1)
    return (np.cumsum(count)[:total] == 1).all() and (starts < total).all()


@pytest.mark.parametrize("n", SIZES)
def test_a34_bands_and_strips_cover_each_node_once(n):
    # every strip the wrappers can pick: A4's bands and strips own each fine
    # output node once, A3's each coarse node once
    H, Hc = n + 1, n // 2 + 1
    for strip in range(2, sw.A12_STRIP_MAX + 1, 2):
        a4, a3 = sw.a4_tiles(n, strip), sw.a3_tiles(n, strip)
        assert (a4.leg, a3.leg) == ("A4", "A3")
        assert _cover_once(np.arange(a4.gy) * strip, strip, H)
        assert _cover_once(np.arange(a4.gx) * a4.band, a4.band, H)
        assert _cover_once(np.arange(a3.gy) * strip // 2, strip // 2, Hc)
        assert _cover_once(np.arange(a3.gx) * a3.band // 2, a3.band // 2, Hc)


@pytest.mark.parametrize("n", SIZES)
def test_balanced_strip_takes_the_fewest_block_steps(n):
    # cards holding 132 x {1, 4, 8} blocks, the psweep's occupancy varying
    # with the strip; the choice is an even height whose waves of blocks
    # times steps per block no other height beats
    for slots in (lambda s: 132, lambda s: 528, lambda s: 132 * (8 if s <= 64 else 4)):
        for leg, tiles_of in (("A1", sw.a1_tiles), ("A2", sw.a2_tiles)):
            strip = sw.balanced_strip(leg, n, slots)
            assert strip % 2 == 0 and 8 <= strip <= sw.A12_STRIP_MAX

            def cost(s):
                blocks = tiles_of(n, s).blocks
                return -(-blocks // slots(s)) * (s + sw._HALO_STEPS[leg])

            assert all(cost(strip) <= cost(s) for s in range(8, sw.A12_STRIP_MAX + 1, 2))
            tiles_of(n, strip)  # a geometry the kernels take
            # the SM count does not enter A1's and A2's choice
            assert sw.balanced_strip(leg, n, slots, sms=66) == strip


@pytest.mark.parametrize("n", SIZES)
def test_a34_balanced_strip_weighs_latency_against_crowding(n):
    # A3 and A4 take strips down to 2 rows; each step costs a block the
    # step latency (3 units per wave) plus its SM's share of blocks
    for sms in (132, 66):
        for slots in (lambda s: 6 * sms, lambda s: sms * (8 if s <= 16 else 2)):
            for leg in ("A3", "A4"):
                strip = sw.balanced_strip(leg, n, slots, sms)
                assert strip % 2 == 0 and 2 <= strip <= sw.A12_STRIP_MAX

                def cost(s):
                    blocks = sw.TILES[leg](n, s).blocks
                    waves = -(-blocks // slots(s))
                    return (s + sw._HALO_STEPS[leg]) * (3 * waves + -(-blocks // sms))

                assert all(cost(strip) <= cost(s) for s in range(2, sw.A12_STRIP_MAX + 1, 2))
    # the coarsest levels fit one wave at any height: the shortest chain wins
    if n <= 256:
        assert sw.balanced_strip("A3", n, lambda s: 792) == 2
        assert sw.balanced_strip("A4", n, lambda s: 792) == 2


@pytest.mark.parametrize("n", SIZES)
def test_partial_buffer_holds_one_sum_per_block(n):
    for tiles in (sw.a1_tiles(n), sw.a2_tiles(n)):
        ws = {}
        partial, done = sw._tile_scratch(tiles, torch.device("cpu"), ws)
        assert partial.numel() == tiles.blocks == tiles.gx * tiles.gy
        assert partial.dtype == torch.float32
        assert done.dtype == torch.int32 and done.numel() == 1 and int(done) == 0
        # the workspace keeps the same buffers for the next launch
        again = sw._tile_scratch(tiles, torch.device("cpu"), ws)
        assert again[0] is partial and again[1] is done


@pytest.mark.parametrize("n", SIZES)
def test_workspace_keys_differ_from_the_other_grids(n):
    shared = {sw._partials_key(which, n) for which in (0, 1, 2)}
    keys = {sw._tiles_key(sw.a1_tiles(n)), sw._tiles_key(sw.a2_tiles(n))}
    assert len(keys) == 2 and not keys & shared
    for strip in (0, 3, sw.A12_STRIP_MAX + 2):
        with pytest.raises(ValueError):
            sw.a1_tiles(n, strip)
        with pytest.raises(ValueError):
            sw.a2_tiles(n, strip)


def test_block_shape_matches_the_kernels():
    # the kernels refuse a grid computed for another block shape; the
    # constants here must be csrc/sweep.cu's
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("ST"), const("SC")) == (sw.A12_THREADS, sw.A12_COLUMNS)
    assert const("A12_STRIP_MAX") == sw.A12_STRIP_MAX
    # A3 launches on A2's grid, as a3_tiles computes it; A4 on its own
    for entry, check in (("mg_zrr", "a2_grid_ok"), ("mg_zpsweep", "a4_grid_ok"),
                         ("mg_swrr", "a2_grid_ok"), ("mg_sweep", "a1_grid_ok")):
        body = src[src.index(f"int {entry}("):]
        assert body[:body.index("\n}\n")].count(f"{check}(n, strip, gx, gy)") == 1, entry
    assert "bw = SB - 2" in src[src.index("inline bool a4_grid_ok("):]
    for n in SIZES:
        assert sw.a3_tiles(n)[2:] == sw.a2_tiles(n)[2:]
        assert sw.a4_tiles(n).band == sw.A12_THREADS * sw.A12_COLUMNS - 2


@pytest.mark.parametrize("name", ["u", "f", "phase", "uc"])
def test_fields_off_a_16_byte_boundary_are_refused(name):
    n = 8
    whole = torch.zeros((n + 1) * (n + 1) + 1)
    aligned = whole[:-1].view(n + 1, n + 1)
    shifted = whole[1:].view(n + 1, n + 1)  # 4 bytes past the allocation's start
    ph = torch.zeros(n * n + 1, dtype=torch.int8)
    coarse = torch.zeros((n // 2 + 1) ** 2 + 1)
    fields = {"u": aligned, "f": aligned, "phase": ph[:-1].view(n, n),
              "uc": coarse[:-1].view(n // 2 + 1, n // 2 + 1)}
    assert aligned.data_ptr() % 16 == 0 and ph.data_ptr() % 16 == 0
    sw._check_aligned(*fields.items())
    fields[name] = {"phase": ph[1:].view(n, n),
                    "uc": coarse[1:].view(n // 2 + 1, n // 2 + 1)}.get(name, shifted)
    with pytest.raises(ValueError, match=name):
        sw._check_aligned(*fields.items())
