"""Launch geometry of the row-streaming X1 (``ops/passes.py`` ``x1_tiles``,
``x1_strip``, ``x1_launch_tiles``): the Python side of what the wrapper
passes to ``csrc/passes.cu``'s ``x1_heat_rhs_rows``, checked without a card.

The staging windows are computed here with the index arithmetic of
``csrc/common.cuh``'s ``stage_window`` as ``stage_x1_row`` calls it: a u or
f row of 2-, 4- or 8-byte values (bf16, float32, float64 u; float32, float64
f) as one window of 16-byte chunks, one chunk a thread, a float64 row in two
parts; and the pattern-id byte row a step late.  Every chunk starts on a
16-byte boundary at the window's aligned-down start, the chunks cover the
window exactly, copy only bytes inside the field (rows off the grid none),
and the values each thread reads lie inside its slot.  The bands and strips
cover each node once, ``x1_strip`` picks the fewest whole waves of steps,
and the wrapper takes the tile at and below ``X1_ONE_PASS_MAX_N`` and the
row stream above it.  The card checks of ``chip_smoke.py`` hold the kernel
itself against its plain version and the tile, bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multigrid_feanet_torch.ops import passes as px
from multigrid_feanet_torch.ops import sweep as sw

CSRC = Path(px.__file__).resolve().parent.parent / "csrc"
RT, RC = sw.A12_THREADS, sw.A12_COLUMNS
RB = RT * RC  # the band a block's threads cover
RW = RB + 2   # a node row's window: one column each side
SIZES = [2, 3, 8, 32, 33, 64, 126, 128, 256, 1000, 1024, 4096]
STRIPS = (8, 54, px.sw.A12_STRIP_MAX)
ELEMENT_BYTES = {"bf16": 2, "float32": 4, "float64": 8}


def _blocks(tiles):
    """(y0, x0, steps) of every block: step s stages u and f row y0 - 1 + s
    and the pattern-id row y0 - 2 + s; the ragged last strip takes fewer."""
    H = tiles.n + 1
    for by in range(tiles.gy):
        y0 = by * tiles.strip
        for bx in range(tiles.gx):
            yield y0, bx * tiles.band, min(tiles.strip, H - y0) + 2


def _stage_window(es, width, rows, length, row, col):
    """``stage_window<es, width>`` for rows ``row`` (an array) of a field of
    ``rows`` x ``length`` values of ``es`` bytes, the window from ``col``:
    per row and thread k, (copies, source byte g, bytes copied, the
    window's byte offset in its first chunk)."""
    row = np.asarray(row, np.int64)[:, None]
    at = es * (row * length + col)
    a = at & ~15
    k16 = 16 * np.arange(RT)[None, :]
    g = a + k16
    copies = k16 < at - a + es * width
    off = (row < 0) | (row >= rows) | (g < 0)
    valid = np.where(off, 0, np.clip(es * rows * length - g, 0, 16))
    return copies, g, np.where(copies, valid, 0), (at - a)[:, 0]


def _staged_row(es, rows, length, row, col):
    """``stage_x1_row``: the (destination byte, source byte, bytes) of every
    chunk of each row's window [col, col + RW), and the window's offset in
    its slot; a float64 row in two parts, the second 1024 bytes on."""
    parts = [(0, es, RW, col)] if es < 8 else [(0, 8, 127, col), (1024, 8, RW - 128, col + 128)]
    dst, src, size, first = [], [], [], None
    for shift, e, width, c in parts:
        copies, g, valid, off = _stage_window(e, width, rows, length, row, c)
        assert copies.sum(axis=1).max() <= RT  # one chunk a thread
        dst.append(np.where(copies, shift + 16 * np.arange(RT)[None, :], -1))
        src.append(g)
        size.append(valid)
        first = off if first is None else first
    return np.concatenate(dst, 1), np.concatenate(src, 1), np.concatenate(size, 1), first


def _slot_bytes(es):
    """csrc/passes.cu x1_slot: RW values after an offset of up to one chunk,
    in whole chunks."""
    el = 16 // es
    return (RW + el - 1 + el - 1) // el * el * es


def _check_row(es, rows, length, row, col, width, slot):
    """The chunks of each staged row start 16-byte aligned at its source
    bytes' place in the slot, stay inside the field and the slot, run
    back to back from the slot's start (no slot chunk staged twice) past
    the window's end, copy every byte of the window inside the field, and
    nothing of a row off the grid."""
    dst, src, size, off = _staged_row(es, rows, length, row, col)
    used = dst >= 0
    total = es * rows * length
    lo = es * (row * length + col) - off  # the source byte of slot byte 0
    assert (src[used] % 16 == 0).all()
    assert ((dst - (src - lo[:, None]))[used] == 0).all()
    assert (dst[used] + 16 <= slot).all()
    count = used.sum(axis=1)
    d = np.sort(np.where(used, dst, np.iinfo(np.int64).max), axis=1)
    step = np.arange(d.shape[1])[None, :]
    assert ((d == 16 * step) | (step >= count[:, None])).all()
    assert (16 * count >= off + es * width).all()
    # bytes copied: all 16 of a chunk inside the field on a row of the grid,
    # the part inside the field at its end, none off the grid
    on = ((row >= 0) & (row < rows))[:, None]
    want = np.where(on & used & (src >= 0), np.clip(total - src, 0, 16), 0)
    assert (size == want).all()
    assert ((src + size <= total) | (size == 0)).all()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("field", sorted(ELEMENT_BYTES))
def test_node_rows_stage_their_window_exactly(n, field):
    es, H = ELEMENT_BYTES[field], n + 1
    slot = _slot_bytes(es)
    for tiles in (px.x1_tiles(n, s) for s in STRIPS):
        for bx in range(tiles.gx):
            # every row the blocks of band bx stage, window from x0 - 1
            rows = np.concatenate([y0 - 1 + np.arange(steps) for y0, x0, steps in _blocks(tiles)
                                   if x0 == bx * RB])
            _check_row(es, H, H, rows, bx * RB - 1, RW, slot)


@pytest.mark.parametrize("n", SIZES)
def test_pattern_id_rows_stage_the_band_a_step_late(n):
    # the byte row of the row computed at step s (y0 - 2 + s), window
    # [x0, x0 + RB), in slots of common.cuh's RSLOTQ bytes
    H, slot = n + 1, (RB + 1 + 15 + 15) // 16 * 16
    for tiles in (px.x1_tiles(n, s) for s in STRIPS):
        for y0, x0, steps in _blocks(tiles):
            s = np.arange(steps)
            copies, g, valid, off = _stage_window(1, RB, H, H, y0 - 2 + s, x0)
            assert (16 * copies.sum(axis=1) <= slot).all() and (off + RB <= slot).all()
            assert ((g >= 0) & (g + valid <= H * H) | (valid == 0)).all()
            computed = y0 - 2 + s[s >= 2]  # the rows the block computes
            assert list(computed) == list(range(y0, min(y0 + tiles.strip, H)))


@pytest.mark.parametrize("field", sorted(ELEMENT_BYTES))
def test_threads_read_inside_their_slot(field):
    # read_x1_row: thread t reads window positions RC t .. RC t + RC + 1
    # after the row's offset in its first chunk (up to one chunk less one
    # value), which stay inside the slot
    es = ELEMENT_BYTES[field]
    last = (16 // es - 1) + RC * (RT - 1) + RC + 1
    assert es * (last + 1) <= _slot_bytes(es)
    assert RC * (RT - 1) + RC + 1 == RW - 1


@pytest.mark.parametrize("n", [32, 64, 128, 256, 1024, 4096])
def test_bands_and_strips_cover_each_node_once(n):
    H = n + 1
    strips = sorted({px.x1_strip(n, slots) for slots in (132, 660, 1320, 2112)} | set(STRIPS))
    for strip in strips:
        tiles = px.x1_tiles(n, strip)
        assert tiles.band == RB and tiles.leg == "X1"
        seen = np.zeros((H, H), np.uint8)
        for y0, x0, _ in _blocks(tiles):
            seen[y0:y0 + strip, x0:x0 + RB] += 1
        assert (seen == 1).all(), tiles
        assert (tiles.gx - 1) * RB < H and (tiles.gy - 1) * strip < H
    tile = px.x1_one_pass_tiles(n)
    assert (tile.gx, tile.gy) == (-(-H // 32), -(-H // 8)) and tile.leg == "X1_tile"


@pytest.mark.parametrize("n", [64, 1024, 2048, 4096])
@pytest.mark.parametrize("slots", [132, 660, 1320, 2112])
def test_x1_strip_takes_the_fewest_whole_waves_of_steps(n, slots):
    strip = px.x1_strip(n, slots)
    assert strip % 2 == 0 and px.X1_MIN_STRIP <= strip <= sw.A12_STRIP_MAX

    def cost(s):
        return -(-px.x1_tiles(n, s).blocks // slots) * (s + px.X1_HALO_STEPS)

    assert all(cost(strip) <= cost(s) for s in range(px.X1_MIN_STRIP, sw.A12_STRIP_MAX + 1, 2))


class _Props:
    multi_processor_count = 132


@pytest.mark.parametrize("bim", [True, False])
@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("n", [32, 64, 128, 256, 512, 1024, 4096, 8192])
def test_wrapper_takes_the_tile_up_to_the_crossover(n, f64, bim, monkeypatch):
    asked = []

    def occupancy(symbol, *args):
        asked.append((symbol, args))
        return 10

    monkeypatch.setattr(px.hx, "occupancy", occupancy)
    monkeypatch.setattr(px, "_X1_TILES", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    dev = torch.device("cuda", 0)
    u_type = 2 if f64 else 0
    tiles = px.x1_launch_tiles(n, u_type, f64, bim, False, dev)
    if n <= px.X1_ONE_PASS_MAX_N[(f64, bim)]:
        assert tiles == px.x1_one_pass_tiles(n) and not asked
        return
    assert tiles == px.x1_tiles(n, px.x1_strip(n, 10 * 132))
    assert asked == [("px_heat_rhs_occupancy", (u_type, int(f64), int(bim), 0))]
    assert px.x1_launch_tiles(n, u_type, f64, bim, False, dev) is tiles and len(asked) == 1
    # forcing a design, as chip_smoke.py does: the tile by a threshold at n
    monkeypatch.setitem(px.X1_ONE_PASS_MAX_N, (f64, bim), n)
    assert px.x1_launch_tiles(n, u_type, f64, bim, False, dev).leg == "X1_tile"


def test_block_shape_matches_the_kernel():
    common = (CSRC / "common.cuh").read_text()
    src = (CSRC / "passes.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", common).group(1))

    assert (const("RT"), const("RC"), const("RS_STRIP_MAX")) == (RT, RC, sw.A12_STRIP_MAX)
    body = src[src.index("inline bool x1_grid_ok("):]
    body = body[:body.index("\n}\n")]
    assert "gx == (H + RB - 1) / RB" in body and "gy == (H + strip - 1) / strip" in body
    assert "grid_of(H)" in body and re.search(r"PX = 32, PY = 8", src)
    entry = src[src.index("int px_heat_rhs("):]
    assert entry[:entry.index("\n}\n")].count("x1_grid_ok(H, one_pass != 0, strip, gx, gy)") == 1
    # the float64 row's first part ends on the 1024-byte chunk boundary
    assert "stage_window<8, 127>" in src and "stage_window<8, RW - 128>(dst + 1024" in src


def test_fields_off_a_16_byte_boundary_are_copied():
    whole = torch.zeros(9 * 9 + 1)
    aligned, shifted = whole[:-1].view(9, 9), whole[1:].view(9, 9)
    assert aligned.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 == 4
    assert px._aligned(aligned) is aligned and px._aligned(None) is None
    moved = px._aligned(shifted)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, shifted)


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("n", [32, 128, 4096])
def test_weights_repeat_as_the_row_stream_takes_them(n, f64):
    # the row stream takes one product per node for each repeated weight:
    # the mass stencil's corners and edges, S9's neighbour taps and S4's
    # corner; _rhs_weights checks that they repeat, in the kernel's type
    w = list(px._rhs_weights(2.0 / n, 0.5, 1e-3, 1.0, 20.0, (0.0,) * 9, f64))
    m, s9, d4 = w[:9], w[18:27], w[29]
    assert px._repeats(m, s9, d4) and len(set(m)) == 3 and len(set(s9)) == 2
    assert not px._repeats(m[:1] + [m[1] * 2] + m[2:], s9, d4)
    assert not px._repeats(m, s9, d4 * 2)
