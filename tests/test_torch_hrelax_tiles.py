"""Launch geometry of E1 (``ops/hrelax.py`` ``e1_tiles``, ``e1_one_pass_tiles``,
``row_strip``, ``e1_launch_tiles``): the Python side of what the wrapper
passes to ``csrc/hrelax.cu``, checked without a card.

For every even n from 2 to 64 and for n in {128, 2048, 4096}, with chain
depths L = 1 and 3: the row-streaming bands and strips (and the one-pass
tiles) cover each output node exactly once; every staged row's 16-byte
chunks, from the window's aligned-down start, stay inside the field's
allocation and cover the window, whose rows and columns hold the chain's
halo of L + 1 nodes; the wavefront's stages read only rows finished at an
earlier step and write each owned row once; the partial-sum buffer holds
one float per block; and the geometry the wrapper launches is
``row_strip``'s choice above ``E1_ONE_PASS_MAX_N[L]`` and the one-pass tile up
to it.  The index arithmetic mirrors ``e1_h_relax``'s ``stage`` and step;
``chip_smoke.py`` holds the kernel itself at ragged sizes on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multigrid_feanet_torch.ops import hrelax as hx
from multigrid_feanet_torch.ops import sweep as sw
from test_torch_sweep_tiles import _check_windows, _cover_once

SIZES = list(range(2, 65, 2)) + [128, 2048, 4096]
DEPTHS = (1, 3)
STRIPS = (2, 32, sw.A12_STRIP_MAX)
CSRC = Path(hx.__file__).resolve().parent.parent / "csrc"
# csrc/common.cuh: a staged node window of RW floats in slots of RSLOT, a
# phase window of RWQ bytes in slots of RSLOTQ
RB = sw.A12_THREADS * sw.A12_COLUMNS
RW, RWQ = RB + 2, RB + 1
RSLOT, RSLOTQ = (RW + 6) // 4 * 4, (RWQ + 30) // 16 * 16


def _blocks(tiles):
    """(x0, y0, rows_out) of every block of a row-streaming geometry."""
    H = tiles.n + 1
    for by in range(tiles.gy):
        for bx in range(tiles.gx):
            y0 = by * tiles.strip
            yield bx * tiles.band, y0, min(tiles.strip, H - y0)


@pytest.mark.parametrize("n", SIZES)
def test_bands_and_strips_cover_each_node_once(n):
    H = n + 1
    for L in DEPTHS:
        for strip in STRIPS:
            tiles = hx.e1_tiles(n, L, strip)
            assert tiles.band == RB - 2 * L and tiles.strip == strip
            assert _cover_once(np.arange(tiles.gx) * tiles.band, tiles.band, H)
            assert _cover_once(np.arange(tiles.gy) * strip, strip, H)
    one = hx.e1_one_pass_tiles(n)
    assert (one.band, one.strip) == (32, 16)
    assert _cover_once(np.arange(one.gx) * 32, 32, H)
    assert _cover_once(np.arange(one.gy) * 16, 16, H)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("L", DEPTHS)
def test_staging_windows_stay_inside_the_allocation(n, L):
    H = n + 1
    for strip in STRIPS:
        tiles = hx.e1_tiles(n, L, strip)
        u_rows, f_rows, cols = [], [], []
        for x0, y0, rows_out in _blocks(tiles):
            staged = rows_out + 2 * L + 2
            rows = y0 - L - 1 + np.arange(staged)
            u_rows.append(rows)  # u (and a boundary field) row base + s
            f_rows.append(rows - 1)  # f and phase row base + s - 1
            cols.append(np.full(staged, x0 - L - 1))
            # the window holds the chain's halo: u over columns x0 - L - 1 ..
            # x0 + band + L and rows y0 - L - 1 .. y0 + rows_out + L; f over
            # the Jacobi rows y0 - L .. y0 + rows_out + L - 1; the phases
            # over the element rows and columns one below those
            assert x0 - L - 1 >= cols[-1][0] and x0 + tiles.band + L < cols[-1][0] + RW
            assert rows[0] <= y0 - L - 1 and rows[-1] >= y0 + rows_out + L
            assert rows[0] - 1 <= y0 - L - 1 and rows[-1] - 1 >= y0 + rows_out + L - 1
            assert x0 + tiles.band + L - 1 < cols[-1][0] + RWQ
        u_rows, f_rows, cols = map(np.concatenate, (u_rows, f_rows, cols))
        _check_windows(((u_rows, cols, H, H, H * H, 4, RSLOT, RW),
                        (f_rows, cols, H, H, H * H, 4, RSLOT, RW),
                        (f_rows, cols, n, n, n * n, 16, RSLOTQ, RWQ)))
    # one chunk of a row per thread (stage_window: thread k copies chunk k)
    assert RSLOT // 4 <= sw.A12_THREADS and RSLOTQ // 16 <= sw.A12_THREADS


@pytest.mark.parametrize("L", DEPTHS)
@pytest.mark.parametrize("rows_out", [1, 2, 7, 32, sw.A12_STRIP_MAX])
def test_wavefront_reads_only_rows_of_earlier_steps(L, rows_out):
    # rows relative to the strip's first row y0 = 0: step s has u row
    # base + s (staged RD steps earlier), the Jacobi stage computes row
    # i = base + s - 1 and layer l row i - 2l, from step 2 to the last of
    # rows_out + e1_halo_steps(L); layer L's row is the output
    base, staged = -L - 1, rows_out + 2 * L + 2
    steps = rows_out + hx.e1_halo_steps(L)
    done = {}  # (stage, row) -> step
    for s in range(2, steps):
        i = base + s - 1
        done[(0, i)] = s
        for l in range(1, L + 1):
            done[(l, i - 2 * l)] = s
    # every row a stage needs (layer l: -L + l .. rows_out - 1 + L - l) is
    # computed at a step after the rows of its inputs
    for l in range(L + 1):
        for r in range(-L + l, rows_out + L - l):
            s = done[(l, r)]
            if l == 0:  # u rows r - 1 .. r + 1, staged and arrived by step s
                assert r + 1 - base <= s and r + 1 - base < staged
            else:
                assert all(done[(l - 1, q)] < s for q in (r - 1, r, r + 1))
    # the output rows: layer L over the owned rows, each at one step
    assert all((L, r) in done for r in range(rows_out))
    assert done[(L, rows_out - 1)] == steps - 1
    src = (CSRC / "hrelax.cu").read_text()
    assert "staged = rows_out + 2 * L + 2, steps = staged + L;" in src


@pytest.mark.parametrize("n", SIZES)
def test_partial_buffer_holds_one_sum_per_block(n):
    geoms = [hx.e1_tiles(n, L, s) for L in DEPTHS for s in STRIPS] + [hx.e1_one_pass_tiles(n)]
    keys = set()
    for tiles in geoms:
        ws = {}
        partial, done = hx.row_scratch(tiles, 1, torch.device("cpu"), ws)
        assert partial.numel() == tiles.blocks and partial.dtype == torch.float32
        assert done.dtype == torch.int32 and int(done) == 0
        assert hx.row_scratch(tiles, 1, torch.device("cpu"), ws)[0] is partial
        keys |= set(ws)
    # E1's scratch keys differ from A1's and A2's and from the shared grids'
    others = {sw._tiles_key(sw.a1_tiles(n)), sw._tiles_key(sw.a2_tiles(n))}
    others |= {sw._partials_key(which, n) for which in (0, 1, 2)}
    assert not keys & others


@pytest.mark.parametrize("n", [504, 1000, 16384])
def test_one_workspace_serves_both_depths(n):
    # the band, and so the number of blocks, depends on L: at these sizes
    # ceil((n+1)/254) != ceil((n+1)/250), and a workspace shared by an L = 1
    # and an L = 3 net must hold each launch's partials in a buffer of its
    # own block count, whichever depth comes first
    assert hx.e1_tiles(n, 1).gx != hx.e1_tiles(n, 3).gx
    for order in (DEPTHS, DEPTHS[::-1]):
        ws = {}
        bufs = {L: hx.row_scratch(hx.e1_tiles(n, L), 1, torch.device("cpu"), ws)
                for L in order}
        for L, (partial, _) in bufs.items():
            assert partial.numel() == hx.e1_tiles(n, L).blocks
        assert bufs[1][0] is not bufs[3][0] and bufs[1][1] is not bufs[3][1]
        # and the one-pass tile at the same n takes a buffer of its own
        tile = hx.row_scratch(hx.e1_one_pass_tiles(n), 1, torch.device("cpu"), ws)[0]
        assert tile.numel() == hx.e1_one_pass_tiles(n).blocks
        assert all(tile is not p for p, _ in bufs.values())


def _cost(tiles_of, halo, slots, sms, strip):
    blocks = tiles_of(strip).blocks
    return (strip + halo) * (sw._STEP_LATENCY * -(-blocks // slots) + -(-blocks // sms))


@pytest.mark.parametrize("n", SIZES)
def test_row_strip_takes_the_cheapest_height(n):
    for L in DEPTHS:
        for sms, per_sm in ((132, 4), (132, 6), (66, 5)):
            tiles_of = lambda s, L=L: hx.e1_tiles(n, L, s)  # noqa: E731
            strip = hx.row_strip(tiles_of, hx.e1_halo_steps(L), sms * per_sm, sms)
            assert strip % 2 == 0 and 2 <= strip <= sw.A12_STRIP_MAX
            costs = [_cost(tiles_of, hx.e1_halo_steps(L), sms * per_sm, sms, s)
                     for s in range(2, sw.A12_STRIP_MAX + 1, 2)]
            assert _cost(tiles_of, hx.e1_halo_steps(L), sms * per_sm, sms, strip) == min(costs)
    # the coarsest levels fit one wave at any height: the shortest chain wins
    if n <= 256:
        assert hx.row_strip(lambda s: hx.e1_tiles(n, 3, s), 11, 528, 132) == 2


class _Props:
    multi_processor_count = 132


@pytest.mark.parametrize("n", SIZES + [130, 256, 258, 512, 514, 1024])
def test_wrapper_takes_the_size_choice(n, monkeypatch):
    # the geometry e1_launch_tiles gives the wrapper on a card of 132 SMs
    # whose library reports 4 (L = 3) or 5 (L = 1) resident blocks: the
    # one-pass tile up to E1_ONE_PASS_MAX_N[L], else row_strip's height
    asked = []

    def occupancy(symbol, *args):
        asked.append((symbol, args))
        return 4 if args[2] == 3 else 5

    monkeypatch.setattr(hx, "occupancy", occupancy)
    monkeypatch.setattr(hx, "_E1_TILES", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    dev = torch.device("cuda", 0)
    for L in DEPTHS:
        for bim, dform, mode in ((False, False, 1), (True, True, 0), (True, False, 2)):
            tiles = hx.e1_launch_tiles(n, L, bim, dform, mode, dev)
            if n <= hx.E1_ONE_PASS_MAX_N[L]:
                assert tiles == hx.e1_one_pass_tiles(n) and tiles.leg == "E1_tile"
                continue
            slots = 132 * (4 if L == 3 else 5)
            want = hx.row_strip(lambda s, L=L: hx.e1_tiles(n, L, s), hx.e1_halo_steps(L), slots,
                                132)
            assert tiles == hx.e1_tiles(n, L, want) and tiles.leg == "E1"
            assert asked[-1] == ("mg_hrelax_occupancy", (int(bim), int(dform), L, mode))
            # computed once per level shape
            count = len(asked)
            assert hx.e1_launch_tiles(n, L, bim, dform, mode, dev) is tiles
            assert len(asked) == count
    assert not asked if n <= min(hx.E1_ONE_PASS_MAX_N.values()) else asked


def test_block_shape_matches_the_kernels():
    # the kernels refuse a grid computed for another block shape; the
    # constants here must be csrc/common.cuh's and csrc/hrelax.cu's
    common = (CSRC / "common.cuh").read_text()
    src = (CSRC / "hrelax.cu").read_text()

    def const(name, text=common):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert (const("RT"), const("RC"), const("RS_STRIP_MAX")) == (
        sw.A12_THREADS, sw.A12_COLUMNS, sw.A12_STRIP_MAX)
    # the one-pass tiles: the fine tiles (2 CY x 2 CX) of the coarse grid
    assert (2 * const("CY"), 2 * const("CX")) == (16, 32)
    body = src[src.index("inline bool e1_grid_ok("):]
    body = body[:body.index("\n}\n")]
    assert "bw = RB - 2 * L" in body and "coarse_grid(n)" in body
    entry = src[src.index("int mg_hrelax("):]
    assert entry[:entry.index("\n}\n")].count("e1_grid_ok(n, L, one_pass, strip, gx, gy)") == 1
    for n in SIZES:
        for L in DEPTHS:
            assert hx.e1_tiles(n, L).band == sw.A12_THREADS * sw.A12_COLUMNS - 2 * L
    with pytest.raises(ValueError):
        hx.e1_tiles(8, 1, 3)
    with pytest.raises(ValueError):
        hx.e1_tiles(8, 1, sw.A12_STRIP_MAX + 2)
