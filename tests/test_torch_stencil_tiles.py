"""Launch geometry of C1 (``ops/stencil_sweep.py`` ``c1_tiles``,
``c1_one_pass_tiles``, ``c1_launch_tiles``): the Python side of what the
wrapper passes to ``csrc/stencil.cu``, checked without a card.

For every even n from 2 to 64 and for the sizes around the one-pass
threshold and up to 4096: the row-streaming bands and strips (and the
one-pass tiles) cover each node exactly once; every staged row's 16-byte
chunks stay inside the field's allocation and cover the window, for u and
f (float32) and for the int8 pattern ids ((n+1)^2 bytes, the window
[x0, x0 + RB) in slots of RSLOTQ bytes); the window a thread computes on
holds each owned node's 3 x 3 neighbourhood, its f and its pattern id; the
partial-sum buffer holds one float per block under a key of its own; and
the geometry the wrapper launches is ``row_strip``'s choice above
``C1_ONE_PASS_MAX_N`` and the one-pass tile up to it.  The index arithmetic
mirrors ``c1_stencil_relax_rows``'s ``stage`` and step; ``chip_smoke.py``
holds the kernel itself at ragged sizes on the card.
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
from test_torch_qsweep_tiles import _window
from test_torch_sweep_tiles import _check_windows, _cover_once

THRESHOLD = ss.C1_ONE_PASS_MAX_N
SIZES = sorted(set(range(2, 65, 2)) | {126, 128, 1000, 2048, 4096}
               | {THRESHOLD - 2, THRESHOLD, THRESHOLD + 2})
STRIPS = (2, 32, sw.A12_STRIP_MAX)
CSRC = Path(ss.__file__).resolve().parent.parent / "csrc"
RT, RC = sw.A12_THREADS, sw.A12_COLUMNS
RB = RT * RC
RW, RWQ = RB + 2, RB + 1
RSLOT, RSLOTQ = (RW + 6) // 4 * 4, (RWQ + 30) // 16 * 16


def _staged_rows(tiles):
    """(u row, f and pattern-id row, window column of u and f) of every
    step of every block; the id window starts one column later."""
    H = tiles.n + 1
    us, fs, cols = [], [], []
    for by in range(tiles.gy):
        y0 = by * tiles.strip
        s = np.arange(min(tiles.strip, H - y0) + ss.C1_HALO_STEPS)
        for bx in range(tiles.gx):
            us.append(y0 - 1 + s)
            fs.append(y0 - 2 + s)
            cols.append(np.full(len(s), bx * RB - 1))
    return np.concatenate(us), np.concatenate(fs), np.concatenate(cols)


@pytest.mark.parametrize("n", SIZES)
def test_bands_and_strips_cover_each_node_once(n):
    H = n + 1
    for strip in STRIPS:
        tiles = ss.c1_tiles(n, strip)
        assert (tiles.leg, tiles.band, tiles.strip) == ("C1", RB, strip)
        assert _cover_once(np.arange(tiles.gx) * RB, RB, H)
        assert _cover_once(np.arange(tiles.gy) * strip, strip, H)
    one = ss.c1_one_pass_tiles(n)
    assert (one.leg, one.band, one.strip) == ("C1_tile", 32, 8)
    assert _cover_once(np.arange(one.gx) * 32, 32, H)
    assert _cover_once(np.arange(one.gy) * 8, 8, H)


@pytest.mark.parametrize("n", SIZES)
def test_staging_windows_stay_inside_the_allocation(n):
    # u and f: float rows of (n+1) values from column x0 - 1; the pattern
    # ids: rows of (n+1) bytes from column x0, RB of them, in slots of
    # RSLOTQ bytes; every slot is at most one chunk per thread
    H = n + 1
    for strip in STRIPS:
        u_rows, f_rows, cols = _staged_rows(ss.c1_tiles(n, strip))
        _check_windows(((u_rows, cols, H, H, H * H, 4, RSLOT, RW),
                        (f_rows, cols, H, H, H * H, 4, RSLOT, RW),
                        (f_rows, cols + 1, H, H, H * H, 16, RSLOTQ, RB)))
    assert RSLOT // 4 <= RT and RSLOTQ // 16 <= RT


@pytest.mark.parametrize("n", SIZES)
def test_windows_hold_each_nodes_neighbourhood(n):
    # a thread's node c0 + e of row i reads u at window positions
    # RC t + e .. RC t + e + 2 of rows i - 1 .. i + 1 (window from x0 - 1),
    # f at RC t + e + 1 and its pattern id at RC t + e (window from x0): for
    # every interior node those are its 3 x 3 neighbours, its f and its id
    H = n + 1
    src = (CSRC / "stencil.cu").read_text()
    body = src[src.index("c1_stencil_relax_rows("):]
    body = body[:body.index("\n}\n")]
    assert "read_row<RC + 2>(un, us[slot], row, H, col, RC * t);" in body
    assert "read_row<RC>(fv, fs[slot], i, H, col, RC * t + 1);" in body
    assert "ps[slot] + win_off<int8_t>(i, H, x0) + RC * t;" in body
    assert "stage_window<1, RB>(pd + RSLOTQ * slot, pid, base + s - 1, H, H, x0, live);" in body
    tiles = ss.c1_tiles(n)
    for bx in range(tiles.gx):
        col = bx * RB - 1
        for i in sorted({1, n // 2, n - 1} & set(range(1, H - 1))):
            u = {di: _window(i + di, H, H, col, RW) for di in (-1, 0, 1)}
            f = _window(i, H, H, col, RW)
            p = _window(i, H, H, col + 1, RB)
            for t in range(RT):
                for e in range(RC):
                    j = bx * RB + RC * t + e
                    if not 1 <= j <= H - 2:
                        continue
                    x = RC * t + e
                    for di in (-1, 0, 1):
                        for dj in (-1, 0, 1):
                            assert (u[di][0][x + 1 + dj], u[di][1][x + 1 + dj]) == (i + di, j + dj)
                    assert (f[0][x + 1], f[1][x + 1]) == (i, j)
                    assert (p[0][x], p[1][x]) == (i, j)


@pytest.mark.parametrize("n", SIZES)
def test_partial_buffer_holds_one_sum_per_block(n):
    geoms = [ss.c1_tiles(n, s) for s in STRIPS] + [ss.c1_one_pass_tiles(n)]
    keys = set()
    for tiles in geoms:
        ws = {}
        partial, done = hx.row_scratch(tiles, 1, torch.device("cpu"), ws)
        assert partial.numel() == tiles.blocks and partial.dtype == torch.float32
        assert done.dtype == torch.int32 and int(done) == 0
        assert hx.row_scratch(tiles, 1, torch.device("cpu"), ws)[0] is partial
        keys |= set(ws)
    assert len(keys) == len(geoms)
    # C1's scratch keys differ from the other legs' geometries and from C2's
    others = {("row_scratch", t) for t in (hx.e1_tiles(n, 1), hx.e1_one_pass_tiles(n),
                                           hx.e2_tiles(n, 1), hx.e2_one_pass_tiles(n))}
    others |= {sw._partials_key(which, n) for which in (0, 1, 2)}
    assert not keys & others


class _Props:
    multi_processor_count = 132


@pytest.mark.parametrize("n", SIZES + [130, 510, 514, 1024])
def test_wrapper_takes_the_size_choice(n, monkeypatch):
    # the geometry c1_launch_tiles gives the wrapper on a card of 132 SMs
    # whose library reports 10 resident blocks: the one-pass tile up to
    # C1_ONE_PASS_MAX_N, else row_strip's height, computed once per shape
    asked = []

    def occupancy(symbol, *args):
        asked.append((symbol, *args))
        return 10

    monkeypatch.setattr(ss, "occupancy", occupancy)
    monkeypatch.setattr(ss, "_C1_TILES", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    dev = torch.device("cuda", 0)
    for bim, mode in ((False, 0), (True, 1)):
        tiles = ss.c1_launch_tiles(n, bim, mode, dev)
        if n <= THRESHOLD:
            assert tiles == ss.c1_one_pass_tiles(n) and not asked
            continue
        want = hx.row_strip(lambda s: ss.c1_tiles(n, s), ss.C1_HALO_STEPS, 10 * 132, 132)
        assert tiles == ss.c1_tiles(n, want) and tiles.leg == "C1"
        assert asked[-1] == ("st_relax_occupancy", int(bim), mode)
        assert ss.c1_launch_tiles(n, bim, mode, dev) is tiles
    assert len(asked) == (0 if n <= THRESHOLD else 2)


def test_block_shape_matches_the_kernel():
    # the kernel refuses a grid computed for another block shape; the
    # constants here must be csrc/common.cuh's and csrc/stencil.cu's
    common = (CSRC / "common.cuh").read_text()
    src = (CSRC / "stencil.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", common).group(1))

    assert (const("RT"), const("RC"), const("TX"), const("TY")) == (RT, RC, 32, 8)
    assert const("RS_STRIP_MAX") == sw.A12_STRIP_MAX
    assert f"const int steps = min(strip, H - y0) + {ss.C1_HALO_STEPS};" in src
    body = src[src.index("inline bool c1_grid_ok("):]
    body = body[:body.index("\n}\n")]
    assert "gx == (H + RB - 1) / RB" in body and "gy == (H + strip - 1) / strip" in body
    assert "fine_grid(n)" in body
    entry = src[src.index("int st_relax("):]
    assert entry[:entry.index("\n}\n")].count("c1_grid_ok(n, one_pass != 0, strip, gx, gy)") == 1
    # the wrapper refuses fields off a 16-byte boundary before it launches
    assert '_check_aligned(("u", u), ("f", f), ("pid", pid))' in inspect.getsource(ss.relax_cuda)
    with pytest.raises(ValueError):
        ss.c1_tiles(8, 5)


def test_pid_off_a_16_byte_boundary_is_refused():
    n = 8
    pid = torch.zeros((n + 1) ** 2 + 16, dtype=torch.int8)
    sw._check_aligned(("pid", pid[:-16].view(n + 1, n + 1)))
    with pytest.raises(ValueError, match="pid"):
        sw._check_aligned(("pid", pid[1:-15].view(n + 1, n + 1)))
