"""Launch geometry of F1 (``ops/qsweep.py`` ``f1_tiles``, ``f1_one_pass_tiles``,
``f1_launch_tiles``): the Python side of what the wrapper passes to
``csrc/qsweep.cu``, checked without a card.

For every n from 2 to 64 and for n in {126, 128, 254, 256, 258, 512, 514,
2048, 4096}: the row-streaming bands and strips (and the one-pass tiles) cover
each node exactly once; every staged row's 16-byte chunks stay inside the
field's allocation and cover the window, for u and f (float32) and for Q in
bfloat16 and float32 (2- and 4-byte elements, in the kernel's Q slots); the
window a thread sweeps holds each owned node's 3 x 3 neighbourhood and the
four elements around it; and the geometry the wrapper launches is
``row_strip``'s choice above ``F1_ONE_PASS_MAX_N`` and the one-pass tile up
to it.  The index arithmetic mirrors ``f1_qsweep_rows``'s ``stage`` and
step; ``chip_smoke.py`` holds the kernel itself at ragged sizes on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multigrid_feanet_torch.ops import hrelax as hx
from multigrid_feanet_torch.ops import qsweep as qs
from multigrid_feanet_torch.ops import sweep as sw
from test_torch_sweep_tiles import _check_windows, _cover_once

SIZES = list(range(2, 65)) + [126, 128, 254, 256, 258, 512, 514, 2048, 4096]
STRIPS = (2, 32, sw.A12_STRIP_MAX)
CSRC = Path(qs.__file__).resolve().parent.parent / "csrc"
RT, RC = sw.A12_THREADS, sw.A12_COLUMNS
RB = RT * RC
RW, RWQ = RB + 2, RB + 1
RSLOT = (RW + 6) // 4 * 4


def q_slot_bytes(es: int) -> int:
    """csrc/qsweep.cu QSlot<ES>::BYTES: the Q window after an offset of up
    to 16 - ES bytes, in whole 16-byte chunks."""
    return (es * RWQ + 16 - es + 15) // 16 * 16


def _staged_rows(tiles):
    """(u row, f and Q row, window column) of every step of every block."""
    H = tiles.n + 1
    us, fs, cols = [], [], []
    for by in range(tiles.gy):
        y0 = by * tiles.strip
        s = np.arange(min(tiles.strip, H - y0) + qs.F1_HALO_STEPS)
        for bx in range(tiles.gx):
            us.append(y0 - 1 + s)
            fs.append(y0 - 2 + s)
            cols.append(np.full(len(s), bx * RB - 1))
    return np.concatenate(us), np.concatenate(fs), np.concatenate(cols)


@pytest.mark.parametrize("n", SIZES)
def test_bands_and_strips_cover_each_node_once(n):
    H = n + 1
    for strip in STRIPS:
        tiles = qs.f1_tiles(n, strip)
        assert (tiles.leg, tiles.band, tiles.strip) == ("F1", RB, strip)
        assert _cover_once(np.arange(tiles.gx) * RB, RB, H)
        assert _cover_once(np.arange(tiles.gy) * strip, strip, H)
    one = qs.f1_one_pass_tiles(n)
    assert (one.leg, one.band, one.strip) == ("F1_tile", 32, 8)
    assert _cover_once(np.arange(one.gx) * 32, 32, H)
    assert _cover_once(np.arange(one.gy) * 8, 8, H)


@pytest.mark.parametrize("n", SIZES)
def test_staging_windows_stay_inside_the_allocation(n):
    # u and f: float rows of (n+1) values; Q: rows of n elements of 2
    # (bf16, 8 to a chunk) or 4 bytes (f32, 4 to a chunk), in slots of
    # q_slot_bytes; every slot is at most one chunk per thread
    H = n + 1
    for strip in STRIPS:
        u_rows, f_rows, cols = _staged_rows(qs.f1_tiles(n, strip))
        fields = [(u_rows, cols, H, H, H * H, 4, RSLOT, RW),
                  (f_rows, cols, H, H, H * H, 4, RSLOT, RW)]
        for es in (2, 4):
            slot = q_slot_bytes(es)
            assert slot % 16 == 0 and slot // 16 <= RT
            fields.append((f_rows, cols, n, n, n * n, 16 // es, slot // es, RWQ))
        _check_windows(fields)
    assert (q_slot_bytes(1), q_slot_bytes(2), q_slot_bytes(4)) == (272, 528, 1040)


def _window(R, rows, length, col, width):
    """(row, column) of each position of a staged window of a compact
    field: the element at flat index R length + col + x, or (-1, -1) where
    the kernel's chunk is zero-filled (rows off the field, indices outside
    it)."""
    q = R * length + col + np.arange(width)
    inside = (q >= 0) & (q < rows * length) & (0 <= R < rows)
    return np.where(inside, q // length, -1), np.where(inside, q % length, -1)


@pytest.mark.parametrize("n", SIZES)
def test_windows_hold_each_nodes_neighbourhood(n):
    # a thread's node c0 + e of row i reads u at window positions
    # RC t + e .. RC t + e + 2 of rows i - 1 .. i + 1 and Q at positions
    # RC t + e (SW / NW) and RC t + e + 1 (SE / NE) of element rows i - 1
    # and i: for every interior node those are its 3 x 3 neighbours and its
    # four elements
    H = n + 1
    src = (CSRC / "qsweep.cu").read_text()
    body = src[src.index("f1_qsweep_rows("):]
    assert "read_row<RC + 2>(un, us[slot], row, H, col, RC * t);" in body
    assert "read_row<RC + 1>(qnth, qs[slot], i, n, col, RC * t);" in body
    assert "read_row<RC>(fv, fs[slot], i, H, col, RC * t + 1);" in body
    tiles = qs.f1_tiles(n)
    for bx in range(tiles.gx):
        col = bx * RB - 1
        for i in sorted({1, n // 2, n - 1} & set(range(1, H - 1))):
            u = {di: _window(i + di, H, H, col, RW) for di in (-1, 0, 1)}
            q = {dr: _window(i + dr, n, n, col, RWQ) for dr in (-1, 0)}
            f = _window(i, H, H, col, RW)
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
                    for dr in (-1, 0):
                        for dc in (-1, 0):
                            assert (q[dr][0][x + 1 + dc], q[dr][1][x + 1 + dc]) == (i + dr, j + dc)


class _Props:
    multi_processor_count = 132


@pytest.mark.parametrize("n", SIZES + [1024])
def test_wrapper_takes_the_size_choice(n, monkeypatch):
    asked = []

    def occupancy(symbol, *args):
        asked.append((symbol, *args))
        return 6

    monkeypatch.setattr(qs, "occupancy", occupancy)
    monkeypatch.setattr(qs, "_F1_TILES", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    dev = torch.device("cuda", 0)
    for bf16 in (True, False):
        tiles = qs.f1_launch_tiles(n, bf16, dev)
        if n <= qs.F1_ONE_PASS_MAX_N:
            assert tiles == qs.f1_one_pass_tiles(n) and not asked
            continue
        want = hx.row_strip(lambda s: qs.f1_tiles(n, s), qs.F1_HALO_STEPS, 6 * 132, 132)
        assert tiles == qs.f1_tiles(n, want) and tiles.leg == "F1"
        assert asked[-1] == ("mg_qsweep_occupancy", int(bf16))
        assert qs.f1_launch_tiles(n, bf16, dev) is tiles
    assert len(asked) == (0 if n <= qs.F1_ONE_PASS_MAX_N else 2)


def test_block_shape_matches_the_kernel():
    common = (CSRC / "common.cuh").read_text()
    src = (CSRC / "qsweep.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", common).group(1))

    assert (const("RT"), const("RC"), const("TX"), const("TY")) == (RT, RC, 32, 8)
    assert const("RS_STRIP_MAX") == sw.A12_STRIP_MAX
    assert "static constexpr int BYTES = (ES * RWQ + 16 - ES + 15) / 16 * 16;" in src
    assert f"const int steps = min(strip, H - y0) + {qs.F1_HALO_STEPS};" in src
    body = src[src.index("inline bool f1_grid_ok("):]
    body = body[:body.index("\n}\n")]
    assert "gx == (H + RB - 1) / RB" in body and "gy == (H + strip - 1) / strip" in body
    assert "fine_grid(n)" in body
    entry = src[src.index("int mg_qsweep("):]
    assert entry[:entry.index("\n}\n")].count("f1_grid_ok(n, one_pass != 0, strip, gx, gy)") == 1
    with pytest.raises(ValueError):
        qs.f1_tiles(8, 5)


def test_q_off_a_16_byte_boundary_is_refused():
    n = 8
    q = torch.zeros(n * n + 8, dtype=torch.bfloat16)
    sw._check_aligned(("q", q[:-8].view(n, n)))
    with pytest.raises(ValueError, match="q"):
        sw._check_aligned(("q", q[1:-7].view(n, n)))
