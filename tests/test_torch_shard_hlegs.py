"""The slab forms of E2 and E3 (``ops/hrelax.py``, ``HSlabLevel``) on the
CPU, at n = 128 cut into 4 row slabs, with the L = 1 kernels of the sharded
H-MG's anchor (``0.1 * default_rng(7).standard_normal((1, 3, 3))``).

- Against the port's whole-field plain versions: bitwise on every slab's
  own rows and, for E2's restriction, on the coarse rows under them
  (elementwise ops on the same values), the partial norms' sum to 1e-6
  relative (another summation order).
- Against JAX's shard-argument kernels (``pallas_hrelax.hswrr / phrelax``
  with ``uh / fh / phh / uch``, the bounds of ``ShardedPallasHMG._bounds_h``
  and ``own_rows``, in interpret mode), the buffers and halo strips built as
  ``ShardedPallasHMG`` builds them.  Each side cuts the level its own way
  (JAX: 40-row shards, the port: 34-row slabs); the assembled logical fields
  agree to 1e-6 of max(1, max|ref|) (f32 reassociation between the two
  implementations) and the summed partial norms to 1e-6 relative.
- The launch geometry of the slab instances and the wrappers' refusals.

JAX is imported inside the fixture that builds its reference.
"""

import numpy as np
import pytest
import torch

from multigrid_feanet_torch.core.problem import Problem
from multigrid_feanet_torch.ops import hrelax as hx
from multigrid_feanet_torch.ops.sweep import SweepLevel
from multigrid_feanet_torch.parallel.shard import GHOST, cut_rows, slab_for, slab_window

N, SLABS = 128, 4
H, HC = N + 1, N // 2 + 1
CIRCLE = ("circle", (0.0, 0.0), 0.5)
LEGS = ("hswrr", "phrelax")
TOL = 1e-6


def _params():
    return (0.1 * np.random.default_rng(7).standard_normal((1, 3, 3))).astype(np.float32)


def _inputs(bim: bool, seed: int = 3):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((H, H)).astype(np.float32)
    f = rng.standard_normal((H, H)).astype(np.float32)
    uc = rng.standard_normal((HC, HC)).astype(np.float32)
    uc[[0, -1]] = 0.0
    uc[:, [0, -1]] = 0.0
    phase = Problem(n=N, inclusion=CIRCLE).phase(N) if bim else None
    return u, f, uc, phase


def _jax_legs(bim: bool):
    """E2 and E3 shard by shard on JAX's 4-shard layout, assembled into
    logical fields: {leg: ([fine field, coarse field], summed norm)}."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from multigrid_feanet_tpu.core.problem import Problem as JProblem
    from multigrid_feanet_tpu.ops.pallas_hrelax import hswrr, phrelax
    from multigrid_feanet_tpu.parallel.pallas_shard import ShardedPallasHMG

    u, f, uc, _ = _inputs(bim)
    params = jnp.asarray(_params())
    mesh = Mesh(np.array(jax.devices()[:SLABS]), ("x",))
    sh = ShardedPallasHMG(JProblem(n=N, inclusion=CIRCLE if bim else None), mesh,
                          num_levels=3, pallas_threshold=32, rows=32, rows_coarse=32,
                          shard_below=100, interpret=True)
    p, Wp = sh.base.pl[0], sh.Wp

    def exchanged(l, x):
        """Per shard: the buffer with its south rows written and the (8, Wp)
        strip, as ShardedPallasHierarchyV2._exchange leaves them."""
        R, Hl, B = sh.base.pl[l].R, sh.Hloc[l], sh.B[l]
        st = np.asarray(sh._stack_field(l, jnp.asarray(x)))
        own = [st[i * B + R : i * B + R + Hl] for i in range(SLABS)]
        zero = np.zeros((4, Wp), np.float32)
        out = []
        for i in range(SLABS):
            buf = st[i * B : (i + 1) * B].copy()
            south = own[i + 1][:4] if i < SLABS - 1 else zero
            strip = np.zeros((8, Wp), np.float32)
            strip[0:4], strip[4:8] = south, own[i - 1][-4:] if i > 0 else zero
            buf[R + Hl : R + Hl + 4] = south
            out.append((jnp.asarray(buf), jnp.asarray(strip)))
        return out

    us, fs, ucs = exchanged(0, u), exchanged(0, f), exchanged(1, uc)
    B0, B1 = sh.B[0], sh.B[1]
    ph = [None if not bim else sh.ph_stack[0][i * B0 : (i + 1) * B0] for i in range(SLABS)]
    phh = [None if not bim else sh.phh_stack[0][i * 8 : (i + 1) * 8] for i in range(SLABS)]
    bufs = {"u1": [], "fc": [], "u3": []}
    rsq = 0.0
    for i in range(SLABS):
        (ub, uh), (fb, fh), (ucb, uch) = us[i], fs[i], ucs[i]
        bnd = sh._bounds_h(0, i)
        dst = jnp.zeros((B0, Wp), jnp.float32)
        u1, fc, r = hswrr(p, ub, fb, params, dst=dst, bnd=bnd, uh=uh, fh=fh, phh=phh[i],
                          out_rows=B1, own_rows=sh.Hloc[0], ph_pad=ph[i])
        u3 = phrelax(p, ub, fb, ucb, params, dst=jnp.zeros((B0, Wp), jnp.float32), bnd=bnd,
                     uh=uh, fh=fh, phh=phh[i], uch=uch, ph_pad=ph[i])
        for key, x in (("u1", u1), ("fc", fc), ("u3", u3)):
            bufs[key].append(np.asarray(x))
        rsq += float(r)

    def field(key, l):
        return np.asarray(sh._unstack_field(l, jnp.asarray(np.concatenate(bufs[key]))))

    return {"hswrr": ([field("u1", 0), field("fc", 1)], rsq), "phrelax": ([field("u3", 0)], None)}


def _slab_levels(bim: bool):
    """The port's slab levels with their slab inputs, and the slab height."""
    u, f, uc, phase = _inputs(bim)
    level = SweepLevel(N, phase=phase, device="cpu")
    Hl = -(-H // SLABS)
    Hl += Hl % 2
    slabs = []
    for r in range(SLABS):
        sl = slab_for(r, Hl, Hl // 2)
        fine, coarse = slab_window(sl), slab_window(sl, coarse=True)
        lv = hx.HSlabLevel(level, None if phase is None else cut_rows(phase, *fine), sl)
        xs = [torch.as_tensor(cut_rows(x, *w)) for x, w in ((u, fine), (f, fine), (uc, coarse))]
        slabs.append((lv, xs))
    return slabs, Hl


def _assemble(bim: bool):
    """The port's slab legs assembled into logical fields and summed norms:
    {leg: ([fine field (, coarse field)], summed norm or None)}."""
    slabs, Hl = _slab_levels(bim)
    params = torch.as_tensor(_params())
    out = {"hswrr": ([torch.zeros((H, H)), torch.zeros((HC, HC))], 0.0),
           "phrelax": ([torch.zeros((H, H))], None)}
    for r, (lv, (u, f, uc)) in enumerate(slabs):
        got = {"hswrr": lv.hswrr(u, f, params), "phrelax": (lv.phrelax(u, f, uc, params),)}
        for leg, res in got.items():
            fields, rsq = out[leg]
            for field, x in zip(fields, res):
                hl = Hl // 2 if field.shape[0] == HC else Hl
                own = min(hl, field.shape[0] - r * hl)
                field[r * hl : r * hl + own] = x[GHOST : GHOST + own]
            if rsq is not None:
                out[leg] = (fields, rsq + float(res[-1]))
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["hom", "bim"])
def legs(request):
    bim = request.param
    return bim, _jax_legs(bim), _assemble(bim)


@pytest.mark.parametrize("leg", LEGS)
def test_slab_legs_match_jax_shard_kernels(legs, leg):
    """Each slab form against JAX's kernel with its shard arguments."""
    _, jax_out, port = legs
    (want, want_rsq), (got, got_rsq) = jax_out[leg], port[leg]
    for g, w in zip(got, want):
        err = float(np.max(np.abs(g.numpy() - w)))
        assert err <= TOL * max(1.0, float(np.max(np.abs(w)))), err
    if want_rsq is not None:
        assert got_rsq == pytest.approx(want_rsq, rel=TOL)


@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_slab_legs_bitwise_whole_field(bim):
    """Every slab's own rows (E2: and the coarse rows under them) are the
    whole-field plain versions' bit for bit; the partial norms add up to the
    whole field's norm."""
    u, f, uc, phase = (torch.as_tensor(x) if x is not None else None for x in _inputs(bim))
    level = SweepLevel(N, phase=phase, device="cpu")
    params = torch.as_tensor(_params())
    whole = {"hswrr": hx.hswrr(level, u, f, params), "phrelax": (hx.phrelax(level, u, f, uc,
                                                                            params),)}
    port = _assemble(bim)
    for leg in LEGS:
        fields, rsq = port[leg]
        for got, want in zip(fields, whole[leg]):
            assert torch.equal(got, want), leg
        if rsq is not None:
            assert rsq == pytest.approx(float(whole[leg][-1]), rel=1e-6), leg


def test_slab_tiles_cover_the_slab():
    """The slab grids: the whole-field bands (E2 at 512: the one-pass tile's
    16-row fine tiles), strips laid where the whole field's lie (from slab
    row -(g mod strip), a multiple of the strip in global rows) and covering
    the slab's rows (E2: its rows / 2 coarse rows) with less than one strip
    to spare."""
    for n, one_pass, strip in ((4096, False, 32), (1024, False, 48), (512, True, 16)):
        for rows, g in ((12, -4), (42, 30), (1032, 1020), (1040, 2044)):
            e2 = hx.e2_slab_tiles(n, 1, rows, g, strip, one_pass)
            full = hx.e2_one_pass_tiles(n) if one_pass else hx.e2_tiles(n, 1, strip)
            assert (e2.gx, e2.band, e2.strip) == (full.gx, full.band, strip)
            yoff = g % strip
            assert (g - yoff) % strip == 0 and 0 <= yoff < strip and yoff % 2 == 0
            need = (rows + yoff) // 2
            assert need <= e2.gy * strip // 2 < need + strip // 2
            if one_pass:
                continue
            e3 = hx.e3_slab_tiles(n, 1, rows, g, strip)
            assert (e3.gx, e3.band) == (hx.e3_tiles(n, 1, strip).gx, hx.e3_tiles(n, 1).band)
            assert rows + yoff <= e3.gy * strip < rows + yoff + strip


def test_slab_operands_checked():
    """The CUDA slab forms refuse CPU tensors, chain depths and forms they
    are not built for, and E3 on a level that runs its one-pass tile."""
    slabs, _ = _slab_levels(True)
    lv, (u, f, uc) = slabs[1]
    params = torch.as_tensor(_params())
    cfg = dict(a0=1.0, da=19.0, omega=2.0 / 3.0, slab=lv.slab)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hx.hswrr_slab_cuda(u, f, lv.ph, params, dform=False, **cfg)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hx.phrelax_slab_cuda(u, f, lv.ph, uc, params, dform=False, **cfg)
    with pytest.raises(ValueError, match="L=1"):
        hx.hswrr_slab_cuda(u, f, lv.ph, torch.zeros((3, 3, 3)), dform=False, **cfg)
    with pytest.raises(ValueError, match="difference form"):
        hx.phrelax_slab_cuda(u, f, lv.ph, uc, params, dform=True, **cfg)
    with pytest.raises(ValueError, match="one-pass tile"):
        hx.e3_slab_launch_tiles(8, 1, True, torch.device("cpu"), 12, -4)


def test_slab_entry_points_match_the_kernel():
    """The C entry points refuse a grid computed another way: their depth,
    band and grid formulas must be those of e2_slab_tiles / e3_slab_tiles,
    and the ctypes signatures theirs."""
    from pathlib import Path

    src = (Path(hx.__file__).resolve().parent.parent / "csrc" / "hrelax.cu").read_text()

    def body(name):
        b = src[src.index(name + "("):]
        return b[:b.index("\n}\n")]

    assert f"constexpr int SLAB_L = {hx.SLAB_DEPTH};" in src
    assert "strip == 2 * CY" in body("inline bool slab_strip_ok")
    assert "(sl.g - sl.yoff) % strip == 0" in body("inline bool slab_strip_ok")
    e2 = body("inline bool e2_slab_grid_ok")
    assert "bw = one_pass ? CX : (RB - 2 * SLAB_L - 4) / 2" in e2
    assert "gy == ((sl.rows + sl.yoff) / 2 + sh - 1) / sh" in e2
    e3 = body("inline bool e3_slab_grid_ok")
    assert "bw = RB - 2 * SLAB_L - 2" in e3 and "gy == (sl.rows + sl.yoff + strip - 1) / strip" in e3
    assert body("int mg_hswrr_slab").count("e2_slab_grid_ok(n, one_pass != 0, strip, gx, gy, sl)") == 1
    assert body("int mg_phrelax_slab").count("e3_slab_grid_ok(n, strip, gx, gy, sl)") == 1
    # pointers, n a0 da omega, the ints (bim L one_pass strip gx gy and the
    # slab's rows g lo hi crows cro yoff; E3 without one_pass, lo, hi), stream
    assert len(hx.KERNELS["E2_slab"]._argtypes) == 9 + 4 + 13 + 1
    assert len(hx.KERNELS["E3_slab"]._argtypes) == 6 + 4 + 10 + 1
