"""The slab forms of A1 (sweep, psweep), A2, A3 and A4 (``ops/sweep.py``,
``SlabLevel``) on the CPU, at n = 128 cut into 4 row slabs.

- Against JAX's shard-argument kernels (``PallasLevel.sweep / psweep /
  sweep_restrict / zsweep_restrict / zpsweep`` with ``uh / fh / phh / uch /
  bnd / own_rows``, in interpret mode), the buffers and halo strips built as
  ``ShardedPallasHierarchyV2`` builds them (tests/test_pallas_shard.py:30-87).
  Each side cuts the level its own way (JAX: 40-row shards, the port: 34-row
  slabs); the assembled logical fields agree to 1e-6 of max(1, max|ref|)
  (f32 reassociation between the two implementations, about one ulp a term)
  and the summed partial norms to 1e-6 relative.
- Against the port's whole-field plain versions: bitwise on every slab's own
  rows (elementwise ops on the same values), the partial norms' sum to 1e-6
  relative (another summation order).

JAX is imported inside the fixture that builds its reference.
"""

import numpy as np
import pytest
import torch

from multigrid_feanet_torch.core.problem import Problem
from multigrid_feanet_torch.ops import sweep as sw
from multigrid_feanet_torch.ops.sweep import SlabLevel, SweepLevel
from multigrid_feanet_torch.parallel.shard import GHOST, cut_rows, slab_for, slab_window

N, SLABS = 128, 4
H, HC = N + 1, N // 2 + 1
CIRCLE = ("circle", (0.0, 0.0), 0.5)
LEGS = ("sweep", "psweep", "sweep_restrict", "zsweep_restrict", "zpsweep")
TOL = 1e-6


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
    """The five legs shard by shard on JAX's 4-shard layout, assembled into
    logical fields: {leg: (fine or coarse field, summed norm or None)}."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from multigrid_feanet_tpu.core.problem import Problem as JProblem
    from multigrid_feanet_tpu.parallel.pallas_shard import ShardedPallasHierarchyV2

    u, f, uc, _ = _inputs(bim)
    mesh = Mesh(np.array(jax.devices()[:SLABS]), ("x",))
    sh = ShardedPallasHierarchyV2(JProblem(n=N, inclusion=CIRCLE if bim else None), mesh,
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
    own = dict(own_rows=sh.Hloc[0])
    res = {leg: ([], 0.0) for leg in LEGS}
    for i in range(SLABS):
        (ub, uh), (fb, fh), (ucb, uch) = us[i], fs[i], ucs[i]
        bnd = sh._bounds(0, i)
        dst = jnp.zeros((B0, Wp), jnp.float32)
        outs = {
            "sweep": p.sweep(ub, fb, dst=dst, uh=uh, bnd=bnd, ph_pad=ph[i], **own),
            "psweep": p.psweep(ub, fb, ucb, dst=dst, uh=uh, uch=uch, bnd=bnd, ph_pad=ph[i],
                               **own),
            "sweep_restrict": p.sweep_restrict(ub, fb, dst=dst, uh=uh, fh=fh, phh=phh[i],
                                               bnd=bnd, out_rows=B1, ph_pad=ph[i], **own)[1:],
            "zsweep_restrict": (p.zsweep_restrict(fb, fh=fh, phh=phh[i], bnd=bnd, out_rows=B1,
                                                  ph_pad=ph[i]),),
            "zpsweep": (p.zpsweep(fb, ucb, dst=dst, fh=fh, phh=phh[i], uch=uch, bnd=bnd,
                                  ph_pad=ph[i]),),
        }
        for leg, out in outs.items():
            res[leg][0].append(np.asarray(out[0]))
            if len(out) > 1:
                res[leg] = (res[leg][0], res[leg][1] + float(out[1]))
    coarse = ("sweep_restrict", "zsweep_restrict")
    return {leg: (np.asarray(sh._unstack_field(1 if leg in coarse else 0,
                                               jnp.asarray(np.concatenate(bufs)))),
                  rsq if leg in ("sweep", "psweep", "sweep_restrict") else None)
            for leg, (bufs, rsq) in res.items()}


def _port_slabs(bim: bool, dform=None):
    """The port's slab levels, the slab inputs and the slab height."""
    u, f, uc, phase = _inputs(bim)
    level = SweepLevel(N, phase=phase, dform=dform, device="cpu")
    Hl = -(-H // SLABS)
    Hl += Hl % 2
    slabs = []
    for r in range(SLABS):
        sl = slab_for(r, Hl, Hl // 2)
        fine, coarse = slab_window(sl), slab_window(sl, coarse=True)
        lv = SlabLevel(level, None if phase is None else cut_rows(phase, *fine), sl)
        xs = [torch.as_tensor(cut_rows(x, *w)) for x, w in ((u, fine), (f, fine), (uc, coarse))]
        slabs.append((lv, xs))
    return slabs, Hl


def _run(lv, xs):
    u, f, uc = xs
    return {"sweep": lv.sweep(u, f), "psweep": lv.psweep(u, f, uc),
            "sweep_restrict": lv.sweep_restrict(u, f)[1:], "zsweep_restrict": (lv.zsweep_restrict(f),),
            "zpsweep": (lv.zpsweep(f, uc),)}


def _assemble(bim: bool, dform=None):
    """The port's slab legs assembled into logical fields and summed norms."""
    slabs, Hl = _port_slabs(bim, dform)
    out = {}
    for leg in LEGS:
        coarse = leg in ("sweep_restrict", "zsweep_restrict")
        rows, hl = (HC, Hl // 2) if coarse else (H, Hl)
        field, rsq = torch.zeros((rows, rows)), 0.0
        for r, (lv, xs) in enumerate(slabs):
            got = _run(lv, xs)[leg]
            own = min(hl, rows - r * hl)
            field[r * hl : r * hl + own] = got[0][GHOST : GHOST + own]
            if len(got) > 1:
                rsq += float(got[1])
        out[leg] = (field, rsq)
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["hom", "bim"])
def legs(request):
    bim = request.param
    return bim, _jax_legs(bim), _assemble(bim)


@pytest.mark.parametrize("leg", LEGS)
def test_slab_legs_match_jax_shard_kernels(legs, leg):
    """Each slab form against JAX's kernel with its shard arguments."""
    _, jax_out, port = legs
    want, want_rsq = jax_out[leg]
    got, got_rsq = port[leg]
    err = float(np.max(np.abs(got.numpy() - want)))
    assert err <= TOL * max(1.0, float(np.max(np.abs(want)))), err
    if want_rsq is not None:
        assert got_rsq == pytest.approx(want_rsq, rel=TOL)


@pytest.mark.parametrize("dform", [False, True], ids=["plain", "dform"])
@pytest.mark.parametrize("bim", [False, True], ids=["hom", "bim"])
def test_slab_legs_bitwise_whole_field(bim, dform):
    """Every slab's own rows are the whole-field plain versions' bit for bit;
    the partial norms add up to the whole field's norm."""
    u, f, uc, phase = (torch.as_tensor(x) if x is not None else None for x in _inputs(bim))
    level = SweepLevel(N, phase=phase, dform=dform, device="cpu")
    whole = {"sweep": level.sweep(u, f), "psweep": level.psweep(u, f, uc),
             "sweep_restrict": level.sweep_restrict(u, f)[1:],
             "zsweep_restrict": (level.zsweep_restrict(f),), "zpsweep": (level.zpsweep(f, uc),)}
    port = _assemble(bim, dform)
    for leg in LEGS:
        assert torch.equal(port[leg][0], whole[leg][0]), leg
        if len(whole[leg]) > 1:
            assert port[leg][1] == pytest.approx(float(whole[leg][1]), rel=1e-6), leg


def test_slab_operands_checked():
    """The CUDA slab forms refuse CPU tensors and slabs they do not take;
    SlabLevel refuses bf16 storage and a mass triple."""
    slabs, _ = _port_slabs(True)
    lv, (u, f, uc) = slabs[1]
    cfg = dict(a0=1.0, da=19.0, omega=2.0 / 3.0, dform=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sw.sweep_slab_cuda(u, f, lv.ph, slab=lv.slab, **cfg)
    with pytest.raises(ValueError):
        SlabLevel(SweepLevel(N, dtype=torch.bfloat16, device="cpu"), None, lv.slab)
    with pytest.raises(ValueError):
        SlabLevel(SweepLevel(N, mass=(0.1, 0.1, -0.05), device="cpu"), None, lv.slab)


def test_slab_tiles_cover_the_slab():
    """The slab grids: the whole-field bands, strips laid where the whole
    field's lie (from slab row -(g mod strip), a multiple of the strip in
    global rows) and covering the slab's rows (A2, A3: its rows / 2 coarse
    rows) with less than one strip to spare."""
    for leg in ("A1", "A2", "A3", "A4"):
        coarse = leg in ("A2", "A3")
        for rows, g in ((10, -4), (42, 30), (1032, 1022), (1032, 1020)):
            strip = 32
            t = sw.slab_tiles(leg, 1024, rows, strip, g)
            assert t.gx == sw.TILES[leg](1024, strip).gx
            yoff = g % strip
            assert (g - yoff) % strip == 0 and 0 <= yoff < strip and yoff % 2 == 0
            per = strip // 2 if coarse else strip
            need = (rows + yoff) // 2 if coarse else rows + yoff
            assert need <= t.gy * per < need + per


def test_slab_for_windows():
    """Each rank's slab: its own rows at GHOST .. GHOST + hloc from global
    row r hloc - GHOST, and a coarse slab whose own rows start under the
    fine slab's (slab row 2 cro is global fine row 2 (r hloc_c - GHOST))."""
    for r, hloc in ((0, 34), (1, 34), (3, 34), (2, 1056)):
        sl = slab_for(r, hloc, hloc // 2)
        g, rows = slab_window(sl)
        gc, crows = slab_window(sl, coarse=True)
        assert (g, rows, sl.lo, sl.hi) == (r * hloc - GHOST, hloc + 2 * GHOST, GHOST,
                                           GHOST + hloc)
        assert (gc, crows) == (r * hloc // 2 - GHOST, hloc // 2 + 2 * GHOST)
        assert g - 2 * sl.cro == 2 * gc and sl.cro >= 1
