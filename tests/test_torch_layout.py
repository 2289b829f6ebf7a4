"""The launch geometry of kernels R, C and S, on the CPU.

Kernel R (``ops/csrc/resident_cg.cu``) runs one block per SM, each over a
contiguous range of band rows with its part of the state on chip; kernel C
(``ops/csrc/ca_cg.cu``) marches each block down a column strip of a segment
of band rows. Both geometries are computed on the host
(``resident.resident_layout``, ``ca_cg.sweep_geometry``), so these tests
check them here, at the shapes the paths launch, for the H100's 132 SMs
and for a smaller card's 114. A numpy replay of kernel C's row march, in
the kernel's own indexing, shows that the geometry and its halo rules give
``basis_sweep_plain``'s fields bit for bit; a numpy replay of kernel S
(``ops/csrc/serial_sum.cu``) in the geometry of ``serial.serial_plan`` --
its staging into shared-memory rows, pieces of whole runs or slices of each
run, the chains dealt to warps and block 0's Kahan walk -- gives
``serial_sum_plain``'s sums bit for bit. The kernels themselves run only on
the card (``chip_smoke.py``)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.ops import ca_cg, fused_cg, resident, serial
from poisson_tpu_torch.ops.fused_cg import HALO
from poisson_tpu_torch.parallel import ca_sharded

SMS = [132, 114]
RESIDENT_GRIDS = [(40, 40), (400, 600), (800, 1200)]


def _resident_cv(M, N):
    return resident.resident_canvas(Problem(M=M, N=N))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("M,N", RESIDENT_GRIDS + [(100, 8000), (270, 3800)])
def test_resident_rows_cover_the_band_once(M, N, sms):
    cv = _resident_cv(M, N)
    lay = resident.resident_layout(cv, sms)
    band = cv.rows - 2 * HALO
    assert lay.blocks == min(sms, band, resident.MAX_BLOCKS)
    owned = np.zeros(band, int)
    for r0, n in zip(lay.row0, lay.nrows):
        assert n >= 1
        owned[r0 : r0 + n] += 1
    assert (owned == 1).all()
    assert list(lay.row0) == sorted(lay.row0)      # contiguous, in order
    assert max(lay.nrows) - min(lay.nrows) <= 1 and lay.rmax == max(lay.nrows)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("M,N", RESIDENT_GRIDS + [(100, 8000), (270, 3800)])
def test_resident_on_chip_bytes_and_exchange(M, N, sms):
    """Each block's shared memory within the 227 KB a block may opt in to,
    the fields placed without overlap, the spilled ones sized in the spill
    region, and the exchange buffer as the kernel indexes it: four rows
    (top r, top p, bottom r, bottom p) per block."""
    cv = _resident_cv(M, N)
    lay = resident.resident_layout(cv, sms)
    assert lay.smem_bytes <= (resident.H100_SMEM_PER_BLOCK
                              - resident.SMEM_RESERVE)
    assert lay.exchange == lay.blocks * 4 * cv.cols
    sizes = resident.field_floats(lay.rmax, cv.cols)
    on_chip = spilled = 0
    for name, off in zip(resident.FIELDS, lay.offsets):
        if off >= 0:
            assert off == on_chip
            on_chip += sizes[name]
        else:
            assert -1 - off == spilled
            spilled += sizes[name]
    assert lay.smem_bytes == 4 * on_chip
    assert lay.spill_stride == max(spilled, 4) and lay.spill_stride % 4 == 0
    groups = -(-lay.rmax * cv.cols // 4)     # 4-point groups of the most rows
    assert lay.points_per_thread == 4 * -(-groups // resident.THREADS)
    assert lay.reg_points == min(lay.points_per_thread, resident.REG_POINTS)


@pytest.mark.parametrize("M,N", [(400, 600), (800, 1200)])
def test_resident_state_fits_on_chip_at_the_served_grids(M, N):
    """On the H100 nothing of the solver state stays in device memory at
    400×600 and 800×1200: every field (w included) in shared memory, every
    point's r and Ap in registers."""
    lay = resident.resident_layout(_resident_cv(M, N))
    assert lay.blocks == resident.H100_SMS
    assert all(off >= 0 for off in lay.offsets)
    assert lay.reg_points == lay.points_per_thread


def test_resident_fallbacks_are_reached():
    """Wide grids the gate admits keep part of the state in device memory:
    one row of 8064 columns per block leaves sc² and w out of shared
    memory; three rows of 3840 leave them out too, and 4 points per thread
    past the registers."""
    wide = resident.resident_layout(_resident_cv(100, 8000))
    assert wide.offsets == (0, 24192, 40320, 48384, -1, -1 - 8064)
    deep = resident.resident_layout(_resident_cv(270, 3800))
    assert deep.offsets[4:] == (-1, -1 - 3 * 3840)
    assert deep.points_per_thread - deep.reg_points == 4
    assert resident.fits_resident(Problem(M=100, N=8000))
    assert resident.fits_resident(Problem(M=270, N=3800))


@pytest.mark.parametrize("M,N,admitted", [(40, 40, True), (40, 300, True),
                                          (400, 600, True), (800, 1200, True),
                                          (2400, 3200, False)])
def test_resident_gate_is_unchanged(M, N, admitted):
    assert resident.fits_resident(Problem(M=M, N=N)) is admitted


def _sweep_canvases():
    """The four canvases kernel C serves: the 2×2 CA shard of 800×1200
    (band 400×640), 800×1200, the 2×2 CA shard of 2400×3200 (band
    1200×1664) and 2400×3200."""
    out = {}
    for M, N in [(800, 1200), (2400, 3200)]:
        p = Problem(M=M, N=N)
        out[f"{M}x{N}-2x2"] = ca_sharded.ca_shard_spec(p, 2, 2).cv
        out[f"{M}x{N}"] = fused_cg.canvas_spec(p)
    return out


def _block_tiles(cv, geo):
    """The Gram tiles each block of kernel C writes, block by block: the
    index ``ca_cg.cu`` computes for warp w of block (s, g) at each tile row
    of its segment, ((row - halo) / 8) · (cols / 32) + s · 4 + w."""
    tile_rows = (cv.rows - 2 * HALO) // ca_cg.TILE_H
    per_row = cv.cols // ca_cg.TILE_W
    warps = ca_cg.STRIP_W // ca_cg.TILE_W
    for g in range(geo.segs):
        rows = range(g * geo.seg_h // ca_cg.TILE_H,
                     min((g + 1) * geo.seg_h // ca_cg.TILE_H, tile_rows))
        for s in range(geo.strips):
            yield [t * per_row + s * warps + w
                   for t in rows for w in range(warps)]


SWEEP_CANVASES = _sweep_canvases()
BANDS = {"800x1200-2x2": (400, 640), "800x1200": (800, 1280),
         "2400x3200-2x2": (1200, 1664), "2400x3200": (2400, 3328)}


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", list(SWEEP_CANVASES))
def test_sweep_tiles_cover_the_band_once_in_order(shape, sms):
    """Every 8×32 Gram tile written once, at the index ``n_tiles`` order
    (tile rows outer, tile columns inner) gives it, whatever the segments."""
    cv = SWEEP_CANVASES[shape]
    assert (cv.rows - 2 * HALO, cv.cols) == BANDS[shape]
    geo = ca_cg.sweep_geometry(cv, sms)
    written = [t for block in _block_tiles(cv, geo) for t in block]
    assert sorted(written) == list(range(ca_cg.n_tiles(cv)))
    # Each block's tiles in row order, its warps' columns inner.
    per_row = cv.cols // ca_cg.TILE_W
    for block in _block_tiles(cv, geo):
        rows = [t // per_row for t in block]
        assert rows == sorted(rows)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", list(SWEEP_CANVASES))
def test_sweep_segments_fill_the_card_in_one_wave(shape, sms):
    cv = SWEEP_CANVASES[shape]
    geo = ca_cg.sweep_geometry(cv, sms)
    band = cv.rows - 2 * HALO
    assert geo.seg_h % ca_cg.TILE_H == 0
    assert geo.strips * ca_cg.STRIP_W == cv.cols
    assert (geo.segs - 1) * geo.seg_h < band <= geo.segs * geo.seg_h
    assert geo.blocks <= sms * ca_cg.SWEEP_BLOCKS_PER_SM
    # One TILE_H row fewer per segment would no longer fit in one wave.
    if geo.seg_h > ca_cg.TILE_H:
        shorter = -(-band // (geo.seg_h - ca_cg.TILE_H))
        assert geo.strips * shorter > sms * ca_cg.SWEEP_BLOCKS_PER_SM


def test_sweep_grid_fills_the_card_at_the_smallest_shard():
    geo = ca_cg.sweep_geometry(SWEEP_CANVASES["800x1200-2x2"])
    assert geo.blocks >= ca_cg.H100_SMS
    assert geo == ca_cg.SweepGeometry(strips=5, seg_h=8, segs=50)


def test_sweep_geometry_refuses_a_ragged_width():
    cv = fused_cg.canvas_spec(Problem(M=24, N=40))
    with pytest.raises(ValueError, match="multiple of 128"):
        ca_cg.sweep_geometry(cv._replace(cols=cv.cols + 32))


# --- a numpy replay of kernel C's row march ----------------------------------

F32 = np.float32
PAD, AHEAD = 4, 3          # ca_cg.cu: kPad, kAhead
ROW_W = ca_cg.STRIP_W + 2 * PAD
SLOTS, RING = AHEAD + 5, 4


def _stencil(c, n, s, e, w, cs_n, cs_c, cw_e, cw_c, g):
    a = F32(cs_n * (c - n))
    a = F32(a + F32(cs_c * F32(c - s)))
    a = F32(a + F32(cw_e * F32(c - e)))
    a = F32(a + F32(cw_c * F32(c - w)))
    return F32(a + F32(g * c))


def _replay(cv, geo, beta, fields, lo, hi):
    """Kernel C's fields as its blocks form them: per block, step j stages
    input row L (zero past the canvas edge) into a ring, forms pn on row L
    and the centre row L - 3 from t1 on rows L - 4 .. L - 2, then t1 on
    row L - 1, the halo columns' pn and t1 recomputed, the coefficients
    carried two steps from t1's row to the centre's. Returns pn, t1, t2,
    t3."""
    r, pprev, cs, cw, g = fields
    outs = [np.zeros((cv.rows, cv.cols), F32) for _ in range(4)]
    own = PAD + np.arange(ca_cg.STRIP_W)
    halo_pn = np.array([PAD - 2, PAD - 1, PAD + ca_cg.STRIP_W,
                        PAD + ca_cg.STRIP_W + 1])
    t1_cols = np.concatenate([own, [PAD - 1, PAD + ca_cg.STRIP_W]])
    for by in range(geo.segs):
        seg0 = HALO + by * geo.seg_h
        seg1 = min(seg0 + geo.seg_h, cv.rows - HALO)
        first, steps = seg0 - 2, seg1 - seg0 + 5
        for bx in range(geo.strips):
            c0 = bx * ca_cg.STRIP_W
            cols = c0 - PAD + np.arange(ROW_W)
            on = (cols >= 0) & (cols < cv.cols)
            ring = np.full((SLOTS, 5, ROW_W), np.nan, F32)
            pn_r = np.full((RING, ROW_W), np.nan, F32)
            t1_r = np.full((RING, ROW_W), np.nan, F32)
            carry = [None, None]        # coefficients of rows L - 3, L - 2
            for j in range(steps):
                row = np.zeros((5, ROW_W), F32)
                row[:, on] = [f[first + j, cols[on]] for f in fields]
                ring[j % SLOTS] = row
                L, inn = first + j, ring[j % SLOTS]
                for xs in (own, halo_pn):
                    ok = (lo <= L < hi) & on[xs]
                    pn_r[j % RING, xs] = np.where(
                        ok, F32(inn[0, xs] + F32(beta * inn[1, xs])), 0)
                if j >= 5:
                    x = own
                    tc, tn = t1_r[(j - 3) % RING], t1_r[(j - 2) % RING]
                    ts = t1_r[(j - 4) % RING]
                    rc, rn, rs = (ring[(j - d) % SLOTS][0] for d in (3, 2, 4))
                    a = tc[x]
                    vals = (pn_r[(j - 3) % RING, x], a,
                            _stencil(a, tn[x], ts[x], tc[x + 1], tc[x - 1],
                                     *carry[0]),
                            _stencil(rc[x], rn[x], rs[x], rc[x + 1],
                                     rc[x - 1], *carry[0]))
                    for o, v in zip(outs, vals):
                        o[L - 3, c0 : c0 + ca_cg.STRIP_W] = v
                carry[0] = carry[1]
                if j < 2 or j == steps - 1:
                    continue
                inc = ring[(j - 1) % SLOTS]
                pc, pns = pn_r[(j - 1) % RING], pn_r[(j - 2) % RING]
                xs = t1_cols
                t1_r[(j - 1) % RING, xs] = np.where(on[xs], _stencil(
                    pc[xs], pn_r[j % RING, xs], pns[xs], pc[xs + 1],
                    pc[xs - 1], inn[2, xs], inc[2, xs], inc[3, xs + 1],
                    inc[3, xs], inc[4, xs]), 0)
                carry[1] = (inn[2, own], inc[2, own], inc[3, own + 1],
                            inc[3, own], inc[4, own])
    return outs


@pytest.mark.parametrize("M,N,widen,sms,per_sm", [
    (24, 40, 0, 132, 8), (40, 300, 0, 4, 2), (56, 200, 2, 2, 1)],
    ids=["one-strip", "three-strips-two-segments", "shard-band"])
def test_row_march_replay_matches_the_plain_version(M, N, widen, sms,
                                                    per_sm):
    """Inputs nonzero on every row and column (a shard's halo holds its
    neighbours' values); ``widen`` 2 is the sharded form's band."""
    cv, cs, cw, g, _, sc2, _ = fused_cg.build_canvases(Problem(M=M, N=N),
                                                       device="cpu")
    rng = np.random.default_rng(M + N)
    pprev, r = (rng.standard_normal((cv.rows, cv.cols)).astype(F32)
                for _ in range(2))
    lo, hi = HALO - widen, cv.rows - HALO + widen
    beta = F32(0.37)
    geo = ca_cg.sweep_geometry(cv, sms, per_sm)
    got = _replay(cv, geo, beta, (r, pprev, cs.numpy(), cw.numpy(),
                                  g.numpy()), lo, hi)
    want = [torch.zeros_like(cs) for _ in range(4)]
    ca_cg.basis_sweep_plain(cv, torch.tensor(beta), torch.tensor(pprev),
                            torch.tensor(r), cs, cw, g, sc2, *want, (lo, hi))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())


# --- kernel S -----------------------------------------------------------


def _kahan(run_sums):
    """The Kahan walk over the run sums of each vector (rows), in order."""
    total = np.zeros(run_sums.shape[0], F32)
    comp = np.zeros_like(total)
    for q in range(run_sums.shape[1]):
        y = run_sums[:, q] - comp
        t = total + y
        comp = (t - total) - y
        total = t
    return total


def _lanes(rows, acc):
    """Lane l of each row adds the row's elements l, l + 32, ... in order
    onto ``acc`` (nv, 32); the zero padding of a short last warp row adds
    +0.0 to a sum that is never -0."""
    nv, length = rows.shape
    padded = np.zeros((nv, -(-length // serial.WARP) * serial.WARP), F32)
    padded[:, :length] = rows
    for row in padded.reshape(nv, -1, serial.WARP).transpose(1, 0, 2):
        acc = acc + row
    return acc


def _tree(acc):
    """The shuffle tree (offsets 16, 8, 4, 2, 1); lane 0's value."""
    acc = acc.copy()
    off = serial.WARP // 2
    while off:
        acc[:, :off] = acc[:, :off] + acc[:, off : 2 * off]
        off //= 2
    return acc[:, 0]


def _segment(stage, at, mem, g0, cnt):
    """One segment copy: ``cnt`` floats from element ``g0`` to the 16-byte
    aligned stage offset ``at``, shifted by g0 mod 4 (the buffer starts
    16-byte aligned) so that the body moves in 16-byte copies; returns the
    shift."""
    sh = g0 % 4
    head = min((4 - sh) % 4, cnt)
    assert at % 4 == 0 and (at + sh + head) % 4 == 0 and (g0 + head) % 4 == 0
    assert np.isnan(stage[at + sh : at + sh + cnt]).all()   # copied once
    stage[at + sh : at + sh + cnt] = mem[g0 : g0 + cnt]
    return sh


def _stage(mem, e0, length, nv, vs, interleaved, origin):
    """The kernel's staging pass over partials [e0, e0 + length) of every
    vector, vector 0 starting at element ``origin`` of the buffer; returns
    the stage (NaN where no copy wrote, so a stray read shows), the offset
    of element (0, v) of each vector and the element step."""
    stage = np.full(serial.stage_floats(length, nv, interleaved), np.nan,
                    F32)
    assert len(stage) <= serial.STAGE_FLOATS
    if interleaved:
        sh = _segment(stage, 0, mem, origin + e0 * nv, nv * length)
        return stage, [sh + v for v in range(nv)], nv
    pitch = -(-(length + 3) // 4) * 4
    base = [v * pitch + _segment(stage, v * pitch, mem,
                                 origin + v * vs + e0, length)
            for v in range(nv)]
    return stage, base, 1


def _chain_of(w, t, g):
    """Thread t of warp w of a run walks lane l of vector v."""
    lanes = serial.WARP // g
    return (w // g) * g + t % g, (w % g) * lanes + t // g


def _walk(stage, base, step, nv, g, offset, length, acc):
    """Every chain of one run over ``length`` staged partials from element
    ``offset``, warp by warp as the kernel deals them: each (v, l) walked
    once, a warp's 32 reads in 32 banks. Returns acc + the lane sums."""
    seen = np.zeros((nv, serial.WARP), int)
    lane_rows = np.zeros((nv, serial.WARP, -(-length // serial.WARP)), F32)
    for w in range(nv):
        banks = set()
        for t in range(serial.WARP):
            v, l = _chain_of(w, t, g)
            seen[v, l] += 1
            at = base[v] + (offset + l) * step
            banks.add(at % serial.WARP)
            ks = np.arange(l, length, serial.WARP)
            lane_rows[v, l, : len(ks)] = stage[base[v] + (offset + ks) * step]
        assert len(banks) == serial.WARP
    assert (seen == 1).all()
    for i in range(lane_rows.shape[2]):      # lane l's adds, in order
        acc = acc + lane_rows[:, :, i]
    return acc


def _replay_serial(mem, n, nv, vs, run, interleaved, plan, origin=0):
    """Kernel S in numpy fp32, block by block, in ``plan``'s geometry: the
    blocks' run sums land in block 0's sums, which it walks."""
    assert plan.smem_bytes <= 227 * 1024
    assert 1 <= plan.blocks <= serial.MAX_CLUSTER       # one cluster
    assert plan.threads <= serial.THREADS
    sums0 = np.full((nv, plan.runs), np.nan, F32)
    g = plan.group
    zeros = np.zeros((nv, serial.WARP), F32)
    for b in range(plan.blocks):
        q0 = b * plan.rpb
        q1 = min(q0 + plan.rpb, plan.runs)
        if plan.slice == 0:
            for qa in range(q0, q1, plan.piece_runs):
                qb = min(qa + plan.piece_runs, q1)
                ea, eb = qa * run, min(qb * run, n)
                stage, base, step = _stage(mem, ea, eb - ea, nv, vs,
                                           interleaved, origin)
                assert (qb - qa) * nv * serial.WARP * (g > 1) <= plan.lanes
                for q in range(qa, qb):
                    length = min(run, n - q * run)
                    acc = _walk(stage, base, step, nv, g, q * run - ea,
                                length, zeros)
                    assert np.isnan(sums0[:, q]).all()
                    sums0[:, q] = _tree(acc)
        else:
            assert nv * serial.WARP <= plan.threads
            for q in range(q0, q1):
                start = q * run
                length = min(run, n - start)
                acc = zeros
                for sa in range(0, length, plan.slice):
                    piece = min(plan.slice, length - sa)
                    assert piece % serial.WARP == 0 or sa + piece == length
                    stage, base, step = _stage(mem, start + sa, piece, nv,
                                               vs, interleaved, origin)
                    acc = _walk(stage, base, step, nv, g, 0, piece, acc)
                assert np.isnan(sums0[:, q]).all()
                sums0[:, q] = _tree(acc)
    assert not np.isnan(sums0).any()
    return _kahan(sums0)


def _partials_of(kind, n, rng, shift=0):
    """Partials as their kernels lay them out: A one vector, B two rows of
    one buffer, C the twelve columns of a (tiles, 12) buffer; ``shift``
    floats into their buffer, so the first partial may sit off a 16-byte
    boundary."""
    nv = {"A": 1, "B": 2, "C": 12}[kind]
    buf = torch.tensor(rng.standard_normal(shift + nv * n, dtype=F32))
    x = buf[shift:]
    if kind == "A":
        return x
    if kind == "B":
        return x[:n], x[n:]
    return x.view(n, 12).T


def _vectors(parts):
    """Flat memory of ``parts`` (its whole buffer) and the kernel's view of
    it: n, vectors, vector stride, interleaved, and where vector 0
    starts."""
    x, _ = serial._as_vectors(parts)
    x, interleaved = serial.kernel_layout(x)
    flat = x.as_strided((x.untyped_storage().nbytes() // 4,), (1,), 0)
    vs = 1 if interleaved else x.stride(0)
    return (flat.numpy(), x.shape[1], x.shape[0], vs, interleaved,
            x.storage_offset())


# (partials kind, n, run): the serial mode's partials at 800x1200 and
# 2400x3200 (A and B per fused step, C's Gram per CA pair), on the 2x2 mesh's
# shards, and on the blocked canvases (A' per step, B' two per step).
SERIAL_CASES = [("A", 4000, 640), ("B", 4000, 640), ("C", 4000, 640),
                ("A", 31200, 936), ("B", 31200, 936), ("C", 31200, 728),
                ("A", 1000, 320), ("B", 7800, 832), ("C", 7800, 728),
                ("A", 1120, 32), ("B", 20160, 224)]


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
@pytest.mark.parametrize("kind,n,run", SERIAL_CASES,
                         ids=[f"{k}-{n}-run{r}" for k, n, r in SERIAL_CASES])
def test_serial_replay_matches_the_plain_version(kind, n, run, shift):
    parts = _partials_of(kind, n, np.random.default_rng(n + run), shift)
    mem, n_, nv, vs, interleaved, origin = _vectors(parts)
    assert interleaved == (kind == "C") and origin == shift
    plan = serial.serial_plan(n_, nv, run, interleaved)
    got = _replay_serial(mem, n_, nv, vs, run, interleaved, plan, origin)
    want = serial.serial_sum_plain(parts, run).reshape(-1).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("kind,n,run,pieces,rpb", [
    ("A", 1_000_000, 2000, 2, 32),   # a block's 32 runs in two stages
    ("C", 31200, 15600, 0, 1),       # a run sliced: 12 x 15600 > a stage
    ("A", 60_000, 60_000, 0, 1),     # one vector's run sliced
    ("A", 850_000, 50_000, 0, 2)])   # a block's two runs, each sliced
def test_serial_replay_longer_than_one_stage(kind, n, run, pieces, rpb):
    parts = _partials_of(kind, n, np.random.default_rng(run), 1)
    mem, n_, nv, vs, interleaved, origin = _vectors(parts)
    plan = serial.serial_plan(n_, nv, run, interleaved)
    assert plan.rpb == rpb
    if pieces:
        assert plan.piece_runs * pieces >= plan.rpb > plan.piece_runs
    else:
        assert plan.slice and plan.slice < run
    got = _replay_serial(mem, n_, nv, vs, run, interleaved, plan, origin)
    want = serial.serial_sum_plain(parts, run).reshape(-1).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# The plans of the shapes the serial paths launch, fixed: (n, vectors, run,
# interleaved) -> (runs, runs per block, blocks, runs per piece, slice,
# group, threads, stage floats, lane-sum floats, shared-memory bytes).
FIXED_PLANS = {
    (4000, 1, 640, False): (7, 7, 1, 7, 0, 1, 256, 4004, 0, 16044),
    (4000, 2, 640, False): (7, 1, 7, 1, 0, 1, 256, 1288, 0, 5208),
    (4000, 12, 640, True): (7, 1, 7, 1, 0, 4, 512, 7684, 384, 32608),
    (31200, 1, 936, False): (34, 3, 12, 3, 0, 1, 256, 2812, 0, 11384),
    (31200, 12, 728, True): (43, 3, 15, 3, 0, 4, 512, 26212, 1152, 111520),
    (60_000, 1, 60_000, False): (1, 1, 1, 0, 49120, 1, 256, 49124, 0,
                                 196500),
}


@pytest.mark.parametrize("shape", list(FIXED_PLANS))
def test_serial_plan_rule(shape):
    """One block for a short launch, a cluster of at most 16 for a long
    one, within the kernel's shared memory, as fixed here."""
    plan = serial.serial_plan(*shape)
    assert tuple(plan) == FIXED_PLANS[shape]
    assert plan.blocks <= serial.MAX_CLUSTER
    assert plan.smem_bytes <= 227 * 1024


def test_serial_plan_refuses_what_the_kernel_cannot_serve():
    with pytest.raises(ValueError, match="run sums"):
        serial.serial_plan(100_000, 1, 1)
    with pytest.raises(ValueError, match="vectors=33"):
        serial.serial_plan(4000, 33, 640)


def test_serial_constants_are_the_kernels():
    """serial.py reads the kernel's block rule from its source: every
    constant the rule uses is there, once."""
    text = (Path(serial.__file__).parent / "csrc" / "serial_sum.cu"
            ).read_text()
    for name in ("StageFloats", "SumFloats", "LaneFloats", "SingleFloats",
                 "BlockFloats", "MaxCluster", "ThreadsContiguous",
                 "ThreadsInterleaved", "Threads", "Warp"):
        assert text.count(f" k{name} = ") == 1, name
    assert (serial.STAGE_FLOATS, serial.MAX_CLUSTER, serial.WARP) == \
        (49152, 16, 32)
