"""The host-side tables of the one-block IBM forcing kernels against lbm_tpu.

Kernel 16 (csrc/ibm_forcing.cu) reads kernels/ibm.py ``forcing_tables``: the
support, each tap's support index and each support cell's (marker, weight)
entries in ascending marker.  Kernels 19-21 (csrc/moving_ibm.cu) read
kernels/moving_ibm.py ``Boxes``: each body's box, its ring band and the
body-frame buckets whose lists hold every marker that can reach a cell.
Here numpy mirrors of the kernels' gathers, driven by those tables, are held
to lbm_tpu's dense operators (ops/ibm.py force_density_roi, ops/moving_ibm.py
window_factors and forcing_window_markers) at 1e-13 in float64, and the
boxes, bands and buckets are checked to hold every marker support the
kernels can meet, with positions rounded as the kernels round them in both
types.  The kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda.py.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import ibm as jibm
from lbm_tpu.ops import moving_ibm as jmi

from lbm_tpu_torch.kernels import ibm as kibm
from lbm_tpu_torch.kernels import moving_ibm as km
from lbm_tpu_torch.ops import ibm
from lbm_tpu_torch.ops.moving_ibm import ellipse_markers, peskin4j

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARKERS = os.path.join(REPO, "configs", "cylinder-markers.toml")


def _pair(case):
    """(port IBM, lbm_tpu IBM) of one marker set."""
    theta = np.linspace(0.0, 2.0 * np.pi, 19, endpoint=False)
    xs, ys = 31.3 + 7.7 * np.cos(theta), 12.6 + 5.1 * np.sin(theta)
    build = {
        "strouhal": lambda m: m.IBM.circle(300.0, 128.0, 16.0, 64),
        "markers_m3": lambda m: m.IBM.from_markers(xs, ys, m_max=3),
        "toml_transposed": lambda m: m.IBM.from_toml(MARKERS, "cylinder-a",
                                                     reference_transposed_weights=True),
        "dense": lambda m: m.IBM.circle(80.0, 80.0, 20.0, 300),
    }[case]
    return build(ibm), build(jibm)


def _mirror16(ib, u, rho):
    """Kernel 16's algorithm on its tables, in numpy: the support's fields,
    16-tap interpolation per marker, the spread gathered per support cell
    over its entries in ascending marker."""
    w16, tap, sup, ptr, ent_j, ent_w = kibm.forcing_tables(ib)
    rho_s = rho.reshape(-1)[sup]
    ux, uy = u[0].reshape(-1)[sup], u[1].reshape(-1)[sup]
    Fx, Fy = np.zeros(sup.size), np.zeros(sup.size)
    rho_j = (w16 * rho_s[tap]).sum(axis=1)
    for _ in range(ib.m_max - 1):
        fx = -2.0 * rho_j * (w16 * ux[tap]).sum(axis=1)
        fy = -2.0 * rho_j * (w16 * uy[tap]).sum(axis=1)
        sx = np.add.reduceat(fx[ent_j] * ent_w, ptr[:-1])
        sy = np.add.reduceat(fy[ent_j] * ent_w, ptr[:-1])
        ux, uy = ux + 0.5 * sx / rho_s, uy + 0.5 * sy / rho_s
        Fx, Fy = Fx + sx, Fy + sy
    F = np.zeros((2, rho.size))
    F[0, sup], F[1, sup] = Fx, Fy
    return F.reshape((2,) + rho.shape)


@pytest.mark.parametrize("case", ["strouhal", "markers_m3", "toml_transposed", "dense"])
def test_forcing_tables_reproduce_lbm_tpu_force_density(case):
    got_ib, want_ib = _pair(case)
    w16, tap, sup, ptr, ent_j, ent_w = kibm.forcing_tables(got_ib)
    flat = np.asarray(want_ib.flat_idx)
    assert np.array_equal(w16, np.asarray(want_ib.weights))
    assert np.array_equal(sup[tap], flat) and np.array_equal(sup, np.unique(flat))
    assert ptr[0] == 0 and ptr[-1] == ent_j.size == w16.size and (np.diff(ptr) > 0).all()
    for s in range(sup.size):                                  # ascending markers
        assert (np.diff(ent_j[ptr[s]:ptr[s + 1]]) > 0).all()
    rng = np.random.default_rng(7)
    u = 0.05 * rng.standard_normal((2,) + got_ib.roi_shape)
    rho = 1.0 + 0.01 * rng.standard_normal(got_ib.roi_shape)
    want = np.asarray(want_ib.force_density_roi(jnp.asarray(u), jnp.asarray(rho)))
    assert np.abs(_mirror16(got_ib, u, rho) - want).max() <= 1e-13


def test_kernel16_block_and_working_set():
    """The block takes a lane per tap or a thread per support cell, in whole
    warps, at most 1024; the Strouhal ROI's working set fits shared memory
    in both types, the 1200-marker ring's float64 one does not (the global
    scratch path of tests/test_torch_cuda.py)."""
    assert kibm.block_threads(64, 450) == 512
    assert kibm.block_threads(10, 170) == 192 and kibm.block_threads(1, 3) == 32
    assert kibm.block_threads(400, 1600) == 1024
    strouhal = ibm.IBM.circle(300.0, 128.0, 16.0, 64)
    n_sup = kibm.forcing_tables(strouhal)[2].size
    assert 300 < n_sup < strouhal.roi_shape[0] * strouhal.roi_shape[1] // 2
    for itemsize in (4, 8):
        assert kibm.scratch_bytes(n_sup, 64, itemsize) <= kibm.SMEM_LIMIT
    big = ibm.IBM.circle(80.0, 80.0, 70.0, 1200)
    n_big = kibm.forcing_tables(big)[2].size
    assert kibm.scratch_bytes(n_big, 1200, 8) > kibm.SMEM_LIMIT


def _ring(r):
    th = np.linspace(0.0, 2.0 * np.pi, int(np.ceil(2 * np.pi * r)), endpoint=False)
    return r * np.cos(th), r * np.sin(th)


def _frame(cos, sin, dtype):
    """The kernels' body frame (cr, sr) = (cos, sin) / (cos^2 + sin^2)."""
    c, s = dtype(cos), dtype(sin)
    inv = dtype(1) / (c * c + s * s)
    return c * inv, s * inv


def _markers(cen, dx, dy, cos, sin, dtype):
    """Marker positions as the kernels round them: x = c + (cos dx - sin dy)."""
    c, s = dtype(cos), dtype(sin)
    dxt, dyt = dx.astype(dtype), dy.astype(dtype)
    rx = c * dxt - s * dyt
    ry = s * dxt + c * dyt
    return dtype(cen[0]) + rx, dtype(cen[1]) + ry


def _candidates(boxes, cen, cr, sr, r, c, dtype):
    """The bucket list that the kernels read for grid cell (r, c), or None
    off the body's band."""
    cx, cy = dtype(cen[0]), dtype(cen[1])
    pr, pc = dtype(r) - cx, dtype(c) - cy
    d2 = pr * pr + pc * pc
    lo, hi = (dtype(v) for v in boxes.near)
    if not lo <= d2 <= hi:
        return None
    kr = int(np.floor(cr * pr + sr * pc)) + boxes.QB
    kc = int(np.floor(cr * pc - sr * pr)) + boxes.QB
    if not (0 <= kr < 2 * boxes.QB and 0 <= kc < 2 * boxes.QB):
        return np.zeros(0, np.int32)
    k = kr * 2 * boxes.QB + kc
    return boxes.ent[boxes.ptr[k]:boxes.ptr[k + 1]]


OFFSETS = {"ring r=12": _ring(12.0), "ring r=8": _ring(8.0), "ring r=6": _ring(6.0),
           "ellipse 16x8": ellipse_markers(16.0, 8.0), "ellipse 9x4.5": ellipse_markers(9.0, 4.5)}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", list(OFFSETS))
def test_boxes_bands_and_buckets_hold_every_support(shape, dtype):
    """For bodies at random centres and orientations (the (cos, sin) pair
    up to 0.5% off norm 1), every cell of every marker's 4x4 support lies
    in the body's box and band, and the bucket of its body-frame position
    lists the marker."""
    dx, dy = (np.asarray(v, np.float64) for v in OFFSETS[shape])
    boxes = km.Boxes(dx, dy)
    assert boxes.side == 2 * boxes.K + 5 and boxes.ptr.size == 4 * boxes.QB ** 2 + 1
    rng = np.random.default_rng(len(shape))
    for trial in range(12):
        cen = rng.uniform(50.0, 700.0, 2)
        ang = rng.uniform(0.0, 2.0 * np.pi) if "ellipse" in shape else 0.0
        norm = 1.0 + (rng.uniform(-5e-3, 5e-3) if "ellipse" in shape else 0.0)
        cos, sin = norm * np.cos(ang), norm * np.sin(ang)
        cr, sr = _frame(cos, sin, dtype) if "ellipse" in shape else (dtype(1), dtype(0))
        x, y = _markers(cen, dx, dy, cos, sin, dtype)
        R0 = int(np.floor(dtype(cen[0]))) - boxes.K - 1
        C0 = int(np.floor(dtype(cen[1]))) - boxes.K - 1
        for jj in range(dx.size):
            fr, fc = int(np.floor(x[jj])) - 1, int(np.floor(y[jj])) - 1
            assert R0 <= fr and fr + 3 < R0 + boxes.side
            assert C0 <= fc and fc + 3 < C0 + boxes.side
            for r in range(fr, fr + 4):
                for c in range(fc, fc + 4):
                    cand = _candidates(boxes, cen, cr, sr, r, c, dtype)
                    assert cand is not None and jj in cand, (trial, jj, r, c)


def _mirror_moving(f_win, r0, centers, dx, dy, ub, m_max):
    """Kernel 21's algorithm in numpy float64 over the window at row r0:
    per marker its support (floor(x) - 1 ..) and Peskin weights; per
    window cell in some body's band, the spread gathered over the bodies in
    order and each bucket's candidates in ascending marker, a candidate
    counted where its support holds the cell; per marker the interpolation
    over its support's rows in order.  Returns (F, per-marker force sum)."""
    rho = f_win.sum(axis=0)
    ux = (f_win[1] - f_win[3] + f_win[5] - f_win[6] - f_win[7] + f_win[8]) / rho
    uy = (f_win[2] - f_win[4] + f_win[5] + f_win[6] - f_win[7] - f_win[8]) / rho
    rw, cw = rho.shape
    boxes = km.Boxes(dx, dy)
    B, Mb = len(centers), dx.size
    x = np.concatenate([c[0] + dx for c in centers])
    y = np.concatenate([c[1] + dy for c in centers])
    rb = np.floor(x).astype(int) - 1 - r0
    cb = np.floor(y).astype(int) - 1
    a4 = np.arange(4)
    wx = peskin4j(torch.as_tensor(rb[:, None] + r0 + a4 - x[:, None])).numpy()
    wy = peskin4j(torch.as_tensor(cb[:, None] + a4 - y[:, None])).numpy()
    cells = []                                   # (rr, cc, [(j, wa, wb), ...])
    for rr in range(rw):
        for cc in range(cw):
            ents = []
            for b in range(B):
                cand = _candidates(boxes, centers[b], 1.0, 0.0, r0 + rr, cc, np.float64)
                for jj in ([] if cand is None else cand):
                    j = b * Mb + jj
                    dr, dc = rr - rb[j], cc - cb[j]
                    if 0 <= dr < 4 and 0 <= dc < 4:
                        ents.append((j, wx[j, dr], wy[j, dc]))
            if ents:
                cells.append((rr, cc, ents))

    def interp(g):
        out = np.zeros(B * Mb)
        for j in range(B * Mb):
            acc = 0.0
            for a in range(4):
                v = 0.0
                if 0 <= rb[j] + a < rw:
                    for b in range(4):
                        if 0 <= cb[j] + b < cw:
                            v += g[rb[j] + a, cb[j] + b] * wy[j, b]
                acc += v * wx[j, a]
            out[j] = acc
        return out

    F = np.zeros((2, rw, cw))
    fj = np.zeros((2, B * Mb))
    rho_j = interp(rho)
    ubm = np.repeat(np.asarray(ub), Mb, axis=0).T
    for _ in range(m_max - 1):
        fx = 2.0 * rho_j * (ubm[0] - interp(ux))
        fy = 2.0 * rho_j * (ubm[1] - interp(uy))
        fj += np.stack([fx, fy])
        for rr, cc, ents in cells:
            sx = sum((wa * fx[j]) * wb for j, wa, wb in ents)
            sy = sum((wa * fy[j]) * wb for j, wa, wb in ents)
            ux[rr, cc] += (0.5 * sx) * (1.0 / rho[rr, cc])
            uy[rr, cc] += (0.5 * sy) * (1.0 / rho[rr, cc])
            F[0, rr, cc] += sx
            F[1, rr, cc] += sy
    return F, fj


def test_gather_mirror_matches_lbm_tpu_window_forcing_at_overlapping_supports():
    """Two rings of r = 6 with centres 2 r + 1.4 apart, their supports
    sharing cells: the kernels' gather (``_mirror_moving``) equals lbm_tpu's
    union-window forcing with the dense factors at 1e-13 in float64, F and
    the per-marker forces."""
    dx, dy = (np.asarray(v, np.float64) for v in _ring(6.0))
    centers = ((20.0, 16.3), (33.4, 16.9))
    r0, rw, W = 8, 40, 32
    rng = np.random.default_rng(3)
    f_win = (np.full((9, rw, W), 1.0 / 9.0)
             * rng.uniform(0.97, 1.03, (9, rw, W)))
    ub = ((0.003, 0.0), (-0.002, 0.001))
    F, fj = _mirror_moving(f_win, r0, centers, dx, dy, ub, 5)
    rho = f_win.sum(axis=0)
    u = np.stack([(f_win[1] - f_win[3] + f_win[5] - f_win[6] - f_win[7] + f_win[8]) / rho,
                  (f_win[2] - f_win[4] + f_win[5] + f_win[6] - f_win[7] - f_win[8]) / rho])
    xs = np.concatenate([c[0] + dx for c in centers])
    ys = np.concatenate([c[1] + dy for c in centers])
    X, Y = jmi.window_factors(jnp.asarray(xs), jnp.asarray(ys), float(r0), 0.0, rw, W)
    ubm = jnp.asarray(np.repeat(np.asarray(ub), dx.size, axis=0).T)
    F_want, fj_want = jmi.forcing_window_markers(jnp.asarray(u), jnp.asarray(rho), X, Y, ubm, 5)
    shared = (np.asarray(X)[:, :dx.size].any(axis=1) & np.asarray(X)[:, dx.size:].any(axis=1))
    assert shared.sum() >= 2                     # the two rings' supports share rows
    assert np.abs(F - np.asarray(F_want)).max() <= 1e-13
    assert np.abs(fj - np.asarray(fj_want)).max() <= 1e-13


def test_launch_shape_and_scratch():
    """Block 0 takes 4 lanes a marker or a thread a slot, in whole warps, at
    most 1024; 1 to 32 more blocks zero the window; DKT's 228-row window
    and the ellipse's working sets fit shared memory in float64."""
    dx, dy = (np.asarray(v, np.float64) for v in _ring(12.0))
    boxes = km.Boxes(dx, dy)
    assert (boxes.K, boxes.side, boxes.QB) == (13, 31, 17)
    assert km.launch_shape(boxes, 2, 152, 228 * 128) == (1024, 8)
    assert km.launch_shape(boxes, 1, 76, 34 * 34) == (992, 1)
    assert km.scratch_bytes(boxes, 2, 152, 1024, 8) <= kibm.SMEM_LIMIT
    ell = km.Boxes(*(np.asarray(v, np.float64) for v in ellipse_markers(16.0, 8.0)))
    threads = km.launch_shape(ell, 1, 78, 42 * 42)[0]
    assert km.scratch_bytes(ell, 1, 78, threads, 8) <= kibm.SMEM_LIMIT


def test_window_packing_limit():
    """The kernels index a window cell as rr cw + cc, and F's second plane
    at 2 wr cw, in int32: windows of any shape up to MAX_WINDOW_CELLS cells
    pass (800x65536, past the 65,535 columns of the old 16-bit packing,
    and a single row of 2^30 - 1 columns), a window cell's F index decodes
    to its row and column, and a window one cell larger is refused before
    it reaches the kernel."""
    n = km.MAX_WINDOW_CELLS
    assert 2 * n <= np.iinfo(np.int32).max < 2 * (n + 1)
    for wr, wc in ((800, 65536), (228, 128), (1, n), (n, 1), (32767, 32768)):
        km.check_window(wr, wc)
        last = np.int32((wr - 1) * wc + (wc - 1))
        assert (int(last) // wc, int(last) % wc) == (wr - 1, wc - 1)
        assert 2 * wr * wc <= np.iinfo(np.int32).max
    for bad in ((1, n + 1), (32768, 32768), (65536, 65536)):
        with pytest.raises(ValueError, match="largest"):
            km.check_window(*bad)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("unit", ["ibm_forcing", "moving_ibm"])
def test_breakdown_probes_apply_to_the_sources(unit):
    """chip_smoke.py --ibm-breakdown builds each probe from an edited copy of
    csrc/<unit>.cu: every edit still finds its text, and every probe but
    "full" changes the source."""
    cs = _chip_smoke()
    full = cs.probe_source(unit, "full")
    for label in cs.IBM_PROBES[unit]:
        src = cs.probe_source(unit, label)
        assert (src == full) == (label == "full"), label
