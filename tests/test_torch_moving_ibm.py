"""The moving-body IBM of lbm_tpu_torch against lbm_tpu: ops/moving_ibm.py,
the plain versions of CUDA kernels 18-21 (kernels/cylinder.py
plain_box_step, kernels/moving_ibm.py), the window origin's rounding and the
rigid-state carry-over.

Tolerances (max abs error, float64): the ops at 1e-13 (ellipse_markers and
the lane constants exactly); the plain forcing steps against lbm_tpu's
Pallas kernels in interpret mode at 1e-12, lbm_tpu's own fused-against-jnp
bound (tests/test_moving_ibm.py:170-177), F over the port's window (the jnp
window) and the state; the plain box step against lbm_tpu's Pallas
make_box_fused_step at 1e-13.  Kernels 18-21 themselves are held to the
plain versions on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels import moving_ibm_pallas as jkm
from lbm_tpu.kernels.cylinder_pallas import make_box_fused_step as jax_box_step
from lbm_tpu.ops import d2q9 as jd
from lbm_tpu.ops import moving_ibm as jmi

from lbm_tpu_torch.io import convert
from lbm_tpu_torch.kernels import cylinder
from lbm_tpu_torch.kernels import moving_ibm as km
from lbm_tpu_torch.ops import moving_ibm as mi

F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def _noisy(R, C, seed):
    rng = np.random.default_rng(seed)
    u = 0.05 * rng.uniform(-1.0, 1.0, (2, R, C))
    rho = 1.0 + 0.01 * rng.uniform(-1.0, 1.0, (R, C))
    f = np.asarray(jd.equilibrium(jnp.asarray(u), jnp.asarray(rho)))
    return f * rng.uniform(0.97, 1.03, (9, R, C))


def test_peskin_factors_and_forcing_match_lbm_tpu():
    """peskin4j, window_factors, forcing_window and
    forcing_window_markers at per-marker targets, float64."""
    rng = np.random.default_rng(4)
    r = np.linspace(-2.5, 2.5, 201)
    _close(mi.peskin4j(_t(r)), jmi.peskin4j(jnp.asarray(r)), 1e-15)
    xs, ys = rng.uniform(10.0, 20.0, 23), rng.uniform(8.0, 22.0, 23)
    X, Y = mi.window_factors(_t(xs), _t(ys), 7.0, 5.0, 17, 21)
    jX, jY = jmi.window_factors(jnp.asarray(xs), jnp.asarray(ys), 7.0, 5.0, 17, 21)
    _close(X, jX, 1e-15)
    _close(Y, jY, 1e-15)
    u = 0.05 * rng.normal(size=(2, 17, 21))
    rho = 1.0 + 0.01 * rng.normal(size=(17, 21))
    ub = rng.normal(0.0, 0.01, (2, 23))
    F, fj = mi.forcing_window_markers(_t(u), _t(rho), X, Y, _t(ub), m_max=5)
    jF, jfj = jmi.forcing_window_markers(jnp.asarray(u), jnp.asarray(rho), jX, jY,
                                         jnp.asarray(ub), m_max=5)
    _close(F, jF, 1e-13)
    _close(fj, jfj, 1e-13)
    F, fsum = mi.forcing_window(_t(u), _t(rho), X, Y, _t([0.02, -0.01]), m_max=3)
    jF, jfsum = jmi.forcing_window(jnp.asarray(u), jnp.asarray(rho), jX, jY,
                                   jnp.asarray([0.02, -0.01]), m_max=3)
    _close(F, jF, 1e-13)
    _close(fsum, jfsum, 1e-13)


@pytest.mark.parametrize("centers,zeta", [
    (((100.0, 90.0), (100.0, 115.0)), 2.0),     # a close pair
    (((13.0, 100.0), (186.0, 188.5)), 2.0),     # the walls
    (((30.0, 120.0), (46.0, 140.0), (60.0, 131.0)), 12.0)])
def test_barrier_forces_match_lbm_tpu(centers, zeta):
    got = mi.barrier_forces(_t(centers), 12.0, 200, 200, zeta=zeta, eps=50.0)
    want = jmi.barrier_forces(jnp.asarray(centers, jnp.float64), 12.0, 200, 200, zeta=zeta,
                              eps=50.0)
    _close(got, want, 1e-13)
    assert got.abs().max() > 0.0


def test_markers_rotation_and_constants_match_lbm_tpu():
    for a, b, n in ((16.0, 8.0, None), (9.0, 4.5, None), (10.0, 10.0, 40)):
        dx, dy = mi.ellipse_markers(a, b, n)
        jdx, jdy = jmi.ellipse_markers(a, b, n)
        assert np.array_equal(dx, jdx) and np.array_equal(dy, jdy)
    c, s = mi.cayley_rotate(_t(np.cos(0.3)), _t(np.sin(0.3)), _t([0.0, 1e-3, -0.2, 2.5]))
    jc, js = jmi.cayley_rotate(jnp.cos(0.3), jnp.sin(0.3), jnp.asarray([0.0, 1e-3, -0.2, 2.5]))
    _close(c, jc, 1e-15)
    _close(s, js, 1e-15)
    xs, ys = mi.circle_markers(_t([30.3, 41.7]), 9.0, 57)
    jxs, jys = jmi.circle_markers(jnp.asarray([30.3, 41.7]), 9.0, 57)
    _close(xs, jxs, 1e-13)
    _close(ys, jys, 1e-13)
    lanes = ("CEN_X", "CEN_Y", "UB_X", "UB_Y", "FH_X", "FH_Y", "ORI_C", "ORI_S", "ANG_W", "TRQ")
    assert [getattr(km, n) for n in lanes] == [getattr(jkm, n) for n in lanes]
    assert km.STATE_LANES == len(lanes)


def test_window_origin_rounds_half_to_even():
    """The port follows lbm_tpu's jnp oracle, round half to even
    (obstacles.py:1047-1050); lbm_tpu's Pallas kernel takes floor(cen + 0.5)
    (moving_ibm_pallas.py:220), one cell apart at an even n + 0.5."""
    for cen, want in ((20.5, 20), (21.5, 22), (20.49, 20), (20.51, 21)):
        got = km.window_origin(_t(cen), _t(cen), 10, 400, 256, 20, 20)
        assert got.tolist() == [want - 10, want - 10]
        assert int(jnp.round(jnp.float64(cen))) == want
    assert int(np.floor(20.5 + 0.5)) == 21
    assert km.window_origin(_t(3.0), None, 10, 400, 256, 20, 256).tolist() == [0, 0]
    assert km.window_origin(_t(399.0), _t(250.0), 10, 400, 256, 20, 20).tolist() == [380, 236]


def _jax_window(F_full, r0, c0, wr, wc):
    F_full = np.asarray(F_full)
    outside = F_full.copy()
    outside[:, r0:r0 + wr, c0:c0 + wc] = 0.0
    assert np.abs(outside).max() == 0.0       # lbm_tpu's margins hold zeros
    return F_full[:, r0:r0 + wr, c0:c0 + wc]


def _rigid(g_net_scale, radius, rho_s=1.25):
    area = np.pi * radius * radius
    return (rho_s - 1.0) * area * g_net_scale, rho_s * area


def test_plain_moving_forcing_matches_pallas_kernel():
    """Kernel 19's plain version against lbm_tpu's make_moving_forcing_step
    in interpret mode (tests/test_moving_ibm.py:124-177's case, 96x256)."""
    H, W, radius = 96, 256, 9.0
    n = int(np.ceil(2 * np.pi * radius))
    half = int(np.ceil(radius)) + 5
    g_net, m_eff = _rigid(5e-5, radius)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    dx, dy = radius * np.cos(th), radius * np.sin(th)
    f = _noisy(H, W, 3)
    jstep = jkm.make_moving_forcing_step(H, W, dx, dy, half=half, g_net=g_net, m_eff=m_eff,
                                         dtype=jnp.float64, interpret=True)
    jF, jst = jstep(jnp.asarray(f), jkm.pack_state((30.3, 130.7), (0.02, -0.01),
                                                   dtype=jnp.float64),
                    jnp.zeros((2, H, W), jnp.float64))
    step = km.make_moving_forcing_step(H, W, dx, dy, half=half, g_net=g_net, m_eff=m_eff,
                                       dtype=F64)
    F, origin, st = step(_t(f), km.pack_state((30.3, 130.7), (0.02, -0.01), dtype=F64))
    r0, c0 = origin.tolist()
    assert (r0, c0) == (16, 117) and origin.dtype == torch.int32
    _close(F, _jax_window(jF, r0, c0, 2 * half, 2 * half), 1e-12)
    _close(st, np.asarray(jst)[:, :km.STATE_LANES], 1e-12)


def test_plain_moving_rot_matches_pallas_kernel():
    """Kernel 20's plain version against lbm_tpu's make_moving_rot_step in
    interpret mode, a tilted spinning ellipse at 64x256."""
    H, W, a, b = 64, 256, 9.0, 4.5
    dx, dy = mi.ellipse_markers(a, b)
    half = int(np.ceil(a)) + 5
    area = np.pi * a * b
    kw = dict(half=half, g_net=0.25 * area * 2e-4, m_eff=1.4 * area,
              i_eff=1.4 * area * (a * a + b * b) / 4.0)
    f = _noisy(H, W, 8)
    cs = (np.cos(0.5), np.sin(0.5))
    jstep = jkm.make_moving_rot_step(H, W, dx, dy, dtype=jnp.float64, interpret=True, **kw)
    jF, jst = jstep(jnp.asarray(f), jkm.pack_state_rot((24.2, 127.3), cs, (0.01, 0.004), 0.003,
                                                       dtype=jnp.float64),
                    jnp.zeros((2, H, W), jnp.float64))
    step = km.make_moving_rot_step(H, W, dx, dy, dtype=F64, **kw)
    F, origin, st = step(_t(f), km.pack_state_rot((24.2, 127.3), cs, (0.01, 0.004), 0.003,
                                                  dtype=F64))
    r0, c0 = origin.tolist()
    _close(F, _jax_window(jF, r0, c0, 2 * half, 2 * half), 1e-12)
    _close(st, np.asarray(jst)[:, :km.STATE_LANES], 1e-12)


def test_plain_moving_bodies_matches_pallas_kernel():
    """Kernel 21's plain version against lbm_tpu's make_moving_bodies_step in
    interpret mode with the pair barrier active, the bodies of
    tests/test_moving_ibm.py:281-310 at 96x256 with that scene's 64-row
    window (at its 64 rows lbm_tpu's margined window does not fit, and its
    scene runs jnp on both sides of that comparison)."""
    H, W, radius, zeta = 96, 256, 8.0, 12.0
    n = int(np.ceil(2 * np.pi * radius))
    half = int(np.ceil(radius)) + 5
    centers = ((30.0, 120.0), (46.0, 140.0))
    rw = 64
    g_net, m_eff = _rigid(1e-4, radius, 1.4)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    dx, dy = radius * np.cos(th), radius * np.sin(th)
    kw = dict(n_bodies=2, rw=rw, half=half, g_net=g_net, m_eff=m_eff, radius=radius, zeta=zeta)
    f = _noisy(H, W, 9)
    jstep = jkm.make_moving_bodies_step(H, W, dx, dy, dtype=jnp.float64, interpret=True, **kw)
    jF, jst = jstep(jnp.asarray(f), jkm.pack_states(centers, ((0.01, 0.0), (0.0, -0.01)),
                                                    dtype=jnp.float64),
                    jnp.zeros((2, H, W), jnp.float64))
    step = km.make_moving_bodies_step(H, W, dx, dy, dtype=F64, **kw)
    F, origin, st = step(_t(f), km.pack_states(centers, ((0.01, 0.0), (0.0, -0.01)),
                                               dtype=F64))
    assert origin.tolist() == [17, 0] and F.shape == (2, rw, W)
    _close(F, _jax_window(jF, 17, 0, rw, W), 1e-12)
    _close(st, np.asarray(jst)[:, :km.STATE_LANES], 1e-12)


def test_plain_box_step_matches_pallas_kernel():
    """plain_box_step against lbm_tpu's make_box_fused_step (interpret mode),
    two steps at 64x128 from a noisy state with a noisy force window."""
    R, C = 64, 128
    rng = np.random.default_rng(12)
    f = _noisy(R, C, 11)
    F = rng.normal(0.0, 1e-3, (2, 34, 34))
    F_full = np.zeros((2, R, C))
    F_full[:, 20:54, 70:104] = F
    kstep = jax_box_step(R, C, 1 / 0.6, dtype=jnp.float64, interpret=True)
    want = kstep(kstep(jnp.asarray(f), jnp.asarray(F_full)), jnp.asarray(F_full))
    step = cylinder.make_box_fused_step(R, C, 1 / 0.6, dtype=F64)
    origin = torch.tensor([20, 70], dtype=torch.int32)
    got = step(step(_t(f), _t(F), origin), _t(F), origin)
    _close(got, want, 1e-13)


def test_steps_reject_what_they_do_not_take():
    th = np.linspace(0, 2 * np.pi, 20, endpoint=False)
    with pytest.raises(ValueError, match="does not fit"):
        km.make_moving_forcing_step(20, 64, np.cos(th), np.sin(th), half=11, g_net=0.0,
                                    m_eff=1.0, dtype=F64)
    step = km.make_moving_forcing_step(64, 64, np.cos(th), np.sin(th), half=6, g_net=0.0,
                                       m_eff=1.0, dtype=F64)
    with pytest.raises(ValueError, match="body state"):
        step(torch.ones(9, 64, 64, dtype=F64), torch.zeros(2, 10, dtype=F64))
    box = cylinder.make_box_fused_step(16, 16, 1.5, dtype=F64)
    with pytest.raises(ValueError, match="int32"):
        box(torch.ones(9, 16, 16, dtype=F64), torch.zeros(2, 4, 4, dtype=F64),
            torch.tensor([0, 0]))
    with pytest.raises(ValueError, match="R >= 4"):
        cylinder.make_box_fused_step(3, 16, 1.5)


def test_rigid_state_carries_both_ways():
    rows = np.asarray(jkm.pack_state_rot((24.2, 127.3), (0.6, 0.8), (0.01, 0.004), 0.003,
                                         dtype=jnp.float64))
    st = convert.rigid_state_from_numpy(rows, "cpu", F64)
    assert torch.equal(st, km.pack_state_rot((24.2, 127.3), (0.6, 0.8), (0.01, 0.004), 0.003,
                                             dtype=F64))
    assert np.array_equal(convert.rigid_state_to_numpy(st), rows)
    rows = np.asarray(jkm.pack_states(((1.0, 2.0), (3.0, 4.0)), ((0.1, 0.2), (0.3, 0.4)),
                                      dtype=jnp.float32))
    st = convert.rigid_state_from_numpy(rows, "cpu", torch.float32)
    assert st.shape == (2, km.STATE_LANES)
    back = convert.rigid_state_to_numpy(st)
    assert back.dtype == np.float32 and np.array_equal(back, rows)
    bad = rows.copy()
    bad[0, 100] = 1.0
    with pytest.raises(ValueError, match="lanes past"):
        convert.rigid_state_from_numpy(bad, "cpu", torch.float32)
