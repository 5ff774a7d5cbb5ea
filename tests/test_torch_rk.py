"""The RK colour-gradient slice of lbm_tpu_torch against lbm_tpu, float64 on
the CPU: models/rk_cg.py, the plain version of CUDA kernel 12
(kernels/rk.py) and the scenes rk_static_droplet and rk_rayleigh_taylor.

The same numpy-seeded inputs go through both packages.  Tolerances: the
model functions and steps 1e-13 absolute (summation order only); the plain
step against lbm_tpu's Pallas kernel in interpret mode (32x128, 3 steps)
1e-13.  The plain step takes the colour gradient in one pass on r/rho, as
lbm_tpu's kernel does; lbm_tpu's jnp model (and so the port's) takes it in
two, (b grad(r/rho) - r grad(b/rho))/rho, equal up to round-off: measured
4.0e-15 after 3 steps at 32x128 and 3.0e-14 after the 100 steps of the
scene test at 32x8 (3.2e-14 after 200 at 64x16), held at 1e-13 and 2e-13.
No singular cell shows on the RT states: where both colours are present
the colour gradient is O(1), and elsewhere r b = 0 zeroes the
recolouring flux whatever its direction.  On the card, kernel 12 is held
to this plain version (tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.core import lattice as jlat
from lbm_tpu.kernels import rk_pallas as jrp
from lbm_tpu.models import rk_cg as jrk
from lbm_tpu.scenes import multiphase as jscn

from lbm_tpu_torch import run
from lbm_tpu_torch.core import lattice as tlat
from lbm_tpu_torch.io import convert
from lbm_tpu_torch.kernels import rk as tk
from lbm_tpu_torch.models import rk_cg as trk
from lbm_tpu_torch.scenes import multiphase as tscn

TOL = 1e-13
MIX = dict(r_alpha=11 / 15, r_rho_0=3.0, r_nu=0.04, b_alpha=0.2, b_rho_0=1.0, b_nu=0.06,
           sigma=0.01, beta=0.7, gravity=(-6.25e-6, 0.0))
STEP = dict(r_alpha=11 / 15, b_alpha=0.2, r_nu=0.04, b_nu=0.06, sigma=0.01, beta=0.7,
            gravity=(-6.25e-6, 0.0))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


def test_unit_velocity_set_is_lbm_tpu_norm_c():
    """lbm_tpu's NORM_C is the port's UNIT_C (core/lattice.py)."""
    assert np.array_equal(tlat.UNIT_C, jlat.NORM_C)


def _fields(R=13, C=11, seed=0):
    rng = np.random.default_rng(seed)
    return {"r_rho": 3.0 * rng.uniform(0.2, 0.8, (R, C)), "b_rho": rng.uniform(0.2, 0.8, (R, C)),
            "u": rng.uniform(-0.05, 0.05, (2, R, C)), "F": rng.uniform(-0.3, 0.3, (2, R, C)),
            "phi": rng.uniform(0.0, 0.5, (9, R, C)), "A": rng.uniform(0.0, 1e-3, (1, R, C)),
            "alpha": rng.uniform(0.2, 0.8, (R, C))}


def _norm(F):
    return (F[0] ** 2 + F[1] ** 2) ** 0.5


RED = dict(rho_0=1.2, alpha=1.0 / 3.0, A=1e-4, nu=0.16, beta=0.7)
BLUE = dict(rho_0=1.0, alpha=0.2, A=1e-4, nu=0.14, beta=-0.7)

FUNCTIONS = {
    "rk_equilibrium_vector": lambda m, a: m.rk_equilibrium(a["r_rho"], a["u"], m.rk_phi(0.3)),
    "rk_equilibrium_field": lambda m, a: m.rk_equilibrium(a["r_rho"], a["u"], a["phi"]),
    "reis_scalar_A": lambda m, a: m.reis_perturbation(a["F"], _norm(a["F"]), 1e-4),
    "reis_field_A": lambda m, a: m.reis_perturbation(a["F"], _norm(a["F"]), a["A"], 1.0),
    "omega_rp": lambda m, a: m.RKMixtureModel(**MIX).omega_rp(
        a["r_rho"], a["b_rho"], a["r_rho"] + a["b_rho"]),
    "alpha_field": lambda m, a: m.RKMixtureModel(**MIX).alpha_field(
        a["r_rho"], a["b_rho"], a["r_rho"] + a["b_rho"]),
    "phi_field": lambda m, a: m.RKMixtureModel(**MIX).phi_field(a["alpha"]),
    "colour_gradient": lambda m, a: m.RKMixtureModel(**MIX).colour_gradient(
        a["r_rho"], a["b_rho"], a["r_rho"] + a["b_rho"])[0],
    "colour_gradient_norm": lambda m, a: m.RKMixtureModel(**MIX).colour_gradient(
        a["r_rho"], a["b_rho"], a["r_rho"] + a["b_rho"])[1],
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_rk_function_matches_lbm_tpu(name):
    fields = _fields()
    got = FUNCTIONS[name](trk, {k: _t(v) for k, v in fields.items()})
    want = FUNCTIONS[name](jrk, {k: jnp.asarray(v) for k, v in fields.items()})
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float64
    _close(got, want)


def test_colour_constants_match_lbm_tpu():
    np.testing.assert_array_equal(trk.rk_phi(0.37), jrk.rk_phi(0.37))
    t, j = trk.RKDropletColour(**RED), jrk.RKDropletColour(**RED)
    assert (t.omega, t.cks2) == (j.omega, j.cks2)
    np.testing.assert_array_equal(t.phi(), j.phi())
    tm = trk.RKDropletModel(red=t, blue=trk.RKDropletColour(**BLUE))
    jm = jrk.RKDropletModel(red=j, blue=jrk.RKDropletColour(**BLUE))
    assert tm.relax().__dict__ == jm.relax().__dict__
    assert convert.rk_droplet_colour(j) == t


def _droplet_models(exact_periodic):
    kw = dict(sigma=5e-3, delta=0.98, exact_periodic=exact_periodic)
    return (trk.RKDropletModel(trk.RKDropletColour(**RED), trk.RKDropletColour(**BLUE), **kw),
            jrk.RKDropletModel(jrk.RKDropletColour(**RED), jrk.RKDropletColour(**BLUE), **kw))


def test_droplet_model_matches_lbm_tpu():
    """init_state, 3 steps with the driver's full-edge wrap copy and the
    curvature diagnostics on a droplet whose edges carry both colours
    (radius 5 in 15x13); the exactly periodic mode is held in the scene test."""
    r0 = tscn.init_rho_droplet(15, 13, 1.2, True, 5.0, 2.0)
    b0 = tscn.init_rho_droplet(15, 13, 1.0, False, 5.0, 2.0)
    tm, jm = _droplet_models(False)
    ts = tm.init_state(r0, b0, dtype=torch.float64, device="cpu")
    js = jm.init_state(r0, b0, dtype=jnp.float64)
    jstep = jax.jit(jm.step)
    for _ in range(3):
        ts, js = tm.step(ts), jstep(js)
    for got, want in ((ts.red.f, js.red.f), (ts.blue.f, js.blue.f), (ts.red.rho, js.red.rho),
                      (ts.u, js.u)):
        _close(got, want)
    for got, want in zip(tm.curvature_diagnostics(ts), jm.curvature_diagnostics(js)):
        _close(got, want, tol=1e-12)


def _rt_state(R, C, gravity=MIX["gravity"]):
    model = jrk.RKMixtureModel(**dict(MIX, gravity=gravity), boundary=jscn.mrtcg_boundary)
    st = model.init_state(jscn.init_rho_cosine(R, C, 3.0, False, 1.0),
                          jscn.init_rho_cosine(R, C, 1.0, True, 1.0), dtype=jnp.float64)
    return model, st


def _packed(st):
    return np.concatenate([np.asarray(st.f), np.asarray(st.r_rho)[None],
                           np.asarray(st.b_rho)[None]])


@functools.cache
def _rt_oracle(R, C, steps, gravity=MIX["gravity"]):
    """lbm_tpu's RKMixtureModel (jitted) on the RT state: the packed state
    before and the model state after ``steps`` steps, as numpy."""
    model, st = _rt_state(R, C, gravity)
    S0 = _packed(st)
    step = jax.jit(model.step)
    for _ in range(steps):
        st = step(st)
    return S0, jax.tree.map(np.asarray, st)


def test_mixture_model_matches_lbm_tpu():
    S0, want = _rt_oracle(32, 24, 3)
    tm = trk.RKMixtureModel(**MIX, boundary=tscn.mrtcg_boundary)
    ts = tm.init_state(S0[9], S0[10], dtype=torch.float64, device="cpu")
    _close(ts.f, S0[:9])
    for _ in range(3):
        ts = tm.step(ts)
    for got, w in ((ts.f, want.f), (ts.r_rho, want.r_rho), (ts.b_rho, want.b_rho),
                   (ts.u, want.u)):
        _close(got, w)


def test_plain_step_matches_lbm_tpu_pallas():
    """The plain version of kernel 12 against lbm_tpu's Pallas kernel in
    interpret mode: lbm_tpu's test size (32x128, block_rows 8), 3 steps."""
    R, C = 32, 128
    _, st = _rt_state(R, C)
    S = _packed(st)
    jstep = jrp.make_rk_fused_step(R, C, dtype=jnp.float64, block_rows=8, interpret=True, **STEP)
    tstep = tk.make_rk_fused_step(R, C, dtype=torch.float64, **STEP)
    want, got = jnp.asarray(S), _t(S)
    for _ in range(3):
        want, got = jstep(want), tstep(got)
    assert tuple(got.shape) == (11, R, C)
    _close(got, want)


def test_plain_step_tracks_the_two_pass_model():
    """One-pass step against lbm_tpu's two-pass RKMixtureModel, 3 steps at
    32x24: 1e-13 (measured 4.0e-15 at 32x128); the colour masses at 1e-14
    relative."""
    S0, want = _rt_oracle(32, 24, 3)
    S = _t(S0)
    step = tk.make_rk_fused_step(32, 24, dtype=torch.float64, **STEP)
    for _ in range(3):
        S = step(S)
    _close(S[:9], want.f)
    _close(S[9], want.r_rho)
    _close(S[10], want.b_rho)
    assert float(S[9].sum()) == pytest.approx(float(want.r_rho.sum()), rel=1e-14)


def test_gravity_free_step_skips_the_source():
    """Without gravity the step takes no Guo source (lbm_tpu rk_pallas.py:101,
    :114; the flag is parameter 6 of kernel 12) and still tracks the model
    (the port's, held to lbm_tpu's above), 2 steps at 1e-13."""
    kw = dict(STEP, gravity=(0.0, 0.0))
    model = trk.RKMixtureModel(**dict(MIX, gravity=(0.0, 0.0)), boundary=tscn.mrtcg_boundary)
    st = model.init_state(tscn.init_rho_cosine(20, 12, 3.0, False, 1.0),
                          tscn.init_rho_cosine(20, 12, 1.0, True, 1.0), dtype=torch.float64,
                          device="cpu")
    S = torch.cat([st.f, st.r_rho[None], st.b_rho[None]])
    step = tk.make_rk_fused_step(20, 12, dtype=torch.float64, **kw)
    for _ in range(2):
        S, st = step(S), model.step(st)
    _close(S[:9], st.f)
    assert tk.kernel_params(**kw)[6] == 0.0 and tk.kernel_params(**STEP)[6] == 1.0


def test_substeps_and_rejections():
    R, C = 12, 9
    _, st = _rt_state(R, C)
    S = _t(_packed(st))
    one = tk.make_rk_fused_step(R, C, dtype=torch.float64, **STEP)
    assert torch.equal(tk.make_rk_fused_step(R, C, dtype=torch.float64, substeps=2, **STEP)(S),
                       one(one(S)))
    with pytest.raises(ValueError, match="step built for"):
        one(S.float())
    with pytest.raises(ValueError, match="step built for"):
        one(S[:10])
    with pytest.raises(ValueError, match="substeps"):
        tk.make_rk_fused_step(R, C, substeps=0, **STEP)


def test_kernel_params_are_the_plain_versions_scalars():
    """csrc/rk_cg.cu reads ``kernel_params`` by position (enum P)."""
    p = tk.kernel_params(**STEP)
    assert len(p) == 17 and all(isinstance(v, float) for v in p)
    assert p[:9] == (11 / 15, 0.2, 0.04, 0.06, 4.5 * 0.01, 0.7, 1.0, -6.25e-6, 0.0)
    assert p[9:13] == (-6.25e-6, 0.0, -6.25e-6, -6.25e-6)
    assert p[13:] == tuple(3.0 * v for v in p[9:13])


def test_rayleigh_taylor_scene_matches_lbm_tpu():
    """rk_rayleigh_taylor at 32x8 for 100 steps against lbm_tpu's scene on
    its jnp path (the two-pass model): 2e-13 (measured 3.0e-14); the
    snapshot cadence is lbm_tpu's."""
    got = tscn.rk_rayleigh_taylor(L=8, T=100, snapshot_every=40, device="cpu")
    want = jscn.rk_rayleigh_taylor(L=8, T=100, snapshot_every=40, fused=False,
                                   dtype=jnp.float64)
    assert tk.RK_CG.launches == 0  # the CPU state took the plain version
    assert got.steps == 100 and got.state.f.dtype == torch.float64
    for g, w in ((got.state.f, want.state.f), (got.state.r_rho, want.state.r_rho),
                 (got.state.b_rho, want.state.b_rho), (got.state.u, want.state.u)):
        _close(g, w, tol=2e-13)
    for k in ("r_rho", "ux"):
        assert got.snapshots[k].shape == want.snapshots[k].shape == (3, 32, 8)
        np.testing.assert_allclose(got.snapshots[k], want.snapshots[k], rtol=0, atol=2e-13)


@pytest.mark.parametrize("exact_periodic", [False, True])
def test_static_droplet_scene_matches_lbm_tpu(exact_periodic):
    """rk_static_droplet at 21x21 for 20 steps: 1e-13 (measured 6.5e-16
    after 50)."""
    kw = dict(L=21, T=20, radius=5.0, exact_periodic=exact_periodic, snapshot_every=10)
    got = tscn.rk_static_droplet(device="cpu", **kw)
    want = jscn.rk_static_droplet(dtype=jnp.float64, **kw)
    for g, w in ((got.state.red.f, want.state.red.f), (got.state.blue.f, want.state.blue.f),
                 (got.state.u, want.state.u)):
        _close(g, w)
    for k in ("r_rho", "b_rho"):
        np.testing.assert_allclose(got.snapshots[k], want.snapshots[k], rtol=0, atol=TOL)


def test_rk_state_conversion():
    S = np.random.default_rng(3).uniform(0, 1, (11, 5, 4))
    t = convert.rk_state_from_numpy(S, device="cpu", dtype=torch.float32)
    assert t.dtype == torch.float32 and t.is_contiguous()
    np.testing.assert_array_equal(convert.state_to_numpy(t), S.astype(np.float32))
    with pytest.raises(ValueError, match="RK mixture"):
        convert.rk_state_from_numpy(S[:10], device="cpu", dtype=torch.float64)


def test_cli_runs_rk_rayleigh_taylor(tmp_path):
    scenes = run._scenes()
    for name in ("rk_static_droplet", "rk_rayleigh_taylor"):
        assert scenes[name] is getattr(tscn, name)
    out = str(tmp_path / "rt")
    assert run.main(["rk_rayleigh_taylor", "--x64", "--device", "cpu", "--set", "L=4",
                     "--set", "T=5", "--out", out]) == 0
    want = tscn.rk_rayleigh_taylor(L=4, T=5, device="cpu")
    np.testing.assert_array_equal(np.load(out + "-state-f.npy"), want.state.f.numpy())
    np.testing.assert_array_equal(np.load(out + "-state-r_rho.npy"), want.state.r_rho.numpy())
