"""The truncated power law of lbm_tpu_torch against lbm_tpu: models/power_law.py,
the periodic power-law step (CUDA kernel 11's plain version) and the
power_law_channel scene, which has no kernel in either package.

The same numpy-seeded inputs go through both packages on the CPU in float64,
in all three branches (Steffensen-Picard for n < 1 and n > 1, bracket-clamped
Newton with a yield stress, the Newtonian constant): 1e-13 absolute against
the jnp functions and against the Pallas kernel in interpret mode (as
tests/test_power_law.py holds that kernel), the scene state at 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels.collide_stream import make_fused_step as jax_fused_step
from lbm_tpu.kernels.power_law_pallas import power_law_collide_fn as jax_collide_fn
from lbm_tpu.models import power_law as jpl
from lbm_tpu.ops import d2q9 as jd
from lbm_tpu.scenes import channel as jchannel
from lbm_tpu.scenes.ulbm import double_shear_init

from lbm_tpu_torch.kernels import collide_stream, power_law
from lbm_tpu_torch.models import power_law as tpl
from lbm_tpu_torch.ops import d2q9 as td
from lbm_tpu_torch.scenes import channel as tchannel

TOL = 1e-13
# (n, sigma_y): Picard below and above n = 1, Newton, Newtonian
BRANCHES = [(0.5, 0.0), (1.5, 0.0), (0.8, 5e-4), (1.0, 0.0)]


def _sheared_state(R=24, C=32, seed=0):
    """The double-shear equilibrium, each population scaled by a seeded
    1 + U(-3%, 3%): nonzero stress everywhere."""
    m0, u = double_shear_init(R, C, 0.08, dtype=jnp.float64)
    f = np.asarray(jd.equilibrium(u, m0))
    return f * (1.0 + np.random.default_rng(seed).uniform(-0.03, 0.03, f.shape))


def _both(f):
    """(f, feq, rho) for torch and for jnp."""
    ft, fj = torch.as_tensor(f), jnp.asarray(f)
    rt, rj = td.calc_rho(ft), jd.calc_rho(fj)
    return ((ft, td.equilibrium(td.calc_u(ft, rt), rt), rt),
            (fj, jd.equilibrium(jd.calc_u(fj, rj), rj), rj))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


def test_stress_norm_matches_lbm_tpu():
    (ft, et, _), (fj, ej, _) = _both(_sheared_state())
    _close(tpl.nonequilibrium_stress_norm(ft, et), jpl.nonequilibrium_stress_norm(fj, ej))
    assert tpl._SQ32 == jpl._SQ32


@pytest.mark.parametrize("iters", [8, 30])
@pytest.mark.parametrize("n,sigma_y", BRANCHES + [(1.0, 5e-4)])
def test_apparent_tau_matches_lbm_tpu(n, sigma_y, iters):
    (ft, et, rt), (fj, ej, rj) = _both(_sheared_state(seed=1))
    kw = dict(cons_K=0.01, n=n, tau_min=0.52, tau_max=50.0, iters=iters,
              sigma_y=sigma_y, m_pap=2e4)
    _close(tpl.apparent_tau(ft, et, rt, **kw), jpl.apparent_tau(fj, ej, rj, **kw))


def test_apparent_tau_at_equilibrium_sits_on_the_plateau():
    """|Q| = 0 takes the tiny floor: a shear-thinning tau clips to tau_max."""
    (ft, et, rt), _ = _both(_sheared_state(seed=2))
    tau = tpl.apparent_tau(et, et, rt, 0.01, 0.5, 0.52, 50.0)
    assert torch.equal(tau, torch.full_like(tau, 50.0))


@pytest.mark.parametrize("n,sigma_y", BRANCHES)
def test_power_law_collide_matches_lbm_tpu(n, sigma_y):
    (ft, _, rt), (fj, _, rj) = _both(_sheared_state(seed=3))
    kw = dict(cons_K=0.01, n=n, sigma_y=sigma_y)
    _close(tpl.power_law_collide(ft, td.calc_u(ft, rt), rt, **kw),
           jpl.power_law_collide(fj, jd.calc_u(fj, rj), rj, **kw))


@pytest.mark.parametrize("n,sigma_y", BRANCHES)
def test_collide_fn_matches_lbm_tpu(n, sigma_y):
    """The plain fused collision against lbm_tpu's collide_fn applied to the
    same planes, and against the model (up to the paired reassociation)."""
    f = _sheared_state(seed=4)
    args = (0.01, n, 0.52, 50.0, 8)
    got = power_law.power_law_collide_fn(*args, torch.float64, sigma_y)(torch.as_tensor(f))
    _close(got, jax_collide_fn(*args, jnp.float64, sigma_y)(jnp.asarray(f)))
    (ft, _, rt), _ = _both(f)
    _close(got, tpl.power_law_collide(ft, td.calc_u(ft, rt), rt, 0.01, n,
                                      sigma_y=sigma_y), tol=1e-12)


@pytest.mark.parametrize("n,sigma_y", [(0.5, 0.0), (0.8, 5e-4)])
def test_plain_power_law_step_matches_pallas_kernel_f64(n, sigma_y):
    R, C = 32, 128
    f = _sheared_state(R, C, seed=5)
    jstep = jax_fused_step(R, C, jax_collide_fn(0.01, n, 0.52, 50.0, 8, jnp.float64,
                                                sigma_y=sigma_y),
                           dtype=jnp.float64, interpret=True)
    tstep = power_law.make_power_law_fused_step(R, C, cons_K=0.01, n=n, sigma_y=sigma_y,
                                                dtype=torch.float64)
    want, got = jnp.asarray(f), torch.as_tensor(f)
    for _ in range(3):
        want = jstep(want)
        got = tstep(got)
    _close(got, want)


def test_plain_power_law_step_f32_tracks_f64():
    R, C = 32, 32
    f = torch.as_tensor(_sheared_state(R, C, seed=6))
    kw = dict(cons_K=0.01, n=0.5, substeps=4)
    got = power_law.make_power_law_fused_step(R, C, dtype=torch.float32, **kw)(f.float())
    want = power_law.make_power_law_fused_step(R, C, dtype=torch.float64, **kw)(f)
    assert got.dtype == torch.float32
    _close(got.double(), want, tol=2e-6)


def test_power_law_substeps_and_cpu_dispatch():
    R, C = 8, 12
    f = torch.as_tensor(_sheared_state(R, C, seed=7))
    one = power_law.make_power_law_fused_step(R, C, cons_K=0.01, n=0.5, dtype=torch.float64)
    four = power_law.make_power_law_fused_step(R, C, cons_K=0.01, n=0.5,
                                               dtype=torch.float64, substeps=4)
    before = power_law.COLLIDE_STREAM_POWER_LAW.launches
    assert torch.equal(four(f), one(one(one(one(f)))))
    assert power_law.COLLIDE_STREAM_POWER_LAW.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        power_law.collide_stream_power_law(f, 0.01, 0.5)
    with pytest.raises(ValueError, match="step built for"):
        one(f.float())


def test_power_law_constants_round_to_the_dtype():
    c32 = power_law.power_law_constants(0.01, 0.8, 0.52, 50.0, torch.float32, 5e-4, 1e4)
    for k, v in c32.items():
        assert v == float(np.float32(v)), k
    assert c32["sy_mp"] == float(np.float32(5e-4) * np.float32(1e4))
    assert c32["tiny"] == float(np.float32(1e-30))
    c64 = power_law.power_law_constants(0.01, 0.8, 0.52, 50.0, torch.float64)
    assert c64["tiny"] == 1e-250 and c64["log_k"] == float(np.log(0.01))


@pytest.mark.parametrize("kw", [dict(n=0.5), dict(n=1.0, cons_K=0.05, sigma_y=2e-5)])
def test_power_law_channel_matches_lbm_tpu(kw):
    """The scene at a small T through both packages (no kernel in either):
    the same watcher stop step, the state at 1e-12, and the tau field (up to
    tau_max = 50, where exp and log of the two libraries part by an ulp) at
    1e-12 relative."""
    args = dict(H=4, W=41, T=1200, fg=4.2e-5, **kw)
    got = tchannel.power_law_channel(device="cpu", dtype=torch.float64, **args)
    want = jchannel.power_law_channel(dtype=jnp.float64, **args)
    assert got.steps == want.steps
    _close(got.f, want.f, tol=1e-12)
    _close(got.u, want.u, tol=1e-12)
    np.testing.assert_allclose(got.snapshots["tau"], want.snapshots["tau"], rtol=1e-12,
                               atol=0)


def test_analytic_profiles_match_lbm_tpu():
    y = np.arange(41) - 20.0
    np.testing.assert_array_equal(
        tchannel.power_law_analytic_profile(y, 20.5, 0.01, 0.5, 4.2e-5),
        jchannel.power_law_analytic_profile(y, 20.5, 0.01, 0.5, 4.2e-5))
    np.testing.assert_array_equal(
        tchannel.bingham_analytic_profile(y, 20.5, 0.05, 1e-4, 2e-5),
        jchannel.bingham_analytic_profile(y, 20.5, 0.05, 1e-4, 2e-5))
