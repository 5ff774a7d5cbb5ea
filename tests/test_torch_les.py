"""Smagorinsky LES of lbm_tpu_torch against lbm_tpu: models/les.py and the
periodic LES step (CUDA kernel 5's plain version).

The same numpy-seeded inputs go through both packages on the CPU in float64:
1e-13 absolute against the jnp functions and against the Pallas kernel in
interpret mode (as tests/test_les.py holds that kernel to the jnp oracle).
Kernel 5 itself is held to the plain version on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels.les_pallas import make_les_fused_step as jax_les_step
from lbm_tpu.models import les as jles
from lbm_tpu.ops import d2q9 as jd

from lbm_tpu_torch.kernels import bgk, les
from lbm_tpu_torch.models import les as tles
from lbm_tpu_torch.ops import d2q9 as td

TOL = 1e-13
TAU0, CS = 0.5 + 3e-4, 0.17  # bench.py's LES constants


def _noisy_state(R, C, seed=0, u_amp=0.1):
    """A sheared equilibrium with each population scaled by 1 + U(-3%, 3%):
    nonzero stress everywhere."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-u_amp, u_amp, (2, R, C))
    rho = 1.0 + rng.uniform(-0.01, 0.01, (R, C))
    f = np.asarray(jd.equilibrium(jnp.asarray(u), jnp.asarray(rho)))
    return f * (1.0 + rng.uniform(-0.03, 0.03, f.shape))


def _jnp_les_step(tau0, cs):
    def step(f):
        rho = jd.calc_rho(f)
        return jd.stream(jles.les_collide(f, jd.calc_u(f, rho), rho, tau0, cs))
    return step


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("cs", [0.0, CS])
def test_les_model_matches_lbm_tpu(cs):
    f = _noisy_state(12, 10, seed=1)
    rho = f.sum(0)
    ft, fj = torch.as_tensor(f), jnp.asarray(f)
    ut, uj = td.calc_u(ft, td.calc_rho(ft)), jd.calc_u(fj, jd.calc_rho(fj))
    rt, rj = torch.as_tensor(rho), jnp.asarray(rho)
    feq_t, feq_j = td.equilibrium(ut, rt), jd.equilibrium(uj, rj)
    _close(tles.smagorinsky_tau(ft, feq_t, rt, TAU0, cs),
           jles.smagorinsky_tau(fj, feq_j, rj, TAU0, cs))
    _close(tles.les_collide(ft, ut, rt, TAU0, cs), jles.les_collide(fj, uj, rj, TAU0, cs))


def test_cs_zero_is_bgk():
    """Cs = 0 reduces exactly to BGK in the model, and to BGK up to the
    reassociation of the paired form in the fused collision."""
    f = torch.as_tensor(_noisy_state(10, 9, seed=2))
    rho = td.calc_rho(f)
    u = td.calc_u(f, rho)
    feq = td.equilibrium(u, rho)
    want = td.bgk_collision(f, feq, 1.0 / TAU0)
    assert torch.equal(tles.les_collide(f, u, rho, TAU0, 0.0), want)
    _close(les.les_collide_fn(TAU0, 0.0, torch.float64)(f), want.numpy(), tol=1e-15)
    _close(les.les_collide_fn(TAU0, 0.0, torch.float64)(f),
           bgk.bgk_collide_fn(1.0 / TAU0, torch.float64)(f).numpy(), tol=1e-15)


def test_plain_les_step_matches_pallas_kernel_f64():
    R, C = 16, 128
    f = _noisy_state(R, C, seed=3)
    jstep = jax_les_step(R, C, tau0=TAU0, cs_smag=CS, dtype=jnp.float64,
                         block_rows=8, interpret=True)
    tstep = les.make_les_fused_step(R, C, tau0=TAU0, cs_smag=CS, dtype=torch.float64)
    want, got = jnp.asarray(f), torch.as_tensor(f)
    for _ in range(4):
        want = jstep(want)
        got = tstep(got)
    _close(got, want)


@pytest.mark.parametrize("shape", [(16, 128), (21, 21), (7, 5)])
def test_plain_les_step_matches_jnp_oracle_f64(shape):
    R, C = shape
    f = _noisy_state(R, C, seed=4)
    step = les.make_les_fused_step(R, C, tau0=TAU0, cs_smag=CS, dtype=torch.float64)
    oracle = _jnp_les_step(TAU0, CS)
    want, got = jnp.asarray(f), torch.as_tensor(f)
    for _ in range(3):
        want = oracle(want)
        got = step(got)
    _close(got, want)


def test_plain_les_step_f32_tracks_f64():
    """The float32 plain step keeps the constants' float32 rounding and
    stays within 2e-6 of float64 over 8 substeps."""
    R, C = 32, 32
    f = torch.as_tensor(_noisy_state(R, C, seed=5))
    s64 = les.make_les_fused_step(R, C, tau0=TAU0, cs_smag=CS, dtype=torch.float64,
                                  substeps=8)
    s32 = les.make_les_fused_step(R, C, tau0=TAU0, cs_smag=CS, dtype=torch.float32,
                                  substeps=8)
    got = s32(f.float())
    assert got.dtype == torch.float32
    _close(got.double(), s64(f).numpy(), tol=2e-6)


def test_les_substeps_and_cpu_dispatch():
    R, C = 8, 12
    f = torch.as_tensor(_noisy_state(R, C, seed=6))
    one = les.make_les_fused_step(R, C, tau0=TAU0, cs_smag=CS, dtype=torch.float64)
    four = les.make_les_fused_step(R, C, tau0=TAU0, cs_smag=CS, dtype=torch.float64,
                                   substeps=4)
    before = les.COLLIDE_STREAM_LES.launches
    want = f
    for _ in range(4):
        want = one(want)
    assert torch.equal(four(f), want)
    assert les.COLLIDE_STREAM_LES.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        les.collide_stream_les(f, TAU0, CS)
    with pytest.raises(ValueError, match="step built for"):
        one(f.float())
