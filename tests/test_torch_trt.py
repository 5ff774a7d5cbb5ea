"""TRT of lbm_tpu_torch against lbm_tpu: models/trt.py, the periodic TRT step
(CUDA kernel 10's plain version) and the trt_poiseuille scene.

The same numpy-seeded inputs go through both packages on the CPU in float64:
1e-13 absolute against the jnp functions and against the Pallas kernel in
interpret mode (as tests/test_trt.py holds that kernel), the scene state at
1e-12.  Kernel 10 itself is held to the plain version on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels.trt_pallas import make_trt_fused_step as jax_trt_step
from lbm_tpu.models import trt as jtrt
from lbm_tpu.ops import d2q9 as jd
from lbm_tpu.scenes import channel as jchannel

from lbm_tpu_torch.kernels import collide_stream, trt
from lbm_tpu_torch.models import trt as ttrt
from lbm_tpu_torch.ops import d2q9 as td
from lbm_tpu_torch.scenes import channel as tchannel

TOL = 1e-13
OM_P = 1.0 / 0.9  # bench.py's TRT rate
OM_M = jtrt.omega_minus_from_magic(OM_P)


def _state(R, C, seed):
    """An equilibrium at a seeded random flow plus seeded noise (tests/test_trt.py)."""
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.05 * rng.standard_normal((R, C))
    u = 0.05 * rng.standard_normal((2, R, C))
    f = np.asarray(jd.equilibrium(jnp.asarray(u), jnp.asarray(rho)))
    return f + 0.01 * rng.standard_normal(f.shape)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


def _feq(f):
    rho = td.calc_rho(f)
    return td.equilibrium(td.calc_u(f, rho), rho)


def test_trt_collision_matches_lbm_tpu():
    f = _state(16, 24, seed=1)
    ft, fj = torch.as_tensor(f), jnp.asarray(f)
    rj = jd.calc_rho(fj)
    want = jtrt.trt_collision(fj, jd.equilibrium(jd.calc_u(fj, rj), rj), OM_P, OM_M)
    _close(ttrt.trt_collision(ft, _feq(ft), OM_P, OM_M), want)


def test_trt_equal_rates_is_bgk():
    """omega_minus = omega_plus is BGK up to the reassociation, in the model
    and in the fused collision."""
    f = torch.as_tensor(_state(16, 24, seed=3))
    feq = _feq(f)
    want = td.bgk_collision(f, feq, 1.0 / 0.8)
    _close(ttrt.trt_collision(f, feq, 1.0 / 0.8, 1.0 / 0.8), want.numpy(), tol=1e-15)
    _close(trt.trt_collide_fn(1.0 / 0.8, 1.0 / 0.8, torch.float64)(f), want.numpy(),
           tol=1e-15)


@pytest.mark.parametrize("tau_plus", [0.6, 0.933, 1.2, 3.0])
def test_magic_lambda_algebra(tau_plus):
    """omega_minus_from_magic is lbm_tpu's and realises
    Lambda = (t+ - 1/2)(t- - 1/2)."""
    w_m = ttrt.omega_minus_from_magic(1.0 / tau_plus)
    assert w_m == jtrt.omega_minus_from_magic(1.0 / tau_plus)
    assert abs((tau_plus - 0.5) * (1.0 / w_m - 0.5) - ttrt.MAGIC_POISEUILLE) < 1e-14
    assert ttrt.MAGIC_POISEUILLE == jtrt.MAGIC_POISEUILLE
    tau_ref = np.sqrt(3.0 / 16.0) + 0.5  # the reference's tau is the BGK magic point
    assert abs(ttrt.omega_minus_from_magic(1.0 / tau_ref) - 1.0 / tau_ref) < 1e-14


def test_plain_trt_step_matches_pallas_kernel_f64():
    R, C = 32, 128
    f = _state(R, C, seed=11)
    jstep = jax_trt_step(R, C, omega_plus=OM_P, omega_minus=OM_M, dtype=jnp.float64,
                         interpret=True)
    tstep = trt.make_trt_fused_step(R, C, omega_plus=OM_P, omega_minus=OM_M,
                                    dtype=torch.float64)
    want, got = jnp.asarray(f), torch.as_tensor(f)
    for _ in range(3):
        want = jstep(want)
        got = tstep(got)
    _close(got, want)


@pytest.mark.parametrize("shape", [(32, 128), (21, 21), (5, 7)])
def test_plain_trt_step_matches_the_model_f64(shape):
    """make_trt_fused_step (CPU) == trt_collision + stream, 3 steps."""
    R, C = shape
    f = torch.as_tensor(_state(R, C, seed=12))
    step = trt.make_trt_fused_step(R, C, omega_plus=OM_P, omega_minus=OM_M,
                                   dtype=torch.float64)
    got, want = f, f
    for _ in range(3):
        got = step(got)
        want = td.stream(ttrt.trt_collision(want, _feq(want), OM_P, OM_M))
    _close(got, want.numpy())


def test_plain_trt_step_f32_tracks_f64():
    R, C = 32, 32
    f = torch.as_tensor(_state(R, C, seed=13))
    s64 = trt.make_trt_fused_step(R, C, omega_plus=OM_P, omega_minus=OM_M,
                                  dtype=torch.float64, substeps=8)
    s32 = trt.make_trt_fused_step(R, C, omega_plus=OM_P, omega_minus=OM_M,
                                  dtype=torch.float32, substeps=8)
    got = s32(f.float())
    assert got.dtype == torch.float32
    _close(got.double(), s64(f).numpy(), tol=2e-6)


def test_trt_substeps_and_cpu_dispatch():
    R, C = 8, 12
    f = torch.as_tensor(_state(R, C, seed=14))
    one = trt.make_trt_fused_step(R, C, omega_plus=OM_P, omega_minus=OM_M,
                                  dtype=torch.float64)
    four = trt.make_trt_fused_step(R, C, omega_plus=OM_P, omega_minus=OM_M,
                                   dtype=torch.float64, substeps=4)
    before = trt.COLLIDE_STREAM_TRT.launches
    assert torch.equal(four(f), one(one(one(one(f)))))
    assert trt.COLLIDE_STREAM_TRT.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        trt.collide_stream_trt(f, OM_P, OM_M)
    with pytest.raises(ValueError, match="step built for"):
        one(f.float())
    with pytest.raises(ValueError, match="substeps"):
        collide_stream.make_fused_step(R, C, trt.trt_collide_fn(OM_P, OM_M, torch.float64),
                                       torch.float64, substeps=9)


def test_trt_poiseuille_matches_lbm_tpu():
    """The reference's L2 <= 1e-11 gate under TRT at tau = 1.2 through the
    port's slice on the CPU: the same step count as lbm_tpu's jnp scene and
    the same final state at 1e-12."""
    got = tchannel.trt_poiseuille(device="cpu", dtype=torch.float64)
    want = jchannel.trt_poiseuille(dtype=jnp.float64, fused=False)
    assert got.l2 <= 1e-11, got.l2
    assert got.steps == want.steps
    _close(got.f, want.f, tol=1e-12)
    _close(got.u, want.u, tol=1e-12)
