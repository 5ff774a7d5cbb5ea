"""The channel step and the horizontal-Poiseuille slice of lbm_tpu_torch
against lbm_tpu.

On the CPU the step takes the plain model step (pressure-periodic rows +
bounce-back columns), held to the Pallas channel kernel in interpret mode
(float32, the tolerances of tests/test_pallas.py) and to the jnp
SinglePhaseModel step (float64, 1e-13).  The whole slice, the reference's
L2 <= 1e-11 gate, runs through both packages.  Kernel 2 itself is held to
the plain version on the card by tests/test_torch_cuda.py.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.boundary import bc as jbc
from lbm_tpu.kernels.channel_pallas import make_channel_fused_step as jax_channel_step
from lbm_tpu.models.single_phase import SinglePhaseModel as JaxModel
from lbm_tpu.ops import d2q9 as jd
from lbm_tpu.scenes import channel as jchannel

from lbm_tpu_torch.kernels import channel
from lbm_tpu_torch.scenes import channel as tchannel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OMEGA, RHO_IN, RHO_OUT = 1.0 / 0.9, 1.02, 1.0


def _developed_state(R, C, seed=0):
    """An incompressible equilibrium at a seeded random flow: every
    population differs, so a wrong index shows."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.05, 0.05, (2, R, C))
    rho = 1.0 + rng.uniform(-0.01, 0.01, (R, C))
    return np.array(jd.incomp_equilibrium(jnp.asarray(u), jnp.asarray(rho)))


def _jax_model():
    return JaxModel(
        omega=OMEGA, incompressible=True,
        pre_stream_bcs=(lambda fc, fe, u, rho: jbc.pressure_periodic(
            fc, fe, u, RHO_IN, RHO_OUT, axis=0, eq_fn=jd.incomp_equilibrium),),
        post_stream_bcs=(lambda fa, fc: jbc.bounce_back(fa, fc, "colN"),
                         lambda fa, fc: jbc.bounce_back(fa, fc, "col0")))


def test_plain_step_matches_pallas_kernel_f32():
    R, C = 24, 128
    f = _developed_state(R, C).astype(np.float32)
    jstep = jax_channel_step(R, C, OMEGA, RHO_IN, RHO_OUT, dtype=jnp.float32,
                             block_rows=8, interpret=True)
    tstep = channel.make_channel_fused_step(R, C, OMEGA, RHO_IN, RHO_OUT,
                                            torch.float32)
    want, got = jnp.asarray(f), torch.as_tensor(f)
    for _ in range(4):
        want = jstep(want)
        got = tstep(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-7)


@pytest.mark.parametrize("shape", [(24, 128), (21, 21), (4, 2)])
def test_plain_step_matches_jnp_model_f64(shape):
    R, C = shape
    f = _developed_state(R, C, seed=1)
    model = _jax_model()
    tstep = channel.make_channel_fused_step(R, C, OMEGA, RHO_IN, RHO_OUT,
                                            torch.float64)
    want, got = jnp.asarray(f), torch.as_tensor(f)
    for _ in range(4):
        want = model.step(want)
        got = tstep(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-13)


@pytest.mark.parametrize("shape", [(3, 8), (8, 1)])
def test_channel_step_rejects_small_grids(shape):
    with pytest.raises(ValueError, match="R >= 4 and C >= 2"):
        channel.make_channel_fused_step(*shape, OMEGA, RHO_IN, RHO_OUT,
                                        torch.float64)


def test_horizontal_poiseuille_slice_matches_lbm_tpu():
    """The reference's hard gate through the port's whole slice on the CPU:
    L2 <= 1e-11 (test/horizontal_poiseuille_test.cpp:175), the same step
    count as lbm_tpu and the same final state at 1e-12."""
    before = channel.CHANNEL_BGK.launches
    got = tchannel.horizontal_poiseuille(device="cpu", dtype=torch.float64)
    want = jchannel.horizontal_poiseuille(dtype=jnp.float64)
    assert channel.CHANNEL_BGK.launches == before  # CPU state: plain path
    assert got.l2 <= 1e-11, got.l2
    assert got.steps == want.steps
    np.testing.assert_allclose(got.f.numpy(), np.asarray(want.f), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), rtol=0, atol=1e-12)


def test_poiseuille_metric_matches_lbm_tpu():
    u = np.random.default_rng(2).uniform(0.0, 0.1, (9, 13))
    np.testing.assert_array_equal(tchannel.poiseuille_analytic(13, 0.1),
                                  jchannel.poiseuille_analytic(13, 0.1))
    assert tchannel.poiseuille_l2(u, 0.1) == jchannel.poiseuille_l2(u, 0.1)


def test_cli_runner_end_to_end(tmp_path):
    """The CLI surface: a tiny float64 Poiseuille run on the CPU writing
    .npy outputs that equal lbm_tpu's run of the same scene."""
    out = str(tmp_path / "hp")
    r = subprocess.run(
        [sys.executable, "-m", "lbm_tpu_torch.run", "horizontal_poiseuille",
         "--x64", "--device", "cpu", "--set", "T=50", "--set", "H=11",
         "--set", "W=11", "--out", out],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    u = np.load(out + "-u.npy")
    assert u.shape == (2, 11, 11) and u.dtype == np.float64
    want = jchannel.horizontal_poiseuille(H=11, W=11, T=50, dtype=jnp.float64)
    np.testing.assert_allclose(u, np.asarray(want.u), rtol=0, atol=1e-13)
    assert "steps=50" in r.stderr


def test_cpu_state_never_reaches_the_kernel():
    f = torch.as_tensor(_developed_state(6, 5, seed=4))
    before = channel.CHANNEL_BGK.launches
    channel.make_channel_fused_step(6, 5, OMEGA, RHO_IN, RHO_OUT, torch.float64)(f)
    assert channel.CHANNEL_BGK.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        channel.channel_bgk(f, OMEGA, RHO_IN, RHO_OUT)
