"""The KBC (ULBM) family of lbm_tpu_torch against lbm_tpu: models/kbc.py,
the periodic KBC step (CUDA kernel 3's plain version) and the KBC channel
step (kernel 4's plain version).

The same numpy-seeded inputs go through both packages on the CPU.  States
are off equilibrium (an equilibrium at a seeded flow, each population
scaled by 1 + U(-0.03, 0.03)): at equilibrium the gamma ratio is 0/0 and
only its regulariser speaks.  Tolerances: float64 1e-13 absolute against
the jnp functions (the two differ at most by summation order); float32
against the Pallas kernels in interpret mode as in tests/test_kbc_pallas.py
and tests/test_pallas.py (rtol 5e-4, atol 5e-6).  The kernels themselves
are held to the plain versions on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.boundary import bc as jbc
from lbm_tpu.kernels import collide_stream as jcs
from lbm_tpu.kernels.channel_pallas import make_channel_fused_step as jax_channel_step
from lbm_tpu.models import kbc as jk
from lbm_tpu.ops import d2q9 as jd

from lbm_tpu_torch.kernels import channel, collide_stream
from lbm_tpu_torch.models import kbc as tk

TOL = 1e-13
S2 = 1.0 / 0.8  # bench.py's relaxation
RHO_IN, RHO_OUT = 1.001, 1.0


def _noisy_state(R, C, seed=0):
    """Off-equilibrium populations (9, R, C) in float64."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.05, 0.05, (2, R, C))
    rho = 1.0 + rng.uniform(-0.01, 0.01, (R, C))
    f = np.asarray(jk.equilibrium(jnp.asarray(rho), jnp.asarray(u)))
    return f * (1.0 + rng.uniform(-0.03, 0.03, f.shape))


def _moments(f):
    m0 = f.sum(0)
    mx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8]
    my = f[2] - f[4] + f[5] + f[6] - f[7] - f[8]
    return m0, np.stack([mx / m0, my / m0])


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


KBC_FUNCTIONS = {
    "central_moments": lambda m, f, m0, u: m.central_moments(f, u),
    "delta_s": lambda m, f, m0, u: m.delta_s(m.central_moments(f, u), u, m0),
    "delta_h": lambda m, f, m0, u: m.delta_h(m.central_moments(f, u), u, m0),
    "eq_factors": lambda m, f, m0, u: m._eq_factors(u),
    "equilibrium": lambda m, f, m0, u: m.equilibrium(m0, u),
    "gamma": lambda m, f, m0, u: m.gamma(m.central_moments(f, u), u, m0, S2),
    "gamma_factored": lambda m, f, m0, u: m.gamma_factored(
        m.central_moments(f, u), u, m0, S2),
    "collide_factored": lambda m, f, m0, u: m.collide(f, m0, u, S2, "factored"),
    "collide_direct": lambda m, f, m0, u: m.collide(f, m0, u, S2, "direct"),
    "model_collide": lambda m, f, m0, u: m.KBCModel(s2=S2).collide(f, m0, u),
    "model_macroscopics_u": lambda m, f, m0, u: m.KBCModel(s2=S2).macroscopics(f)[1],
}


@pytest.mark.parametrize("name", sorted(KBC_FUNCTIONS))
def test_kbc_function_matches_lbm_tpu(name):
    f = _noisy_state(12, 10, seed=1)
    m0, u = _moments(f)
    t = [torch.as_tensor(a) for a in (f, m0, u)]
    j = [jnp.asarray(a) for a in (f, m0, u)]
    got = KBC_FUNCTIONS[name](tk, *t)
    want = KBC_FUNCTIONS[name](jk, *j)
    assert got.dtype == torch.float64 and tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_gamma_impls_agree_and_stay_in_the_window():
    f = torch.as_tensor(_noisy_state(16, 16, seed=2))
    m0, u = (torch.as_tensor(a) for a in _moments(f.numpy()))
    cT = tk.central_moments(f, u)
    direct = tk.gamma(cT, u, m0, S2)
    factored = tk.gamma_factored(cT, u, m0, S2)
    _close(factored, direct.numpy())
    assert float(direct.min()) >= 0.0 and float(direct.max()) <= 2.0 / S2
    np.testing.assert_array_equal(tk.INV_M, jk.INV_M)
    assert (tk.CS2, tk.CS4) == (jk.CS2, jk.CS4)


def test_gamma_clip_keeps_nan_and_eps_follows_dtype():
    """A NaN cell stays NaN through the clip (as jnp.clip); eps is lbm_tpu's
    per dtype; at an equilibrium state (num/den at round-off) gamma stays in
    its window [0, 2/s2], in the state's dtype."""
    f = torch.as_tensor(_noisy_state(4, 5, seed=3))
    f[:, 1, 2] = float("nan")
    m0, u = tk.KBCModel(s2=S2).macroscopics(f)
    g = tk.gamma_factored(tk.central_moments(f, u), u, m0, S2)
    assert torch.isnan(g[1, 2]) and torch.isfinite(g[0]).all()
    assert tk._eps(g.float()) == 1e-28 and tk._eps(g) == 1e-200
    for dtype in (torch.float32, torch.float64):
        m0 = torch.ones((3, 4), dtype=dtype)
        u = torch.zeros((2, 3, 4), dtype=dtype)
        feq = tk.equilibrium(m0, u)
        for gamma in (tk.gamma(tk.central_moments(feq, u), u, m0, S2),
                      tk.gamma_factored(tk.central_moments(feq, u), u, m0, S2)):
            assert gamma.dtype == dtype
            assert float(gamma.min()) >= 0.0 and float(gamma.max()) <= 2.0 / S2


def test_collide_rejects_unknown_gamma_impl():
    f = torch.as_tensor(_noisy_state(4, 4))
    m0, u = tk.KBCModel(s2=S2).macroscopics(f)
    with pytest.raises(ValueError, match="gamma_impl"):
        tk.collide(f, m0, u, S2, "exact")
    with pytest.raises(ValueError, match="gamma_impl"):
        collide_stream.make_kbc_fused_step(4, 4, S2, torch.float64, gamma_impl="x")


@pytest.mark.parametrize("gamma_impl", ["factored", "direct"])
def test_plain_kbc_step_matches_pallas_kernel_f32(gamma_impl):
    R, C = 16, 128
    f = _noisy_state(R, C, seed=4).astype(np.float32)
    want = jcs.make_kbc_fused_step(R, C, S2, jnp.float32, block_rows=8,
                                   interpret=True, gamma_impl=gamma_impl)(jnp.asarray(f))
    got = collide_stream.make_kbc_fused_step(R, C, S2, torch.float32,
                                             gamma_impl=gamma_impl)(torch.as_tensor(f))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-6)


def _jnp_kbc_step(f, gamma_impl):
    m0 = jd.calc_rho(f)
    return jd.stream(jk.collide(f, m0, jd.calc_u(f, m0), S2, gamma_impl))


@pytest.mark.parametrize("gamma_impl", ["factored", "direct"])
@pytest.mark.parametrize("shape", [(16, 128), (21, 21), (7, 5)])
def test_plain_kbc_step_matches_jnp_oracle_f64(shape, gamma_impl):
    R, C = shape
    f = _noisy_state(R, C, seed=5)
    step = collide_stream.make_kbc_fused_step(R, C, S2, torch.float64,
                                              gamma_impl=gamma_impl)
    want, got = jnp.asarray(f), torch.as_tensor(f)
    for _ in range(3):
        want = _jnp_kbc_step(want, gamma_impl)
        got = step(got)
    _close(got, want)


def test_kbc_substeps_equal_repeated_single_steps():
    R, C = 12, 10
    f = torch.as_tensor(_noisy_state(R, C, seed=6))
    one = collide_stream.make_kbc_fused_step(R, C, S2, torch.float64)
    three = collide_stream.make_kbc_fused_step(R, C, S2, torch.float64, substeps=3)
    want = f
    for _ in range(3):
        want = one(want)
    assert torch.equal(three(f), want)


def test_cpu_state_never_reaches_kernels_3_and_4():
    f = torch.as_tensor(_noisy_state(6, 5, seed=7))
    k3, k4 = collide_stream.COLLIDE_STREAM_KBC, channel.CHANNEL_KBC
    before = (k3.launches, k4.launches)
    collide_stream.make_kbc_fused_step(6, 5, S2, torch.float64, substeps=2)(f)
    channel.make_channel_fused_step(6, 5, S2, RHO_IN, RHO_OUT, torch.float64,
                                    family="kbc")(f)
    assert (k3.launches, k4.launches) == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        collide_stream.collide_stream_kbc(f, S2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        channel.channel_kbc(f, S2, RHO_IN, RHO_OUT)


def _jnp_kbc_channel_step(g):
    """The jnp step of lbm_tpu/scenes/ulbm.py:117-130, as
    tests/test_pallas.py::test_kbc_channel_fused_matches_model writes it."""
    m = jd.calc_rho(g)
    v = jd.calc_u(g, m)
    fc = jk.collide(g, m, v, S2)
    fe = jk.equilibrium(m, v)
    fc = jbc.pressure_periodic(fc, fe, v, RHO_IN, RHO_OUT, axis=0,
                               eq_fn=jd.incomp_equilibrium)
    fn = jd.stream(fc)
    fn = jbc.bounce_back(fn, fc, "colN")
    return jbc.bounce_back(fn, fc, "col0")


def test_plain_kbc_channel_matches_pallas_kernel_f32():
    R, C = 24, 128
    f = _noisy_state(R, C, seed=8).astype(np.float32)
    jstep = jax_channel_step(R, C, S2, RHO_IN, RHO_OUT, dtype=jnp.float32,
                             block_rows=8, interpret=True, family="kbc")
    tstep = channel.make_channel_fused_step(R, C, S2, RHO_IN, RHO_OUT,
                                            torch.float32, family="kbc")
    want, got = jnp.asarray(f), torch.as_tensor(f)
    for _ in range(3):
        want = jstep(want)
        got = tstep(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-6)


@pytest.mark.parametrize("shape", [(24, 128), (21, 21), (4, 2)])
def test_plain_kbc_channel_matches_jnp_step_f64(shape):
    R, C = shape
    f = _noisy_state(R, C, seed=9)
    tstep = channel.make_channel_fused_step(R, C, S2, RHO_IN, RHO_OUT,
                                            torch.float64, family="kbc")
    want, got = jnp.asarray(f), torch.as_tensor(f)
    for _ in range(4):
        want = _jnp_kbc_channel_step(want)
        got = tstep(got)
    _close(got, want)


def test_channel_family_is_checked():
    with pytest.raises(ValueError, match="family"):
        channel.make_channel_fused_step(8, 8, S2, RHO_IN, RHO_OUT,
                                        torch.float64, family="mrt")
    with pytest.raises(ValueError, match="R >= 4 and C >= 2"):
        channel.make_channel_fused_step(3, 8, S2, RHO_IN, RHO_OUT,
                                        torch.float64, family="kbc")
