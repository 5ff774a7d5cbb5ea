"""The MRT-CSF droplet slice of lbm_tpu_torch against lbm_tpu, float64 on the
CPU: models/mrt_csf_droplet.py, the plain version of CUDA kernel 13
(kernels/csf_droplet.py) and the scene csf_static_droplet.

The same numpy-seeded inputs go through both packages.  Tolerances: 1e-13
absolute for the model functions, the model step, the plain step against
the model and against lbm_tpu's Pallas kernel in interpret mode (32x128, 2
steps), and the scene (summation order only; measured 1.5e-16 to 2.4e-16).
The thresholded normal (|grad psi| >= 0.1) keeps this formulation
well-conditioned: unlike the MRT-CG CSF mode, it has no round-off
direction where grad(psi) vanishes (lbm_tpu tests/test_mrtcg_pallas.py
:105-109), and a droplet centred on a grid node (L = 24) agrees at 1e-13
too.  On the card, kernel 13 is held to this plain version
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels import csf_droplet_pallas as jcp
from lbm_tpu.models import mrt_csf_droplet as jcm
from lbm_tpu.scenes import multiphase as jscn

from lbm_tpu_torch import run
from lbm_tpu_torch.io import convert
from lbm_tpu_torch.kernels import csf_droplet as tk
from lbm_tpu_torch.models import mrt_csf_droplet as tcm
from lbm_tpu_torch.scenes import multiphase as tscn

TOL = 1e-13
# lbm_tpu's kernel-test colours (tests/test_mrtcg_pallas.py:116-117) and the
# scene's (static_droplet_test.cpp:476-486)
TEST_RED = dict(rho_0=1.0, alpha=0.92, nu=0.1667, A=1.0, beta=0.7)
TEST_BLUE = dict(rho_0=1.0, alpha=0.2, nu=0.1667, A=1.0, beta=0.7)
SCENE_RED = dict(rho_0=1.0, alpha=0.2, nu=0.1667, A=0.5, beta=0.7)
SCENE_BLUE = dict(rho_0=1.0, alpha=0.2, nu=0.1667, A=0.5, beta=-0.7)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


def test_colour_constants_match_lbm_tpu():
    t, j = tcm.CSFColour(**TEST_RED), jcm.CSFColour(**TEST_RED)
    assert (t.cs2, t.tau, t.omega) == (j.cs2, j.tau, j.omega)
    np.testing.assert_array_equal(t.phi(), j.phi())
    np.testing.assert_array_equal(t.equ_factor(), j.equ_factor())
    assert convert.csf_colour(j) == t
    tm = tcm.CSFDropletModel(t, tcm.CSFColour(**TEST_BLUE))
    jm = jcm.CSFDropletModel(j, jcm.CSFColour(**TEST_BLUE))
    assert tm.relax().__dict__ == jm.relax().__dict__


def _fields(R=13, C=11, seed=0):
    rng = np.random.default_rng(seed)
    return {"rho": rng.uniform(0.2, 1.0, (R, C)), "u": rng.uniform(-0.05, 0.05, (2, R, C)),
            "fs": rng.uniform(-1e-3, 1e-3, (2, R, C))}


FUNCTIONS = {
    "csf_equilibrium": lambda m, a: m.csf_equilibrium(
        a["rho"], a["u"], m.CSFColour(**TEST_RED).phi(), m.CSFColour(**TEST_RED).equ_factor()),
    "m_eq": lambda m, a: m.m_eq(a["rho"], a["u"], 0.92),
    "force_moments": lambda m, a: m.force_moments(a["u"], a["fs"]),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_csf_function_matches_lbm_tpu(name):
    fields = _fields()
    got = FUNCTIONS[name](tcm, {k: _t(v) for k, v in fields.items()})
    want = FUNCTIONS[name](jcm, {k: jnp.asarray(v) for k, v in fields.items()})
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float64
    _close(got, want)


def _models(red, blue):
    return (tcm.CSFDropletModel(tcm.CSFColour(**red), tcm.CSFColour(**blue), 0.1, 0.1),
            jcm.CSFDropletModel(jcm.CSFColour(**red), jcm.CSFColour(**blue), 0.1, 0.1))


def _packed(st):
    R, C = st.red.rho.shape
    return np.concatenate([np.asarray(st.red.f), np.asarray(st.blue.f), np.zeros((2, R, C))])


def test_model_and_plain_step_match_lbm_tpu():
    """init_state and 3 model steps against lbm_tpu's model (jitted), and the
    plain version of kernel 13 against the same model states (lbm_tpu's
    kernel-test colours, radius 6 in 24x20)."""
    R, C = 24, 20
    tm, jm = _models(TEST_RED, TEST_BLUE)
    r0 = tscn.init_rho_droplet(R, C, 1.0, True, 6.0)
    b0 = tscn.init_rho_droplet(R, C, 1.0, False, 6.0)
    ts = tm.init_state(r0, b0, dtype=torch.float64, device="cpu")
    js = jm.init_state(r0, b0, dtype=jnp.float64)
    _close(ts.red.f, js.red.f)
    S = _t(_packed(js))
    step = tk.make_csf_droplet_fused_step(R, C, tm.red, tm.blue, 0.1, dtype=torch.float64)
    jstep = jax.jit(jm.step)
    for _ in range(3):
        ts, js, S = tm.step(ts), jstep(js), step(S)
    for got, want in ((ts.red.f, js.red.f), (ts.blue.f, js.blue.f), (ts.blue.rho, js.blue.rho),
                      (ts.u, js.u), (S[:9], js.red.f), (S[9:18], js.blue.f)):
        _close(got, want)
    # the carried force gives the model's velocity: u = calc_u + 0.5 fs / rho
    rho = S[:9].sum(0) + S[9:18].sum(0)
    mom = S[[1, 5, 8]].sum(0) - S[[3, 6, 7]].sum(0) + S[[10, 14, 17]].sum(0) - \
        S[[12, 15, 16]].sum(0)
    _close(mom / rho + 0.5 * S[18] / rho, js.u[0])


def test_plain_step_matches_lbm_tpu_pallas():
    """The plain version of kernel 13 against lbm_tpu's Pallas kernel in
    interpret mode (32x128, block_rows 8, 2 steps, radius 8)."""
    R, C = 32, 128
    _, jm = _models(TEST_RED, TEST_BLUE)
    js = jm.init_state(jscn.init_rho_droplet(R, C, 1.0, True, 8.0),
                       jscn.init_rho_droplet(R, C, 1.0, False, 8.0), dtype=jnp.float64)
    S = _packed(js)
    jstep = jcp.make_csf_droplet_fused_step(R, C, jm.red, jm.blue, 0.1, dtype=jnp.float64,
                                            block_rows=8, interpret=True)
    tstep = tk.make_csf_droplet_fused_step(R, C, tcm.CSFColour(**TEST_RED),
                                           tcm.CSFColour(**TEST_BLUE), 0.1,
                                           dtype=torch.float64)
    want, got = jnp.asarray(S), _t(S)
    for _ in range(2):
        want, got = jstep(want), tstep(got)
    _close(got, want)


def test_threshold_edges_and_stencils_wrap_apart():
    """On a grid whose edges cut the droplet (centre off the grid's middle
    column, 20x14), the stencils replicate at the edges while the stream
    wraps: the plain step equals the model there (1e-13) after 2 steps."""
    R, C = 20, 14
    tm, _ = _models(SCENE_RED, SCENE_BLUE)
    r0 = tscn.init_rho_droplet(R, C, 1.0, True, 5.0, 2.0)
    b0 = tscn.init_rho_droplet(R, C, 1.0, False, 5.0, 2.0)
    ts = tm.init_state(r0, b0, dtype=torch.float64, device="cpu")
    S = torch.cat([ts.red.f, ts.blue.f, torch.zeros((2, R, C), dtype=torch.float64)])
    assert float(ts.red.rho[:, -1].max()) > 0.1  # the droplet crosses the last column
    step = tk.make_csf_droplet_fused_step(R, C, tm.red, tm.blue, 0.1, dtype=torch.float64,
                                          substeps=2)
    S = step(S)
    for _ in range(2):
        ts = tm.step(ts)
    _close(S[:9], ts.red.f)
    _close(S[9:18], ts.blue.f)


def test_kernel_params_and_rejections():
    red, blue = tcm.CSFColour(**SCENE_RED), tcm.CSFColour(**SCENE_BLUE)
    p = tk.kernel_params(red, blue, 0.1)
    assert len(p) == 23 and all(isinstance(v, float) for v in p)
    assert p[10] == 0.05 and p[11:17] == (-3.6 * 0.2 - 0.4, 5.4 * 0.2 - 1.4, -1.8 * 0.2 - 0.2,
                                          1.8 * 0.2 - 0.8, 0.5 * (1.0 - 0.5 * red.omega), 0.7)
    assert p[22] == -0.7
    step = tk.make_csf_droplet_fused_step(6, 5, red, blue, 0.1, dtype=torch.float64)
    with pytest.raises(ValueError, match="step built for"):
        step(torch.zeros((18, 6, 5), dtype=torch.float64))
    with pytest.raises(ValueError, match="step built for"):
        step(torch.zeros((20, 6, 5), dtype=torch.float32))


def test_static_droplet_scene_matches_lbm_tpu():
    """csf_static_droplet at 24x24 (centre on a node) for 20 steps against
    lbm_tpu's scene on its jnp path: 1e-13 (measured 2.4e-16); frames
    before each chunk; the per-colour masses exactly kept (1e-12)."""
    got = tscn.csf_static_droplet(L=24, T=20, radius=6.0, snapshot_every=10, device="cpu")
    want = jscn.csf_static_droplet(L=24, T=20, radius=6.0, snapshot_every=10, fused=False,
                                   dtype=jnp.float64)
    for g, w in ((got.state.red.f, want.state.red.f), (got.state.blue.f, want.state.blue.f),
                 (got.state.u, want.state.u)):
        _close(g, w)
    assert got.snapshots["rho"].shape == (2, 24, 24)
    np.testing.assert_allclose(got.snapshots["psi"], want.snapshots["psi"], rtol=0, atol=TOL)
    r0 = tscn.init_rho_droplet(24, 24, 1.0, True, 6.0, 2.0).sum()
    assert float(got.state.red.rho.sum()) == pytest.approx(r0, rel=1e-12)


def test_csf_droplet_state_conversion_and_cli(tmp_path):
    S = np.random.default_rng(4).uniform(0, 1, (20, 5, 4))
    t = convert.csf_droplet_state_from_numpy(S, device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(convert.state_to_numpy(t), S)
    with pytest.raises(ValueError, match="CSF droplet"):
        convert.csf_droplet_state_from_numpy(S[:18], device="cpu", dtype=torch.float64)
    assert run._scenes()["csf_static_droplet"] is tscn.csf_static_droplet
    out = str(tmp_path / "csf")
    assert run.main(["csf_static_droplet", "--x64", "--device", "cpu", "--set", "L=12",
                     "--set", "T=3", "--set", "radius=3.0", "--out", out]) == 0
    want = tscn.csf_static_droplet(L=12, T=3, radius=3.0, device="cpu")
    np.testing.assert_array_equal(np.load(out + "-state-red-f.npy"), want.state.red.f.numpy())
    np.testing.assert_array_equal(np.load(out + "-state-u.npy"), want.state.u.numpy())
