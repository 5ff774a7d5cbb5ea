"""The Shan-Chen slice of lbm_tpu_torch against lbm_tpu, float64 on the CPU:
models/shan_chen.py, the plain version of CUDA kernel 14
(kernels/shan_chen.py) and the four scenes of scenes/shan_chen.py.

The same numpy-seeded inputs go through both packages.  Tolerances: 1e-13
absolute for the model functions and steps, for the plain step against the
model and against lbm_tpu's Pallas kernel in interpret mode (32x128,
substeps 1 and 2), and for the scenes (summation order only; measured
2e-16 to 3e-16 per step).  sc_phase_separation draws its noise from numpy
where lbm_tpu draws it from jax.random, so its scene test hands both
packages the same numpy field at the step level and holds the scene to its
gate (ROADMAP Queue 3).  On the card, kernel 14 is held to this plain
version (tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels import shan_chen_pallas as jsp
from lbm_tpu.models import shan_chen as jsc
from lbm_tpu.ops import d2q9 as jd
from lbm_tpu.scenes import shan_chen as jscn

from lbm_tpu_torch import run
from lbm_tpu_torch.kernels import shan_chen as tk
from lbm_tpu_torch.models import shan_chen as tsc
from lbm_tpu_torch.ops import d2q9 as td
from lbm_tpu_torch.scenes import shan_chen as tscn

TOL = 1e-13
T_EOS = 0.7 * 0.094330


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


def _noisy_f(R, C, seed, cs=False):
    """lbm_tpu's kernel-test states: the equilibrium at rest of
    0.7 + 0.1 N(0, 1) (exponential EOS) or of the CS coexistence midpoint
    with 0.2 (rho_l - rho_v) N(0, 1) noise."""
    rng = np.random.default_rng(seed)
    if cs:
        rv, rl = jsc.maxwell_coexistence(T_EOS)
        rho = 0.5 * (rv + rl) + 0.2 * (rl - rv) * rng.standard_normal((R, C))
    else:
        rho = 0.7 + 0.1 * rng.standard_normal((R, C))
    return np.asarray(jd.equilibrium(jnp.zeros((2, R, C), jnp.float64), jnp.asarray(rho)))


def test_constants_match_lbm_tpu():
    for name in ("G_CRITICAL", "RHO_CRITICAL", "CS_A", "CS_B", "CS_TC", "CS_RHOC"):
        assert getattr(tsc, name) == getattr(jsc, name)


@functools.cache
def _maxwell():
    return tsc.maxwell_coexistence(T_EOS), jsc.maxwell_coexistence(T_EOS)


def test_maxwell_coexistence_matches_lbm_tpu():
    got, want = _maxwell()
    assert got == want


RHO = np.random.default_rng(5).uniform(0.05, 0.45, (13, 11))
FUNCTIONS = {
    "psi": lambda m, r: m.psi(r),
    "cs_eos_pressure": lambda m, r: m.cs_eos_pressure(r, T_EOS),
    "cs_psi": lambda m, r: m.cs_psi(r, T_EOS),
    "make_psi_cs": lambda m, r: m.make_psi("cs", T_EOS)[0](r),
    "pressure": lambda m, r: m.pressure(r, -5.0),
    "sc_force": lambda m, r: m.sc_force(r, -5.0),
    "sc_force_cs": lambda m, r: m.sc_force(r, -1.0, m.make_psi("cs", T_EOS)[0]),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_shan_chen_function_matches_lbm_tpu(name):
    got = FUNCTIONS[name](tsc, _t(RHO))
    want = FUNCTIONS[name](jsc, jnp.asarray(RHO))
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float64
    _close(got, want)


def test_cs_psi_clamps_like_lbm_tpu():
    """The stiff liquid branch (rho > ~0.47) gives a negative radicand:
    psi = 0 there, and a NaN stays a NaN."""
    rho = np.array([0.3, 0.6, 0.9, np.nan])
    got = tsc.cs_psi(_t(rho), T_EOS).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsc.cs_psi(jnp.asarray(rho), T_EOS)))
    assert got[1] == got[2] == 0.0 and np.isnan(got[3])
    plain = tk.resolve_eos("cs", None, T_EOS, None)[0](_t(rho)).numpy()
    assert plain[1] == plain[2] == 0.0 and np.isnan(plain[3])


@pytest.mark.parametrize("eos,forcing", [("sc", "guo"), ("sc", "shift"), ("cs", "shift"),
                                         ("cs", "guo")])
def test_model_and_plain_step_match_lbm_tpu(eos, forcing):
    """macroscopics, collide and 3 steps of the port's model against
    lbm_tpu's model, and the plain version of kernel 14 against it (24x20)."""
    R, C = 24, 20
    f0 = _noisy_f(R, C, 7, cs=eos == "cs")
    G = -5.0 if eos == "sc" else None
    j_psi, jG, jforcing = jsp.resolve_eos(eos, G, T_EOS, forcing)
    t_psi, tG, tforcing = tk.resolve_eos(eos, G, T_EOS, forcing)
    assert (jG, jforcing) == (tG, tforcing)
    t_model_psi = tsc.make_psi(eos, T_EOS)[0] if eos == "cs" else tsc.psi
    for got, want in zip(tsc.macroscopics(_t(f0), tG, t_model_psi),
                         jsc.macroscopics(jnp.asarray(f0), jG, j_psi)):
        _close(got, want)
    _close(tsc.collide(_t(f0), 1.0, tG, t_model_psi, tforcing),
           jsc.collide(jnp.asarray(f0), 1.0, jG, j_psi, jforcing))
    jstep = jax.jit(lambda x: jsc.step(x, 1.0, jG, j_psi, jforcing))
    want, model, plain = jnp.asarray(f0), _t(f0), _t(f0)
    step = tk.make_sc_fused_step(R, C, omega=1.0, G=G, eos=eos, T=T_EOS, forcing=forcing,
                                 dtype=torch.float64)
    for _ in range(3):
        want, model, plain = jstep(want), tsc.step(model, 1.0, tG, t_model_psi, tforcing), \
            step(plain)
    _close(model, want)
    _close(plain, want)


@pytest.mark.parametrize("substeps", [1, 2])
def test_plain_step_matches_lbm_tpu_pallas(substeps):
    """The plain version of kernel 14 against lbm_tpu's Pallas kernel in
    interpret mode at lbm_tpu's test size (32x128), 2 steps in ``substeps``
    per call (lbm_tpu fuses them in one launch, the port runs one per
    step)."""
    R, C = 32, 128
    f0 = _noisy_f(R, C, 7)
    jstep = jsp.make_sc_fused_step(R, C, omega=1.0, G=-5.0, substeps=substeps,
                                   dtype=jnp.float64, interpret=True)
    tstep = tk.make_sc_fused_step(R, C, omega=1.0, G=-5.0, substeps=substeps,
                                  dtype=torch.float64)
    want, got = jnp.asarray(f0), _t(f0)
    for _ in range(2 // substeps):
        want, got = jstep(want), tstep(got)
    _close(got, want)


def test_factory_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="substeps"):
        tk.make_sc_fused_step(8, 8, omega=1.0, G=-5.0, substeps=0)
    with pytest.raises(ValueError, match="needs the coupling G"):
        tk.make_sc_fused_step(8, 8, omega=1.0)
    with pytest.raises(ValueError, match="temperature"):
        tk.make_sc_fused_step(8, 8, omega=1.0, eos="cs")
    with pytest.raises(ValueError, match="unknown eos"):
        tk.make_sc_fused_step(8, 8, omega=1.0, eos="vdw")
    with pytest.raises(ValueError, match="unknown forcing"):
        tk.make_sc_fused_step(8, 8, omega=1.0, G=-5.0, forcing="he")
    step = tk.make_sc_fused_step(8, 8, omega=1.0, G=-5.0, dtype=torch.float64)
    with pytest.raises(ValueError, match="step built for"):
        step(torch.zeros((9, 8, 8), dtype=torch.float32))
    eos_i, forcing_i, p = tk.kernel_params(1.0, eos="cs", T=T_EOS)
    assert (eos_i, forcing_i, len(p)) == (1, 1, 10) and p[3] == 1.0 and p[8] == T_EOS


def test_flat_interface_scene_matches_lbm_tpu():
    """sc_flat_interface at 32x8 for 40 steps, 4 per call, against lbm_tpu's
    scene on its jnp path (one step per call): 1e-13, and the scalars."""
    got = tscn.sc_flat_interface(H=32, W=8, T=40, substeps=4, device="cpu")
    want = jscn.sc_flat_interface(H=32, W=8, T=40, fused=False, dtype=jnp.float64)
    _close(got.f, want.f)
    _close(got.u, want.u)
    assert got.rho_l == pytest.approx(want.rho_l, abs=TOL)
    assert got.p_jump == pytest.approx(want.p_jump, abs=1e-12)


def test_static_droplet_scene_matches_lbm_tpu():
    got = tscn.sc_static_droplet(H=24, W=24, T=30, radius=6.0, device="cpu")
    want = jscn.sc_static_droplet(H=24, W=24, T=30, radius=6.0, fused=False,
                                  dtype=jnp.float64)
    _close(got.f, want.f)
    assert got.dp == pytest.approx(want.dp, abs=1e-13)


def test_cs_interface_scene_matches_lbm_tpu():
    got = tscn.sc_cs_interface(H=32, W=8, T=30, device="cpu")
    want = jscn.sc_cs_interface(H=32, W=8, T=30, fused=False, dtype=jnp.float64)
    _close(got.f, want.f)
    assert (got.rho_l, got.rho_v) == pytest.approx((want.rho_l, want.rho_v), abs=TOL)


def test_phase_separation_scene_takes_numpy_noise():
    """The scene's noise is numpy's (lbm_tpu's is jax.random's, ROADMAP Queue
    3): the port's scene equals the port's step from that numpy field, and
    lbm_tpu's step from the same field agrees at 1e-13; at G = -5 the fluid
    separates (lbm_tpu's gate, tests/test_shan_chen.py:21-33, at a smaller
    grid and horizon: ratio 15.0 at 32x32 after 800 steps)."""
    H, W, T = 16, 24, 30
    got = tscn.sc_phase_separation(H=H, W=W, T=T, device="cpu")
    rho0 = 0.7 + 0.02 * np.random.default_rng(0).standard_normal((H, W))
    f = np.asarray(jd.equilibrium(jnp.zeros((2, H, W), jnp.float64), jnp.asarray(rho0)))
    step = jax.jit(lambda x: jsc.step(x, 1.0, -5.0))
    want = jnp.asarray(f)
    for _ in range(T):
        want = step(want)
    _close(got.f, want)
    sep = tscn.sc_phase_separation(H=32, W=32, T=800, substeps=4, device="cpu")
    assert sep.rho_l / sep.rho_v > 4.0 and sep.rho_l > 1.5 and sep.rho_v < 0.3


def test_scenes_reject_the_unported_options():
    with pytest.raises(ValueError, match="checkpoint_every must be >= 1"):
        tscn.sc_flat_interface(H=8, W=8, T=1, device="cpu", checkpoint_dir="x",
                               checkpoint_every=0)


def test_cli_runs_sc_flat_interface(tmp_path):
    scenes = run._scenes()
    for name in ("sc_phase_separation", "sc_static_droplet", "sc_flat_interface",
                 "sc_cs_interface"):
        assert scenes[name] is getattr(tscn, name)
    out = str(tmp_path / "flat")
    assert run.main(["sc_flat_interface", "--x64", "--device", "cpu", "--set", "H=16",
                     "--set", "W=4", "--set", "T=8", "--set", "substeps=4", "--out", out]) == 0
    want = tscn.sc_flat_interface(H=16, W=4, T=8, substeps=4, device="cpu")
    np.testing.assert_array_equal(np.load(out + "-f.npy"), want.f.numpy())
    assert td.calc_rho(want.f).shape == (16, 4)
