"""The thermal scenes of lbm_tpu_torch against lbm_tpu: the plain versions of
CUDA kernels 23 and 24 (kernels/thermal.py) in both scalar lattices, the
scene helpers, rayleigh_benard and heated_cavity with their series and
snapshots, substeps, the input checks and the CLIs.

The plain steps are held to lbm_tpu's Pallas kernels (interpret mode) and to
its jnp steps at 1e-13 in float64, the scenes to lbm_tpu's jnp scenes at
1e-12 (f, g, theta, u, Nu and the series).  The D2Q5 collision follows the
Pallas kernel's even/odd pairing, lbm_tpu's jnp step its d2q5_equilibrium:
the two differ by rounding only.  The Nusselt and onset physics run on the
card (chip_smoke.py); kernels 23 and 24 are held to the plain versions on the
card by tests/test_torch_cuda.py.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.core import lattice as jlat
from lbm_tpu.kernels import thermal_pallas as jtp
from lbm_tpu.scenes import thermal as jth

from lbm_tpu_torch.core import lattice as tlat
from lbm_tpu_torch.kernels import thermal as kth
from lbm_tpu_torch.scenes import thermal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
# rayleigh_benard's rates at Ra = 1e4 on H = 32, tau_g = 0.8, Pr = 0.71
KAPPA = (0.8 - 0.5) / 3.0
PHYS = dict(omega_f=1.0 / (0.71 * KAPPA * 3.0 + 0.5), omega_g=1.0 / 0.8,
            g_beta=1e4 * 0.71 * KAPPA * KAPPA / 32.0 ** 3)
STEPS = {"rb": (jtp.make_thermal_fused_step, kth.make_thermal_fused_step,
                jth.make_rb_step, thermal.make_rb_step),
         "cavity": (jtp.make_heated_cavity_fused_step, kth.make_heated_cavity_fused_step,
                    jth.make_cavity_step, thermal.make_cavity_step)}


def _close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def _noisy(q, R, C, seed):
    """A fluid near rest at rho ~ 1 and a temperature of +-0.1, every
    population times 1 + U(-0.05, 0.05): buoyant, off equilibrium."""
    rng = np.random.default_rng(seed)
    w = np.concatenate([jlat.W, jlat.W if q == 9 else jlat.W5])
    theta = np.concatenate([np.ones(9), np.full(q, 0.1)])
    return w[:, None, None] * theta[:, None, None] * rng.uniform(0.95, 1.05, (9 + q, R, C))


def test_lattice_constants_are_lbm_tpu_s():
    """The D2Q5 weights and opposites, copied, equal lbm_tpu's."""
    for name in ("W5", "OPP5"):
        assert getattr(tlat, name).dtype == getattr(jlat, name).dtype, name
        assert np.array_equal(getattr(tlat, name), getattr(jlat, name)), name


@pytest.mark.parametrize("lattice", ["d2q9", "d2q5"])
@pytest.mark.parametrize("kind,shape", [("rb", (32, 128)), ("cavity", (64, 128))])
def test_plain_step_matches_pallas_kernel_f64(kind, shape, lattice):
    """The plain kernel-23 / 24 step, 3 steps from a noisy state, against
    lbm_tpu's Pallas kernel (interpret mode) and its jnp step."""
    R, C = shape
    q = kth.scalar_planes(lattice)
    S0 = _noisy(q, R, C, seed=R + q)
    jax_fused, port_fused, jax_jnp, _ = STEPS[kind]
    kstep = jax_fused(R, C, dtype=jnp.float64, interpret=True, scalar_lattice=lattice, **PHYS)
    jstep = jax_jnp(R, C, dtype=jnp.float64, scalar_lattice=lattice, **PHYS)
    want, carry = jnp.asarray(S0), (jnp.asarray(S0[:9]), jnp.asarray(S0[9:]))
    for _ in range(3):
        want, carry = kstep(want), jstep(carry)
    got = port_fused(R, C, substeps=3, dtype=F64, scalar_lattice=lattice,
                     **PHYS)(torch.as_tensor(S0))
    _close(got, want, 1e-13)
    _close(got, np.concatenate([np.asarray(c) for c in carry]), 1e-13)


@pytest.mark.parametrize("lattice", ["d2q9", "d2q5"])
@pytest.mark.parametrize("kind", ["rb", "cavity"])
def test_carry_steps_match_lbm_tpu_jnp_steps(kind, lattice):
    """make_rb_step / make_cavity_step on lbm_tpu's carry (f, g), 4 steps at
    an odd 15x21, against lbm_tpu's jnp steps."""
    R, C = 15, 21
    q = kth.scalar_planes(lattice)
    S0 = _noisy(q, R, C, seed=q)
    _, _, jax_jnp, port_carry = STEPS[kind]
    jstep = jax_jnp(R, C, dtype=jnp.float64, scalar_lattice=lattice, **PHYS)
    tstep = port_carry(R, C, dtype=F64, scalar_lattice=lattice, **PHYS)
    want = (jnp.asarray(S0[:9]), jnp.asarray(S0[9:]))
    got = (torch.as_tensor(S0[:9]), torch.as_tensor(S0[9:]))
    for _ in range(4):
        want, got = jstep(want), tstep(got)
    for g, w in zip(got, want):
        _close(g, w, 1e-13)


def test_scene_helpers_match_lbm_tpu():
    """conduction_profile, d2q5_equilibrium, d2q5_stream and nusselt_number."""
    for H in (16, 33):
        np.testing.assert_array_equal(thermal.conduction_profile(H), jth.conduction_profile(H))
    rng = np.random.default_rng(5)
    u, th, g = rng.uniform(-0.1, 0.1, (2, 6, 7)), rng.uniform(-0.5, 0.5, (6, 7)), \
        rng.uniform(0, 1, (5, 6, 7))
    _close(thermal.d2q5_equilibrium(torch.as_tensor(u), torch.as_tensor(th)),
           jth.d2q5_equilibrium(jnp.asarray(u), jnp.asarray(th)), 1e-16)
    _close(thermal.d2q5_stream(torch.as_tensor(g)), jth.d2q5_stream(jnp.asarray(g)), 0.0)
    got = thermal.nusselt_number(torch.as_tensor(u[0]), torch.as_tensor(th), KAPPA, 6)
    assert abs(float(got) - float(jth.nusselt_number(jnp.asarray(u[0]), jnp.asarray(th),
                                                     KAPPA, 6))) <= 1e-14


@pytest.mark.parametrize("lattice", ["d2q9", "d2q5"])
def test_rayleigh_benard_matches_lbm_tpu_jnp(lattice):
    """rayleigh_benard, 40 steps at 16x32 above onset, with the series every
    10 steps: f, g, theta, u, Nu and the series against lbm_tpu's jnp scene."""
    kw = dict(H=16, W=32, T=40, Ra=5e3, amp=1e-2, record_every=10, scalar_lattice=lattice)
    got = thermal.rayleigh_benard(device="cpu", dtype=F64, **kw)
    want = jth.rayleigh_benard(fused=False, dtype=jnp.float64, **kw)
    for name in ("f", "g", "rho", "u", "theta", "series"):
        _close(getattr(got, name), getattr(want, name), 1e-12)
    assert abs(got.nusselt - want.nusselt) <= 1e-12
    assert got.series.shape == (4, 3) and not got.series.is_cuda and got.steps == 40


@pytest.mark.parametrize("lattice", ["d2q9", "d2q5"])
def test_heated_cavity_matches_lbm_tpu_jnp(lattice):
    """heated_cavity, 40 steps at 16x24 with the series every 20 steps."""
    kw = dict(H=16, W=24, T=40, Ra=1e4, record_every=20, scalar_lattice=lattice)
    got = thermal.heated_cavity(device="cpu", dtype=F64, **kw)
    want = jth.heated_cavity(fused=False, dtype=jnp.float64, **kw)
    for name in ("f", "g", "rho", "u", "theta", "series"):
        _close(getattr(got, name), getattr(want, name), 1e-12)
    assert abs(got.nusselt - want.nusselt) <= 1e-12 and got.series.shape == (2, 3)


def test_snapshots_match_lbm_tpu_jnp():
    """snapshot_every: (ux, uy, theta) at t = 0, 10, 20, as lbm_tpu records
    them; with substeps=2 the same frames."""
    kw = dict(H=16, W=32, T=30, Ra=5e3, amp=1e-2, snapshot_every=10)
    want = jth.rayleigh_benard(fused=False, dtype=jnp.float64, **kw)
    for substeps in (1, 2):
        got = thermal.rayleigh_benard(device="cpu", dtype=F64, substeps=substeps, **kw)
        assert set(got.snapshots) == {"ux", "uy", "theta"} and got.series is None
        for k, v in want.snapshots.items():
            assert np.asarray(v).shape == (3, 16, 32)
            _close(torch.as_tensor(got.snapshots[k]), v, 1e-12)


def test_substeps_equal_single_steps():
    """substeps=4 per call is four single steps, bit for bit, in the steps
    and in the scenes."""
    S = torch.as_tensor(_noisy(5, 12, 10, seed=3))
    for make in (kth.make_thermal_fused_step, kth.make_heated_cavity_fused_step):
        one = make(12, 10, dtype=F64, scalar_lattice="d2q5", **PHYS)
        four = make(12, 10, substeps=4, dtype=F64, scalar_lattice="d2q5", **PHYS)
        want = S
        for _ in range(8):
            want = one(want)
        assert torch.equal(four(four(S)), want)
    kw = dict(H=12, W=16, T=16, record_every=8, device="cpu", dtype=F64)
    for scene in (thermal.rayleigh_benard, thermal.heated_cavity):
        a, b = scene(substeps=4, **kw), scene(**kw)
        assert torch.equal(a.f, b.f) and torch.equal(a.g, b.g)
        assert torch.equal(a.series, b.series)


def test_scenes_reject_what_they_do_not_take(tmp_path):
    kw = dict(H=8, W=8, T=8, device="cpu")
    for scene in (thermal.rayleigh_benard, thermal.heated_cavity):
        with pytest.raises(ValueError, match="unknown scalar_lattice"):
            scene(scalar_lattice="d3q7", **kw)
        with pytest.raises(ValueError, match="divisible by substeps"):
            scene(substeps=3, **kw)
        with pytest.raises(ValueError, match="divisible by substeps"):
            scene(substeps=2, record_every=3, **dict(kw, T=12))
        with pytest.raises(ValueError, match="multiple of record_every"):
            scene(record_every=3, **kw)
        with pytest.raises(ValueError, match="mutually exclusive"):
            scene(record_every=4, snapshot_every=4, **kw)
        with pytest.raises(ValueError, match="substeps"):
            scene(substeps=9, **dict(kw, T=9))
    with pytest.raises(NotImplementedError, match="item 14"):
        thermal.rayleigh_benard(mesh_shape=(2, 1), **kw)
    with pytest.raises(ValueError, match="snapshot_every and checkpoint_dir are mutually"):
        thermal.rayleigh_benard(snapshot_every=4, checkpoint_dir=str(tmp_path), **kw)
    with pytest.raises(ValueError, match="R >= 4"):
        kth.make_thermal_fused_step(3, 8, **PHYS)


@pytest.mark.parametrize("scene,args,kw", [
    ("rayleigh_benard", ["--set", "H=16", "--set", "W=32", "--set", "T=20",
                         "--set", "record_every=10", "--set", "scalar_lattice='d2q5'"],
     dict(H=16, W=32, T=20, record_every=10, scalar_lattice="d2q5")),
    ("heated_cavity", ["--set", "H=16", "--set", "W=16", "--set", "T=20"],
     dict(H=16, W=16, T=20)),
])
def test_cli_runs_thermal_scenes(tmp_path, scene, args, kw):
    """The CLI prints the Nusselt number and writes the fields, as the scene
    called directly gives them."""
    out = str(tmp_path / scene)
    r = subprocess.run(
        [sys.executable, "-m", "lbm_tpu_torch.run", scene, "--x64", "--device", "cpu",
         *args, "--out", out],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    want = getattr(thermal, scene)(device="cpu", dtype=F64, **kw)
    assert f"nusselt={want.nusselt:g}" in r.stderr and "steps=20" in r.stderr
    _close(torch.as_tensor(np.load(f"{out}-g.npy")), want.g.numpy(), 0.0)
    if want.series is not None:
        _close(torch.as_tensor(np.load(f"{out}-series.npy")), want.series.numpy(), 0.0)
