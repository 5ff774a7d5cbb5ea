"""The IBM cylinder of lbm_tpu_torch against lbm_tpu: the plain version of
CUDA kernel 15 (kernels/cylinder.py), cylinder_flow, the carry converter,
the CLI with --markers and its summary line.

On the CPU the scene steps through the plain versions of kernels 16 and 15.
The grid step is held to lbm_tpu's Pallas make_cylinder_fused_step
(interpret mode) at 1e-13 in float64; the scene to lbm_tpu's jnp scene at
1e-12 in float64 with the weak Guo pair, and at the standard (3, 9) pair to
lbm_tpu's two Pallas kernels in float64 interpret mode, since lbm_tpu's jnp
path ignores ``guo_coeffs`` (pinned below); ``record_every`` to lbm_tpu's
fused float32 scene at its own tolerances.  Kernels 15 and 16 themselves are
held to the plain versions on the card by tests/test_torch_cuda.py.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels.cylinder_pallas import make_cylinder_fused_step as jax_cylinder_step
from lbm_tpu.kernels.ibm_pallas import make_ibm_forcing_step as jax_forcing_step
from lbm_tpu.ops import d2q9 as jd
from lbm_tpu.ops.ibm import IBM as JaxIBM
from lbm_tpu.scenes import obstacles as jobs

from lbm_tpu_torch import run
from lbm_tpu_torch.io import convert
from lbm_tpu_torch.kernels import cylinder
from lbm_tpu_torch.ops.ibm import IBM
from lbm_tpu_torch.scenes import obstacles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OMEGA, U = 1.0 / 0.55, 0.05
STANDARD = (3.0, 9.0)


def _noisy(R, C, seed):
    rng = np.random.default_rng(seed)
    u = 0.05 * rng.uniform(-1.0, 1.0, (2, R, C))
    rho = 1.0 + 0.01 * rng.uniform(-1.0, 1.0, (R, C))
    f = np.asarray(jd.equilibrium(jnp.asarray(u), jnp.asarray(rho)))
    return f * rng.uniform(0.97, 1.03, (9, R, C))


@pytest.mark.parametrize("guo,steps", [(cylinder.WEAK_GUO, 1), (STANDARD, 2)])
def test_plain_step_matches_pallas_kernel_f64(guo, steps):
    """The plain kernel-15 step against lbm_tpu's Pallas kernel (interpret
    mode) at 64x128 from a noisy state, a noisy force over a 16x16 ROI."""
    R, C = 64, 128
    rng = np.random.default_rng(11)
    f = _noisy(R, C, seed=7)
    F = rng.normal(0.0, 1e-3, (2, 16, 16))
    F_full = np.zeros((2, R, C))
    F_full[:, 20:36, 50:66] = F
    kstep = jax_cylinder_step(R, C, OMEGA, u_wall=(U, 0.0), guo=guo, dtype=jnp.float64,
                              interpret=True)
    want = jnp.asarray(f)
    for _ in range(steps):
        want = kstep(want, jnp.asarray(F_full))
    step = cylinder.make_cylinder_fused_step(R, C, OMEGA, (U, 0.0), guo, torch.float64)
    got = torch.as_tensor(f)
    for _ in range(steps):
        got = step(got, torch.as_tensor(F), (20, 50))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-13


def _kw(**extra):
    return {**dict(H=48, W=128, T=50, center=(24.0, 60.0), radius=9.0, n_markers=24),
            **extra}


def _close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.shape(want)
    assert np.abs(got - np.asarray(want)).max() <= tol


def test_scene_matches_lbm_tpu_jnp_f64():
    """cylinder_flow at the weak default with the reference's weight pairing,
    50 steps: f, F_roi and surface_force against lbm_tpu's jnp scene."""
    kw = _kw(reference_weights=True)
    got = obstacles.cylinder_flow(device="cpu", dtype=torch.float64, **kw)
    want = jobs.cylinder_flow(fused=False, dtype=jnp.float64, **kw)
    for name in ("f", "rho", "u", "F_roi", "surface_force"):
        _close(getattr(got, name), getattr(want, name), 1e-12)
    assert got.steps == 50 and got.forces is None and got.snapshots is None


def test_scene_at_the_standard_guo_matches_lbm_tpu_kernels_f64():
    """At guo (3, 9), lbm_tpu's forcing and grid kernels in float64
    interpret mode, driven as tests/test_cylinder_transcription.py drives
    them, over 4 steps."""
    H, W, T = 48, 128, 4
    kw = dict(H=H, W=W, T=T, center=(24.0, 60.0), radius=9.0, n_markers=24)
    jib = JaxIBM.circle(24.0, 60.0, 9.0, 24)
    kstep = jax_cylinder_step(H, W, OMEGA, u_wall=(U, 0.0), guo=STANDARD, dtype=jnp.float64,
                              interpret=True)
    kforce = jax_forcing_step(H, W, jib, dtype=jnp.float64, interpret=True)

    @jax.jit
    def step(carry):
        f, F = carry
        F = kforce(f, F)
        return kstep(f, F), F

    u0 = jnp.zeros((2, H, W), jnp.float64).at[0].set(U)
    carry = (jd.incomp_equilibrium(u0, jnp.ones((H, W), jnp.float64)),
             jnp.zeros((2, H, W), jnp.float64))
    for _ in range(T):
        carry = step(carry)
    got = obstacles.cylinder_flow(guo_coeffs=STANDARD, device="cpu", dtype=torch.float64,
                                  **kw)
    (r0, r1), (c0, c1) = jib.roi_rows, jib.roi_cols
    _close(got.f, carry[0], 1e-13)
    _close(got.F_roi, np.asarray(carry[1])[:, r0:r1, c0:c1], 1e-13)


def test_lbm_tpu_jnp_path_ignores_guo_coeffs():
    """lbm_tpu's jnp path always takes the weak Guo pair
    (lbm_tpu/scenes/obstacles.py:235); the port honours guo_coeffs on both
    devices, so at (3, 9) it leaves lbm_tpu's jnp path."""
    kw = _kw(T=10)
    j_weak = jobs.cylinder_flow(fused=False, dtype=jnp.float64, **kw)
    j_std = jobs.cylinder_flow(fused=False, dtype=jnp.float64, guo_coeffs=STANDARD, **kw)
    assert np.array_equal(np.asarray(j_weak.f), np.asarray(j_std.f))
    weak = obstacles.cylinder_flow(device="cpu", dtype=torch.float64, **kw)
    std = obstacles.cylinder_flow(guo_coeffs=STANDARD, device="cpu", dtype=torch.float64,
                                  **kw)
    _close(weak.f, j_weak.f, 1e-12)
    assert (std.f - weak.f).abs().max().item() > 1e-6


def test_record_every_matches_lbm_tpu_fused_f32():
    """record_every's (T // k, 2) series against lbm_tpu's fused float32
    scene (both Pallas kernels in interpret mode), at lbm_tpu's own
    tolerances, rtol 5e-4 and atol 3e-6 (tests/test_cylinder_pallas.py).
    The lift Fy is zero by symmetry (1e-15 in float64): in float32 it is
    the round-off of a ROI sum of terms the size of the drag (7.4), so
    each float32 lift is held to the float64 series (port 9.7e-7, lbm_tpu
    2.7e-6 at these steps), and the drag of the two float32 series to each
    other."""
    kw = dict(H=64, W=128, T=20, center=(30.0, 60.0), radius=10.0, n_markers=24,
              record_every=5)
    want = np.asarray(jobs.cylinder_flow(fused=True, interpret=True, **kw).forces)
    got = obstacles.cylinder_flow(device="cpu", dtype=torch.float32, **kw)
    exact = obstacles.cylinder_flow(device="cpu", dtype=torch.float64, **kw).forces.numpy()
    assert got.forces.shape == (4, 2) and got.forces.dtype == torch.float32
    np.testing.assert_allclose(got.forces.numpy()[:, 0], want[:, 0], rtol=5e-4, atol=3e-6)
    for series in (got.forces.numpy(), want):
        np.testing.assert_allclose(series, exact, rtol=5e-4, atol=3e-6)
    assert torch.equal(got.forces[-1], got.surface_force)
    with pytest.raises(ValueError, match="multiple of record_every"):
        obstacles.cylinder_flow(device="cpu", **dict(kw, T=21))


def test_scene_with_config_markers_and_snapshots(tmp_path):
    """config_path + markers_path, as the reference program's two argv files:
    the grid, velocity, omega and T from the TOML, the markers from
    configs/cylinder-markers.toml, and the snapshot set against lbm_tpu's
    jnp path."""
    cfg = tmp_path / "cyl.toml"
    cfg.write_text("""
[flow]
initial_density = 1e3
kinematic_viscosity = 3.3333333333333335E-5
characteristic_length = 6.0E-3
characteristic_velocity = 0.5

[lattice]
relaxation_time = 0.55
lattice_spacing = 2.0E-4
x_multiplier = 3.5
y_multiplier = 3

[simulation]
stop_time = 0.001
snapshot_period = 0.0004
file_prefix = "cyl"
""")
    markers = os.path.join(REPO, "configs", "cylinder-markers.toml")
    kw = dict(config_path=str(cfg), markers_path=markers)
    got = obstacles.cylinder_flow(device="cpu", dtype=torch.float64, **kw)
    want = jobs.cylinder_flow(fused=False, dtype=jnp.float64, **kw)
    assert got.f.shape == (9, 105, 90) and got.steps == want.steps == 50
    assert abs(got.u[0, 5, 5].item() - 0.05) < 1e-3  # lattice.u, Re 90
    assert set(got.snapshots) == {"ux", "uy", "ps", "surface_force", "forces"}
    for k, v in want.snapshots.items():
        assert got.snapshots[k].shape[0] >= 2
        _close(torch.as_tensor(got.snapshots[k]), v, 1e-12)
    _close(got.f, want.f, 1e-12)


def test_cylinder_carry_from_numpy():
    ib = IBM.circle(20.0, 20.0, 6.0, 16)
    f, F = np.ones((9, 40, 40)), np.zeros((2,) + ib.roi_shape)
    tf, tF = convert.cylinder_carry_from_numpy(f, F, ib, "cpu", torch.float32)
    assert tf.shape == (9, 40, 40) and tF.shape == (2,) + ib.roi_shape
    assert tF.dtype == torch.float32 and tF.is_contiguous()
    with pytest.raises(ValueError, match="ROI force"):
        convert.cylinder_carry_from_numpy(f, np.zeros((2, 40, 40)), ib, "cpu", torch.float32)


def test_grid_step_checks_its_force():
    step = cylinder.make_cylinder_fused_step(16, 16, OMEGA, dtype=torch.float64)
    f = torch.ones((9, 16, 16), dtype=torch.float64)
    with pytest.raises(ValueError, match="does not fit"):
        step(f, torch.zeros((2, 8, 8), dtype=torch.float64), (10, 0))
    with pytest.raises(ValueError, match="device and dtype"):
        step(f, torch.zeros((2, 8, 8)).float(), (0, 0))
    with pytest.raises(ValueError, match="R >= 4"):
        cylinder.make_cylinder_fused_step(3, 16, OMEGA)


def test_summary_prints_short_vector_fields():
    """The CLI's closing line names 1-D tensor fields of at most 4 entries,
    as lbm_tpu's does (lbm_tpu/run.py:114-117)."""
    res = obstacles.CylinderResult(
        f=torch.zeros(9, 2, 2), rho=torch.ones(2, 2), u=torch.zeros(2, 2, 2),
        F_roi=torch.zeros(2, 3, 3), surface_force=torch.tensor([-1.5, 0.25]), steps=7,
        forces=torch.zeros(5, 2))
    line = run._summarise(res)
    assert "steps=7" in line and "surface_force=(-1.5, 0.25)" in line
    assert "forces" not in line and "F_roi" not in line


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "lbm_tpu_torch.run", *args],
                          capture_output=True, text=True, cwd=REPO, timeout=300)


def test_cli_runs_cylinder_flow_with_markers(tmp_path):
    """Both obstacle scenes are registered; --markers reaches cylinder_flow
    and the summary names surface_force; a scene without markers_path
    rejects --markers."""
    out = str(tmp_path / "cyl")
    r = _cli("cylinder_flow", "--markers", "configs/cylinder-markers.toml", "--x64",
             "--device", "cpu", "--set", "H=100", "--set", "W=90", "--set", "T=6",
             "--out", out)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "steps=6" in r.stderr and "surface_force=(" in r.stderr
    want = obstacles.cylinder_flow(H=100, W=90, T=6, device="cpu", dtype=torch.float64,
                                   markers_path="configs/cylinder-markers.toml")
    _close(torch.as_tensor(np.load(f"{out}-surface_force.npy")), want.surface_force, 0.0)
    r = _cli("horizontal_poiseuille", "--markers", "configs/cylinder-markers.toml",
             "--device", "cpu")
    assert r.returncode == 2 and "does not take --markers" in r.stderr
    assert run._scenes()["cylinder_flow"] is obstacles.cylinder_flow
    assert run._scenes()["rectangle_sedimentation"] is obstacles.rectangle_sedimentation
