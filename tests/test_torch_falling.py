"""The falling-body scenes of lbm_tpu_torch against lbm_tpu's jnp scenes:
falling_cylinder, falling_cylinders (the DKT pair) and falling_ellipse, the
plain ellipse_fsi_step builder, the window-budget warning, the CLI.

On the CPU each step runs the plain versions of kernels 19-21 and 18.  The
scenes are held to lbm_tpu's jnp scenes in float64 at small sizes over at
most 12 steps: f at 1e-12, the trajectory, centres, velocities and
orientation at 1e-12 (lbm_tpu's own fused-against-jnp tolerances,
tests/test_moving_ibm.py:180-198).
"""

import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops.moving_ibm import ellipse_markers
from lbm_tpu.scenes import obstacles as jobs

from lbm_tpu_torch import run
from lbm_tpu_torch.scenes import obstacles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


def _close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def _same(got, want, fields):
    for name in fields:
        _close(getattr(got, name), getattr(want, name), 1e-12)


def test_falling_cylinder_matches_lbm_tpu_jnp():
    kw = dict(H=64, W=96, T=12, center=(20.3, 47.0), radius=8.0, rho_s=1.4, gravity=1e-4,
              record_every=4)
    got = obstacles.falling_cylinder(device="cpu", dtype=F64, **kw)
    want = jobs.falling_cylinder(fused=False, dtype=jnp.float64, **kw)
    _same(got, want, ("f", "rho", "u", "trajectory", "center", "velocity"))
    assert got.steps == 12 and got.trajectory.shape == (3, 6)
    assert got.center[0] > 20.3 and got.trajectory[-1, 4] < 0.0   # falls; drag opposes


@pytest.mark.parametrize("centers,zeta", [
    (((24.0, 40.0), (45.0, 48.0)), 2.0),        # the DKT arrangement, barriers idle
    (((30.0, 40.0), (46.0, 60.0)), 12.0)])      # pair and wall barriers active
def test_falling_cylinders_match_lbm_tpu_jnp(centers, zeta):
    kw = dict(H=96, W=96, T=9, centers=centers, radius=8.0, rho_s=1.4, gravity=1e-4,
              zeta=zeta, record_every=3)
    got = obstacles.falling_cylinders(device="cpu", dtype=F64, **kw)
    want = jobs.falling_cylinders(fused=False, dtype=jnp.float64, **kw)
    _same(got, want, ("f", "trajectory", "centers", "velocities"))
    assert got.trajectory.shape == (3, 2, 6)


def test_falling_ellipse_matches_lbm_tpu_jnp():
    kw = dict(H=64, W=96, T=9, center=(24.0, 48.5), a=9.0, b=4.5, theta0=0.5, rho_s=1.4,
              gravity=2e-4, record_every=3)
    got = obstacles.falling_ellipse(device="cpu", dtype=F64, **kw)
    want = jobs.falling_ellipse(fused=False, dtype=jnp.float64, **kw)
    _same(got, want, ("f", "trajectory", "center", "velocity", "orientation", "omega_body"))
    assert got.trajectory.shape == (3, 10) and abs(float(got.omega_body)) > 0.0


def test_ellipse_fsi_step_matches_lbm_tpu():
    """The plain step builder on lbm_tpu's carry, 4 steps from a tilted,
    moving, spinning body."""
    H, W, a, b = 48, 64, 8.0, 4.0
    dx, dy = ellipse_markers(a, b)
    area = np.pi * a * b
    kw = dict(dx=dx, dy=dy, half=13, omega=1 / 0.6, m_eff=1.4 * area,
              i_eff=1.4 * area * (a * a + b * b) / 4.0, g_net=0.4 * area * 2e-4)
    jstep = jobs.ellipse_fsi_step(H, W, dtype=jnp.float64, **kw)
    step = obstacles.ellipse_fsi_step(H, W, dtype=F64, **kw)
    f0 = np.asarray(obstacles._rest(H, W, "cpu", F64))
    init = (f0, [20.2, 31.5], [0.01, -0.002], [np.cos(0.4), np.sin(0.4)], 0.003, [0.0, 0.0],
            0.0)
    jc = tuple(jnp.asarray(x, jnp.float64) for x in init)
    c = tuple(torch.as_tensor(np.asarray(x), dtype=F64) for x in init)
    for _ in range(4):
        jc, c = jstep(jc), step(c)
    for g, w in zip(c, jc):
        _close(g, w, 1e-12)


def test_dkt_window_budget_warns_as_lbm_tpu_does():
    """lbm_tpu's _finish warning (obstacles.py:625-642), reproduced: two
    bodies on one row with no slack drift apart, beyond the
    rows their window budgets (the one near the wall falls slower once its
    disturbance has reached the wall)."""
    kw = dict(H=64, W=64, T=30, centers=((30.0, 12.0), (30.0, 40.0)), radius=6.0,
              row_slack=0, record_every=2)
    with pytest.warns(UserWarning, match="forcing window budget"):
        jobs.falling_cylinders(fused=False, dtype=jnp.float64, **kw)
    with pytest.warns(UserWarning, match="forcing window budget"):
        obstacles.falling_cylinders(device="cpu", dtype=F64, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        obstacles.falling_cylinders(device="cpu", dtype=F64, **dict(kw, row_slack=4))


def test_scenes_reject_what_they_do_not_take():
    with pytest.raises(ValueError, match="checkpoint_every must be >= 1"):
        obstacles.falling_cylinder(checkpoint_dir="ckpt", checkpoint_every=0, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        obstacles.falling_ellipse(H=64, W=64, center=(5.0, 30.0), device="cpu")
    with pytest.raises(ValueError, match="multiple of record_every"):
        obstacles.falling_cylinders(T=7, record_every=2, device="cpu")
    for scene in (obstacles.falling_cylinder, obstacles.falling_ellipse):
        with pytest.raises(ValueError, match="multiple of record_every"):
            scene(T=6, record_every=0, device="cpu")
    with pytest.raises(ValueError, match="a >= b"):
        obstacles.falling_ellipse(a=4.0, b=8.0, device="cpu")


def test_falling_cylinder_mesh_raises_as_the_other_scenes_do():
    """lbm_tpu's falling_cylinder takes ``mesh`` (obstacles.py:927); the
    port's takes it too and raises no_mesh's NotImplementedError, not a
    TypeError, before any work."""
    import inspect

    assert "mesh" in inspect.signature(jobs.falling_cylinder).parameters
    assert inspect.signature(obstacles.falling_cylinder).parameters["mesh"].default is None
    with pytest.raises(NotImplementedError, match="item 14"):
        obstacles.falling_cylinder(mesh=object(), device="cpu")


@pytest.mark.parametrize("scene,kw,shape", [
    (obstacles.falling_cylinder, dict(H=48, W=48, radius=6.0), (0, 6)),
    (obstacles.falling_cylinders, dict(H=96, W=48, centers=((20.0, 23.0), (40.0, 24.0)),
                                       radius=6.0), (0, 2, 6)),
    (obstacles.falling_ellipse, dict(H=64, W=64, a=8.0, b=4.0), (0, 10)),
])
def test_zero_steps_record_an_empty_trajectory(scene, kw, shape):
    res = scene(T=0, record_every=3, device="cpu", dtype=F64, **kw)
    assert res.steps == 0 and tuple(res.trajectory.shape) == shape
    assert res.trajectory.dtype == F64


def test_summary_leaves_trajectories_and_body_arrays_out():
    """P3's rule on the new results: a body's (2,) centre and velocity are
    printed, the (B, 2) centres and the trajectories are not."""
    one = obstacles.FallingCylinderResult(
        f=torch.zeros(9, 2, 2), rho=torch.ones(2, 2), u=torch.zeros(2, 2, 2),
        center=torch.tensor([30.5, 48.0]), velocity=torch.tensor([0.01, 0.0]), steps=5,
        trajectory=torch.zeros(5, 6))
    line = run._summarise(one)
    assert "center=(30.5, 48)" in line and "velocity=(" in line and "trajectory" not in line
    pair = obstacles.FallingCylindersResult(
        f=torch.zeros(9, 2, 2), rho=torch.ones(2, 2), u=torch.zeros(2, 2, 2),
        centers=torch.zeros(2, 2), velocities=torch.zeros(2, 2), steps=5,
        trajectory=torch.zeros(5, 2, 6))
    assert run._summarise(pair).split() == ["steps=5"]


@pytest.mark.parametrize("scene,sets,field", [
    ("falling_cylinder", ("H=64", "W=64", "T=6", "radius=6.0", "record_every=3"), "center"),
    ("falling_cylinders", ("H=96", "W=64", "T=6", "centers=((24.0,30.0),(45.0,33.0))",
                           "radius=6.0", "record_every=3"), "centers"),
    ("falling_ellipse", ("H=64", "W=64", "T=6", "a=8.0", "b=4.0", "record_every=3"),
     "orientation")])
def test_cli_runs_the_falling_scenes(tmp_path, scene, sets, field):
    out = str(tmp_path / scene)
    args = [a for s in sets for a in ("--set", s)]
    r = subprocess.run([sys.executable, "-m", "lbm_tpu_torch.run", scene, "--x64",
                        "--device", "cpu", *args, "--out", out],
                       capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "steps=6" in r.stderr
    assert np.load(f"{out}-trajectory.npy").shape[0] == 2
    assert np.isfinite(np.load(f"{out}-{field}.npy")).all()
    assert run._scenes()[scene] is getattr(obstacles, scene)
