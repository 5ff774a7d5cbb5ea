"""Rectangle sedimentation of lbm_tpu_torch against lbm_tpu: the plain
version of CUDA kernel 17 (kernels/sediment.py), the scene, substeps, the
physical-units config and the CLI.

The plain step is held to lbm_tpu's Pallas make_sediment_fused_step
(interpret mode) at 1e-13 in float64, the scene to lbm_tpu's jnp scene at
1e-12 in float64.  Kernel 17 itself is held to the plain version on the card
by tests/test_torch_cuda.py.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels.sediment_pallas import make_sediment_fused_step as jax_sediment_step
from lbm_tpu.scenes import obstacles as jobs

from lbm_tpu_torch.io import convert
from lbm_tpu_torch.kernels import sediment
from lbm_tpu_torch.scenes import obstacles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHYS = dict(omega=1.0 / 0.55, u_in=0.02, w_s=3e-3, C_w=1e-3)
# lbm_tpu's kernel-test geometry at 64x128 (tests/test_sediment_pallas.py)
GEOM = dict(R23=44, C28=40, C38=56, inlet_rows=16)
# tests/test_sedimentation.py's scene at 64x96
SCENE = dict(H=64, W=96, R23=-30, C28=50, C38=62, inlet_rows=16)


def _close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.shape(want)
    assert np.abs(got - np.asarray(want)).max() <= tol


def _noisy_initial(R, C, seed):
    S = obstacles.sediment_initial_state(R, C, PHYS["u_in"], PHYS["C_w"],
                                         GEOM["inlet_rows"], "cpu", torch.float64)
    rng = np.random.default_rng(seed)
    return S.numpy() * rng.uniform(0.97, 1.03, S.shape)


@pytest.mark.parametrize("steps", [2, 4])
def test_plain_step_matches_pallas_kernel_f64(steps):
    """The plain kernel-17 step against lbm_tpu's Pallas kernel (interpret
    mode) at 64x128 from the scene's initial state with noise."""
    R, C = 64, 128
    S0 = _noisy_initial(R, C, seed=steps)
    kstep = jax_sediment_step(R, C, dtype=jnp.float64, interpret=True, **PHYS, **GEOM)
    want = jnp.asarray(S0)
    for _ in range(steps):
        want = kstep(want)
    got = sediment.make_sediment_fused_step(R, C, substeps=steps, dtype=torch.float64,
                                            **PHYS, **GEOM)(torch.as_tensor(S0))
    _close(got, want, 1e-13)


def test_scene_matches_lbm_tpu_jnp_f64():
    """rectangle_sedimentation, 50 steps: f, g, u, rho and C against lbm_tpu's
    jnp scene."""
    got = obstacles.rectangle_sedimentation(T=50, device="cpu", dtype=torch.float64, **SCENE)
    want = jobs.rectangle_sedimentation(T=50, fused=False, dtype=jnp.float64, **SCENE)
    for name in ("f", "g", "u", "rho", "C"):
        _close(getattr(got, name), getattr(want, name), 1e-12)
    assert got.steps == 50 and got.snapshots is None


def test_scene_invariants():
    """tests/test_sedimentation.py's invariants on the port's scene
    (float64, 120 steps): a plume at the bottom inlet rows, C above -1e-3,
    and the flow faster than the inlet above the rectangle."""
    res = obstacles.rectangle_sedimentation(T=120, u_in=0.02, device="cpu",
                                            dtype=torch.float64, **SCENE)
    C = res.C.numpy()
    assert np.isfinite(res.f.numpy()).all() and np.isfinite(res.g.numpy()).all()
    assert C.max() > 1e-4 and C.min() > -1e-3
    assert C[-16:, 1:20].mean() > C[:16, 1:20].mean()
    assert (res.u[1] / res.rho).numpy()[:30, 55].mean() > 0.02


def test_substeps_equal_single_steps():
    """substeps=4 per call is four single steps, bit for bit."""
    S = torch.as_tensor(_noisy_initial(64, 128, seed=9))
    one = sediment.make_sediment_fused_step(64, 128, dtype=torch.float64, **PHYS, **GEOM)
    four = sediment.make_sediment_fused_step(64, 128, substeps=4, dtype=torch.float64,
                                             **PHYS, **GEOM)
    want = S
    for _ in range(8):
        want = one(want)
    assert torch.equal(four(four(S)), want)
    got = obstacles.rectangle_sedimentation(T=8, substeps=4, device="cpu",
                                            dtype=torch.float64, **SCENE)
    ref = obstacles.rectangle_sedimentation(T=8, device="cpu", dtype=torch.float64, **SCENE)
    assert torch.equal(got.f, ref.f) and torch.equal(got.g, ref.g)
    with pytest.raises(ValueError, match="T % substeps"):
        obstacles.rectangle_sedimentation(T=10, substeps=4, device="cpu", **SCENE)


def _small_toml(tmp_path):
    """configs/channel.toml's schema at 60x45 and 24 steps, a snapshot every
    8 (u = 1/15 at Re 60 on l = 15; 9375 steps per second)."""
    path = tmp_path / "sed.toml"
    path.write_text("""
[flow]
initial_density = 1e3
kinematic_viscosity = 2.5E-5
characteristic_length = 6.0E-3
characteristic_velocity = 0.25

[lattice]
relaxation_time = 0.55
lattice_spacing = 4.0E-4
x_multiplier = 4
y_multiplier = 3

[simulation]
stop_time = 0.00255
snapshot_period = 0.00085
file_prefix = "sed"
""")
    return str(path)


def test_config_path_matches_lbm_tpu(tmp_path):
    """config_path: H, W, u_in, omega and T from the TOML, the rectangle
    from the keywords, (ux, uy, ps, cs) snapshots as lbm_tpu's jnp path."""
    cfg = _small_toml(tmp_path)
    kw = dict(config_path=cfg, R23=-12, C28=20, C38=26, inlet_rows=10)
    got = obstacles.rectangle_sedimentation(device="cpu", dtype=torch.float64, **kw)
    want = jobs.rectangle_sedimentation(fused=False, dtype=jnp.float64, **kw)
    assert got.f.shape == (9, 60, 45) and got.steps == want.steps == 24
    assert set(got.snapshots) == {"ux", "uy", "ps", "cs"}
    for k, v in want.snapshots.items():
        assert got.snapshots[k].shape == v.shape and v.shape[0] == 3
        _close(torch.as_tensor(got.snapshots[k]), v, 1e-12)
    _close(got.g, want.g, 1e-12)
    with pytest.raises(ValueError, match="no snapshot cadence"):
        obstacles.rectangle_sedimentation(device="cpu", substeps=2, **kw)


def test_cli_runs_rectangle_sedimentation(tmp_path):
    """The CLI with --config and the rectangle through --set, against the
    scene called directly."""
    cfg = _small_toml(tmp_path)
    out = str(tmp_path / "sed")
    r = subprocess.run(
        [sys.executable, "-m", "lbm_tpu_torch.run", "rectangle_sedimentation", "--config", cfg,
         "--x64", "--device", "cpu", "--set", "R23=-12", "--set", "C28=20", "--set", "C38=26",
         "--set", "inlet_rows=10", "--out", out],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "steps=24" in r.stderr
    want = obstacles.rectangle_sedimentation(config_path=cfg, R23=-12, C28=20, C38=26,
                                             inlet_rows=10, device="cpu",
                                             dtype=torch.float64)
    _close(torch.as_tensor(np.load(f"{out}-C.npy")), want.C.numpy(), 0.0)
    assert np.load(f"{out}-snap-cs.npy").shape == (3, 60, 45)


def test_state_converter_and_geometry_checks():
    S = convert.sediment_state_from_numpy(np.zeros((18, 8, 6)), "cpu", torch.float32)
    assert S.shape == (18, 8, 6) and S.dtype == torch.float32
    with pytest.raises(ValueError, match="sedimentation"):
        convert.sediment_state_from_numpy(np.zeros((9, 8, 6)), "cpu", torch.float32)
    for bad in (dict(R23=0, C28=5, C38=9), dict(R23=10, C28=0, C38=9),
                dict(R23=10, C28=9, C38=5), dict(R23=10, C28=5, C38=19)):
        with pytest.raises(ValueError, match="does not fit"):
            sediment.make_sediment_fused_step(24, 20, inlet_rows=4, **PHYS, **bad)
    # inlet_rows is a Python slice [-inlet_rows:]: 0 takes every row, as in lbm_tpu
    assert sediment.inlet_profile(5, 1.0, 0, torch.float64, "cpu").tolist() == [1.0] * 5
    assert sediment.inlet_profile(5, 1.0, 2, torch.float64, "cpu").tolist() == \
        [0.0, 0.0, 0.0, 1.0, 1.0]
