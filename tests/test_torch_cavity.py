"""The ring cavity of lbm_tpu_torch against lbm_tpu: the plain version of CUDA
kernel 22 (kernels/cavity.py), the scene, substeps, its checks and the CLI.

The plain step is held to lbm_tpu's Pallas make_cavity_fused_step (interpret
mode) at 1e-13 in float64, the scene to lbm_tpu's jnp scene at 1e-12 in
float64.  lbm_tpu compares its kernel with its jnp path only in float32 at
rtol 5e-4 (tests/test_cavity.py:34-53); here the two are also held to each
other in float64.  Kernel 22 itself is held to the plain version on the card
by tests/test_torch_cuda.py.
"""

import math
import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels.cavity_pallas import make_cavity_fused_step as jax_cavity_step
from lbm_tpu.ops import d2q9 as jd2q9
from lbm_tpu.scenes import cavity as jcav

from lbm_tpu_torch.kernels import cavity
from lbm_tpu_torch.scenes import cavity as scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OMEGA = 1.0 / (math.sqrt(3.0 / 16.0) + 0.5)


def _close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def _noisy(L, seed):
    """An equilibrium at a seeded random flow, each population times
    1 + U(-0.03, 0.03)."""
    rng = np.random.default_rng(seed)
    f = jd2q9.equilibrium(jnp.asarray(rng.uniform(-0.05, 0.05, (2, L, L))),
                          jnp.asarray(1.0 + rng.uniform(-0.01, 0.01, (L, L))))
    return np.asarray(f) * rng.uniform(0.97, 1.03, (9, L, L))


@pytest.mark.parametrize("steps,force", [(2, 3e-5), (4, 3e-3)])
def test_plain_step_matches_pallas_kernel_f64(steps, force):
    """The plain kernel-22 step against lbm_tpu's Pallas kernel (interpret
    mode) at L = 128 from a noisy state."""
    L = 128
    f0 = _noisy(L, seed=steps)
    kstep = jax_cavity_step(L, omega=OMEGA, force=force, dtype=jnp.float64, interpret=True)
    want = jnp.asarray(f0)
    for _ in range(steps):
        want = kstep(want)
    got = cavity.make_cavity_fused_step(L, omega=OMEGA, force=force, substeps=steps,
                                        dtype=torch.float64)(torch.as_tensor(f0))
    _close(got, want, 1e-13)


def test_lbm_tpu_kernel_and_jnp_scene_agree_f64():
    """lbm_tpu's two paths in float64 (its own test compares them in float32
    only): the Pallas kernel (interpret) and the jnp scene, 30 steps at
    L = 128, within 1e-13 of each other and of the port's scene."""
    kw = dict(L=128, T=30, force=3e-3, dtype=jnp.float64)
    fused = jcav.ring_cavity(fused=True, interpret=True, **kw)
    plain = jcav.ring_cavity(fused=False, **kw)
    _close(np.asarray(fused.f), plain.f, 1e-13)
    got = scene.ring_cavity(L=128, T=30, force=3e-3, device="cpu", dtype=torch.float64)
    _close(got.f, fused.f, 1e-13)


@pytest.mark.parametrize("L", [32, 30])
def test_scene_matches_lbm_tpu_jnp_f64(L):
    """ring_cavity, 40 steps at the reference's super-critical force: f, rho
    and u against lbm_tpu's jnp scene (L = 30 is not a multiple of 4)."""
    got = scene.ring_cavity(L=L, T=40, device="cpu", dtype=torch.float64)
    want = jcav.ring_cavity(L=L, T=40, fused=False, dtype=jnp.float64)
    for name in ("f", "rho", "u"):
        _close(getattr(got, name), getattr(want, name), 1e-12)
    assert got.steps == 40


def test_scene_circulates():
    """lbm_tpu's tests/test_cavity.py:13-24 on the port: the forced left
    strip flows +x, the right strip returns -x, the block stays quiescent."""
    res = scene.ring_cavity(L=64, T=400, force=3e-3, device="cpu", dtype=torch.float64)
    u = (res.u / res.rho[None]).numpy()
    assert np.isfinite(u).all()
    left = u[0, 24:40, 4:12].mean()
    right = u[0, 24:40, 52:60].mean()
    assert left > 1e-4 and right < -1e-5
    assert np.abs(u[0, 28:36, 28:36]).max() < np.abs(left)


def test_substeps_equal_single_steps():
    """substeps=4 per call is four single steps, bit for bit, in the step
    and in the scene."""
    L = 32
    f = torch.as_tensor(_noisy(L, seed=7))
    one = cavity.make_cavity_fused_step(L, omega=OMEGA, force=3e-3, dtype=torch.float64)
    four = cavity.make_cavity_fused_step(L, omega=OMEGA, force=3e-3, substeps=4,
                                         dtype=torch.float64)
    want = f
    for _ in range(8):
        want = one(want)
    assert torch.equal(four(four(f)), want)
    a = scene.ring_cavity(L=L, T=12, substeps=4, device="cpu", dtype=torch.float64)
    b = scene.ring_cavity(L=L, T=12, device="cpu", dtype=torch.float64)
    assert torch.equal(a.f, b.f)


def test_scene_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="divisible by substeps"):
        scene.ring_cavity(L=16, T=10, substeps=4, device="cpu")
    with pytest.raises(ValueError, match="substeps"):
        scene.ring_cavity(L=16, T=18, substeps=9, device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        scene.ring_cavity(L=16, T=10, mesh_shape=(2, 1), device="cpu")
    with pytest.raises(ValueError, match="L >= 4"):
        cavity.make_cavity_fused_step(3, omega=OMEGA, force=3e-5)
    step = cavity.make_cavity_fused_step(16, omega=OMEGA, force=3e-5)  # float32
    with pytest.raises(ValueError, match="step built for"):
        step(torch.ones((9, 16, 16), dtype=torch.float64))


def test_super_critical_warning():
    """lbm_tpu's warning, word for word, for F >= 1e-3 past T = 1500 (here
    the run then stops at the substeps check); none at F = 3e-5."""
    with pytest.warns(UserWarning) as rec, pytest.raises(ValueError):
        scene.ring_cavity(L=16, T=1601, substeps=2, device="cpu")
    assert str(rec[0].message) == (
        "ring_cavity: F=0.003 is super-critical (reference workload quirk, "
        "decompose_domain_loop.cpp:41-78) — fields go non-finite by t~2000-2500; "
        "use force=3e-5 for T > 1500")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError):
            scene.ring_cavity(L=16, T=1601, force=3e-5, substeps=2, device="cpu")


def test_watchdog_stops_a_run_gone_non_finite():
    """The port's scene checks for NaNs every 1000 steps, as lbm_tpu's
    docstring says its runs stop (lbm_tpu's scene itself returns the
    non-finite fields): F = 0.2 on L = 16 is non-finite by step 1000."""
    with pytest.raises(FloatingPointError, match="after step 1000"):
        scene.ring_cavity(L=16, T=1000, force=0.2, device="cpu")


def test_cli_runs_ring_cavity(tmp_path):
    """The CLI against the scene called directly."""
    out = str(tmp_path / "cav")
    r = subprocess.run(
        [sys.executable, "-m", "lbm_tpu_torch.run", "ring_cavity", "--x64", "--device", "cpu",
         "--set", "L=32", "--set", "T=20", "--set", "force=3e-5", "--out", out],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "steps=20" in r.stderr
    want = scene.ring_cavity(L=32, T=20, force=3e-5, device="cpu", dtype=torch.float64)
    _close(torch.as_tensor(np.load(f"{out}-f.npy")), want.f.numpy(), 0.0)
    assert np.load(f"{out}-u.npy").shape == (2, 32, 32)
