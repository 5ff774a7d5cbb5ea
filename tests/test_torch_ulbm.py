"""The ULBM slice of lbm_tpu_torch (scenes/ulbm.py and the CLI) against
lbm_tpu's jnp path (``fused=False``) in float64 on the CPU: the same step
counts, the same watcher stop step and watch list, the same l2 and the
same final state at 1e-12 absolute.  On the card each scene steps through
its CUDA kernel (tests/test_torch_cuda.py, chip_smoke.py phase 5).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.scenes import ulbm as julbm

from lbm_tpu_torch import run
from lbm_tpu_torch.kernels import channel, collide_stream, les
from lbm_tpu_torch.scenes import ulbm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


SCENES = {
    "ulbm_poiseuille": dict(H=24, W=24, T=400, nu=1e-2),
    "ulbm_double_shear": dict(H=32, W=32, T=50),
    "les_double_shear": dict(H=32, W=24, T=200, u_max=0.1),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_scene_matches_lbm_tpu(scene):
    kernels = (channel.CHANNEL_KBC, collide_stream.COLLIDE_STREAM_KBC,
               les.COLLIDE_STREAM_LES)
    before = [k.launches for k in kernels]
    got = getattr(ulbm, scene)(device="cpu", dtype=torch.float64, **SCENES[scene])
    want = getattr(julbm, scene)(fused=False, dtype=jnp.float64, **SCENES[scene])
    assert [k.launches for k in kernels] == before  # CPU state: plain path
    assert got.steps == want.steps == SCENES[scene]["T"]
    assert got.f.dtype == torch.float64 and np.isfinite(got.f.numpy()).all()
    _close(got.f, want.f)
    _close(got.m0, want.m0)
    _close(got.m1, want.m1)
    if scene == "ulbm_poiseuille":
        assert got.l2 == pytest.approx(want.l2, rel=0, abs=1e-12)
        assert got.watch is None and want.watch is None


def test_ulbm_poiseuille_watcher_matches_lbm_tpu():
    """The convergence watcher on the geometry of
    tests/test_ulbm_scenes.py::test_ulbm_poiseuille_convergence_watcher,
    kept short: a tolerance loose enough to stop inside 3000 steps.  Both
    packages stop at the same step with the same watch list.  The mean u_x
    after the first step is round-off (the pressure rows carry no net
    momentum yet), so the second sample, a ratio to it, is only checked to
    be huge in both."""
    kw = dict(H=8, W=11, T=3000, nu=5e-3, u_max=0.01, tolerance=0.05,
              t_interval=100)
    got = ulbm.ulbm_poiseuille(device="cpu", dtype=torch.float64, **kw)
    want = julbm.ulbm_poiseuille(fused=False, dtype=jnp.float64, **kw)
    assert got.steps == want.steps < 3000
    assert [s for s, _ in got.watch] == [s for s, _ in want.watch]
    assert got.watch[-1][1] < 0.05 <= got.watch[-2][1]
    assert got.watch[1][1] > 1e10 and want.watch[1][1] > 1e10
    rel = [r for _, r in got.watch]
    np.testing.assert_allclose(rel[:1] + rel[2:],
                               [r for i, (_, r) in enumerate(want.watch) if i != 1],
                               rtol=1e-9)
    _close(got.f, want.f)
    assert got.l2 == pytest.approx(want.l2, rel=0, abs=1e-12)


def test_double_shear_init_matches_lbm_tpu():
    m0, u = ulbm.double_shear_init(16, 12, 0.04, device="cpu", dtype=torch.float32)
    jm0, ju = julbm.double_shear_init(16, 12, 0.04, dtype=jnp.float32)
    assert m0.dtype == u.dtype == torch.float32
    np.testing.assert_array_equal(m0.numpy(), np.asarray(jm0))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))


def test_les_double_shear_substeps_and_their_check():
    one = ulbm.les_double_shear(H=16, W=16, T=40, u_max=0.1, device="cpu")
    four = ulbm.les_double_shear(H=16, W=16, T=40, u_max=0.1, substeps=4,
                                 device="cpu")
    assert four.steps == 40 and torch.equal(four.f, one.f)
    with pytest.raises(ValueError, match="divisible"):
        ulbm.les_double_shear(H=16, W=16, T=41, substeps=4, device="cpu")


def test_cli_registers_the_ulbm_scenes():
    scenes = run._scenes()
    for name in ("ulbm_poiseuille", "ulbm_double_shear", "les_double_shear"):
        assert scenes[name] is getattr(ulbm, name)


def test_cli_runs_ulbm_double_shear(tmp_path):
    """The CLI end to end: a tiny float64 run on the CPU whose .npy output
    equals the scene called in process."""
    out = str(tmp_path / "ds")
    r = subprocess.run(
        [sys.executable, "-m", "lbm_tpu_torch.run", "ulbm_double_shear",
         "--x64", "--device", "cpu", "--set", "T=20", "--set", "H=12",
         "--set", "W=12", "--out", out],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    f = np.load(out + "-f.npy")
    want = ulbm.ulbm_double_shear(H=12, W=12, T=20, device="cpu",
                                  dtype=torch.float64)
    assert f.dtype == np.float64
    np.testing.assert_array_equal(f, want.f.numpy())
    assert "steps=20" in r.stderr
