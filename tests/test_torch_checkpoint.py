"""Checkpoint/resume in lbm_tpu_torch (io/checkpoint, scenes/_common.py
drive_recorded) against lbm_tpu/io/checkpoint.py and
tests/test_checkpoint_scenes.py: the file round trip and pruning, the two
packages reading each other's checkpoints, a resumed run bit-identical to
the uninterrupted one in five scenes (the series and the trajectory too),
the shape check, and the CLI flags.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.io import checkpoint as jck
from lbm_tpu.scenes import thermal as jth
from lbm_tpu.scenes import three_d as j3

from lbm_tpu_torch import run
from lbm_tpu_torch.io import checkpoint as ck
from lbm_tpu_torch.scenes import obstacles, shan_chen, thermal, three_d, ulbm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


def test_save_load_round_trip_and_pruning(tmp_path):
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((3, 4, 5)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((7,)))
    path = str(tmp_path / "sub" / "x.npz")
    ck.save(path, (a, b), step=12)
    assert not os.path.exists(path + ".tmp")
    (a2, b2), step = ck.load(path, (a, b))
    assert step == 12 and torch.equal(a2, a) and torch.equal(b2, b)
    assert a2.dtype == torch.float32 and b2.dtype == F64
    (a3, b3), _ = ck.load(path, (a.double(), None))  # like's dtype; None as stored
    assert a3.dtype == F64 and torch.equal(a3, a.double()) and torch.equal(b3, b)

    d = str(tmp_path / "ck")
    assert ck.latest(d) is None
    cp = ck.Checkpointer(d, every=10, keep=2)
    assert cp.restore_latest((a,)) == (None, None)
    for s in (5, 10, 20, 25, 30):
        assert cp.maybe_save(s, (a * s,)) == (s % 10 == 0)
    assert sorted(os.listdir(d)) == ["ckpt-20.npz", "ckpt-30.npz"]
    assert ck.latest(d) == os.path.join(d, "ckpt-30.npz")
    (got,), step = cp.restore_latest((a,))
    assert step == 30 and torch.equal(got, a * 30)
    cp.force_save(33, (a,))
    assert sorted(os.listdir(d)) == ["ckpt-30.npz", "ckpt-33.npz"]


def test_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "x.npz")
    ck.save(path, (torch.zeros((19, 2, 3, 4)),), step=1)
    with pytest.raises(ValueError, match="shape"):
        ck.load(path, (torch.zeros((19, 2, 3, 5)),))
    with pytest.raises(ValueError, match="leaves"):
        ck.load(path, (torch.zeros((19, 2, 3, 4)), None))


def test_files_read_across_packages(tmp_path):
    """The same carry saved by either package loads in the other, leaf for
    leaf, with its step."""
    rng = np.random.default_rng(1)
    f = rng.standard_normal((19, 2, 3, 4))
    series = rng.standard_normal((5, 3))
    p_port, p_jax = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    ck.save(p_port, (torch.as_tensor(f), torch.as_tensor(series)), step=40)
    jck.save(p_jax, (jnp.asarray(f), series), step=40)
    (jf, js), jstep = jck.load(p_port, (jnp.zeros_like(f), np.zeros_like(series)))
    assert jstep == 40
    np.testing.assert_array_equal(np.asarray(jf), f)
    np.testing.assert_array_equal(np.asarray(js), series)
    (tf, ts), tstep = ck.load(p_jax, (torch.zeros((19, 2, 3, 4), dtype=F64), None))
    assert tstep == 40
    assert torch.equal(tf, torch.as_tensor(f)) and torch.equal(ts, torch.as_tensor(series))


def test_resume_across_packages_on_the_jnp_path(tmp_path):
    """taylor_green_3d interrupted in one package and resumed in the other:
    within 1e-12 of the other package's uninterrupted run (the two paths
    round differently, so not bit for bit)."""
    kw = dict(N=8, tau=0.8)
    j_ref = j3.taylor_green_3d(T=50, fused=False, dtype=jnp.float64, **kw)
    t_ref = three_d.taylor_green_3d(T=50, device="cpu", dtype=F64, **kw)
    d1, d2 = str(tmp_path / "from_jax"), str(tmp_path / "from_port")
    j3.taylor_green_3d(T=30, fused=False, dtype=jnp.float64, checkpoint_dir=d1,
                       checkpoint_every=10, **kw)
    got = three_d.taylor_green_3d(T=50, device="cpu", dtype=F64, checkpoint_dir=d1,
                                  checkpoint_every=10, **kw)
    assert np.abs(got.f.numpy() - np.asarray(j_ref.f)).max() <= 1e-12
    three_d.taylor_green_3d(T=30, device="cpu", dtype=F64, checkpoint_dir=d2,
                            checkpoint_every=10, **kw)
    back = j3.taylor_green_3d(T=50, fused=False, dtype=jnp.float64, checkpoint_dir=d2,
                              checkpoint_every=10, **kw)
    assert np.abs(np.asarray(back.f) - t_ref.f.numpy()).max() <= 1e-12


def _resume(scene, tmp_path, T1, T, every, **kw):
    """(uninterrupted, resumed): the scene to T, and to T1 then on to T in
    one checkpoint directory."""
    d = str(tmp_path / "ck")
    ref = scene(T=T, **kw)
    scene(T=T1, checkpoint_dir=d, checkpoint_every=every, **kw)
    assert os.listdir(d), "no checkpoint written"
    return ref, scene(T=T, checkpoint_dir=d, checkpoint_every=every, **kw)


@pytest.mark.parametrize("substeps", [1, 2])
def test_taylor_green_3d_resume(tmp_path, substeps):
    ref, res = _resume(three_d.taylor_green_3d, tmp_path, 30, 50, 10, N=8, substeps=substeps,
                       device="cpu", dtype=F64)
    assert torch.equal(res.f, ref.f) and res.l2 == ref.l2


def test_falling_cylinder_resume(tmp_path):
    """The carry (f and the rigid state) and the recorded trajectory survive
    the restart."""
    ref, res = _resume(obstacles.falling_cylinder, tmp_path, 60, 100, 30, H=48, W=48,
                       radius=5.0, center=(12.0, 24.0), rho_s=1.5, gravity=5e-5,
                       record_every=10, device="cpu", dtype=F64)
    assert torch.equal(res.f, ref.f) and torch.equal(res.center, ref.center)
    assert res.trajectory.shape == (10, 6) and torch.equal(res.trajectory, ref.trajectory)


def test_sc_flat_interface_resume(tmp_path):
    ref, res = _resume(shan_chen.sc_flat_interface, tmp_path, 60, 100, 30, H=32, W=16,
                       G=-5.0, device="cpu", dtype=F64)
    assert torch.equal(res.f, ref.f) and res.p_jump == ref.p_jump


def test_ulbm_poiseuille_resume(tmp_path):
    ref, res = _resume(ulbm.ulbm_poiseuille, tmp_path, 60, 100, 30, H=12, W=12,
                       device="cpu", dtype=F64)
    assert torch.equal(res.f, ref.f) and res.l2 == ref.l2
    with pytest.raises(ValueError, match="flat run"):
        ulbm.ulbm_poiseuille(H=12, W=12, T=10, tolerance=1e-12, checkpoint_dir="x",
                             device="cpu")


def test_rayleigh_benard_resume(tmp_path):
    """The state and the (Nu, u_rms, theta_max) series survive the restart,
    also with substeps (lbm_tpu refuses record_every with checkpoint_dir,
    scenes/thermal.py:339-341; the port's drive loop saves the series)."""
    kw = dict(H=16, W=32, Ra=5e3, amp=1e-2, record_every=10, device="cpu", dtype=F64)
    ref, res = _resume(thermal.rayleigh_benard, tmp_path, 60, 100, 30, **kw)
    assert torch.equal(res.f, ref.f) and torch.equal(res.g, ref.g)
    assert res.series.shape == (10, 3) and torch.equal(res.series, ref.series)
    assert res.nusselt == ref.nusselt
    _, res2 = _resume(thermal.rayleigh_benard, tmp_path / "s2", 60, 100, 30,
                      **dict(kw, substeps=2))
    assert torch.equal(res2.f, ref.f) and torch.equal(res2.series, ref.series)


def test_rayleigh_benard_checkpoints_stay_in_their_package(tmp_path):
    """lbm_tpu's rayleigh_benard saves its carry alone, (f, g) on the jnp
    path (scenes/thermal.py:335-381); the port's saves (S, series) with S =
    [f; g], as every drive_recorded scene does.  The port refuses lbm_tpu's
    file by its first leaf's shape (ROADMAP Queue 3)."""
    d = str(tmp_path / "ck")
    kw = dict(H=16, W=32, Ra=5e3, amp=1e-2, checkpoint_dir=d, checkpoint_every=10)
    jth.rayleigh_benard(T=20, fused=False, dtype=jnp.float64, **kw)
    assert sorted(os.listdir(d)) == ["ckpt-10.npz", "ckpt-20.npz"]
    with pytest.raises(ValueError, match="leaf 0 has shape"):
        thermal.rayleigh_benard(T=40, device="cpu", dtype=F64, **kw)


def test_checkpoint_counts_steps_in_the_state_layout(tmp_path):
    """The port's choice where lbm_tpu's fused 3-D path differs (ROADMAP
    Queue 3): the file's step counts steps, not launches, even at substeps
    2; the carry is the (19, X, Y, Z) state; and a checkpoint of another
    shape (lbm_tpu's packed (19 X, Y, Z) carry) raises instead of
    restoring."""
    d = str(tmp_path / "ck")
    three_d.lid_cavity_3d(X=2, Y=4, Z=5, T=30, substeps=2, checkpoint_dir=d,
                          checkpoint_every=10, device="cpu", dtype=F64)
    assert sorted(os.listdir(d)) == ["ckpt-20.npz", "ckpt-30.npz"]
    with np.load(os.path.join(d, "ckpt-30.npz")) as data:
        assert data["leaf_0"].shape == (19, 2, 4, 5)
    packed = str(tmp_path / "packed")
    jck.save(os.path.join(packed, "ckpt-10.npz"),
             (np.zeros((19 * 2, 4, 5)), np.zeros((0,))), step=10)
    with pytest.raises(ValueError, match="shape"):
        three_d.lid_cavity_3d(X=2, Y=4, Z=5, T=30, checkpoint_dir=packed, device="cpu",
                              dtype=F64)
    with pytest.raises(ValueError, match="multiple of substeps"):
        three_d.lid_cavity_3d(X=2, Y=4, Z=5, T=36, substeps=4, checkpoint_dir=d,
                              device="cpu", dtype=F64)


def test_cli_checkpoint_flags(tmp_path):
    """--checkpoint-dir / --checkpoint-every / --resume: --resume fails on an
    empty directory with lbm_tpu's words and resumes after a checkpointed
    run (tests/test_checkpoint_scenes.py:87-115)."""
    d = str(tmp_path / "ck")
    base = [sys.executable, "-m", "lbm_tpu_torch.run", "sc_phase_separation", "--x64",
            "--device", "cpu", "--set", "H=16", "--set", "W=16", "--checkpoint-dir", d,
            "--checkpoint-every", "20"]

    def cli(*extra):
        return subprocess.run([*base, *extra], capture_output=True, text=True, cwd=REPO,
                              timeout=300)

    r = cli("--set", "T=30", "--resume")
    assert r.returncode != 0 and "--resume: no checkpoint found in" in r.stderr
    r = cli("--set", "T=30")
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.listdir(d) == ["ckpt-20.npz"]
    r = cli("--set", "T=50", "--resume")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed" in r.stderr and sorted(os.listdir(d)) == ["ckpt-20.npz", "ckpt-40.npz"]


def test_cli_flag_checks():
    with pytest.raises(SystemExit):
        run.main(["sc_phase_separation", "--resume"])
    with pytest.raises(SystemExit):
        run.main(["horizontal_poiseuille", "--checkpoint-dir", "x", "--device", "cpu"])
