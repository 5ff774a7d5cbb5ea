"""The D3Q19 slice of lbm_tpu_torch against lbm_tpu: ops/d3q19, the plain
versions of CUDA kernels 25 and 26 (kernels/d3q19.py), the three 3-D scenes,
the layout converters and the CLIs.

The operators are held to lbm_tpu.ops.d3q19 at 1e-13 in float64; the plain
steps to lbm_tpu's Pallas kernels in interpret mode (the planes and the lanes
layout) at 1e-13, at the shapes lbm_tpu's own tests use
(tests/test_d3q19.py); the scenes to lbm_tpu's jnp scenes at 1e-12 (f, rho,
u, l2).  Kernels 25 and 26 are held to the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels.d3q19_lanes_pallas import make_d3q19_lanes_step as j_lanes_step
from lbm_tpu.kernels.d3q19_lanes_pallas import pack_lanes as j_pack_lanes
from lbm_tpu.kernels.d3q19_pallas import make_d3q19_fused_step as j_fused_step
from lbm_tpu.ops import d3q19 as jd
from lbm_tpu.scenes import three_d as j3

from lbm_tpu_torch import run
from lbm_tpu_torch.io import convert
from lbm_tpu_torch.kernels import d3q19 as kd
from lbm_tpu_torch.ops import d3q19 as td
from lbm_tpu_torch.scenes import three_d as t3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
# the four wall sets of kernel 25: make_d3q19_fused_step keywords
WALLS = {
    "periodic": dict(),
    "channel": dict(x_walls=True, force_z=1e-5),
    "cavity": dict(x_walls=True, y_walls=True, z_walls=True, lid_u=0.05),
    "cavity_no_x": dict(y_walls=True, z_walls=True, lid_u=0.05),
}


def _close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def _noisy(X, Y, Z, seed):
    """An equilibrium at a seeded flow (|u| <= 0.02, rho within 5%), every
    population times 1 + U(-0.03, 0.03): off equilibrium, float64 numpy."""
    rng = np.random.default_rng(seed)
    f = np.asarray(jd.equilibrium(jnp.asarray(rng.uniform(-0.02, 0.02, (3, X, Y, Z))),
                                  jnp.asarray(rng.uniform(0.95, 1.05, (X, Y, Z)))))
    return f * rng.uniform(0.97, 1.03, f.shape)


def _jnp_step(g, omega, force_z=0.0, x_walls=False, y_walls=False, z_walls=False,
              lid_u=0.0):
    """lbm_tpu's jnp step of its scenes (scenes/three_d.py:127-138 and
    :254-268) from lbm_tpu.ops.d3q19."""
    rho = jd.calc_rho(g)
    u = jd.calc_u(g, rho)
    fvec = jnp.asarray([0.0, 0.0, force_z], jnp.float64)[:, None, None, None]
    if force_z:
        u = u + 0.5 * fvec / rho[None]
    f_coll = jd.bgk_collision(g, jd.equilibrium(u, rho), omega)
    if force_z:
        f_coll = f_coll + jd.guo_source(u, fvec * jnp.ones_like(rho)[None], omega)
    f_new = jd.stream(f_coll)
    if x_walls:
        f_new = jd.bounce_back(f_new, f_coll, 0, "lo")
        f_new = jd.bounce_back(f_new, f_coll, 0, "hi")
    if y_walls:
        f_new = jd.bounce_back(f_new, f_coll, 1, "lo")
        f_new = jd.bounce_back(f_new, f_coll, 1, "hi",
                               u_wall=(0.0, 0.0, lid_u) if lid_u else None)
    if z_walls:
        f_new = jd.bounce_back(f_new, f_coll, 2, "lo")
        f_new = jd.bounce_back(f_new, f_coll, 2, "hi")
    return f_new


def test_constants_are_lbm_tpu_s():
    assert td.Q == jd.Q and td.ICS2 == jd.ICS2 and td.ICS4 == jd.ICS4
    for name in ("C3", "W3", "OPP3"):
        assert np.array_equal(getattr(td, name), getattr(jd, name)), name
    assert td.X_OUT_LO == jd.X_OUT_LO and td.X_OUT_HI == jd.X_OUT_HI
    for axis in range(3):
        for side in ("lo", "hi"):
            assert td.wall_ks(axis, side) == jd.wall_ks(axis, side)


@pytest.mark.parametrize("op", ["calc_rho", "calc_u", "equilibrium", "bgk_collision",
                                "guo_source", "stream", "bounce_back_x", "bounce_back"])
def test_ops_match_lbm_tpu(op):
    X, Y, Z = 4, 5, 6
    f = _noisy(X, Y, Z, seed=3)
    tf = torch.as_tensor(f)
    rng = np.random.default_rng(4)
    u = rng.uniform(-0.03, 0.03, (3, X, Y, Z))
    rho = rng.uniform(0.9, 1.1, (X, Y, Z))
    force = rng.uniform(-1e-4, 1e-4, (3, X, Y, Z))
    tu, trho, tforce = (torch.as_tensor(a) for a in (u, rho, force))
    g = _noisy(X, Y, Z, seed=5)
    pairs = {
        "calc_rho": lambda: (td.calc_rho(tf), jd.calc_rho(jnp.asarray(f))),
        "calc_u": lambda: (td.calc_u(tf, trho), jd.calc_u(jnp.asarray(f), jnp.asarray(rho))),
        "equilibrium": lambda: (td.equilibrium(tu, trho),
                                jd.equilibrium(jnp.asarray(u), jnp.asarray(rho))),
        "bgk_collision": lambda: (td.bgk_collision(tf, torch.as_tensor(g), 1.3),
                                  jd.bgk_collision(jnp.asarray(f), jnp.asarray(g), 1.3)),
        "guo_source": lambda: (td.guo_source(tu, tforce, 1.3),
                               jd.guo_source(jnp.asarray(u), jnp.asarray(force), 1.3)),
        "stream": lambda: (td.stream(tf), jd.stream(jnp.asarray(f))),
    }
    if op == "bounce_back_x":
        for side in ("lo", "hi"):
            _close(td.bounce_back_x(tf, torch.as_tensor(g), side),
                   jd.bounce_back_x(jnp.asarray(f), jnp.asarray(g), side), 0.0)
    elif op == "bounce_back":
        for axis in range(3):
            for side in ("lo", "hi"):
                for u_wall in (None, (0.01, -0.02, 0.05)):
                    _close(td.bounce_back(tf, torch.as_tensor(g), axis, side, u_wall=u_wall),
                           jd.bounce_back(jnp.asarray(f), jnp.asarray(g), axis, side,
                                          u_wall=u_wall), 1e-13)
    else:
        got, want = pairs[op]()
        _close(got, want, 1e-13)


@pytest.mark.parametrize("walls,shape,substeps", [
    ("channel", (8, 32, 128), 1),      # tests/test_d3q19.py:101-111
    ("periodic", (8, 32, 128), 1),     # :113-142
    ("cavity", (2, 32, 128), 1),       # :184-211
    ("cavity_no_x", (2, 32, 128), 1),
])
def test_plain_step_matches_pallas_kernel(walls, shape, substeps):
    """The plain version of kernel 25, ``substeps`` steps from a noisy state,
    against lbm_tpu's depth-as-planes kernel in interpret mode: 1e-13 in
    float64."""
    X, Y, Z = shape
    kw, omega = WALLS[walls], 1.0 / 0.7
    f = _noisy(X, Y, Z, seed=X + Y + Z + substeps)
    kstep = j_fused_step(X, Y, Z, omega=omega, substeps=substeps, dtype=jnp.float64,
                         block_rows=8, interpret=True, **kw)
    want = np.asarray(j3._unpack(kstep(j3._pack(jnp.asarray(f), X, Y, Z)), X, Y, Z))
    step = kd.make_d3q19_fused_step(X, Y, Z, omega=omega, substeps=substeps, dtype=F64, **kw)
    got = step(torch.as_tensor(f))
    _close(got, want, 1e-13)
    ref = jnp.asarray(f)
    for _ in range(substeps):
        ref = _jnp_step(ref, omega, **kw)
    _close(got, ref, 1e-13)


@pytest.mark.parametrize("walls,substeps", [("channel", 1), ("periodic", 3), ("cavity", 1)])
def test_lanes_plain_step_matches_lanes_kernel(walls, substeps):
    """The plain version of kernel 26 on the lanes state (19, Y, X*Z), lane =
    z*X + x, against lbm_tpu's lanes kernel in interpret mode at
    tests/test_d3q19.py:252-330's 4x32x32: 1e-13 in float64; unpacked, it
    is the planes step bit for bit."""
    X, Y, Z = 4, 32, 32
    kw, omega = WALLS[walls], 1.0 / 0.8
    f = _noisy(X, Y, Z, seed=11 + substeps)
    S = kd.pack_lanes(torch.as_tensor(f))
    _close(S, j_pack_lanes(jnp.asarray(f), X, Y, Z), 0.0)
    kstep = j_lanes_step(X, Y, Z, omega=omega, substeps=substeps, dtype=jnp.float64,
                         block_rows=8, interpret=True, **kw)
    got = kd.make_d3q19_lanes_step(X, Y, Z, omega=omega, substeps=substeps, dtype=F64,
                                   **kw)(S)
    _close(got, kstep(jnp.asarray(S.numpy())), 1e-13)
    planes = kd.make_d3q19_fused_step(X, Y, Z, omega=omega, substeps=substeps, dtype=F64,
                                      **kw)(torch.as_tensor(f))
    assert torch.equal(kd.unpack_lanes(got, X, Y, Z), planes)


@pytest.mark.parametrize("scene,kw", [
    ("poiseuille_3d", dict(X=6, Y=3, Z=4, T=40, force=1e-4)),
    ("taylor_green_3d", dict(N=8, T=30)),
    ("lid_cavity_3d", dict(X=3, Y=8, Z=10, T=30, Re=20.0, x_walls=True)),
    ("lid_cavity_3d", dict(X=3, Y=8, Z=10, T=30, Re=20.0, x_walls=False)),
])
def test_scenes_match_lbm_tpu_jnp_scenes(scene, kw):
    """Each scene in float64 on the CPU against lbm_tpu's jnp scene: f, rho,
    u and l2 at 1e-12."""
    got = getattr(t3, scene)(device="cpu", dtype=F64, **kw)
    want = getattr(j3, scene)(fused=False, dtype=jnp.float64, **kw)
    for name in ("f", "rho", "u"):
        _close(getattr(got, name), getattr(want, name), 1e-12)
    assert got.steps == want.steps == kw["T"]
    if want.l2 is None:
        assert got.l2 is None
    else:
        assert abs(got.l2 - want.l2) <= 1e-12, (got.l2, want.l2)


def test_lid_edge_cells():
    """At the lid's edges (y = Y-1, z = 0 and Z-1) the z rule overwrites the
    lid's corrected reflection with the plain one (d3q19_pallas.py:226-242):
    there the step holds coll[k] exactly, one cell in the lid holds
    coll[k] - 6 w_k c_z,k u_lid; both as lbm_tpu's jnp step gives them."""
    X, Y, Z, lid, omega = 2, 6, 7, 0.05, 1.0 / 0.7
    f = torch.as_tensor(_noisy(X, Y, Z, seed=21))
    got = kd.plain_d3q19_step(f, omega=omega, **WALLS["cavity"])
    coll = torch.stack(kd.collide(list(f), omega, 0.0))
    # q = 18 = (0, -1, +1) reflects k = 17 = (0, +1, -1) at the lid and the
    # z = 0 face; q = 16 = (0, -1, -1) reflects k = 15 = (0, +1, +1) at the
    # lid and the z = Z-1 face
    assert torch.equal(got[18, :, -1, 0], coll[17, :, -1, 0])
    assert torch.equal(got[16, :, -1, -1], coll[15, :, -1, -1])
    corr = 6.0 * td.WQ[15] * lid
    assert torch.equal(got[18, :, -1, 1], coll[17, :, -1, 1] + corr)
    assert torch.equal(got[16, :, -1, -2], coll[15, :, -1, -2] - corr)
    want = np.asarray(_jnp_step(jnp.asarray(f.numpy()), omega, **WALLS["cavity"]))
    for z in (0, 1, -2, -1):
        _close(got[:, :, -1, z], want[:, :, -1, z], 1e-13)
    _close(got, want, 1e-13)


def test_quasi_2d_x_invariance():
    """x-periodic cavity: every depth slice stays identical (1e-13), mass is
    kept, and a primary vortex forms (tests/test_d3q19.py:145-163 at a
    smaller grid)."""
    r = t3.lid_cavity_3d(X=3, Y=20, Z=20, T=600, Re=100.0, u_lid=0.05, x_walls=False,
                         device="cpu", dtype=F64)
    f = r.f.numpy()
    assert np.isfinite(f).all()
    assert np.abs(f - f[:, :1]).max() < 1e-13
    assert abs(float(r.rho.sum()) / (3 * 20 * 20) - 1.0) < 1e-12
    uz = r.u[2, 0].numpy()
    assert uz[-2].mean() > 0.01 and uz[5].mean() < 0.0


def test_x_mirror_symmetry():
    """With end walls the cavity is mirror-symmetric in x: f(x) equals its
    x-reflection with the x-reversed populations swapped (1e-12;
    tests/test_d3q19.py:165-181 at a smaller grid)."""
    r = t3.lid_cavity_3d(X=6, Y=12, Z=12, T=300, Re=50.0, u_lid=0.05, x_walls=True,
                         device="cpu", dtype=F64)
    mirror = [next(j for j in range(19) if (td.C3[:, j] == (-td.C3[0, k], td.C3[1, k],
                                                             td.C3[2, k])).all())
              for k in range(19)]
    f = r.f.numpy()
    assert np.abs(f - f[mirror, ::-1]).max() < 1e-12


def test_taylor_green_z_invariance():
    """The z-invariant Taylor-Green vortex stays z-invariant: u_z stays at
    round-off and every z slice equals the first."""
    r = t3.taylor_green_3d(N=12, T=100, device="cpu", dtype=F64)
    assert r.u[2].abs().max() < 1e-12
    f = r.f.numpy()
    assert np.abs(f - f[..., :1]).max() < 1e-13


def test_converters_take_lbm_tpu_layouts():
    X, Y, Z = 3, 4, 5
    f = _noisy(X, Y, Z, seed=9)
    for got in (convert.d3q19_from_numpy(f, "cpu", F64),
                convert.d3q19_from_planes(np.asarray(j3._pack(jnp.asarray(f), X, Y, Z)),
                                          "cpu", F64),
                convert.d3q19_from_lanes(np.asarray(j_pack_lanes(jnp.asarray(f), X, Y, Z)), X,
                                         "cpu", F64)):
        assert torch.equal(got, torch.as_tensor(f))
    assert torch.equal(kd.unpack_lanes(kd.pack_lanes(torch.as_tensor(f)), X, Y, Z),
                       torch.as_tensor(f))
    with pytest.raises(ValueError, match="planes"):
        convert.d3q19_from_planes(np.zeros((20, 2, 2)), "cpu", F64)
    with pytest.raises(ValueError, match="lanes"):
        convert.d3q19_from_lanes(np.zeros((19, 2, 7)), 2, "cpu", F64)
    with pytest.raises(ValueError, match="D3Q19"):
        convert.d3q19_from_numpy(np.zeros((9, 2, 2, 2)), "cpu", F64)


def test_steps_reject_what_they_do_not_take():
    with pytest.raises(ValueError, match="substeps"):
        kd.make_d3q19_fused_step(4, 4, 4, omega=1.0, substeps=9)
    with pytest.raises(ValueError, match="walled"):
        kd.make_d3q19_fused_step(1, 4, 4, omega=1.0, x_walls=True)
    with pytest.raises(ValueError, match="walled"):
        kd.make_d3q19_lanes_step(4, 4, 1, omega=1.0, z_walls=True)
    with pytest.raises(ValueError, match="lid_u needs y_walls"):
        kd.make_d3q19_fused_step(4, 4, 4, omega=1.0, lid_u=0.1)
    step = kd.make_d3q19_fused_step(2, 3, 4, omega=1.0, dtype=F64)
    with pytest.raises(ValueError, match="step built for"):
        step(torch.zeros((19, 2, 3, 5), dtype=F64))
    with pytest.raises(ValueError, match="step built for"):
        step(torch.zeros((19, 2, 3, 4), dtype=torch.float32))
    # a periodic axis of one cell is a grid the step takes
    f = torch.as_tensor(_noisy(1, 3, 1, seed=2))
    out = kd.make_d3q19_fused_step(1, 3, 1, omega=1.0, dtype=F64)(f)
    assert torch.isfinite(out).all()
    # the launch itself refuses a CPU tensor: the wrapper sends those to the
    # plain version
    with pytest.raises(ValueError, match="CUDA"):
        kd.launch_d3q19(kd.D3Q19, f, 1, 3, 1, 1, kd.d3q19_constants(1.0, 0.0, 0.0, F64), 0)


def test_scenes_reject_what_they_do_not_take():
    for scene, kw in ((t3.poiseuille_3d, dict(X=4, Y=2, Z=2)),
                      (t3.taylor_green_3d, dict(N=4)),
                      (t3.lid_cavity_3d, dict(X=2, Y=4, Z=4))):
        with pytest.raises(NotImplementedError, match="item 14"):
            scene(T=2, mesh_shape=(2, 1), device="cpu", **kw)
        with pytest.raises(ValueError, match="divisible by substeps"):
            scene(T=5, substeps=2, device="cpu", **kw)


def test_new_modules_load_no_jax():
    code = ("import sys\n"
            "import lbm_tpu_torch.ops.d3q19, lbm_tpu_torch.kernels.d3q19\n"
            "import lbm_tpu_torch.scenes.three_d, lbm_tpu_torch.io.checkpoint\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'lbm_tpu' or m.startswith('lbm_tpu.')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("scene,args,kw", [
    ("poiseuille_3d", ["--set", "X=6", "--set", "Y=2", "--set", "Z=2", "--set", "T=20"],
     dict(X=6, Y=2, Z=2, T=20)),
    ("taylor_green_3d", ["--set", "N=6", "--set", "T=10"], dict(N=6, T=10)),
    ("lid_cavity_3d", ["--set", "X=2", "--set", "Y=6", "--set", "Z=6", "--set", "T=10",
                       "--set", "substeps=2"], dict(X=2, Y=6, Z=6, T=10, substeps=2)),
])
def test_cli_runs_3d_scenes(tmp_path, scene, args, kw):
    """The CLI lists the scene, prints l2 where the scene has one and writes
    the fields, as the scene called directly gives them."""
    assert run._scenes()[scene] is getattr(t3, scene)
    out = str(tmp_path / scene)
    r = subprocess.run(
        [sys.executable, "-m", "lbm_tpu_torch.run", scene, "--x64", "--device", "cpu",
         *args, "--out", out],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    want = getattr(t3, scene)(device="cpu", dtype=F64, **kw)
    assert f"steps={kw['T']}" in r.stderr
    if want.l2 is not None:
        assert f"l2={want.l2:g}" in r.stderr
    _close(torch.as_tensor(np.load(f"{out}-f.npy")), want.f.numpy(), 0.0)


def test_cli_lists_32_scenes():
    assert len(run._scenes()) == 32
