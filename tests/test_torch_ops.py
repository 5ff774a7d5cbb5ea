"""lbm_tpu_torch's plain operators, BCs and model against the lbm_tpu oracle.

The same numpy-seeded inputs go through the JAX function and its PyTorch
counterpart in float64 on the CPU; tolerance 1e-13 absolute (the two differ
only by summation order, a few ulp of values of order 1).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.boundary import bc as jbc
from lbm_tpu.core import lattice as jlat
from lbm_tpu.models.single_phase import SinglePhaseModel as JaxModel
from lbm_tpu.ops import d2q9 as jd

from lbm_tpu_torch.boundary import bc as tbc
from lbm_tpu_torch.core import lattice as tlat
from lbm_tpu_torch.io import convert
from lbm_tpu_torch.models.single_phase import SinglePhaseModel as TorchModel
from lbm_tpu_torch.ops import d2q9 as td
from lbm_tpu_torch.utils import observe, xmath

TOL = 1e-13
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(R=12, C=10, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "f": rng.uniform(0.05, 0.3, (9, R, C)),
        "u": rng.uniform(-0.1, 0.1, (2, R, C)),
        "rho": 1.0 + rng.uniform(-0.05, 0.05, (R, C)),
        "feq": rng.uniform(0.05, 0.3, (9, R, C)),
        "force": rng.uniform(-1e-3, 1e-3, (2, R, C)),
        "omega_field": rng.uniform(0.8, 1.6, (R, C)),
    }


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.as_tensor(v, dtype=torch.float64) for k, v in d.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


def test_lattice_constants_are_lbm_tpu_s():
    """The port keeps its own copy of lbm_tpu's numbers; every one is equal."""
    for name in ("C", "W", "OPP", "SPEC_X", "SPEC_Y", "M_MRT", "MI_MRT", "B_CG", "UNIT_C"):
        assert getattr(tlat, name).dtype == getattr(jlat, name).dtype, name
        np.testing.assert_array_equal(getattr(tlat, name), getattr(jlat, name))
    assert (tlat.Q, tlat.CS2, tlat.ICS2, tlat.ICS4) == \
        (jlat.Q, jlat.CS2, jlat.ICS2, jlat.ICS4)
    w = tlat.tensor(tlat.W, device="cpu", dtype=torch.float32)
    assert w.dtype == torch.float32 and w.device.type == "cpu"
    np.testing.assert_array_equal(w.numpy(), jlat.W.astype(np.float32))


OPS = {
    "calc_rho": lambda m, a: m.calc_rho(a["f"]),
    "calc_momentum": lambda m, a: m.calc_momentum(a["f"]),
    "calc_u": lambda m, a: m.calc_u(a["f"], a["rho"]),
    "equilibrium": lambda m, a: m.equilibrium(a["u"], a["rho"]),
    "incomp_equilibrium": lambda m, a: m.incomp_equilibrium(a["u"], a["rho"]),
    "bgk_collision": lambda m, a: m.bgk_collision(a["f"], a["feq"], 1.3),
    "bgk_collision_field": lambda m, a: m.bgk_collision(a["f"], a["feq"],
                                                        a["omega_field"]),
    "stream": lambda m, a: m.stream(a["f"]),
    "guo_uniform": lambda m, a: m.guo_source(a["u"], a["force"][:, 0, 0], 1.2),
    "guo_field": lambda m, a: m.guo_source(a["u"], a["force"], 1.2),
    "guo_weak_per_cell_omega": lambda m, a: m.guo_source(
        a["u"], a["force"], a["omega_field"], ics2=1.0 / 3.0, ics4=1.0 / 9.0),
    "abb_uniform": lambda m, a: m.abb_coefficient(a["u"][:, 0, 0]),
    "abb_per_node": lambda m, a: m.abb_coefficient(a["u"][:, 0, :]),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_d2q9_op_matches_lbm_tpu(name):
    fields = _fields()
    got = OPS[name](td, _torch(fields))
    want = OPS[name](jd, _jax(fields))
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == torch.float64
    _close(got, want)


def test_shift_table_matches_lbm_tpu():
    assert td.SHIFTS == jd.SHIFTS


@pytest.mark.parametrize("lane", [slice(None), slice(1, -1)], ids=["full", "inner"])
@pytest.mark.parametrize("side", ["row0", "rowN", "col0", "colN"])
def test_bounce_back_matches_lbm_tpu(side, lane):
    a = _fields(seed=1)
    b = _fields(seed=2)
    got = tbc.bounce_back(_torch(a)["f"], _torch(b)["f"], side, lane)
    want = jbc.bounce_back(_jax(a)["f"], _jax(b)["f"], side, lane)
    _close(got, want, tol=0.0)


def test_bounce_back_leaves_inputs_alone():
    a = _torch(_fields(seed=1))["f"]
    before = a.clone()
    tbc.bounce_back(a, a * 2.0, "col0")
    assert torch.equal(a, before)


@pytest.mark.parametrize("eq", ["incomp_equilibrium", "equilibrium"])
@pytest.mark.parametrize("axis", [0, 1])
def test_pressure_periodic_matches_lbm_tpu(axis, eq):
    a = _fields(seed=3)
    t, j = _torch(a), _jax(a)
    got = tbc.pressure_periodic(t["f"], t["feq"], t["u"], 1.02, 0.99,
                                axis=axis, eq_fn=getattr(td, eq))
    want = jbc.pressure_periodic(j["f"], j["feq"], j["u"], 1.02, 0.99,
                                 axis=axis, eq_fn=getattr(jd, eq))
    _close(got, want)


def _models(kind):
    """The same SinglePhaseModel configuration built in both packages."""
    def build(pkg_bc, pkg_d2q9, Model):
        if kind == "periodic":
            return Model(omega=1.0 / 0.8)
        if kind == "gravity":
            return Model(omega=1.0 / 0.9, incompressible=True,
                         force=(-3e-4, 1e-4),
                         post_stream_bcs=(
                             lambda fa, fc: pkg_bc.bounce_back(fa, fc, "rowN"),
                             lambda fa, fc: pkg_bc.bounce_back(fa, fc, "row0")))
        if kind == "custom_collision":
            return Model(omega=1.1, collision=lambda f, fe: 0.5 * (f + fe),
                         pre_stream_bcs=(
                             lambda fc, fe, u, rho: pkg_bc.pressure_periodic(
                                 fc, fe, u, 1.01, 1.0, axis=1,
                                 eq_fn=pkg_d2q9.equilibrium),))
        raise ValueError(kind)

    return build(tbc, td, TorchModel), build(jbc, jd, JaxModel)


@pytest.mark.parametrize("kind", ["periodic", "gravity", "custom_collision"])
def test_single_phase_model_matches_lbm_tpu(kind):
    tm, jm = _models(kind)
    a = _fields(seed=4)
    u0 = a["u"] * 0.5
    ft = tm.init(12, 10, device="cpu", dtype=torch.float64, rho0=1.01,
                 u0=torch.as_tensor(u0))
    fj = jm.init(12, 10, dtype=jnp.float64, rho0=1.01, u0=jnp.asarray(u0))
    _close(ft, fj)
    _close(tm.run_chunk(ft, 3), jm.run_chunk(fj, 3))
    rho_t, u_t = tm.macroscopics(ft)
    rho_j, u_j = jm.macroscopics(fj)
    _close(rho_t, rho_j)
    _close(u_t, u_j)


def test_model_init_takes_explicit_dtype():
    f = TorchModel(omega=1.0).init(4, 5, device="cpu", dtype=torch.float32)
    assert f.dtype == torch.float32 and tuple(f.shape) == (9, 4, 5)


def test_state_round_trip():
    f = _fields(seed=5)["f"]
    t = convert.state_from_numpy(f, device="cpu", dtype=torch.float64)
    assert t.is_contiguous() and t.dtype == torch.float64
    back = convert.state_to_numpy(t)
    np.testing.assert_array_equal(back, f)
    ref = np.moveaxis(f, 0, -1)  # the reference's {R, C, 9}
    np.testing.assert_array_equal(
        convert.from_reference_layout(ref, device="cpu",
                                      dtype=torch.float64).numpy(), f)


@pytest.mark.parametrize("bad", [np.zeros((8, 4, 4)), np.zeros((9, 4)),
                                 np.zeros((9, 4, 4), np.int64)])
def test_state_from_numpy_rejects(bad):
    with pytest.raises((ValueError, TypeError)):
        convert.state_from_numpy(bad, device="cpu", dtype=torch.float64)


def test_import_loads_no_jax():
    code = ("import sys\n"
            "import lbm_tpu_torch, lbm_tpu_torch.run, lbm_tpu_torch.io.convert\n"
            "import lbm_tpu_torch.scenes.channel, lbm_tpu_torch.kernels.bgk\n"
            "import lbm_tpu_torch.scenes.ulbm, lbm_tpu_torch.kernels.les\n"
            "import lbm_tpu_torch.models.kbc, lbm_tpu_torch.models.les\n"
            "import lbm_tpu_torch.models.mrt_cg, lbm_tpu_torch.kernels.mrtcg\n"
            "import lbm_tpu_torch.scenes.multiphase, lbm_tpu_torch.ops.gradients\n"
            "import lbm_tpu_torch.core.params, lbm_tpu_torch.boundary.bc\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'lbm_tpu' or m.startswith('lbm_tpu.')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_observe_and_dispatch_defaults():
    f = torch.zeros((9, 3, 3), dtype=torch.float64)
    observe.check_finite(f, 1)
    f[4, 1, 2] = float("nan")
    with pytest.raises(FloatingPointError, match="step 7"):
        observe.check_finite(f, 7)
    meter = observe.StepMeter(9, "cpu", total_steps=10)
    meter.update(5)
    assert meter.steps == 5 and meter.mlups() > 0
    assert "step 5/10" in meter.summary()
    assert xmath.default_float() == torch.float64
    assert xmath.default_float(torch.float32) == torch.float32
    assert not xmath.resolve_fused(f)
    assert xmath.default_device("cpu").type == "cpu"


def test_default_device_is_the_card():
    """Entry points run on the card unless the caller asks for the CPU."""
    assert xmath.default_device() == torch.device("cuda")
    assert xmath.default_device("cpu") == torch.device("cpu")
    assert xmath.default_device(torch.device("cpu")).type == "cpu"


def test_port_imports_alone(tmp_path):
    """A copy of lbm_tpu_torch/ with no lbm_tpu/ beside it imports every one
    of its modules: the port reads no file of the JAX package."""
    import shutil

    src = os.path.join(REPO, "lbm_tpu_torch")
    shutil.copytree(src, tmp_path / "lbm_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    modules = sorted(
        "lbm_tpu_torch." + os.path.relpath(os.path.join(d, f), src)[:-3].replace(os.sep, ".")
        for d, _, files in os.walk(src) if "_build" not in d for f in files
        if f.endswith(".py"))
    code = ("import importlib, sys\n"
            f"mods = {modules!r}\n"
            "for m in mods:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "import lbm_tpu_torch\n"
            f"assert lbm_tpu_torch.__file__.startswith({str(tmp_path)!r}), lbm_tpu_torch.__file__\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'lbm_tpu' or m.startswith('lbm_tpu.')]\n"
            "assert not bad, bad\n"
            "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout.split()[-1]) >= 25
