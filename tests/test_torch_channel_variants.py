"""The channel variants of lbm_tpu_torch against lbm_tpu: the variant step
(CUDA kernel 9's plain version), the five kernel-9 scenes, PhysicalConfig,
the snapshot stream and the CLI flags.

On the CPU the variant step takes its plain model step.  It is held to the
Pallas make_channel_variant_step in interpret mode (float32, the tolerances
of tests/test_pallas.py's channel check), to the jnp SinglePhaseModel
composition of lbm_tpu's scenes (float64, 1e-13), and each scene to
lbm_tpu's jnp scene path (float64, the same steps, the state at 1e-12).
Kernel 9 itself is held to the plain version on the card by
tests/test_torch_cuda.py.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.boundary import bc as jbc
from lbm_tpu.core import lattice as jlat
from lbm_tpu.core.params import PhysicalConfig as JaxPhysicalConfig
from lbm_tpu.kernels.channel_pallas import make_channel_variant_step as jax_variant_step
from lbm_tpu.models import trt as jtrt
from lbm_tpu.models.single_phase import SinglePhaseModel as JaxModel
from lbm_tpu.ops import d2q9 as jd
from lbm_tpu.scenes import channel as jchannel

from lbm_tpu_torch.core.params import PhysicalConfig
from lbm_tpu_torch.io import snapshots
from lbm_tpu_torch.kernels import channel
from lbm_tpu_torch.scenes import channel as tchannel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAU = tchannel.TAU_DEFAULT
# the configurations of lbm_tpu's scenes (scenes/channel.py), with pressure
# drops and a force large enough to move every population
VARIANTS = {
    "gravity": dict(omega=1 / TAU, incompressible=True, pressure=(1.0, 1.0, 0),
                    force=(-3e-4, 0.0), col_walls="bounce"),
    "specular": dict(omega=1 / TAU, incompressible=False, pressure=(1.004, 1.0, 0),
                     col_walls="specular"),
    "free_stream": dict(omega=1 / 0.55, incompressible=True, row_walls="abb",
                        abb_u=(0.1, 0.0), col_walls="specular"),
    "free_stream_cc": dict(omega=1 / 0.55, incompressible=False, row_walls="abb",
                           abb_u=(0.1, 0.0), col_walls="specular",
                           corner_consistent=True),
    "vertical": dict(omega=1 / TAU, incompressible=False, pressure=(1.004, 1.0, 1),
                     row_walls="bounce"),
    "vertical_incomp": dict(omega=1 / TAU, incompressible=True,
                            pressure=(1.004, 1.0, 1), row_walls="bounce"),
    "trt": dict(omega=1 / 1.2, incompressible=True, pressure=(1.004, 1.0, 0),
                col_walls="bounce", omega_minus=jtrt.omega_minus_from_magic(1 / 1.2)),
}
# lbm_tpu's Pallas kernel bakes the reference's corner order in
PALLAS_VARIANTS = sorted(set(VARIANTS) - {"free_stream_cc"})


def _state(R, C, incompressible, seed=0):
    """An equilibrium at a seeded random flow, each population scaled by a
    seeded 1 + U(-3%, 3%): every population differs, so a wrong index shows."""
    rng = np.random.default_rng(seed)
    u = jnp.asarray(rng.uniform(-0.05, 0.05, (2, R, C)))
    rho = jnp.asarray(1.0 + rng.uniform(-0.01, 0.01, (R, C)))
    f = np.asarray((jd.incomp_equilibrium if incompressible else jd.equilibrium)(u, rho))
    return f * rng.uniform(0.97, 1.03, f.shape)


def _jax_model(kw, dtype=jnp.float64):
    """lbm_tpu's jnp scene composition of one variant (scenes/channel.py)."""
    eq = jd.incomp_equilibrium if kw["incompressible"] else jd.equilibrium
    pre = ()
    if kw.get("pressure"):
        rho_in, rho_out, axis = kw["pressure"]
        pre = (lambda fc, fe, u, rho: jbc.pressure_periodic(
            fc, fe, u, rho_in, rho_out, axis=axis, eq_fn=eq),)
    post = []
    if kw.get("row_walls") == "bounce":
        post += [lambda fa, fc: jbc.bounce_back(fa, fc, "rowN"),
                 lambda fa, fc: jbc.bounce_back(fa, fc, "row0")]
    elif kw.get("row_walls") == "abb":
        u_w = jnp.asarray(kw["abb_u"], dtype)
        post += [lambda fa, fc: jbc.anti_bounce_back(fa, fc, "row0", u_w),
                 lambda fa, fc: jbc.anti_bounce_back(fa, fc, "rowN", u_w)]
    lane = slice(1, -1) if kw.get("corner_consistent") else slice(None)
    if kw.get("col_walls") == "bounce":
        post += [lambda fa, fc: jbc.bounce_back(fa, fc, "colN"),
                 lambda fa, fc: jbc.bounce_back(fa, fc, "col0")]
    elif kw.get("col_walls") == "specular":
        post += [lambda fa, fc: jbc.specular(fa, fc, "colN", lane),
                 lambda fa, fc: jbc.specular(fa, fc, "col0", lane)]
    collision = None
    if kw.get("omega_minus") is not None:
        collision = lambda f, fe: jtrt.trt_collision(  # noqa: E731
            f, fe, kw["omega"], kw["omega_minus"])
    return JaxModel(omega=kw["omega"], incompressible=kw["incompressible"],
                    collision=collision, force=kw.get("force"), pre_stream_bcs=pre,
                    post_stream_bcs=tuple(post))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("name", PALLAS_VARIANTS)
def test_plain_variant_step_matches_pallas_kernel_f32(name):
    kw = VARIANTS[name]
    R, C = 32, 128
    f = _state(R, C, kw["incompressible"], seed=1).astype(np.float32)
    jkw = {k: v for k, v in kw.items() if k != "corner_consistent"}
    jstep = jax_variant_step(R, C, dtype=jnp.float32, block_rows=8, interpret=True, **jkw)
    tstep = channel.make_channel_variant_step(R, C, dtype=torch.float32, **kw)
    want, got = jnp.asarray(f), torch.as_tensor(f)
    for _ in range(4):
        want = jstep(want)
        got = tstep(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-7)


@pytest.mark.parametrize("shape", [(21, 21), (54, 42), (4, 4)])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_plain_variant_step_matches_jnp_model_f64(name, shape):
    kw = VARIANTS[name]
    R, C = shape
    f = _state(R, C, kw["incompressible"], seed=2)
    model = _jax_model(kw)
    tstep = channel.make_channel_variant_step(R, C, dtype=torch.float64, **kw)
    want, got = jnp.asarray(f), torch.as_tensor(f)
    for _ in range(4):
        want = model.step(want)
        got = tstep(got)
    _close(got.numpy(), want, 1e-13)


def test_variant_constants_are_the_plain_version_s():
    """Kernel 9 takes its scalars as the plain step rounds them: the ABB
    coefficients (lbm_tpu's abb_coefficient in float32) and c_k.F."""
    c = list(channel.ChannelVariant(**VARIANTS["free_stream"]).constants(torch.float32))
    assert len(c) == 28 and all(x == float(np.float32(x)) for x in c)
    abb = np.asarray(jd.abb_coefficient(jnp.asarray([0.1, 0.0], jnp.float32)))
    np.testing.assert_array_equal(np.float32(c[19:]), abb)
    v = channel.ChannelVariant(omega=1 / 0.55, incompressible=True, force=(-3e-4, 2e-4))
    c64 = list(v.constants(torch.float64))
    assert c64[:5] == [1 / 0.55, 1 - 1 / 0.55, 1 / 0.55, -3e-4, 2e-4]
    assert c64[8:17] == [cx * -3e-4 + cy * 2e-4 for cx, cy in zip(*jlat.C.tolist())]


@pytest.mark.parametrize("bad, match", [
    (dict(R=3, C=8), "R >= 4 and C >= 4"),
    (dict(R=8, C=3), "R >= 4 and C >= 4"),
    (dict(force=(1e-4, 0.0), omega_minus=1.1), "TRT"),
    (dict(col_walls="abb"), "abb"),
    (dict(row_walls="specular"), "specular"),
    (dict(pressure=(1.0, 1.0, 2)), "axis"),
    (dict(corner_consistent=True, col_walls="bounce", row_walls="abb"), "corner_consistent"),
])
def test_variant_step_rejects(bad, match):
    kw = dict(R=8, C=8, omega=1.0, incompressible=True, dtype=torch.float64)
    kw.update(bad)
    R, C = kw.pop("R"), kw.pop("C")
    with pytest.raises(ValueError, match=match):
        channel.make_channel_variant_step(R, C, **kw)


def test_cpu_state_never_reaches_kernel_9():
    kw = VARIANTS["gravity"]
    f = torch.as_tensor(_state(6, 5, True, seed=4))
    before = channel.CHANNEL_VARIANT.launches
    channel.make_channel_variant_step(6, 5, dtype=torch.float64, **kw)(f)
    assert channel.CHANNEL_VARIANT.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        channel.channel_variant(f, channel.ChannelVariant(**kw))
    with pytest.raises(ValueError, match="step built for"):
        channel.make_channel_variant_step(6, 5, dtype=torch.float32, **kw)(f)


# --- the scenes -----------------------------------------------------------------

SCENES = [
    ("gravity_channel", dict(H=21, W=21, T=2000)),
    ("specular_channel", dict(H=31, W=21, T=600)),
    ("free_stream", dict(H=30, W=24, T=100)),
    ("vertical_poiseuille", dict(H=21, W=17, T=3000, tolerance=1e-12)),
    ("trt_poiseuille", dict(H=16, W=13, T=600, tau=0.8)),
]


@pytest.mark.parametrize("name,kwargs", SCENES)
def test_scene_matches_lbm_tpu(name, kwargs):
    """Each kernel-9 scene on the CPU against lbm_tpu's jnp scene path: the
    same step count, the state and the velocity at 1e-12."""
    got = getattr(tchannel, name)(device="cpu", dtype=torch.float64, **kwargs)
    want = getattr(jchannel, name)(dtype=jnp.float64, fused=False, **kwargs)
    assert got.steps == want.steps
    _close(got.f.numpy(), want.f, 1e-12)
    _close(got.u.numpy(), want.u, 1e-12)
    assert (got.l2 is None) == (want.l2 is None)
    if got.l2 is not None:
        assert abs(got.l2 - want.l2) <= 1e-12


def test_gravity_channel_parabola():
    """lbm_tpu's gravity check (tests/test_channel.py:19-37): the weak Guo
    source leaves the converged profile ~8% shy of the analytic peak."""
    nu = (2.0 * TAU - 1.0) / 6.0
    W, fg = 21, -0.0003
    res = tchannel.gravity_channel(H=21, W=W, T=10000, fg=fg, device="cpu")
    ua = tchannel.poiseuille_analytic(W, fg * W * W / (8.0 * nu))
    mid = res.u[0][10].numpy()
    np.testing.assert_allclose(mid, ua, rtol=0.25, atol=2e-4)
    np.testing.assert_allclose(mid, mid[::-1], rtol=1e-6)
    assert abs(mid).argmax() == W // 2


def test_vertical_poiseuille_incompressible_l2_gate():
    """The reference's 1e-11 gate in the vertical geometry with the
    incompressible equilibrium, on the CPU, at lbm_tpu's step count."""
    kw = dict(H=21, W=21, T=20000, u_max=1.030985714e-1, tolerance=1e-12,
              incompressible=True)
    got = tchannel.vertical_poiseuille(device="cpu", dtype=torch.float64, **kw)
    want = jchannel.vertical_poiseuille(dtype=jnp.float64, fused=False, **kw)
    assert got.l2 <= 1e-11, got.l2
    assert got.steps == want.steps
    _close(got.f.numpy(), want.f, 1e-12)


def test_free_stream_corner_consistent_is_a_fixed_point():
    """lbm_tpu's exactness check (tests/test_channel.py:76-88): the uniform
    stream is a fixed point of the corner-consistent stack at 1e-12, and
    the state equals lbm_tpu's jnp path."""
    kw = dict(H=30, W=24, T=500, corner_consistent=True)
    res = tchannel.free_stream(device="cpu", dtype=torch.float64, **kw)
    u = res.u.numpy()
    assert np.abs(u[0] - 0.1).max() < 1e-12 and np.abs(u[1]).max() < 1e-12
    assert np.abs(res.rho.numpy() - 1.0).max() < 1e-12
    _close(res.f.numpy(), jchannel.free_stream(dtype=jnp.float64, fused=False, **kw).f,
           1e-12)


# --- the physical-units config, snapshots and the CLI -------------------------------

def _small_toml(tmp_path, simulation=True):
    """A channel.toml cut to a 30x24 grid and 10 steps between snapshots."""
    text = """
[flow]
initial_density = 1e3
kinematic_viscosity = 1.0e-6
characteristic_length = 6.0E-3
characteristic_velocity = 0.5

[lattice]
relaxation_time = 0.55
lattice_spacing = 1.0E-3
x_multiplier = 5
y_multiplier = 4
"""
    if simulation:
        text += """
[simulation]
stop_time = 0.7
snapshot_period = 0.17
file_prefix = "small"
"""
    path = tmp_path / ("small.toml" if simulation else "nosim.toml")
    path.write_text(text)
    return str(path)


def _config_fields(cfg):
    lt = cfg.lattice
    out = {"flow": vars(cfg.flow),
           "lattice": {k: getattr(lt, k) for k in (
               "tau", "dx", "x_multiplier", "y_multiplier", "cs2", "omega", "l", "Re",
               "nu", "u", "dt", "T", "X", "Y")}}
    if cfg.simulation is not None:
        out["simulation"] = vars(cfg.simulation)
        out["snap0"] = cfg.simulation.snapshot(0)
        out["snap1"] = cfg.simulation.snapshot(1)
    return out


def test_physical_config_matches_lbm_tpu(tmp_path):
    """configs/channel.toml (the free_stream full-size run: 2700x2100,
    omega 1/0.55, 1580 steps, a snapshot every 79) and a table without
    [simulation] load field for field as lbm_tpu's."""
    path = os.path.join(REPO, "configs", "channel.toml")
    got, want = PhysicalConfig.load(path), JaxPhysicalConfig.load(path)
    assert _config_fields(got) == _config_fields(want)
    assert (got.lattice.X, got.lattice.Y, got.simulation.total_steps,
            got.simulation.snapshot_steps) == (2700, 2100, 1580, 79)
    nosim = _small_toml(tmp_path, simulation=False)
    assert PhysicalConfig.load(nosim).simulation is None
    assert _config_fields(PhysicalConfig.load(nosim)) == \
        _config_fields(JaxPhysicalConfig.load(nosim))


def test_free_stream_snapshots_match_lbm_tpu(tmp_path):
    """free_stream from a small TOML: the same (ux, uy, ps) stacks as
    lbm_tpu's, in memory and streamed to disk."""
    cfg = _small_toml(tmp_path)
    got = tchannel.free_stream(config_path=cfg, device="cpu", dtype=torch.float64)
    want = jchannel.free_stream(config_path=cfg, fused=False, dtype=jnp.float64)
    assert got.steps == want.steps and set(got.snapshots) == {"ux", "uy", "ps"}
    for k, v in want.snapshots.items():
        assert got.snapshots[k].shape == v.shape and v.shape[0] >= 4
        _close(got.snapshots[k], v, 1e-12)
    tchannel.free_stream(config_path=cfg, snapshot_prefix=str(tmp_path / "t" / "fs"),
                         device="cpu", dtype=torch.float64)
    jchannel.free_stream(config_path=cfg, snapshot_prefix=str(tmp_path / "j" / "fs"),
                         fused=False, dtype=jnp.float64)
    meta = json.loads((tmp_path / "t" / "fs-meta.json").read_text())
    assert meta == json.loads((tmp_path / "j" / "fs-meta.json").read_text())
    for k in ("ux", "uy", "ps"):
        a = snapshots.load_stream(str(tmp_path / "t" / "fs"), k)
        _close(a, snapshots.load_stream(str(tmp_path / "j" / "fs"), k), 1e-12)
        _close(a, got.snapshots[k], 0.0)


def test_snapshot_writer(tmp_path):
    """Frames from CPU tensors append to a valid .npy stream; a changed
    shape, an unknown backend and the unported native writer raise."""
    prefix = str(tmp_path / "s")
    with snapshots.SnapshotWriter(prefix) as w:
        for i in range(3):
            w.append("a", torch.full((2, 3), float(i), dtype=torch.float64))
        with pytest.raises(ValueError, match="shape/dtype"):
            w.append("a", torch.zeros(3))
    a = snapshots.load_stream(prefix, "a")
    assert a.shape == (3, 2, 3) and (a[:, 0, 0] == [0.0, 1.0, 2.0]).all()
    snapshots.save_torch(str(tmp_path / "a.pt"), a)
    assert torch.equal(torch.load(str(tmp_path / "a.pt")), torch.as_tensor(a))
    with pytest.raises(NotImplementedError, match="native"):
        snapshots.SnapshotWriter(prefix, backend="native")
    with pytest.raises(ValueError, match="backend"):
        snapshots.SnapshotWriter(prefix, backend="threads")


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "lbm_tpu_torch.run", *args],
                          capture_output=True, text=True, cwd=REPO, timeout=300)


def test_cli_config_and_snapshots(tmp_path):
    """--config reaches free_stream, whose snapshots land as
    {out}-snap-{name}.npy; a scene without config_path rejects --config."""
    cfg = _small_toml(tmp_path)
    out = str(tmp_path / "fs")
    r = _cli("free_stream", "--config", cfg, "--x64", "--device", "cpu", "--out", out)
    assert r.returncode == 0, r.stderr[-2000:]
    want = jchannel.free_stream(config_path=cfg, fused=False, dtype=jnp.float64)
    for k in ("ux", "uy", "ps"):
        _close(np.load(f"{out}-snap-{k}.npy"), want.snapshots[k], 1e-12)
    assert np.load(f"{out}-f.npy").shape == (9, 30, 24)
    r = _cli("horizontal_poiseuille", "--config", cfg, "--device", "cpu")
    assert r.returncode == 2 and "does not take --config" in r.stderr


def test_cli_registers_the_channel_scenes():
    r = _cli("vertical_poiseuille", "--x64", "--device", "cpu", "--set", "H=12",
             "--set", "W=9", "--set", "T=40")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "steps=40" in r.stderr
    r = _cli("--help")
    for name in ("vertical_poiseuille", "gravity_channel", "specular_channel",
                 "trt_poiseuille", "power_law_channel", "free_stream"):
        assert name in r.stdout
