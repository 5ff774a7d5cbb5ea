"""The port's single-process mesh, halo exchange and plain sharded steps
(lbm_tpu_torch/parallel/) against lbm_tpu's shard_map versions on its 8
virtual CPU devices and against the port's single-device steps.

The port's mesh is a list of torch devices (here ``["cpu"] * n``); the same
numpy inputs go through both packages.  Tolerances: lbm_tpu vs the port
1e-13 in float64 (XLA may reassociate); the port's sharded steps against
its single-device steps bit for bit (the same elementwise arithmetic, the
exchange and the rolls only move values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.parallel import halo as jhalo
from lbm_tpu.parallel import mesh as jmesh
from lbm_tpu.parallel import sharded as jsharded
from lbm_tpu_torch.kernels.channel import channel_model
from lbm_tpu_torch.ops import d2q9
from lbm_tpu_torch.parallel import dryrun, halo, mesh, sharded
from lbm_tpu_torch.scenes import channel as scene

F64 = torch.float64


def _rand(shape, seed):
    return np.random.default_rng(seed).uniform(0.5, 1.5, shape)


def _single_periodic_step(f, omega):
    rho = d2q9.calc_rho(f)
    u = d2q9.calc_u(f, rho)
    return d2q9.stream(d2q9.bgk_collision(f, d2q9.equilibrium(u, rho), omega))


def test_make_mesh_layouts_and_errors(monkeypatch):
    m = mesh.make_mesh(["cpu"] * 8)
    assert m.shape == {"x": 8, "y": 1} and len(m.flat) == 8
    m2 = mesh.make_mesh(["cpu"] * 8, shape=(4, 2))
    assert m2.shape == {"x": 4, "y": 2} and m2.devices[3][1] == torch.device("cpu")
    with pytest.raises(ValueError, match=r"mesh shape \(3, 2\) != 8 devices"):
        mesh.make_mesh(["cpu"] * 8, shape=(3, 2))
    # no device list and no card: raise, never a CPU mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (1, 1), (2, 4)])
@pytest.mark.parametrize("planes", [None, 9])
def test_shard_state_and_gather(shape, planes):
    m = mesh.make_mesh(["cpu"] * (shape[0] * shape[1]), shape=shape)
    R, C = 16, 8
    x = torch.as_tensor(_rand((R, C) if planes is None else (planes, R, C), seed=1))
    st = mesh.shard_state(m, x)
    assert len(st.shards) == shape[0] * shape[1] and st.mesh == m
    r, c = R // shape[0], C // shape[1]
    assert torch.equal(st.grid(shape[0] - 1, shape[1] - 1), x[..., -r:, -c:])
    assert all(s.is_contiguous() and s.data_ptr() != x.data_ptr() for s in st.shards)
    assert torch.equal(st.gather(), x)


def test_shard_state_uneven_split_raises():
    m = mesh.make_mesh(["cpu"] * 8, shape=(4, 2))
    with pytest.raises(ValueError, match="rows 18 not divisible by mesh x=4"):
        mesh.shard_state(m, torch.zeros((9, 18, 8)))
    with pytest.raises(ValueError, match="cols 9 not divisible by mesh y=2"):
        mesh.shard_state(m, torch.zeros((16, 9)))
    with pytest.raises(ValueError, match="takes"):
        mesh.shard_state(m, torch.zeros((2, 9, 16, 8)))


@pytest.mark.parametrize("width", [1, 2])
def test_halo_pad_2d_matches_global_roll(width):
    """A roll of every padded block, interior kept, equals the global roll:
    the corners come from the diagonal neighbour (lbm_tpu
    tests/test_parallel.py::test_halo_pad_2d_matches_global_roll)."""
    m = mesh.make_mesh(["cpu"] * 8, shape=(4, 2))
    f = torch.as_tensor(_rand((9, 16, 8), seed=2))
    st = mesh.shard_state(m, f)
    grid = [[st.grid(i, j) for j in range(2)] for i in range(4)]
    w = width
    blocks = [torch.stack([torch.roll(p[k], (w, -w), (0, 1))[w:-w, w:-w] for k in range(9)])
              for row in halo.halo_pad_2d(grid, width=w) for p in row]
    got = mesh.ShardedState(m, blocks).gather()
    assert torch.equal(got, torch.roll(f, (w, -w), (1, 2)))


@pytest.mark.parametrize("axis", ["x", "y"])
def test_halo_pad_axis_matches_a_periodic_window(axis):
    """Along either mesh axis each block is padded with its ring
    neighbours' lines, and only along that axis."""
    f = torch.as_tensor(_rand((2, 12, 8), seed=6))
    st = mesh.shard_state(mesh.make_mesh(["cpu"] * 8, shape=(4, 2)), f)
    grid = [[st.grid(i, j) for j in range(2)] for i in range(4)]
    for i, row in enumerate(halo.halo_pad_axis(grid, axis, 2)):
        for j, p in enumerate(row):
            lines = torch.arange(-2, 5 if axis == "x" else 6)
            r = (3 * i + (lines if axis == "x" else torch.arange(3))) % 12
            c = (4 * j + (lines if axis == "y" else torch.arange(4))) % 8
            assert p.is_contiguous() and torch.equal(p, f[:, r][:, :, c])


def test_exchange_rows_ring_and_self_wrap():
    f = torch.as_tensor(_rand((3, 32, 4), seed=3))
    shards = mesh.shard_state(mesh.make_mesh(["cpu"] * 4), f).shards
    for i, (top, bot) in enumerate(halo.exchange_rows(shards, 2)):
        assert torch.equal(top, f[:, (8 * i - 2) % 32:][:, :2] if i else f[:, -2:])
        assert torch.equal(bot, f[:, (8 * i + 8) % 32:][:, :2])
        assert top.is_contiguous() and top.data_ptr() != shards[i - 1].data_ptr()
    (top, bot), = halo.exchange_rows([f], 3)
    assert torch.equal(top, f[:, -3:]) and torch.equal(bot, f[:, :3])


def test_periodic_bgk_matches_lbm_tpu_on_a_4x2_mesh():
    """make_periodic_bgk_step on a (4, 2) mesh of CPU shards against lbm_tpu's
    shard_map step on its 8 virtual devices, 5 steps, float64."""
    omega = 1.0 / 0.8
    f = _rand((9, 32, 16), seed=3)
    jm = jmesh.make_mesh(jax.devices()[:8], shape=(4, 2))
    jstep = jax.jit(jsharded.make_periodic_bgk_step(jm, omega))
    want = jmesh.shard_state(jm, jnp.asarray(f))
    m = mesh.make_mesh(["cpu"] * 8, shape=(4, 2))
    step = sharded.make_periodic_bgk_step(m, omega)
    got = mesh.shard_state(m, torch.as_tensor(f))
    single = torch.as_tensor(f)
    for _ in range(5):
        want, got = jstep(want), step(got)
        single = _single_periodic_step(single, omega)
    got = got.gather()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-13)
    assert torch.equal(got, single)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (8, 1), (2, 4)])
@pytest.mark.parametrize("incompressible", [False, True])
def test_periodic_bgk_equals_the_single_device_step(shape, incompressible):
    omega = 1.0 / 0.7
    f = torch.as_tensor(_rand((9, 16, 8), seed=4))
    m = mesh.make_mesh(["cpu"] * (shape[0] * shape[1]), shape=shape)
    step = sharded.make_periodic_bgk_step(m, omega, incompressible)
    got = mesh.shard_state(m, f)
    want = f
    for _ in range(4):
        got = step(got)
        rho = d2q9.calc_rho(want)
        u = d2q9.calc_momentum(want) if incompressible else d2q9.calc_u(want, rho)
        eq = (d2q9.incomp_equilibrium if incompressible else d2q9.equilibrium)(u, rho)
        want = d2q9.stream(d2q9.bgk_collision(want, eq, omega))
    assert torch.equal(got.gather(), want)


def _channel_setup(H=24, W=24):
    tau = scene.TAU_DEFAULT
    rho_in = scene._inlet_density(H, W, 1.030985714e-1, tau)
    f0 = scene._equilibrium_state(H, W, True, torch.device("cpu"), F64)
    return 1.0 / tau, rho_in, f0


def test_channel_matches_lbm_tpu_on_8_shards():
    """make_channel_bgk_step on 8 row shards against lbm_tpu's shard_map
    channel (the coupled pressure BC across the cut), 50 steps, float64."""
    omega, rho_in, f0 = _channel_setup()
    jm = jmesh.make_mesh(jax.devices()[:8], shape=(8, 1))
    jstep = jsharded.make_channel_bgk_step(jm, omega, rho_in, 1.0)
    chunk = jax.jit(lambda s: jax.lax.fori_loop(0, 50, lambda _, x: jstep(x), s))
    want = chunk(jax.device_put(jnp.asarray(f0.numpy()), jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec(None, "x", None))))
    m = mesh.make_mesh(["cpu"] * 8)
    step = sharded.make_channel_bgk_step(m, omega, rho_in, 1.0)
    got = mesh.shard_state(m, f0)
    for _ in range(50):
        got = step(got)
    np.testing.assert_allclose(got.gather().numpy(), np.asarray(want), rtol=0, atol=1e-13)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_sharded_channel_equals_the_scene(n):
    """The n-shard channel equals the single-device channel step bit for bit,
    and so horizontal_poiseuille (tests/test_parallel.py:111's comparison)."""
    omega, rho_in, f0 = _channel_setup()
    m = mesh.make_mesh(["cpu"] * n)
    step = sharded.make_channel_bgk_step(m, omega, rho_in, 1.0)
    model = channel_model(omega, rho_in, 1.0)
    got, want = mesh.shard_state(m, f0), f0
    for _ in range(60):
        got, want = step(got), model.step(want)
    assert torch.equal(got.gather(), want)
    if n == 8:
        ref = scene.horizontal_poiseuille(H=24, W=24, T=60, device="cpu", dtype=F64)
        assert ref.steps == 60 and torch.equal(got.gather(), ref.f)


def test_channel_rejects_a_column_mesh_and_another_mesh():
    omega, rho_in, f0 = _channel_setup()
    with pytest.raises(ValueError, match="shards rows only"):
        sharded.make_channel_bgk_step(mesh.make_mesh(["cpu"] * 4, (2, 2)), omega, rho_in, 1.0)
    step = sharded.make_channel_bgk_step(mesh.make_mesh(["cpu"] * 4), omega, rho_in, 1.0)
    with pytest.raises(ValueError, match="another mesh"):
        step(mesh.shard_state(mesh.make_mesh(["cpu"] * 2), f0))


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_multichip_on_cpu_shards(n):
    out = dryrun.dryrun_multichip(n, devices=["cpu"] * n)
    two_d = {"sharded_fused_2d", "sharded2d_mrtcg", "sharded2d_csf", "sharded2d_sc",
             "sharded2d_thermal"} if n == 8 else set()  # an (n/2, 2) mesh for even n > 2
    assert set(out) == {"periodic_bgk", "channel_bgk", "sharded_fused", "sharded_mrtcg",
                        "sharded_sc", "sharded_d3q19"} | two_d
    assert all(bool(torch.isfinite(x).all()) for x in out.values())
    with pytest.raises(ValueError, match="devices for a"):
        dryrun.dryrun_multichip(n, devices=["cpu"] * (n + 1))


def test_lbm_tpu_halo_pad_axis_is_the_ported_rule():
    """The n == 1 self-wrap of lbm_tpu's halo_pad_axis (halo.py:41-42): one
    block pads itself with its own far lines, as the port's does."""
    x = _rand((9, 6, 4), seed=5)
    jm = jmesh.make_mesh(jax.devices()[:1], shape=(1, 1))
    fn = jax.shard_map(lambda a: jhalo.halo_pad_axis(a, "x", 1, 2), mesh=jm,
                       in_specs=jmesh.FIELD_SPEC, out_specs=jmesh.FIELD_SPEC)
    want = np.asarray(fn(jnp.asarray(x)))
    got = halo.halo_pad_axis([[torch.as_tensor(x)]], "x", 2)[0][0]
    np.testing.assert_array_equal(got.numpy(), want)
