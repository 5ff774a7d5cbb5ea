"""The rows x cols sharded collide-stream of lbm_tpu_torch/kernels/sharded2d.py
(the plain version of kernel 34) and the two-pass exchange
``parallel/halo.py exchange_2d``, against lbm_tpu's sharded2d_pallas factory
and against the port's single-device step.

lbm_tpu's factory runs as its own tests run it: ``interpret=True`` on its 8
virtual CPU devices, one case at its smallest legal shape (128 local
columns), float64 at 1e-13.  The port's sharded plain step equals its
single-device plain step bit for bit on every mesh and cadence here (the
exchange and the rolls only move values).  Kernel 34 runs on the card
(tests/test_torch_cuda.py) and, built by g++, on the CPU
(tests/test_torch_csrc_on_cpu.py); its inputs, ``ring_2d``'s in-place
parts, are held to ``exchange_2d``'s strips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels.bgk_pallas import bgk_collide_fn as j_bgk_collide_fn
from lbm_tpu.kernels.sharded2d_pallas import make_sharded_fused_step_2d as j_step_2d
from lbm_tpu.parallel import mesh as jmesh
from lbm_tpu_torch.kernels import bgk, collide_stream, les, power_law, trt
from lbm_tpu_torch.kernels import sharded2d as k2d
from lbm_tpu_torch.ops import d2q9
from lbm_tpu_torch.parallel import halo, mesh

F64 = torch.float64
OMEGA = 1.0 / 0.8
COLLISIONS = {
    "bgk": lambda: bgk.bgk_collide_fn(OMEGA, F64),
    "kbc": lambda: collide_stream.kbc_collide_fn(OMEGA),
    "les": lambda: les.les_collide_fn(0.5 + 3e-4, 0.17, F64),
    "trt": lambda: trt.trt_collide_fn(1.0 / 0.9, 1.2, F64),
    "power_law": lambda: power_law.power_law_collide_fn(0.01, 0.5, 0.52, 50.0, 8, F64),
}


def _noisy(R, C, seed):
    """An equilibrium at a seeded flow, each population times 1 +- 3%."""
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.uniform(-0.05, 0.05, (2, R, C)))
    rho = torch.as_tensor(1.0 + rng.uniform(-0.01, 0.01, (R, C)))
    return (d2q9.equilibrium(u, rho) * torch.as_tensor(rng.uniform(0.97, 1.03, (9, R, C))))


def _run_port(step, x, shape, calls):
    m = mesh.make_mesh(["cpu"] * (shape[0] * shape[1]), shape)
    y = mesh.shard_state(m, x)
    for _ in range(calls):
        y = step(y)
    return y.gather()


def test_k34_plain_matches_lbm_tpu_sharded_fused_step_2d():
    """BGK on a (2, 4) mesh at lbm_tpu's smallest legal shard, 8 x 128, two
    steps per exchange."""
    R, C = 16, 512
    x = _noisy(R, C, seed=1)
    jm = jmesh.make_mesh(jax.devices()[:8], shape=(2, 4))
    jstep = j_step_2d(jm, R, C, j_bgk_collide_fn(OMEGA, jnp.float64), dtype=jnp.float64,
                      substeps=2, interpret=True)
    y = jax.device_put(jnp.asarray(x.numpy()), jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec(None, "x", "y")))
    want = np.asarray(jstep(y))
    m = mesh.make_mesh(["cpu"] * 8, (2, 4))
    step = k2d.make_sharded_fused_step_2d(m, R, C, bgk.bgk_collide_fn(OMEGA, F64), F64,
                                          substeps=2)
    np.testing.assert_allclose(_run_port(step, x, (2, 4), 1).numpy(), want, rtol=0,
                               atol=1e-13)


@pytest.mark.parametrize("shape", [(1, 1), (2, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("s", [1, 3, 8])
def test_k34_plain_equals_single_device(shape, s):
    R, C = 64, 32
    x = _noisy(R, C, seed=10 + s)
    fn = COLLISIONS["bgk"]()
    m = mesh.make_mesh(["cpu"] * (shape[0] * shape[1]), shape)
    step = k2d.make_sharded_fused_step_2d(m, R, C, fn, F64, substeps=s)
    want = collide_stream.make_fused_step(R, C, fn, F64, s)
    assert torch.equal(_run_port(step, x, shape, 2), want(want(x)))


@pytest.mark.parametrize("kind", ["kbc", "les", "trt", "power_law"])
def test_k34_plain_equals_single_device_every_collision(kind):
    R, C = 32, 48
    x = _noisy(R, C, seed=20)
    fn = COLLISIONS[kind]()
    m = mesh.make_mesh(["cpu"] * 8, (4, 2))
    step = k2d.make_sharded_fused_step_2d(m, R, C, fn, F64, substeps=2)
    want = collide_stream.make_fused_step(R, C, fn, F64, 2)
    assert torch.equal(_run_port(step, x, (4, 2), 1), want(x))


@pytest.mark.parametrize("shape,width", [((2, 4), 2), ((4, 2), 8), ((1, 1), 3), ((3, 2), 8)])
def test_exchange_2d_corners_match_a_periodic_roll(shape, width):
    """Each block padded with its four strips is the periodic window of the
    field around it, corners from the diagonal neighbours."""
    nx, ny = shape
    R, C = 8 * nx, 8 * ny
    x = torch.as_tensor(np.random.default_rng(3).uniform(size=(2, R, C)))
    st = mesh.shard_state(mesh.make_mesh(["cpu"] * (nx * ny), shape), x)
    grid = [st.shards[i * ny:(i + 1) * ny] for i in range(nx)]
    for b, (top, bot, left, right) in enumerate(halo.exchange_2d(grid, width)):
        i, j = divmod(b, ny)
        assert tuple(top.shape) == (2, width, 8) and tuple(left.shape) == (2, 8 + 2 * width,
                                                                           width)
        block = torch.cat([left, torch.cat([top, grid[i][j], bot], dim=-2), right], dim=-1)
        lines = torch.arange(-width, 8 + width)
        window = x[:, (8 * i + lines) % R][:, :, (8 * j + lines) % C]
        assert torch.equal(block, window)


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 1), (3, 1)])
def test_ring_2d_views_equal_exchange_2d_strips(shape, monkeypatch):
    """``ring_2d``'s 3 x 3 parts of each padded block are views of the
    neighbours' buffers on one device (no copy; a corner of the diagonal
    neighbour at its own plane and row strides) and equal ``exchange_2d``'s
    strips as ``strip_parts`` views them: their concatenation is the same
    padded block.  Across devices each part is a copy on the receiving one."""
    nx, ny = shape
    R_loc, C_loc, w = 10, 12, 8
    x = torch.as_tensor(np.random.default_rng(11).uniform(size=(9, nx * R_loc, ny * C_loc)))
    st = mesh.shard_state(mesh.make_mesh(["cpu"] * (nx * ny), shape), x)
    grid = [st.shards[i * ny:(i + 1) * ny] for i in range(nx)]
    copies = []
    copy_to = halo.copy_to
    monkeypatch.setattr(halo, "copy_to", lambda src, dev: copies.append(1) or copy_to(src, dev))
    rings = halo.ring_2d(grid, w)
    assert copies == []
    strips = halo.exchange_2d(grid, w)
    item = x.element_size()
    for b, (parts, (top, bot, left, right)) in enumerate(zip(rings, strips)):
        i, j = divmod(b, ny)
        f = grid[i][j]
        assert torch.equal(halo.parts_block(parts), halo.pad_block(f, top, bot, left, right))
        for pa, pb in zip(parts, halo.strip_parts(f, top, bot, left, right)):
            assert all(torch.equal(u, v) for u, v in zip(pa, pb))
        corner = grid[(i - 1) % nx][(j - 1) % ny]
        assert parts[0][0].data_ptr() == corner.data_ptr() + ((R_loc - w) * C_loc + C_loc - w) * item
        assert parts[0][0].stride() == (R_loc * C_loc, C_loc, 1)
        assert parts[1][1].data_ptr() == f.data_ptr()
        assert parts[2][1].data_ptr() == grid[(i + 1) % nx][j].data_ptr()
    copies.clear()
    monkeypatch.setattr(halo, "copy_to", lambda src, dev: copies.append(1) or torch.zeros(
        src.shape, device=dev))
    mixed = [[f if (i + j) % 2 else torch.empty(f.shape, dtype=f.dtype, device="meta")
              for j, f in enumerate(row)] for i, row in enumerate(grid)]
    crossing = 0
    for b, parts in enumerate(halo.ring_2d(mixed, w)):
        i, j = divmod(b, ny)
        for a in range(3):
            for c in range(3):
                assert parts[a][c].device == mixed[i][j].device
                crossing += mixed[(i + a - 1) % nx][(j + c - 1) % ny].device != mixed[i][j].device
    assert len(copies) == crossing and (crossing > 0) == (nx * ny > 1)


def test_sweep_bands_2d_shrink_to_the_shard():
    R_loc, C_loc, h, s = 16, 24, 8, 5
    bands = k2d.sweep_bands_2d(R_loc, C_loc, h, s)
    assert bands[-1][0][2:] == (h, h + R_loc) and bands[-1][1][2:] == (h, h + C_loc)
    for j, (rows, cols) in enumerate(bands, start=1):
        for (i_lo, i_hi, o_lo, o_hi), n in ((rows, R_loc), (cols, C_loc)):
            m = s - j
            assert (o_lo, o_hi, i_lo, i_hi) == (h - m, h + n + m, h - m - 1, h + n + m + 1)
            assert i_lo >= 0 and i_hi <= n + 2 * h


def test_local_2d_step_with_self_strips_is_the_periodic_step():
    """One shard whose strips are its own far lines is the periodic step."""
    R, C = 16, 12
    x = _noisy(R, C, seed=5)
    fn = bgk.bgk_collide_fn(OMEGA, F64)
    (top, bot, left, right), = halo.exchange_2d([[x]], 8)
    got = k2d.make_local_2d_step(R, C, fn, F64, substeps=3)(x, top, bot, left, right)
    assert torch.equal(got, collide_stream.make_fused_step(R, C, fn, F64, 3)(x))


def test_sharded_2d_rejects_bad_shapes_and_cadences():
    m = mesh.make_mesh(["cpu"] * 8, (2, 4))
    fn = bgk.bgk_collide_fn(OMEGA, F64)
    with pytest.raises(ValueError, match="grid 31x64 not divisible by mesh 2x4"):
        k2d.make_sharded_fused_step_2d(m, 31, 64, fn, F64)
    with pytest.raises(ValueError, match="grid 32x66 not divisible by mesh 2x4"):
        k2d.make_sharded_fused_step_2d(m, 32, 66, fn, F64)
    with pytest.raises(ValueError, match="smaller than the 8-line exchange strips"):
        k2d.make_sharded_fused_step_2d(m, 32, 16, fn, F64)
    with pytest.raises(ValueError, match=r"substeps must be an int in \[1, 8\]"):
        k2d.make_sharded_fused_step_2d(m, 32, 64, fn, F64, substeps=9)
    with pytest.raises(ValueError, match=r"substeps must be an int in \[1, 8\]"):
        k2d.make_local_2d_step(16, 16, fn, F64, substeps=0)
    step = k2d.make_sharded_fused_step_2d(m, 32, 64, fn, F64, substeps="auto")
    x = _noisy(32, 64, seed=6)
    want = collide_stream.make_fused_step(32, 64, fn, F64, 8)  # "auto" = 8
    assert torch.equal(_run_port(step, x, (2, 4), 1), want(x))
    with pytest.raises(ValueError, match="step built for"):
        step(mesh.shard_state(m, x.float()))
    with pytest.raises(ValueError, match="another mesh"):
        step(mesh.shard_state(mesh.make_mesh(["cpu"] * 8, (4, 2)), x))


def test_a_non_cpu_shard_reaches_kernel_34_or_raises():
    """No fallback: a shard off the CPU goes to kernel 34.  An untagged
    collide function raises there; a tagged one reaches the kernel's checks,
    which take CUDA tensors only (meta shards stand in for a card)."""
    m = mesh.make_mesh(["meta"] * 4, (2, 2))
    x = torch.zeros((9, 32, 32), dtype=F64, device="meta")
    untagged = (lambda fn: (lambda f: fn(f)))(bgk.bgk_collide_fn(OMEGA, F64))
    with pytest.raises(ValueError, match="names no halo-input kernel"):
        k2d.make_sharded_fused_step_2d(m, 32, 32, untagged, F64)(mesh.shard_state(m, x))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        k2d.make_sharded_fused_step_2d(m, 32, 32, bgk.bgk_collide_fn(OMEGA, F64), F64)(
            mesh.shard_state(m, x))
    assert set(k2d.HALO2D_COLLIDE_STREAM) == {"bgk", "kbc", "les", "trt", "power_law"}
    assert all(k.symbol == f"lbm_halo2d_{kind}" for kind, k in k2d.HALO2D_COLLIDE_STREAM.items())
