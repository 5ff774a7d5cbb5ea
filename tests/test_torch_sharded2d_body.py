"""The rows x cols body steps of lbm_tpu_torch/kernels/sharded2d.py (the
plain versions of kernels 35-38: Shan-Chen, thermal, RK and the full MRT-CG
state in both modes), against lbm_tpu's sharded2d_pallas wrappers and
against the port's single-device steps.

lbm_tpu's wrappers run as its own tests run them: ``interpret=True`` on its
8 virtual CPU devices, one case per family (CSF too) at its smallest legal
shape, 2 shards of 128 columns (32x256 on a (2, 2) mesh), float64 at 1e-13,
2 steps.  The MRT-CG and RK states vary along the columns, so the
stencils' replicate padding and the column repair at the grid's global
columns 0 and C-1 show.  The port's rows x cols plain steps equal its
single-device plain steps bit for bit on the (1, 2), (2, 2), (4, 2) and (2,
4) meshes at s = 1 and at each family's cap; on every one of them global
columns C-1 and 0 fall inside the strips of the first and last column
ranks.  The kernels run on the card only (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels import sharded2d_pallas as j2d
from lbm_tpu.parallel import mesh as jmesh
from lbm_tpu.scenes.multiphase import DEFAULT_BLUE as J_BLUE, DEFAULT_RED as J_RED
from lbm_tpu_torch.kernels import mrtcg, rk, shan_chen
from lbm_tpu_torch.kernels import sharded2d as k2d
from lbm_tpu_torch.kernels import thermal as kth
from lbm_tpu_torch.ops import d2q9, gradients
from lbm_tpu_torch.parallel import mesh
from lbm_tpu_torch.scenes import multiphase as mp

F64 = torch.float64
MRT = dict(sigma=1e-4, gravity=(6.25e-7, 0.0))
RK = dict(r_alpha=11.0 / 15.0, b_alpha=0.2, r_nu=0.04, b_nu=0.04, sigma=0.1, beta=0.7,
          gravity=(-6.25e-6, 0.0))
THERMAL = dict(omega_f=1.0 / (0.71 * 0.1 * 3.0 + 0.5), omega_g=1.25, g_beta=1e-4)


def _wave(R, C):
    """0.9 sin(2 pi (row + 0.5) / 32) cos(2 pi (col + 0.5) / 64): a colour
    field that varies along both axes."""
    r = (torch.arange(R, dtype=F64)[:, None] + 0.5) / 32.0
    c = (torch.arange(C, dtype=F64)[None, :] + 0.5) / 64.0
    return 0.9 * torch.sin(2 * np.pi * r) * torch.cos(2 * np.pi * c)


def _colours(r0, b0, rng, fst_scale=None):
    """[red f, blue f (+ fst)] at rest from the two densities, each
    population times 1 +- 3% (seeded), with a seeded surface-force carry of
    +- ``fst_scale`` in CSF mode."""
    R, C = r0.shape
    feq = d2q9.equilibrium(torch.zeros((2, R, C), dtype=F64), torch.ones((R, C), dtype=F64))
    F = torch.cat([r0[None] * feq, b0[None] * feq])
    F = F * torch.as_tensor(rng.uniform(0.97, 1.03, (18, R, C)))
    if fst_scale is None:
        return F
    return torch.cat([F, torch.as_tensor(rng.uniform(-fst_scale, fst_scale, (2, R, C)))])


def _state(family, R, C, seed):
    """A seeded noisy state of ``family`` as its step takes it (flat)."""
    rng = np.random.default_rng(seed)
    if family == "mrtcg":
        phi = _wave(R, C)
        return _colours(mp.DEFAULT_RED.rho_0 * 0.5 * (1 + phi),
                        mp.DEFAULT_BLUE.rho_0 * 0.5 * (1 - phi), rng)
    if family == "csf":
        # tests/test_torch_sharded_k20b.py's mixed state: grad(psi) nowhere
        # round-off small (the extremes fall midway between rows)
        s = torch.sin(2 * np.pi * (torch.arange(R, dtype=F64) + 0.5) / 96)[:, None]
        one = torch.ones((1, C), dtype=F64)
        return _colours(mp.DEFAULT_RED.rho_0 * 0.5 * (1.0 + 0.8 * s) * one,
                        mp.DEFAULT_BLUE.rho_0 * 0.5 * (1.0 - 0.8 * s) * one, rng, 1e-6)
    if family == "rk":
        phi = _wave(R, C)
        r0, b0 = 1.5 * (1 + phi), 0.5 * (1 - phi)
        u = torch.as_tensor(rng.uniform(-0.02, 0.02, (2, R, C)))
        return torch.cat([d2q9.equilibrium(u, r0 + b0), r0[None], b0[None]])
    if family == "shan_chen":
        rho = torch.as_tensor(0.7 + 0.1 * rng.standard_normal((R, C)))
        return d2q9.equilibrium(torch.zeros((2, R, C), dtype=F64), rho)
    theta = torch.as_tensor(rng.uniform(-0.5, 0.5, (R, C)))
    u = torch.as_tensor(rng.uniform(-0.02, 0.02, (2, R, C)))
    return torch.cat([d2q9.equilibrium(u, torch.ones((R, C), dtype=F64)),
                      d2q9.equilibrium(u, theta)])


def _port_step(family, m, R, C, s):
    if family in ("mrtcg", "csf"):
        return k2d.make_sharded2d_mrtcg_step(
            m, R, C, mp.DEFAULT_RED, mp.DEFAULT_BLUE, dtype=F64, substeps=s,
            surface_tension="csf" if family == "csf" else "perturbation", **MRT)
    if family == "rk":
        return k2d.make_sharded2d_rk_step(m, R, C, dtype=F64, **RK)
    if family == "shan_chen":
        return k2d.make_sharded2d_sc_step(m, R, C, omega=1.0, G=-5.0, substeps=s, dtype=F64)
    return k2d.make_sharded2d_thermal_step(m, R, C, substeps=s, dtype=F64, **THERMAL)


def _single_step(family, R, C, s):
    """The port's single-device plain step, ``s`` steps a call, on the flat
    state."""
    if family == "mrtcg":
        full = mrtcg.make_mrtcg_fused_step(R, C, mp.DEFAULT_RED, mp.DEFAULT_BLUE, dtype=F64,
                                           substeps=s, **MRT)
        return lambda x: full(x.reshape(2, 9, R, C)).reshape(18, R, C)
    if family == "csf":
        return mrtcg.make_csf_fused_step(R, C, mp.DEFAULT_RED, mp.DEFAULT_BLUE, dtype=F64,
                                         substeps=s, **MRT)
    if family == "rk":
        return rk.make_rk_fused_step(R, C, dtype=F64, substeps=s, **RK)
    if family == "shan_chen":
        return shan_chen.make_sc_fused_step(R, C, omega=1.0, G=-5.0, substeps=s, dtype=F64)
    return kth.make_thermal_fused_step(R, C, substeps=s, dtype=F64, **THERMAL)


def _run_port(step, x, shape, calls):
    m = mesh.make_mesh(["cpu"] * (shape[0] * shape[1]), shape)
    y = mesh.shard_state(m, x)
    for _ in range(calls):
        y = step(y)
    return y.gather().reshape(x.shape)


# --- against lbm_tpu's wrappers, one case per family --------------------------------

def _j_step(family, jm, R, C, s):
    kw = dict(dtype=jnp.float64, interpret=True)
    if family in ("mrtcg", "csf"):
        return j2d.make_sharded2d_mrtcg_step(
            jm, R, C, J_RED, J_BLUE, substeps=s,
            surface_tension="csf" if family == "csf" else "perturbation", **MRT, **kw)
    if family == "rk":
        return j2d.make_sharded2d_rk_step(jm, R, C, **RK, **kw)
    if family == "shan_chen":
        return j2d.make_sharded2d_sc_step(jm, R, C, omega=1.0, G=-5.0, substeps=s, **kw)
    return j2d.make_sharded2d_thermal_step(jm, R, C, substeps=s, **THERMAL, **kw)


@pytest.mark.parametrize("family,s,calls", [("mrtcg", 2, 1), ("csf", 1, 2), ("rk", 1, 2),
                                            ("shan_chen", 2, 1), ("thermal", 2, 1)])
def test_body_plain_matches_lbm_tpu_sharded2d_wrappers(family, s, calls):
    """32x256 on a (2, 2) mesh (lbm_tpu's smallest legal shard, 16 x 128),
    2 steps: MRT-CG with 2 per exchange, CSF and RK with 1, Shan-Chen and
    thermal with 2."""
    R, C = 32, 256
    x = _state(family, R, C, seed=len(family) + s)
    jm = jmesh.make_mesh(jax.devices()[:4], shape=(2, 2))
    jx = jnp.asarray(x.reshape(2, 9, R, C).numpy() if family == "mrtcg" else x.numpy())
    lead = (None,) * (jx.ndim - 2)
    y = jax.device_put(jx, jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec(*lead, "x", "y")))
    jstep = _j_step(family, jm, R, C, s)
    for _ in range(calls):
        y = jstep(y)
    want = np.asarray(y).reshape(x.shape)
    got = _run_port(_port_step(family, mesh.make_mesh(["cpu"] * 4, (2, 2)), R, C, s), x,
                    (2, 2), calls)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_rk_parts_path_matches_lbm_tpu_sharded2d_rk(shape, monkeypatch):
    """Kernel 37's path on CPU shards: the RK step takes each padded block
    as ``ring_2d``'s 3 x 3 parts (once a call) and runs ``plain.parts`` on it,
    a batch of edge and interior row ranks on (4, 2); 2 steps of 16 x 128
    shards, float64, within 1e-13 of lbm_tpu's wrapper, and bit for bit
    ``step.plain`` (``exchange_2d``'s strips)."""
    nx, ny = shape
    R, C = 16 * nx, 256
    x = _state("rk", R, C, seed=nx + 20)
    jm = jmesh.make_mesh(jax.devices()[:nx * ny], shape=shape)
    y = jax.device_put(jnp.asarray(x.numpy()), jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec(None, "x", "y")))
    jstep = _j_step("rk", jm, R, C, 1)
    want = np.asarray(jstep(jstep(y)))
    calls, ring_2d = [], k2d.ring_2d
    monkeypatch.setattr(k2d, "ring_2d", lambda grid, w: calls.append(w) or ring_2d(grid, w))
    m = mesh.make_mesh(["cpu"] * (nx * ny), shape)
    step = _port_step("rk", m, R, C, 1)
    got = _run_port(step, x, shape, 2)
    assert calls == [k2d.HALO] * 2
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)
    assert torch.equal(got, _run_port(step.plain, x, shape, 2))


# --- against the port's single-device steps, bit for bit ----------------------------

@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (4, 2), (2, 4)])
@pytest.mark.parametrize("family,s", [("mrtcg", 1), ("mrtcg", 2), ("csf", 1), ("rk", 1),
                                      ("shan_chen", 1), ("shan_chen", 4), ("thermal", 1),
                                      ("thermal", 8)])
def test_body_plain_equals_single_device(family, s, shape):
    """Shards of 16 x 16 (24 rows on (1, 2)), 2 calls."""
    nx, ny = shape
    R, C = (24 if nx == 1 else 16 * nx), 16 * ny
    x = _state(family, R, C, seed=10 * nx + ny + s)
    step = _port_step(family, mesh.make_mesh(["cpu"] * (nx * ny), shape), R, C, s)
    one = _single_step(family, R, C, s)
    assert torch.equal(_run_port(step, x, shape, 2), one(one(x)))


def test_mrtcg_takes_its_own_output_and_hands_back_the_colour_pairs():
    """Perturbation mode hands back (2, 9, R/nx, C/ny) shards, which gather to
    F (2, 9, R, C) and go into the next call as they are; ``step.plain`` is
    the same plain version."""
    R, C = 32, 32
    x = _state("mrtcg", R, C, seed=7)
    m = mesh.make_mesh(["cpu"] * 4, (2, 2))
    step = _port_step("mrtcg", m, R, C, 1)
    y = step(mesh.shard_state(m, x))
    assert all(tuple(f.shape) == (2, 9, 16, 16) for f in y.shards)
    two = step(y)
    one = _single_step("mrtcg", R, C, 2)
    assert torch.equal(two.gather(), one(x).reshape(2, 9, R, C))
    assert torch.equal(step.plain(y).gather(), two.gather())


def test_tap_cols_is_the_periodic_grid_s_replicate_padding():
    """A 5x5 gradient over a block of a periodic grid's columns (wrapped
    global indices, crossing the grid's column C-1 to 0) equals the
    whole grid's gradient on the block's columns, bar the two stale ones a
    side."""
    R, C = 12, 20
    psi = torch.as_tensor(np.random.default_rng(2).uniform(size=(R, C)))
    cols = torch.arange(13, 13 + 14) % C  # global 13..19, then 0..6
    for fn in (gradients.dx5, gradients.dy5):
        block = fn(psi[:, cols], cols=cols, grid_cols=C)
        assert torch.equal(block[:, 2:-2], fn(psi)[:, cols[2:-2]])


# --- cadences and guards ------------------------------------------------------------

def test_auto_is_lbm_tpu_s_2d_cap_and_the_cap_binds():
    assert {f: k2d.resolve_substeps_2d("auto", f) for f in k2d.CAP_2D} == \
        {"mrtcg": 2, "csf": 1, "shan_chen": 4, "thermal": 8, "rk": 1}
    m = mesh.make_mesh(["cpu"] * 4, (2, 2))
    for family, cap in (("mrtcg", 2), ("csf", 1), ("shan_chen", 4), ("thermal", 8)):
        with pytest.raises(ValueError, match=rf"substeps must be an int in \[1, {cap}\]"):
            _port_step(family, m, 32, 32, cap + 1)
    R, C = 32, 32
    x = _state("mrtcg", R, C, seed=8)
    step = k2d.make_sharded2d_mrtcg_step(m, R, C, mp.DEFAULT_RED, mp.DEFAULT_BLUE, dtype=F64,
                                         substeps="auto", **MRT)
    assert torch.equal(_run_port(step, x, (2, 2), 1), _single_step("mrtcg", R, C, 2)(x))


@pytest.mark.parametrize("shape,R,C,match", [
    ((4, 1), 32, 32, r"ny >= 2.*make_sharded_\w+_step for an \(n, 1\) mesh"),
    ((2, 2), 31, 32, "grid 31x32 not divisible by mesh 2x2"),
    ((2, 2), 32, 33, "grid 32x33 not divisible by mesh 2x2"),
    ((4, 2), 16, 64, r"local shard 4x32 smaller than the 8-line exchange strips"),
    ((2, 2), 32, 14, r"local shard 16x7 smaller than the 8-line exchange strips"),
    ((2, 2), 32, 24, r"C - C/ny = 12 < 16: .* hold a global column twice"),
])
@pytest.mark.parametrize("family", ["mrtcg", "csf", "rk", "shan_chen", "thermal"])
def test_body_steps_guard_the_mesh(family, shape, R, C, match):
    m = mesh.make_mesh(["cpu"] * (shape[0] * shape[1]), shape)
    with pytest.raises(ValueError, match=match):
        _port_step(family, m, R, C, 1)


def test_body_steps_reject_a_foreign_state():
    m = mesh.make_mesh(["cpu"] * 4, (2, 2))
    step = _port_step("thermal", m, 32, 32, 1)
    x = _state("thermal", 32, 32, seed=9)
    with pytest.raises(ValueError, match="step built for"):
        step(mesh.shard_state(m, x.float()))
    with pytest.raises(ValueError, match="another mesh"):
        step(mesh.shard_state(mesh.make_mesh(["cpu"] * 4, (1, 4)), x))


def test_a_non_cpu_shard_reaches_kernels_35_to_38_or_raises():
    """No fallback: shards off the CPU (the meta device stands in for a
    card) reach the kernels' checks, which take CUDA tensors only."""
    m = mesh.make_mesh(["meta"] * 4, (2, 2))
    for family, planes in (("mrtcg", 18), ("csf", 20), ("rk", 11), ("shan_chen", 9),
                           ("thermal", 18)):
        step = _port_step(family, m, 32, 32, 1)
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            step(mesh.shard_state(m, torch.zeros((planes, 32, 32), dtype=F64, device="meta")))
    assert [k.symbol for k in (k2d.HALO2D_SHAN_CHEN, k2d.HALO2D_THERMAL, k2d.HALO2D_RK,
                               k2d.HALO2D_MRTCG_FULL)] == \
        ["lbm_halo2d_shan_chen", "lbm_halo2d_thermal", "lbm_halo2d_rk", "lbm_halo2d_mrtcg_full"]
