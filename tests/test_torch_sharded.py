"""The row-sharded steps of lbm_tpu_torch/kernels/sharded.py (the plain
versions of kernels 27-30) against lbm_tpu's sharded_pallas factories and
against the port's single-device steps.

lbm_tpu's factories run as its own tests run them: ``interpret=True`` on its
8 virtual CPU devices, one case per family at the smallest shape its slab
pipeline takes, float64 at 1e-13.  The port's n-shard plain steps equal its
single-device plain steps bit for bit, for n in {1, 2, 8} and every cadence
the family's strip admits.  The kernels themselves run on the card only
(tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels import sharded_pallas as jsp
from lbm_tpu.kernels.bgk_pallas import bgk_collide_fn as j_bgk_collide_fn
from lbm_tpu.parallel import mesh as jmesh
from lbm_tpu.scenes.multiphase import DEFAULT_BLUE as J_BLUE, DEFAULT_RED as J_RED
from lbm_tpu_torch.kernels import bgk, collide_stream, les, mrtcg, power_law, rk, thermal, trt
from lbm_tpu_torch.kernels import sharded as ksh
from lbm_tpu_torch.ops import d2q9
from lbm_tpu_torch.parallel import mesh
from lbm_tpu_torch.scenes import multiphase as mp

F64 = torch.float64
OMEGA = 1.0 / 0.8
THERMAL = dict(omega_f=1.0 / (0.71 * 0.1 * 3.0 + 0.5), omega_g=1.25, g_beta=2e-4)
MRT = dict(sigma=1e-4, gravity=(6.25e-7, 0.0))
RK = dict(r_alpha=11.0 / 15.0, b_alpha=0.2, r_nu=0.04, b_nu=0.04, sigma=0.1, beta=0.7,
          gravity=(-6.25e-6, 0.0))


def _noisy(R, C, seed):
    """An equilibrium at a seeded flow, each population times 1 +- 3%."""
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.uniform(-0.05, 0.05, (2, R, C)))
    rho = torch.as_tensor(1.0 + rng.uniform(-0.01, 0.01, (R, C)))
    return (d2q9.equilibrium(u, rho) * torch.as_tensor(rng.uniform(0.97, 1.03, (9, R, C))))


def _thermal_state(R, C, seed):
    rng = np.random.default_rng(seed)
    w = torch.as_tensor([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4, dtype=F64)[:, None, None]
    g = w * torch.as_tensor(rng.uniform(-0.5, 0.5, (R, C)) * rng.uniform(0.97, 1.03, (9, R, C)))
    return torch.cat([_noisy(R, C, seed), g]).contiguous()


def _reduced_state(R, C, csf, seed):
    """The RT layers of the MRT-CG scenes, each population times 1 +- 3%, as
    the reduced state (plus a seeded surface-force carry in CSF mode)."""
    rng = np.random.default_rng(seed)
    sign = 1.0 if csf else -1.0
    r0 = torch.as_tensor(mp.init_rho_cosine(R, C, mp.DEFAULT_RED.rho_0, True, sign))
    b0 = torch.as_tensor(mp.init_rho_cosine(R, C, mp.DEFAULT_BLUE.rho_0, False, sign))
    feq = d2q9.equilibrium(torch.zeros((2, R, C), dtype=F64), torch.ones((R, C), dtype=F64))
    tot = (r0 + b0).clamp_min(1e-30)[None]
    F = [p * torch.as_tensor(rng.uniform(0.97, 1.03, (9, R, C)))
         for p in (r0[None] * feq / tot, b0[None] * feq / tot)]
    if csf:
        S = torch.cat(F + [torch.as_tensor(rng.uniform(-1e-6, 1e-6, (2, R, C)))])
        return mrtcg.reduce_mrtcg_state(S, "csf")
    return mrtcg.reduce_mrtcg_state(torch.stack(F), "perturbation")


def _rk_state(R, C):
    r0 = torch.as_tensor(mp.init_rho_cosine(R, C, 3.0, False, 1.0))
    b0 = torch.as_tensor(mp.init_rho_cosine(R, C, 1.0, True, 1.0))
    f0 = d2q9.equilibrium(torch.zeros((2, R, C), dtype=F64), r0 + b0)
    return torch.cat([f0, r0[None], b0[None]]).contiguous()


def _run_port(step, x, n, calls):
    m = mesh.make_mesh(["cpu"] * n)
    y = mesh.shard_state(m, x)
    for _ in range(calls):
        y = step(y)
    return y.gather()


def _run_lbm_tpu(step, x, calls):
    jm = jmesh.make_mesh(jax.devices()[:8], shape=(8, 1))
    y = jax.device_put(jnp.asarray(x.numpy()), jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec(None, "x", None)))
    for _ in range(calls):
        y = step(y)
    return np.asarray(y)


def _jmesh8():
    return jmesh.make_mesh(jax.devices()[:8], shape=(8, 1))


# --- against lbm_tpu's factories, one case per family -------------------------------

def test_k27_plain_matches_lbm_tpu_sharded_fused_step():
    R, C = 64, 16
    x = _noisy(R, C, seed=1)
    want = _run_lbm_tpu(jsp.make_sharded_fused_step(
        _jmesh8(), R, C, j_bgk_collide_fn(OMEGA, jnp.float64), dtype=jnp.float64,
        block_rows=8, substeps=2, interpret=True), x, 2)
    step = ksh.make_sharded_fused_step(mesh.make_mesh(["cpu"] * 8), R, C,
                                       bgk.bgk_collide_fn(OMEGA, F64), F64, substeps=2)
    np.testing.assert_allclose(_run_port(step, x, 8, 2).numpy(), want, rtol=0, atol=1e-13)


def test_k28_plain_matches_lbm_tpu_sharded_thermal_step():
    R, C = 192, 128  # lbm_tpu's slab needs 24 rows per shard and 128 columns
    x = _thermal_state(R, C, seed=2)
    want = _run_lbm_tpu(jsp.make_sharded_thermal_step(
        _jmesh8(), R, C, substeps=2, dtype=jnp.float64, interpret=True, **THERMAL), x, 1)
    step = ksh.make_sharded_thermal_step(mesh.make_mesh(["cpu"] * 8), R, C, substeps=2,
                                         dtype=F64, **THERMAL)
    np.testing.assert_allclose(_run_port(step, x, 8, 1).numpy(), want, rtol=0, atol=1e-13)


def test_k29_plain_matches_lbm_tpu_sharded_mrtcg_reduced_step():
    R, C = 192, 128
    x = _reduced_state(R, C, csf=False, seed=3)
    want = _run_lbm_tpu(jsp.make_sharded_mrtcg_reduced_step(
        _jmesh8(), R, C, J_RED, J_BLUE, dtype=jnp.float64, substeps=2, interpret=True, **MRT),
        x, 1)
    step = ksh.make_sharded_mrtcg_reduced_step(mesh.make_mesh(["cpu"] * 8), R, C,
                                               mp.DEFAULT_RED, mp.DEFAULT_BLUE, dtype=F64,
                                               substeps=2, **MRT)
    np.testing.assert_allclose(_run_port(step, x, 8, 1).numpy(), want, rtol=0, atol=1e-13)


def test_k30_plain_matches_lbm_tpu_sharded_rk_step():
    R, C = 192, 128
    x = _rk_state(R, C)
    want = _run_lbm_tpu(jsp.make_sharded_rk_step(
        _jmesh8(), R, C, dtype=jnp.float64, interpret=True, **RK), x, 1)
    step = ksh.make_sharded_rk_step(mesh.make_mesh(["cpu"] * 8), R, C, dtype=F64, **RK)
    np.testing.assert_allclose(_run_port(step, x, 8, 1).numpy(), want, rtol=0, atol=1e-13)


# --- against the port's single-device steps, bit for bit ----------------------------

COLLISIONS = {
    "bgk": lambda: bgk.bgk_collide_fn(OMEGA, F64),
    "kbc": lambda: collide_stream.kbc_collide_fn(OMEGA),
    "les": lambda: les.les_collide_fn(0.5 + 3e-4, 0.17, F64),
    "trt": lambda: trt.trt_collide_fn(1.0 / 0.9, 1.2, F64),
    "power_law": lambda: power_law.power_law_collide_fn(0.01, 0.5, 0.52, 50.0, 8, F64),
}


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("s", [1, 3, 8])
@pytest.mark.parametrize("kind", sorted(COLLISIONS))
def test_k27_plain_equals_single_device(kind, s, n):
    R, C = 64, 12
    x = _noisy(R, C, seed=10 + s)
    fn = COLLISIONS[kind]()
    step = ksh.make_sharded_fused_step(mesh.make_mesh(["cpu"] * n), R, C, fn, F64, substeps=s)
    want = collide_stream.make_fused_step(R, C, fn, F64, s)
    assert torch.equal(_run_port(step, x, n, 2), want(want(x)))


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("s", [1, 4, 8])
def test_k28_plain_equals_single_device(s, n):
    R, C = 64, 12
    x = _thermal_state(R, C, seed=20 + s)
    step = ksh.make_sharded_thermal_step(mesh.make_mesh(["cpu"] * n), R, C, substeps=s,
                                         dtype=F64, **THERMAL)
    want = thermal.make_thermal_fused_step(R, C, substeps=s, dtype=F64, **THERMAL)
    assert torch.equal(_run_port(step, x, n, 2), want(want(x)))


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("mode,s", [("perturbation", 1), ("perturbation", 2),
                                    ("perturbation", 5), ("csf", 1), ("csf", 2), ("csf", 4)])
def test_k29_plain_equals_single_device(mode, s, n):
    R, C = 192, 12
    x = _reduced_state(R, C, mode == "csf", seed=30 + s)
    step = ksh.make_sharded_mrtcg_reduced_step(
        mesh.make_mesh(["cpu"] * n), R, C, mp.DEFAULT_RED, mp.DEFAULT_BLUE, dtype=F64,
        surface_tension=mode, substeps=s, **MRT)
    want = mrtcg.make_mrtcg_reduced_step(R, C, mp.DEFAULT_RED, mp.DEFAULT_BLUE, dtype=F64,
                                         surface_tension=mode, substeps=s, **MRT)
    assert torch.equal(_run_port(step, x, n, 1), want(x))


@pytest.mark.parametrize("n", [1, 2, 8])
def test_k30_plain_equals_single_device(n):
    R, C = 64, 12
    x = _rk_state(R, C)
    step = ksh.make_sharded_rk_step(mesh.make_mesh(["cpu"] * n), R, C, dtype=F64, **RK)
    want = rk.make_rk_fused_step(R, C, dtype=F64, **RK)
    assert torch.equal(_run_port(step, x, n, 3), want(want(want(x))))


def test_local_halo_step_with_self_halos_is_the_periodic_step():
    """One shard with its own edge rows as halos (lbm_tpu
    tests/test_sharded_pallas.py::test_local_halo_step_matches_periodic)."""
    R, C = 16, 8
    x = _noisy(R, C, seed=5)
    fn = bgk.bgk_collide_fn(OMEGA, F64)
    local = ksh.make_local_halo_step(R, C, fn, F64, substeps=3)
    got = local(x, x[:, -8:].contiguous(), x[:, :8].contiguous())
    assert torch.equal(got, collide_stream.make_fused_step(R, C, fn, F64, 3)(x))


# --- substeps, bands and errors -----------------------------------------------------

def test_auto_resolution():
    """"auto" is the deepest cadence each family's strip admits; ints pass
    through (lbm_tpu's picker gives 8 for BGK at every ICI cost)."""
    assert {f: ksh.resolve_substeps("auto", f) for f in ("bgk", "thermal", "mrtcg", "csf",
                                                         "rk")} == \
        {"bgk": 8, "thermal": 8, "mrtcg": 5, "csf": 4, "rk": 1}
    assert ksh.resolve_substeps(3, "mrtcg") == 3
    assert ksh.resolve_substeps("auto", "bgk") == jsp.resolve_substeps("auto", "bgk", C=2048)
    assert [ksh.halo_for(s, r) for s, r in ((1, 3), (2, 3), (5, 3), (2, 5), (4, 5))] == \
        [8, 8, 16, 16, 24]
    with pytest.raises(ValueError, match="int or 'auto'"):
        ksh.resolve_substeps("deep", "bgk")
    with pytest.raises(ValueError, match="unknown family"):
        ksh.default_substeps("sc")
    m = mesh.make_mesh(["cpu"] * 2)
    step = ksh.make_sharded_mrtcg_reduced_step(m, 64, 12, mp.DEFAULT_RED, mp.DEFAULT_BLUE,
                                               dtype=F64, surface_tension="csf",
                                               substeps="auto", **MRT)
    x = _reduced_state(64, 12, True, seed=6)
    want = mrtcg.make_mrtcg_reduced_step(64, 12, mp.DEFAULT_RED, mp.DEFAULT_BLUE, dtype=F64,
                                         surface_tension="csf", substeps=4, **MRT)
    assert torch.equal(_run_port(step, x, 2, 1), want(x))


@pytest.mark.parametrize("walls", [False, True])
def test_sweep_bands_shrink_to_the_shard(walls):
    """Sweep j of s writes the shard's rows and r (s - j) more each side,
    reading r beyond them; the wall families' bands end at the grid."""
    R_loc, halo, r, s = 16, 16, 3, 5
    for off in (0, 16, 48):
        bands = ksh.sweep_bands(R_loc, halo, off, 64, s, r, walls)
        assert bands[-1][2:] == (halo, halo + R_loc)
        for j, (i_lo, i_hi, o_lo, o_hi) in enumerate(bands, start=1):
            lo, hi = halo - r * (s - j), halo + R_loc + r * (s - j)
            if walls:
                lo, hi = max(lo, halo - off), min(hi, halo - off + 64)
            assert (o_lo, o_hi) == (lo, hi) and 0 <= i_lo <= o_lo and o_hi <= i_hi <= 48
            if j > 1:  # a sweep reads only rows the one before wrote
                assert bands[j - 2][2] <= i_lo and i_hi <= bands[j - 2][3]


def test_sharded_steps_reject_bad_shapes_and_cadences():
    m8 = mesh.make_mesh(["cpu"] * 8)
    fn = bgk.bgk_collide_fn(OMEGA, F64)
    with pytest.raises(ValueError, match="rows 60 not divisible by mesh x=8"):
        ksh.make_sharded_fused_step(m8, 60, 8, fn, F64)
    with pytest.raises(ValueError, match="shallower than the 8-row exchange strip"):
        ksh.make_sharded_fused_step(m8, 32, 8, fn, F64)
    with pytest.raises(ValueError, match="shallower than the 24-row exchange strip"):
        ksh.make_sharded_mrtcg_reduced_step(m8, 128, 8, mp.DEFAULT_RED, mp.DEFAULT_BLUE,
                                            dtype=F64, surface_tension="csf", substeps=4, **MRT)
    with pytest.raises(ValueError, match=r"substeps must be an int in \[1, 8\]"):
        ksh.make_sharded_fused_step(m8, 64, 8, fn, F64, substeps=9)
    with pytest.raises(ValueError, match=r"substeps must be an int in \[1, 8\]"):
        ksh.make_sharded_thermal_step(m8, 64, 8, substeps=0, dtype=F64, **THERMAL)
    with pytest.raises(ValueError, match="an \\(n, 1\\) mesh"):
        ksh.make_sharded_rk_step(mesh.make_mesh(["cpu"] * 8, (4, 2)), 64, 8, dtype=F64, **RK)
    step = ksh.make_sharded_fused_step(m8, 64, 8, fn, F64)
    with pytest.raises(ValueError, match="step built for"):
        step(mesh.shard_state(m8, _noisy(64, 8, 1).float()))


def test_a_non_cpu_shard_reaches_the_kernel_or_raises():
    """No fallback: a shard off the CPU goes to the kernel.  An untagged
    collide function raises there; a tagged one reaches the kernel's checks,
    which take CUDA tensors only (shards on the meta device stand in for a
    card here)."""
    m = mesh.make_mesh(["meta"] * 2)
    x = torch.zeros((9, 32, 8), dtype=F64, device="meta")
    untagged = (lambda fn: (lambda f: fn(f)))(bgk.bgk_collide_fn(OMEGA, F64))
    with pytest.raises(ValueError, match="names no halo-input kernel"):
        ksh.make_sharded_fused_step(m, 32, 8, untagged, F64)(mesh.shard_state(m, x))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ksh.make_sharded_fused_step(m, 32, 8, bgk.bgk_collide_fn(OMEGA, F64), F64)(
            mesh.shard_state(m, x))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ksh.make_sharded_thermal_step(m, 32, 8, dtype=F64, **THERMAL)(
            mesh.shard_state(m, torch.zeros((18, 32, 8), dtype=F64, device="meta")))
    # the same untagged function runs its plain version on CPU shards
    mc = mesh.make_mesh(["cpu"] * 2)
    out = ksh.make_sharded_fused_step(mc, 32, 8, untagged, F64)(
        mesh.shard_state(mc, _noisy(32, 8, 2)))
    assert bool(torch.isfinite(out.gather()).all())


def test_collide_functions_name_their_kernel_27_instance():
    assert bgk.bgk_collide_fn(OMEGA, F64).halo_kernel == ("bgk", (OMEGA,), (0, 0))
    assert collide_stream.kbc_collide_fn(1.6, "direct").halo_kernel == ("kbc", (1.6,), (0, 0))
    assert les.les_collide_fn(0.5003, 0.17, F64).halo_kernel[0] == "les"
    assert trt.trt_collide_fn(1.1, 1.2, F64).halo_kernel == ("trt", (1.1, 1.2), (0, 0))
    kind, consts, ints = power_law.power_law_collide_fn(0.01, 0.8, 0.52, 50.0, 6, F64,
                                                        sigma_y=5e-4).halo_kernel
    assert kind == "power_law" and len(consts) == 15 and ints == (power_law.NEWTON, 6)
    assert set(ksh.HALO_COLLIDE_STREAM) == set(ksh.COLLIDE_KINDS)
