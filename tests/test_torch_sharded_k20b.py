"""The row-sharded steps of kernels 31-33 in lbm_tpu_torch/kernels/sharded.py
(their plain versions): the full MRT-CG state, Shan-Chen and D3Q19 with the
y axis sharded, against lbm_tpu's sharded_pallas factories and against the
port's single-device steps.

lbm_tpu's factories run as its own tests run them: ``interpret=True`` on its
8 virtual CPU devices, one case per family at the shapes of its tests,
float64 at 1e-13.  The port's n-shard plain steps equal its single-device
plain steps bit for bit, for n in {1, 2, 8} and several cadences.  The
kernels themselves run on the card only (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels import sharded_pallas as jsp
from lbm_tpu.kernels.d3q19_pallas import make_d3q19_body
from lbm_tpu.kernels.shan_chen_pallas import make_sc_body
from lbm_tpu.parallel import mesh as jmesh
from lbm_tpu.scenes.multiphase import DEFAULT_BLUE as J_BLUE, DEFAULT_RED as J_RED
from lbm_tpu_torch.io import convert
from lbm_tpu_torch.kernels import d3q19, mrtcg, shan_chen
from lbm_tpu_torch.kernels import sharded as ksh
from lbm_tpu_torch.models.shan_chen import CS_TC, maxwell_coexistence
from lbm_tpu_torch.ops import d2q9
from lbm_tpu_torch.ops import d3q19 as od3
from lbm_tpu_torch.parallel import mesh
from lbm_tpu_torch.scenes import multiphase as mp

F64 = torch.float64
MRT = dict(sigma=1e-4, gravity=(6.25e-7, 0.0))
CAVITY = dict(x_walls=True, y_walls=True, z_walls=True, lid_u=0.05)


def _full_state(R, C, csf, seed):
    """The RT layers of the MRT-CG scenes, each population times 1 +- 3%:
    F (2, 9, R, C), or in CSF mode S (20, R, C) with a seeded surface-force
    carry."""
    rng = np.random.default_rng(seed)
    sign = 1.0 if csf else -1.0
    r0 = torch.as_tensor(mp.init_rho_cosine(R, C, mp.DEFAULT_RED.rho_0, True, sign))
    b0 = torch.as_tensor(mp.init_rho_cosine(R, C, mp.DEFAULT_BLUE.rho_0, False, sign))
    return _colours(r0, b0, rng.uniform(0.97, 1.03, (2, 9, R, C)),
                    rng.uniform(-1e-6, 1e-6, (2, R, C)) if csf else None)


def _colours(r0, b0, noise, fst):
    """[red f, blue f (+ fst)] at rest from the two densities."""
    R, C = r0.shape
    feq = d2q9.equilibrium(torch.zeros((2, R, C), dtype=F64), torch.ones((R, C), dtype=F64))
    tot = (r0 + b0).clamp_min(1e-30)[None]
    F = [p * torch.as_tensor(n) for p, n in zip((r0[None] * feq / tot, b0[None] * feq / tot),
                                                 noise)]
    return torch.stack(F) if fst is None else torch.cat(F + [torch.as_tensor(fst)])


def _mixed_csf_state(R, C, seed):
    """Both colours everywhere, psi = 0.8 sin(2 pi (row + 0.5) / 96): |grad
    psi| stays far above round-off at every cell (the extremes fall midway
    between rows), so the CSF normal is a well-defined direction.  Each
    population times 1 +- 1e-4 (seeded, so it varies along the columns too)
    and a seeded surface-force carry of +- 1e-6."""
    rng = np.random.default_rng(seed)
    s = torch.sin(2 * np.pi * (torch.arange(R, dtype=F64) + 0.5) / 96)[:, None]
    r0 = mp.DEFAULT_RED.rho_0 * 0.5 * (1.0 + 0.8 * s) * torch.ones((1, C), dtype=F64)
    b0 = mp.DEFAULT_BLUE.rho_0 * 0.5 * (1.0 - 0.8 * s) * torch.ones((1, C), dtype=F64)
    return _colours(r0, b0, rng.uniform(1.0 - 1e-4, 1.0 + 1e-4, (2, 9, R, C)),
                    rng.uniform(-1e-6, 1e-6, (2, R, C)))


def _sc_state(R, C, seed):
    """lbm_tpu's kernel-test density 0.7 + 0.1 N(0, 1) at rest
    (tests/test_shan_chen.py:127-129)."""
    rho = torch.as_tensor(0.7 + 0.1 * np.random.default_rng(seed).standard_normal((R, C)))
    return d2q9.equilibrium(torch.zeros((2, R, C), dtype=F64), rho)


def _d3_state(X, Y, Z, seed):
    """A seeded off-equilibrium D3Q19 state (19, X, Y, Z)."""
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.uniform(-0.05, 0.05, (3, X, Y, Z)))
    rho = torch.as_tensor(1.0 + rng.uniform(-0.01, 0.01, (X, Y, Z)))
    return (od3.equilibrium(u, rho) * torch.as_tensor(rng.uniform(0.97, 1.03, (19, X, Y, Z))))


def _run_port(step, x, n, calls):
    m = mesh.make_mesh(["cpu"] * n)
    y = mesh.shard_state(m, x)
    for _ in range(calls):
        y = step(y)
    return y.gather()


def _run_lbm_tpu(step, x, calls, spec=("x", None)):
    jm = jmesh.make_mesh(jax.devices()[:8], shape=(8, 1))
    lead = (None,) * (x.ndim - 2)
    y = jax.device_put(jnp.asarray(x.numpy()), jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec(*lead, *spec)))
    for _ in range(calls):
        y = step(y)
    return np.asarray(y)


def _jmesh8():
    return jmesh.make_mesh(jax.devices()[:8], shape=(8, 1))


# --- against lbm_tpu's factories, one case per family -------------------------------

@pytest.mark.parametrize("mode,s", [("perturbation", 2), ("csf", 1), ("csf", "auto")])
def test_k31_plain_matches_lbm_tpu_sharded_mrtcg_step(mode, s):
    """Perturbation mode from a noisy RT state; CSF mode, at s = 1 and at its
    "auto" cadence (4 sweeps on a 24-row strip), from a noisy mixed state
    with a seeded surface-force carry whose grad(psi) is nowhere round-off
    small.  (In a one-colour bulk the CSF normal is a round-off direction,
    and two correct programs that round differently part there by ~1e-6:
    tests/test_torch_mrtcg.py.)"""
    # lbm_tpu's slab needs 128 columns and 2 halo + 24 rows per shard
    R, C = (576 if s == "auto" else 192), 128
    csf = mode == "csf"
    x = _mixed_csf_state(R, C, seed=5) if csf else _full_state(R, C, csf, seed=3)
    want = _run_lbm_tpu(jsp.make_sharded_mrtcg_step(
        _jmesh8(), R, C, J_RED, J_BLUE, dtype=jnp.float64,
        substeps=ksh.resolve_substeps(s, "csf"), interpret=True, surface_tension=mode,
        **MRT), x, 1)
    step = ksh.make_sharded_mrtcg_step(mesh.make_mesh(["cpu"] * 8), R, C, mp.DEFAULT_RED,
                                       mp.DEFAULT_BLUE, dtype=F64, substeps=s,
                                       surface_tension=mode, **MRT)
    got = _run_port(step, x if csf else x.reshape(18, R, C), 8, 1)
    assert tuple(got.shape) == tuple(x.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)


def test_k32_plain_matches_lbm_tpu_sharded_sc_body():
    """tests/test_shan_chen.py:121's configuration: 192x128, 8 ranks, 4 steps
    per exchange."""
    R, C = 192, 128
    x = _sc_state(R, C, seed=11)
    run = make_sc_body(R, C, omega=1.0, G=-5.0, substeps=4)
    want = _run_lbm_tpu(jsp.make_sharded_body_step(_jmesh8(), 9, R, C, run,
                                                   dtype=jnp.float64, block_rows=8,
                                                   interpret=True), x, 1)
    step = ksh.make_sharded_sc_step(mesh.make_mesh(["cpu"] * 8), R, C, omega=1.0, G=-5.0,
                                    substeps=4, dtype=F64)
    np.testing.assert_allclose(_run_port(step, x, 8, 1).numpy(), want, rtol=0, atol=1e-13)


def test_k33_plain_matches_lbm_tpu_sharded_d3q19_body():
    """tests/test_d3q19.py:214's configuration: 2x192x128, the full cavity
    (x end walls, y walls, the lid, z walls), 2 steps per exchange; lbm_tpu's
    x-major packed layout converted with io/convert.py."""
    X, Y, Z = 2, 192, 128
    f = _d3_state(X, Y, Z, seed=4)
    packed = f.permute(1, 0, 2, 3).reshape(19 * X, Y, Z)  # lbm_tpu's plane 19 x + k
    run = make_d3q19_body(X, Y, Z, omega=1.0 / 0.8, substeps=2, **CAVITY)
    want = _run_lbm_tpu(jsp.make_sharded_body_step(_jmesh8(), 19 * X, Y, Z, run,
                                                   dtype=jnp.float64, block_rows=8,
                                                   interpret=True), packed, 1)
    step = ksh.make_sharded_d3q19_step(mesh.make_mesh(["cpu"] * 8), X, Y, Z, omega=1.0 / 0.8,
                                       substeps=2, dtype=F64, **CAVITY)
    got = _run_port(step, f.reshape(19 * X, Y, Z), 8, 1).reshape(19, X, Y, Z)
    np.testing.assert_allclose(got.numpy(), convert.d3q19_from_planes(want, "cpu", F64).numpy(),
                               rtol=0, atol=1e-13)


# --- against the port's single-device steps, bit for bit ----------------------------

@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("mode,s", [("perturbation", 1), ("perturbation", 5), ("csf", 2),
                                    ("csf", 4)])
def test_k31_plain_equals_single_device(mode, s, n):
    R, C = 192, 12
    csf = mode == "csf"
    x = _full_state(R, C, csf, seed=30 + s)
    step = ksh.make_sharded_mrtcg_step(mesh.make_mesh(["cpu"] * n), R, C, mp.DEFAULT_RED,
                                       mp.DEFAULT_BLUE, dtype=F64, surface_tension=mode,
                                       substeps=s, **MRT)
    factory = mrtcg.make_csf_fused_step if csf else mrtcg.make_mrtcg_fused_step
    want = factory(R, C, mp.DEFAULT_RED, mp.DEFAULT_BLUE, dtype=F64, substeps=s, **MRT)
    assert torch.equal(_run_port(step, x if csf else x.reshape(18, R, C), n, 1), want(x))


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("eos,forcing,s", [("sc", "guo", 1), ("sc", "shift", 4),
                                           ("cs", "shift", 2), ("cs", "guo", 3)])
def test_k32_plain_equals_single_device(eos, forcing, s, n):
    R, C = 64, 12
    kw = dict(omega=1.0, eos=eos, forcing=forcing,
              **({"T": 0.7 * CS_TC} if eos == "cs" else {"G": -5.0}))
    x = _sc_state(R, C, seed=40 + s)
    if eos == "cs":  # around the CS coexistence densities at T/T_c = 0.7
        rho_v, rho_l = maxwell_coexistence(0.7 * CS_TC)
        rho = 0.5 * (rho_v + rho_l) + 0.2 * (rho_l - rho_v) * (d2q9.calc_rho(x) - 0.7) / 0.1
        x = d2q9.equilibrium(torch.zeros((2, R, C), dtype=F64), rho)
    step = ksh.make_sharded_sc_step(mesh.make_mesh(["cpu"] * n), R, C, substeps=s, dtype=F64,
                                    **kw)
    want = shan_chen.make_sc_fused_step(R, C, substeps=s, dtype=F64, **kw)
    got = _run_port(step, x, n, 2)
    assert torch.equal(got, want(want(x))) and bool(torch.isfinite(got).all())


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("walls,s", [("periodic", 1), ("periodic", 8), ("cavity", 2),
                                     ("cavity", 8), ("channel", 3)])
def test_k33_plain_equals_single_device(walls, s, n):
    X, Y, Z = 3, 64, 10
    kw = {"periodic": {}, "cavity": CAVITY,
          "channel": {"x_walls": True, "force_z": 1e-5}}[walls]
    f = _d3_state(X, Y, Z, seed=50 + s)
    step = ksh.make_sharded_d3q19_step(mesh.make_mesh(["cpu"] * n), X, Y, Z, omega=1.0 / 0.7,
                                       substeps=s, dtype=F64, **kw)
    want = d3q19.make_d3q19_fused_step(X, Y, Z, omega=1.0 / 0.7, substeps=s, dtype=F64, **kw)
    got = _run_port(step, f.reshape(19 * X, Y, Z), n, 2).reshape(19, X, Y, Z)
    assert torch.equal(got, want(want(f)))


# --- cadences, layouts and errors ---------------------------------------------------

def test_auto_cadences_of_the_new_families():
    """"auto": 5 (MRT-CG) and 4 (CSF) as kernel 29, 4 for Shan-Chen (2 rows of
    the 8-row strip a sweep), 8 for D3Q19 (1 row)."""
    assert {f: ksh.resolve_substeps("auto", f) for f in ("mrtcg", "csf", "shan_chen",
                                                         "d3q19")} == \
        {"mrtcg": 5, "csf": 4, "shan_chen": 4, "d3q19": 8}
    R, C = 64, 12
    x = _sc_state(R, C, seed=6)
    step = ksh.make_sharded_sc_step(mesh.make_mesh(["cpu"] * 2), R, C, omega=1.0, G=-5.0,
                                    substeps="auto", dtype=F64)
    want = shan_chen.make_sc_fused_step(R, C, omega=1.0, G=-5.0, substeps=4, dtype=F64)
    assert torch.equal(_run_port(step, x, 2, 1), want(x))


def test_k31_takes_its_own_output_and_hands_back_the_colour_pairs():
    """Perturbation mode hands back (2, 9, R/n, C) shards, which gather to F
    (2, 9, R, C) and go into the next call as they are."""
    R, C = 64, 12
    x = _full_state(R, C, False, seed=7)
    m = mesh.make_mesh(["cpu"] * 4)
    step = ksh.make_sharded_mrtcg_step(m, R, C, mp.DEFAULT_RED, mp.DEFAULT_BLUE, dtype=F64,
                                       **MRT)
    y = step(mesh.shard_state(m, x.reshape(18, R, C)))
    assert all(tuple(f.shape) == (2, 9, 16, C) for f in y.shards)
    two = step(y)
    want = mrtcg.make_mrtcg_fused_step(R, C, mp.DEFAULT_RED, mp.DEFAULT_BLUE, dtype=F64,
                                       substeps=2, **MRT)
    assert torch.equal(two.gather(), want(x))
    assert torch.equal(step.plain(y).gather(), two.gather())


def test_new_sharded_steps_reject_bad_shapes_and_cadences():
    m8 = mesh.make_mesh(["cpu"] * 8)
    with pytest.raises(ValueError, match=r"substeps must be an int in \[1, 4\]"):
        ksh.make_sharded_sc_step(m8, 64, 8, omega=1.0, G=-5.0, substeps=5, dtype=F64)
    with pytest.raises(ValueError, match=r"substeps must be an int in \[1, 8\]"):
        ksh.make_sharded_d3q19_step(m8, 2, 64, 8, omega=1.0, substeps=9, dtype=F64)
    with pytest.raises(ValueError, match="shallower than the 24-row exchange strip"):
        ksh.make_sharded_mrtcg_step(m8, 128, 8, mp.DEFAULT_RED, mp.DEFAULT_BLUE, dtype=F64,
                                    surface_tension="csf", substeps=4, **MRT)
    with pytest.raises(ValueError, match="rows 60 not divisible by mesh x=8"):
        ksh.make_sharded_d3q19_step(m8, 2, 60, 8, omega=1.0, dtype=F64)
    with pytest.raises(ValueError, match="lid_u needs y_walls"):
        ksh.make_sharded_d3q19_step(m8, 2, 64, 8, omega=1.0, lid_u=0.1, dtype=F64)
    with pytest.raises(ValueError, match="needs the coupling G"):
        ksh.make_sharded_sc_step(m8, 64, 8, omega=1.0, dtype=F64)
    with pytest.raises(ValueError, match="an \\(n, 1\\) mesh.*sharded2d"):
        ksh.make_sharded_sc_step(mesh.make_mesh(["cpu"] * 8, (4, 2)), 64, 8, omega=1.0,
                                 G=-5.0, dtype=F64)
    step = ksh.make_sharded_d3q19_step(m8, 2, 64, 8, omega=1.0, dtype=F64)
    with pytest.raises(ValueError, match="step built for"):
        step(mesh.shard_state(m8, torch.zeros((19, 64, 8), dtype=F64)))


def test_a_non_cpu_shard_reaches_kernels_31_to_33_or_raises():
    """No fallback: shards off the CPU (the meta device stands in for a
    card) reach the kernels' checks, which take CUDA tensors only."""
    m = mesh.make_mesh(["meta"] * 2)
    cases = (
        (ksh.make_sharded_mrtcg_step(m, 32, 8, mp.DEFAULT_RED, mp.DEFAULT_BLUE, dtype=F64,
                                     **MRT), 18),
        (ksh.make_sharded_mrtcg_step(m, 32, 8, mp.DEFAULT_RED, mp.DEFAULT_BLUE, dtype=F64,
                                     surface_tension="csf", **MRT), 20),
        (ksh.make_sharded_sc_step(m, 32, 8, omega=1.0, G=-5.0, dtype=F64), 9),
        (ksh.make_sharded_d3q19_step(m, 2, 32, 8, omega=1.0, dtype=F64), 38))
    for step, planes in cases:
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            step(mesh.shard_state(m, torch.zeros((planes, 32, 8), dtype=F64, device="meta")))
