"""The MRT-CG slice of lbm_tpu_torch against lbm_tpu, float64 on the CPU:
core/params.py, ops/gradients.py, bc.periodic_edge, models/mrt_cg.py and
the plain versions of CUDA kernels 6-8 (kernels/mrtcg.py).

The same numpy-seeded inputs go through both packages.  Tolerances:
operators and the model 1e-13 absolute (summation order only); the plain
kernels against lbm_tpu's Pallas kernels in interpret mode at lbm_tpu's
own bounds (tests/test_mrtcg_pallas.py): 1e-12 for the perturbation mode,
1e-6 for CSF, whose normal is a round-off direction wherever grad(psi)
vanishes.  On the card the kernels are held to these plain versions
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.boundary import bc as jbc
from lbm_tpu.core import params as jparams
from lbm_tpu.kernels import mrtcg_pallas as jp
from lbm_tpu.models import mrt_cg as jm
from lbm_tpu.ops import gradients as jg
from lbm_tpu.scenes import multiphase as jscn

from lbm_tpu_torch.boundary import bc as tbc
from lbm_tpu_torch.core import params as tparams
from lbm_tpu_torch.kernels import mrtcg as tk
from lbm_tpu_torch.models import mrt_cg as tm
from lbm_tpu_torch.ops import gradients as tg
from lbm_tpu_torch.scenes import multiphase as tscn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-13
RED, BLUE = tscn.DEFAULT_RED, tscn.DEFAULT_BLUE
GRAVITY = (6.25e-7, 0.0)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


# --- core/params.py ---------------------------------------------------------------

def test_params_match_lbm_tpu():
    path = os.path.join(REPO, "configs", "mrtcg-rayleigh-taylor.toml")
    tbl = tparams.load_toml(path)
    assert tbl == jparams.load_toml(path)
    assert tparams.DomainParams.from_toml(tbl).__dict__ == \
        jparams.DomainParams.from_toml(tbl).__dict__
    assert tparams.DomainParams.from_toml(tbl).period_snapshots == 100
    assert tparams.GeneralParams.from_toml(tbl).__dict__ == \
        jparams.GeneralParams.from_toml(tbl).__dict__
    for key in ("red", "blue"):
        t, j = tparams.ColourParams.from_toml(tbl, key), jparams.ColourParams.from_toml(tbl, key)
        assert t.__dict__ == j.__dict__
        assert (t.mu, t.cs2, t.ics2, t.rlx) == (j.mu, j.cs2, j.ics2, j.rlx)
        np.testing.assert_array_equal(t.phi(), j.phi())
        np.testing.assert_array_equal(t.eta(), j.eta())
    with pytest.raises(KeyError, match="sigma"):
        tparams.GeneralParams.from_toml({"general": {"name": "x", "gravity_magnitude": 1.0}})


# --- ops/gradients.py -------------------------------------------------------------

GRADS = {
    "dx5": lambda m, x: m.dx5(x),
    "dy5": lambda m, x: m.dy5(x),
    "grad5": lambda m, x: m.grad5(x),
    "dx3_swapped": lambda m, x: m.dx3(x),
    "dy3_swapped": lambda m, x: m.dy3(x),
    "grad3_swapped": lambda m, x: m.grad3(x),
    "dx3_plain": lambda m, x: m.dx3(x, reference_swapped=False),
    "dy3_plain": lambda m, x: m.dy3(x, reference_swapped=False),
    "grad3_plain": lambda m, x: m.grad3(x, reference_swapped=False),
}


@pytest.mark.parametrize("shape", [(21, 13), (7, 5)])
@pytest.mark.parametrize("name", sorted(GRADS))
def test_gradient_matches_lbm_tpu(name, shape):
    x = np.random.default_rng(sum(shape)).uniform(-1.0, 1.0, shape)
    got = GRADS[name](tg, _t(x))
    assert got.dtype == torch.float64
    _close(got, GRADS[name](jg, jnp.asarray(x)))


def test_gradient_kernels_are_lbm_tpu_s():
    for name in ("XI_5", "KERNEL_X5", "KERNEL_Y5", "KERNEL_X3", "KERNEL_Y3"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name))


@pytest.mark.parametrize("name", ["dx5", "dy5", "dx3_swapped", "grad3_plain"])
def test_gradient_float32_tracks_float64(name):
    """The TF32 guard: the stencils are explicit sums, so float32 keeps
    float32's digits (TF32 would keep ~3)."""
    x = np.random.default_rng(3).uniform(-1.0, 1.0, (33, 17))
    lo = GRADS[name](tg, torch.as_tensor(x, dtype=torch.float32))
    hi = GRADS[name](tg, _t(x))
    assert lo.dtype == torch.float32
    np.testing.assert_allclose(lo.double().numpy(), hi.numpy(), rtol=0, atol=2e-7)


# --- boundary/bc.py periodic_edge -----------------------------------------------------

@pytest.mark.parametrize("lane", [slice(None), slice(1, -1)], ids=["full", "inner"])
@pytest.mark.parametrize("diagonal_shift", [True, False])
@pytest.mark.parametrize("side", ["row0", "rowN", "col0", "colN"])
def test_periodic_edge_matches_lbm_tpu(side, diagonal_shift, lane):
    rng = np.random.default_rng(11)
    a, b = rng.uniform(0.0, 1.0, (9, 7, 5)), rng.uniform(0.0, 1.0, (9, 7, 5))
    ta = _t(a)
    got = tbc.periodic_edge(ta, _t(b), side, lane, diagonal_shift)
    want = jbc.periodic_edge(jnp.asarray(a), jnp.asarray(b), side, lane, diagonal_shift)
    _close(got, want, tol=0.0)
    np.testing.assert_array_equal(ta.numpy(), a)  # inputs left alone


# --- models/mrt_cg.py ----------------------------------------------------------------

def _fields(R=21, C=13, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "f": rng.uniform(0.05, 0.3, (9, R, C)),
        "feq": rng.uniform(0.05, 0.3, (9, R, C)),
        "r_rho": 3.0 * rng.uniform(0.2, 0.8, (R, C)),
        "b_rho": rng.uniform(0.2, 0.8, (R, C)),
        "u": rng.uniform(-0.05, 0.05, (2, R, C)),
        "grad": rng.uniform(-0.3, 0.3, (2, R, C)),
        "fs": rng.uniform(-1e-4, 1e-4, (2, R, C)),
        "psi": rng.uniform(-1.0, 1.0, (R, C)),
        "s_nu": rng.uniform(1.0, 1.6, (R, C)),
        "corr": rng.uniform(-1e-3, 1e-3, (9, R, C)),
        "n": rng.uniform(-1.0, 1.0, (2, R, C)),
    }


def _norm(g):
    return (g[0] ** 2 + g[1] ** 2) ** 0.5


MRT_CG = {
    "phase_field": lambda m, a: m.phase_field(a["r_rho"], 3.0, a["b_rho"], 1.0),
    "relaxation": lambda m, a: m.RelaxationFunction.from_omegas(RED, BLUE, 0.1)(a["psi"]),
    "cg_equilibrium": lambda m, a: m.cg_equilibrium(a["r_rho"], RED.phi(), RED.eta(), a["u"]),
    "s_vector": lambda m, a: m.s_vector(a["s_nu"], a["s_nu"].dtype),
    "mrt_omega1": lambda m, a: m.mrt_omega1(a["f"], a["feq"], a["corr"], a["s_nu"]),
    "correction_C": lambda m, a: m.correction_C(0.7, a["r_rho"], a["u"], a["s_nu"]),
    "xi_perturbation": lambda m, a: m.xi_perturbation(a["grad"], _norm(a["grad"])),
    "kappa_unit_e": lambda m, a: m.kappa_recolour(
        a["r_rho"], a["b_rho"], a["r_rho"] + a["b_rho"], a["grad"], _norm(a["grad"]),
        RED.phi(), BLUE.phi()),
    "kappa_plain_e": lambda m, a: m.kappa_recolour(
        a["r_rho"], a["b_rho"], a["r_rho"] + a["b_rho"], a["grad"], _norm(a["grad"]),
        RED.phi(), BLUE.phi(), unit_e=False),
    "recolour": lambda m, a: m.recolour(a["f"], a["r_rho"], a["r_rho"] + a["b_rho"], 0.7,
                                        a["corr"]),
    "local_curvature": lambda m, a: m.local_curvature(a["n"]),
    "csf_eta": lambda m, a: m.csf_eta(a["u"], a["fs"]),
}


@pytest.mark.parametrize("name", sorted(MRT_CG))
def test_mrt_cg_function_matches_lbm_tpu(name):
    fields = _fields()
    got = MRT_CG[name](tm, {k: _t(v) for k, v in fields.items()})
    want = MRT_CG[name](jm, {k: jnp.asarray(v) for k, v in fields.items()})
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float64
    _close(got, want)


def test_relaxation_branches_at_their_edges():
    """The three selects in lbm_tpu's order fix the values at 0 and at
    +/-delta, and a NaN stays a NaN."""
    psi = np.array([0.0, 0.1, -0.1, 0.1 + 1e-17, -0.1 - 1e-12, 1.0, -1.0, np.nan])
    relax_t = tm.RelaxationFunction.from_omegas(RED, BLUE, 0.1)
    got = relax_t(_t(psi)).numpy()
    want = np.asarray(jm.RelaxationFunction.from_omegas(RED, BLUE, 0.1)(jnp.asarray(psi)))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[-1]) and got[5] == RED.rlx and got[6] == BLUE.rlx


def _mixed_state(R, C, seed, csf):
    """A two-phase state with both colours everywhere (so the recolouring
    flux is exercised), populations scaled by 1 + U(-0.03, 0.03), and the
    carried u derived from them as the fused step derives it."""
    rng = np.random.default_rng(seed)
    r_rho = 3.0 * rng.uniform(0.2, 0.8, (R, C))
    b_rho = rng.uniform(0.2, 0.8, (R, C))
    model = jm.MRTCGModel(red=RED, blue=BLUE, sigma=1e-4)
    st = model.init_state(r_rho, b_rho, dtype=jnp.float64)
    rf = np.asarray(st.red.f) * rng.uniform(0.97, 1.03, (9, R, C))
    bf = np.asarray(st.blue.f) * rng.uniform(0.97, 1.03, (9, R, C))
    fst = rng.uniform(-1e-6, 1e-6, (2, R, C)) if csf else np.zeros((2, R, C))
    rho = rf.sum(0) + bf.sum(0)
    mom = np.stack([(rf + bf)[[1, 5, 8]].sum(0) - (rf + bf)[[3, 6, 7]].sum(0),
                    (rf + bf)[[2, 5, 6]].sum(0) - (rf + bf)[[4, 7, 8]].sum(0)])
    u = mom / rho + 0.5 * (np.asarray(GRAVITY)[:, None, None] + fst) / rho
    return rf, bf, fst, u


def _models(surface_tension):
    kw = dict(sigma=1e-4, gravity=GRAVITY, surface_tension=surface_tension)
    return (tm.MRTCGModel(red=RED, blue=BLUE, boundary=tscn.mrtcg_boundary, **kw),
            jm.MRTCGModel(red=RED, blue=BLUE, boundary=jscn.mrtcg_boundary, **kw))


@pytest.mark.parametrize("surface_tension", ["perturbation", "csf"])
def test_model_step_matches_lbm_tpu(surface_tension):
    R, C = 21, 13
    rf, bf, _, u = _mixed_state(R, C, 5, csf=False)
    t_model, j_model = _models(surface_tension)
    ts = tm.TwoPhaseState(tm.ColourFields(_t(rf), _t(rf.sum(0))),
                          tm.ColourFields(_t(bf), _t(bf.sum(0))), _t(u))
    js = jm.TwoPhaseState(jm.ColourFields(jnp.asarray(rf), jnp.asarray(rf.sum(0))),
                          jm.ColourFields(jnp.asarray(bf), jnp.asarray(bf.sum(0))),
                          jnp.asarray(u))
    for _ in range(3):
        ts, js = t_model.step(ts), j_model.step(js)
    for got, want in ((ts.red.f, js.red.f), (ts.blue.f, js.blue.f), (ts.red.rho, js.red.rho),
                      (ts.u, js.u)):
        _close(got, want)


def test_model_init_state_matches_lbm_tpu():
    r0 = tscn.init_rho_droplet(12, 10, 3.0, True, radius=3.0)
    b0 = tscn.init_rho_droplet(12, 10, 1.0, False, radius=3.0)
    t_model, j_model = _models("perturbation")
    for kw in (dict(u_init_gravity_shift=True), dict(u0=np.array([1e-3, -2e-3])[:, None, None])):
        ts = t_model.init_state(r0, b0, dtype=torch.float64, device="cpu", **kw)
        js = j_model.init_state(r0, b0, dtype=jnp.float64, **kw)
        _close(ts.red.f, js.red.f)
        _close(ts.blue.f, js.blue.f)
        _close(ts.u, js.u)
    st = t_model.init_state(r0, b0, dtype=torch.float32, device="cpu")
    assert st.red.f.dtype == torch.float32


# --- kernels/mrtcg.py: the plain versions of kernels 6-8 ------------------------------

def test_reduce_state_matches_lbm_tpu():
    rf, bf, fst, _ = _mixed_state(8, 6, 1, csf=True)
    F = np.stack([rf, bf])
    S = np.concatenate([rf, bf, fst])
    _close(tk.reduce_mrtcg_state(_t(F)), jp.reduce_mrtcg_state(jnp.asarray(F)), tol=0.0)
    _close(tk.reduce_mrtcg_state(_t(S), "csf"),
           jp.reduce_mrtcg_state(jnp.asarray(S), "csf"), tol=0.0)
    assert (tk.reduced_planes(), tk.reduced_planes("csf")) == (10, 12)
    assert (tk.full_planes(), tk.full_planes("csf")) == (18, 20)
    with pytest.raises(ValueError, match="surface_tension"):
        tk.reduced_planes("capillary")


@pytest.mark.parametrize("layout", ["reduced", "split", "full"])
@pytest.mark.parametrize("surface_tension", ["perturbation", "csf"])
def test_plain_kernel_matches_lbm_tpu_pallas(surface_tension, layout):
    """Each plain step against lbm_tpu's Pallas kernel in interpret mode
    (f64, 32x128, block_rows=8) on a mixed state: 1e-12 (perturbation),
    1e-6 (CSF)."""
    R, C = 32, 128
    csf = surface_tension == "csf"
    rf, bf, fst, _ = _mixed_state(R, C, 2, csf)
    full = np.concatenate([rf, bf, fst]) if csf else np.stack([rf, bf])
    reduced = np.asarray(jp.reduce_mrtcg_state(jnp.asarray(full), surface_tension))
    jkw = dict(sigma=1e-4, gravity=GRAVITY, dtype=jnp.float64, block_rows=8, interpret=True)
    tkw = dict(sigma=1e-4, gravity=GRAVITY, dtype=torch.float64)
    if layout == "full":
        x = full
        want = (jp.make_csf_fused_step if csf else jp.make_mrtcg_fused_step)(
            R, C, jscn.DEFAULT_RED, jscn.DEFAULT_BLUE, **jkw)(jnp.asarray(x))
        got = (tk.make_csf_fused_step if csf else tk.make_mrtcg_fused_step)(
            R, C, RED, BLUE, **tkw)(_t(x))
    else:
        jf = jp.make_mrtcg_reduced_step if layout == "reduced" else jp.make_mrtcg_split_step
        tf = tk.make_mrtcg_reduced_step if layout == "reduced" else tk.make_mrtcg_split_step
        want = jf(R, C, jscn.DEFAULT_RED, jscn.DEFAULT_BLUE, surface_tension=surface_tension,
                  **jkw)(jnp.asarray(reduced))
        got = tf(R, C, RED, BLUE, surface_tension=surface_tension, **tkw)(_t(reduced))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, tol=1e-6 if csf else 1e-12)


@pytest.mark.parametrize("surface_tension", ["perturbation", "csf"])
def test_plain_reduced_step_equals_the_model(surface_tension):
    """reduced_step(reduce(F)) == reduce(MRTCGModel.step(F)) with the model
    seeded with the derived u (1e-12, f64, 21x13, 3 steps); the split step
    then gives the model's per-colour populations."""
    R, C = 21, 13
    csf = surface_tension == "csf"
    rf, bf, fst, u = _mixed_state(R, C, 4, csf)
    t_model, _ = _models(surface_tension)
    st = tm.TwoPhaseState(tm.ColourFields(_t(rf), _t(rf.sum(0))),
                          tm.ColourFields(_t(bf), _t(bf.sum(0))), _t(u))
    full = np.concatenate([rf, bf, fst]) if csf else np.stack([rf, bf])
    G = tk.reduce_mrtcg_state(_t(full), surface_tension)
    kw = dict(sigma=1e-4, gravity=GRAVITY, dtype=torch.float64,
              surface_tension=surface_tension)
    step = tk.make_mrtcg_reduced_step(R, C, RED, BLUE, **kw)
    for _ in range(2):
        st, G = t_model.step(st), step(G)
        np.testing.assert_allclose(G[:9].numpy(), (st.red.f + st.blue.f).numpy(),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(G[9].numpy(), st.red.rho.numpy(), rtol=0, atol=1e-12)
    out = tk.make_mrtcg_split_step(R, C, RED, BLUE, **kw)(G).reshape(-1, R, C)
    st = t_model.step(st)
    np.testing.assert_allclose(out[:9].numpy(), st.red.f.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(out[9:18].numpy(), st.blue.f.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("factory", ["reduced", "reduced_csf", "full", "csf_full"])
def test_substeps_equal_single_steps(factory):
    R, C = 12, 9
    rf, bf, fst, _ = _mixed_state(R, C, 6, csf=True)
    kw = dict(sigma=1e-4, gravity=GRAVITY, dtype=torch.float64)
    build, x = {
        "reduced": (lambda n: tk.make_mrtcg_reduced_step(R, C, RED, BLUE, substeps=n, **kw),
                    tk.reduce_mrtcg_state(_t(np.stack([rf, bf])))),
        "reduced_csf": (lambda n: tk.make_mrtcg_reduced_step(
            R, C, RED, BLUE, surface_tension="csf", substeps=n, **kw),
            tk.reduce_mrtcg_state(_t(np.concatenate([rf, bf, fst])), "csf")),
        "full": (lambda n: tk.make_mrtcg_fused_step(R, C, RED, BLUE, substeps=n, **kw),
                 _t(np.stack([rf, bf]))),
        "csf_full": (lambda n: tk.make_csf_fused_step(R, C, RED, BLUE, substeps=n, **kw),
                     _t(np.concatenate([rf, bf, fst]))),
    }[factory]
    one = build(1)
    assert torch.equal(build(2)(x), one(one(x)))


def test_factories_reject_what_they_do_not_take():
    with pytest.raises(ValueError, match="_WIDE_OPT"):
        tk.make_mrtcg_reduced_step(32, 128, RED, BLUE, 1e-4, substeps="auto")
    with pytest.raises(ValueError, match="substeps"):
        tk.make_mrtcg_fused_step(8, 8, RED, BLUE, 1e-4, substeps=0)
    step = tk.make_mrtcg_reduced_step(8, 8, RED, BLUE, 1e-4, dtype=torch.float64)
    with pytest.raises(ValueError, match="step built for"):
        step(torch.zeros((10, 8, 8), dtype=torch.float32))
    with pytest.raises(ValueError, match="step built for"):
        step(torch.zeros((12, 8, 8), dtype=torch.float64))


def test_kernel_params_are_the_plain_versions_scalars():
    """csrc/mrtcg.cuh reads ``kernel_params`` by position (enum P): 41
    doubles, the relaxation function's and the derived colour constants."""
    p = tk.kernel_params(RED, BLUE, 1e-4, GRAVITY, 0.1, True)
    relax = tm.RelaxationFunction.from_omegas(RED, BLUE, 0.1)
    assert len(p) == 41 and all(isinstance(v, float) for v in p)
    assert p[:10] == (1 / 3.0, 1.0, 0.1, relax.r_val, relax.b_val, relax.s1, relax.s2,
                      relax.s3, relax.t2, relax.t3)
    assert p[32] == 1.0 and tk.kernel_params(RED, BLUE, 1e-4, GRAVITY, 0.1, False)[32] == 0.0
    assert p[33:37] == (6.25e-7, 0.0, 6.25e-7, 6.25e-7)
