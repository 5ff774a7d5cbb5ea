"""The MRT-CG scenes of lbm_tpu_torch (scenes/multiphase.py), their CLI names
and the two-phase conversions, float64 on the CPU.

The port runs lbm_tpu's fused dataflow on either device (the reduced state
for T-1 steps, one split step).  Its oracle is lbm_tpu's jnp model
(MRTCGModel.step) driven with the fused path's convention: u derived from
the populations from the first step on, and in CSF mode the fst0 seed of
lbm_tpu/scenes/multiphase.py:474-482.  Bounds: 1e-12 absolute for the
perturbation mode, 1e-6 for CSF (its normal is a round-off direction
where grad(psi) vanishes, lbm_tpu tests/test_mrtcg_pallas.py:58-64) with
the colour masses at 1e-12 relative.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.models import mrt_cg as jm
from lbm_tpu.ops import d2q9 as jd
from lbm_tpu.scenes import multiphase as jscn

from lbm_tpu_torch import run
from lbm_tpu_torch.io import convert
from lbm_tpu_torch.kernels import mrtcg
from lbm_tpu_torch.scenes import multiphase as scn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "mrtcg-rayleigh-taylor.toml")


def _oracle(scene, R, C, T, sigma=1e-4, gravity_magnitude=6.25e-7, radius=6.0,
            modes=None):
    """lbm_tpu's jnp model on the scene's initial state, seeded with the
    fused path's first-step velocity, T steps."""
    red, blue = jscn.DEFAULT_RED, jscn.DEFAULT_BLUE
    fst = None
    if scene == "droplet":
        g = (0.0, -6.25e-6)
        model = jm.MRTCGModel(red=red, blue=blue, sigma=0.1, gravity=g,
                              apply_gravity_source=False, boundary=jscn.mrtcg_boundary)
        st = model.init_state(jscn.init_rho_droplet(R, C, 3.0, True, radius),
                              jscn.init_rho_droplet(R, C, 1.0, False, radius),
                              dtype=jnp.float64, u_init_gravity_shift=True)
    else:
        g = (gravity_magnitude, 0.0)
        csf = scene == "csf"
        model = jm.MRTCGModel(red=red, blue=blue, sigma=sigma, gravity=g,
                              boundary=jscn.mrtcg_boundary,
                              surface_tension="csf" if csf else "perturbation")
        if modes is not None:
            r0 = jscn.init_rho_modes(R, C, 3.0, True, modes)
            b0 = jscn.init_rho_modes(R, C, 1.0, False, modes)
        else:
            sign = 1.0 if csf else -1.0
            r0 = jscn.init_rho_cosine(R, C, 3.0, True, sign)
            b0 = jscn.init_rho_cosine(R, C, 1.0, False, sign)
        st = model.init_state(r0, b0, dtype=jnp.float64)
        if csf:
            fst = jnp.asarray(g)[:, None, None] * ((st.red.rho + st.blue.rho)[None] / 3.0 - 1.0)
    rho = st.red.rho + st.blue.rho
    shift = jnp.asarray(g)[:, None, None] + (0.0 if fst is None else fst)
    st = jm.TwoPhaseState(st.red, st.blue,
                          jd.calc_u(st.red.f + st.blue.f, rho) + 0.5 * shift / rho)
    step = jax.jit(model.step)
    for _ in range(T):
        st = step(st)
    return st


CASES = {
    "droplet": ("mrtcg_static_droplet", dict(R=25, C=25, T=20, radius=6.0), {}),
    "rayleigh_taylor": ("mrtcg_rayleigh_taylor", dict(R=32, C=16, T=30), {}),
    "rayleigh_taylor_config": ("mrtcg_rayleigh_taylor",
                               dict(R=32, C=16, T=30, config_path=CONFIG), {}),
    "multimode": ("mrtcg_multimode_rayleigh_taylor", dict(R=32, C=16, T=20),
                  dict(modes=((1, -0.1), (3, 0.03), (5, 0.015)))),
    "csf": ("mrt_csf_rayleigh_taylor", dict(R=32, C=16, T=20), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scene_matches_lbm_tpu_model(case):
    name, kwargs, oracle_kw = CASES[case]
    before = (mrtcg.MRTCG_REDUCED.launches, mrtcg.MRTCG_SPLIT.launches)
    got = getattr(scn, name)(device="cpu", **kwargs)
    assert (mrtcg.MRTCG_REDUCED.launches, mrtcg.MRTCG_SPLIT.launches) == before
    kind = {"droplet": "droplet", "csf": "csf"}.get(case, "rt")
    want = _oracle(kind, kwargs["R"], kwargs["C"], kwargs["T"], **oracle_kw,
                   **({"radius": kwargs["radius"]} if "radius" in kwargs else {}))
    tol = 1e-6 if kind == "csf" else 1e-12
    assert got.steps == kwargs["T"] and got.state.red.f.dtype == torch.float64
    for g, w in ((got.state.red.f, want.red.f), (got.state.blue.f, want.blue.f),
                 (got.state.red.rho, want.red.rho), (got.state.u, want.u)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)
    for g, w in ((got.state.red.f, want.red.f), (got.state.blue.f, want.blue.f)):
        assert float(g.sum()) == pytest.approx(float(jnp.sum(w)), rel=1e-12)


def test_droplet_centre_on_a_node_is_a_singular_point():
    """At R = C = 24 the droplet's centre (12, 12) is a grid node, where
    grad(psi) is round-off and the recolouring flux's direction is noise:
    any two summation orders (here the port's stencil and lbm_tpu's XLA
    convolution) disagree there at 1e-4 after one step, and only within one
    cell of the centre.  The 25 x 25 case above has its centre between
    nodes and agrees at 1e-12."""
    got = scn.mrtcg_static_droplet(R=24, C=24, T=1, radius=6.0, device="cpu")
    want = _oracle("droplet", 24, 24, 1)
    diff = np.abs(got.state.red.f.numpy() - np.asarray(want.red.f)).max(0)
    assert diff.max() > 1e-6
    far = np.ones_like(diff, dtype=bool)
    far[11:14, 11:14] = False
    assert diff[far].max() <= 1e-12


@pytest.mark.parametrize("scene,kwargs", [
    ("mrtcg_rayleigh_taylor", dict(R=32, C=16)),
    ("mrtcg_static_droplet", dict(R=25, C=25, radius=6.0)),
])
def test_lbm_tpu_jnp_scene_starts_elsewhere(scene, kwargs):
    """Pin of a reference-side discrepancy (ROADMAP Queue 3): lbm_tpu's jnp
    scene path carries init_state's u into its first step (0 for RT, 0.5
    Fg/rho for the droplet), its fused path derives u from the populations.
    The port follows the fused path, so after one step it differs from the
    jnp scene path, while it equals the model under the fused convention."""
    got = getattr(scn, scene)(device="cpu", T=1, **kwargs)
    jnp_path = getattr(jscn, scene)(fused=False, dtype=jnp.float64, T=1, **kwargs)
    diff = np.abs(got.state.red.f.numpy() - np.asarray(jnp_path.state.red.f)).max()
    assert diff > 1e-8


def test_initial_fields_and_boundary_match_lbm_tpu():
    for name, args in (("init_rho_droplet", (13, 11, 3.0, True, 4.0)),
                       ("init_rho_cosine", (13, 11, 1.0, False, 1.0)),
                       ("init_rho_modes", (13, 11, 3.0, True))):
        np.testing.assert_array_equal(getattr(scn, name)(*args), getattr(jscn, name)(*args))
    rng = np.random.default_rng(9)
    a, b = rng.uniform(0, 1, (9, 7, 6)), rng.uniform(0, 1, (9, 7, 6))
    np.testing.assert_array_equal(
        scn.mrtcg_boundary(torch.tensor(a), torch.tensor(b)).numpy(),
        np.asarray(jscn.mrtcg_boundary(jnp.asarray(a), jnp.asarray(b))))
    assert scn.DEFAULT_RED.__dict__ == jscn.DEFAULT_RED.__dict__
    assert scn.DEFAULT_BLUE.__dict__ == jscn.DEFAULT_BLUE.__dict__


def test_snapshots_follow_lbm_tpu_cadence():
    """Frames before each chunk (RT, droplet) or after it (CSF), as on
    lbm_tpu's fused path."""
    rt = scn.mrtcg_rayleigh_taylor(R=16, C=8, T=25, snapshot_every=10, device="cpu")
    assert rt.snapshots["psi"].shape == rt.snapshots["ux"].shape == (3, 16, 8)
    r0 = scn.init_rho_cosine(16, 8, 3.0, True, -1.0)
    np.testing.assert_allclose(rt.snapshots["psi"][0], np.where(r0 > 0, 1.0, -1.0))
    dr = scn.mrtcg_static_droplet(R=12, C=12, T=5, radius=3.0, snapshot_every=2,
                                  device="cpu")
    assert dr.snapshots["rho"].shape == (3, 12, 12)
    csf = scn.mrt_csf_rayleigh_taylor(R=16, C=8, T=5, snapshot_every=2, device="cpu")
    assert csf.snapshots["psi"].shape == (3, 16, 8)
    assert scn.mrtcg_static_droplet(R=8, C=8, T=2, radius=2.0,
                                    device="cpu").snapshots["rho"] is None


@pytest.mark.parametrize("option", ["checkpoint_dir", "checkpoint_every", "snapshot_prefix"])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match=option):
        scn.mrtcg_rayleigh_taylor(R=8, C=8, T=1, device="cpu", **{option: 1})


def test_scenes_run_on_the_card_unless_asked():
    """No device argument means cuda: with no card the first allocation
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert scn.mrtcg_static_droplet(R=8, C=8, T=2, radius=2.0).state.red.f.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            scn.mrtcg_static_droplet(R=8, C=8, T=2, radius=2.0)


def test_cli_registers_the_multiphase_scenes():
    scenes = run._scenes()
    for name in ("mrtcg_static_droplet", "mrtcg_rayleigh_taylor",
                 "mrtcg_multimode_rayleigh_taylor", "mrt_csf_rayleigh_taylor"):
        assert scenes[name] is getattr(scn, name)


def test_cli_runs_mrtcg_static_droplet(tmp_path):
    out = str(tmp_path / "drop")
    r = subprocess.run(
        [sys.executable, "-m", "lbm_tpu_torch.run", "mrtcg_static_droplet", "--x64",
         "--device", "cpu", "--set", "R=12", "--set", "C=12", "--set", "T=3",
         "--set", "radius=3.0", "--out", out],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    want = scn.mrtcg_static_droplet(R=12, C=12, T=3, radius=3.0, device="cpu")
    np.testing.assert_array_equal(np.load(out + "-state-red-f.npy"), want.state.red.f.numpy())
    np.testing.assert_array_equal(np.load(out + "-state-u.npy"), want.state.u.numpy())
    assert "steps=3" in r.stderr


def test_two_phase_conversions_round_trip():
    rng = np.random.default_rng(12)
    rf, bf = rng.uniform(0, 1, (9, 5, 4)), rng.uniform(0, 1, (9, 5, 4))
    F = convert.two_phase_from_numpy(rf, bf, device="cpu", dtype=torch.float64)
    assert tuple(F.shape) == (2, 9, 5, 4) and F.is_contiguous()
    np.testing.assert_array_equal(convert.state_to_numpy(F), np.stack([rf, bf]))
    for planes in (10, 12):
        G = rng.uniform(0, 1, (planes, 5, 4))
        t = convert.reduced_from_numpy(G, device="cpu", dtype=torch.float32)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(convert.state_to_numpy(t), G.astype(np.float32))
    with pytest.raises(ValueError):
        convert.reduced_from_numpy(np.zeros((11, 5, 4)), device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError):
        convert.two_phase_from_numpy(rf, bf[:, :4], device="cpu", dtype=torch.float64)
    assert convert.colour_params(jscn.DEFAULT_RED) == scn.DEFAULT_RED
