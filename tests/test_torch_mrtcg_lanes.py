"""The lane-blocked reduced MRT-CG step of lbm_tpu_torch (kernels/mrtcg.py
make_mrtcg_reduced_lanes_step, kernel 39 on the card) against lbm_tpu,
float64 on the CPU.

The same numpy-made inputs go through both packages.  Tolerances: 1e-13
absolute against lbm_tpu's lanes step in interpret mode (lbm_tpu's own
bound, tests/test_mrtcg_pallas.py:320-360) and against its reduced step
where its lanes step cannot run, except on bench.py's sharp-layer CSF
state, 1e-6 (tests/test_torch_mrtcg.py's CSF bound); bit for bit against
the port's own reduced step run ``substeps`` times in perturbation mode,
1e-13 in CSF mode.  lbm_tpu's interpret-mode lanes step takes 5-25 s a
call, so each mode calls it twice: on a seeded state and on bench.py's.
On the card kernel 39 is held to kernel 6 and to this plain version
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels import mrtcg_pallas as jp
from lbm_tpu.models import mrt_cg as jmodel
from lbm_tpu.ops import d2q9 as jd2q9
from lbm_tpu.scenes import multiphase as jscn

from lbm_tpu_torch.kernels import mrtcg as tk
from lbm_tpu_torch.scenes import multiphase as tscn

RED, BLUE = tscn.DEFAULT_RED, tscn.DEFAULT_BLUE
KW = dict(sigma=1e-4, gravity=(6.25e-7, 0.0))
MODES = ("perturbation", "csf")


def _state(R, C, surface_tension, seed):
    """A reduced state, made with numpy from ``seed``; a numpy array.

    Perturbation mode: two layers at rest split by a cosine interface, as
    lbm_tpu's lanes test builds them (tests/test_mrtcg_pallas.py:331-348,
    init_rho_cosine), the interface's amplitude and phase drawn from the
    seed and each population scaled by 1 + U(-0.01, 0.01).

    CSF mode: both colours everywhere, psi = 0.8 sin(2 pi (row + 0.5) / 96)
    + 0.1 cos(2 pi (col + 0.5) / C + phase), phase a multiple of pi / 2
    drawn from the seed, so that no 5x5 gradient of psi cancels to round-off
    (the extremes of each term fall midway between rows and columns); each
    population times 1 + U(-1e-4, 1e-4) and a surface-force carry of U(-1e-6,
    1e-6).  Where grad(psi) is round-off (the layers' interiors) the CSF
    normal is a round-off direction and the two packages' stencil sums, in
    different orders, part by ~1e-6 after one step; there lbm_tpu's bound
    is 1e-6 (tests/test_torch_mrtcg.py), here it is 1e-13."""
    rng = np.random.default_rng(seed)
    feq = np.asarray(jd2q9.equilibrium(jnp.zeros((2, R, C), jnp.float64), jnp.ones((R, C))))
    red0, blue0 = jscn.DEFAULT_RED.rho_0, jscn.DEFAULT_BLUE.rho_0
    if surface_tension == "csf":
        phase = 0.5 * np.pi * rng.integers(4)
        psi = (0.8 * np.sin(2.0 * np.pi * (np.arange(R)[:, None] + 0.5) / 96.0)
               + 0.1 * np.cos(2.0 * np.pi * (np.arange(C)[None, :] + 0.5) / C + phase))
        noise = rng.uniform(1.0 - 1e-4, 1.0 + 1e-4, (2, 9, R, C))
        S = np.concatenate([red0 * 0.5 * (1.0 + psi)[None] * feq * noise[0],
                            blue0 * 0.5 * (1.0 - psi)[None] * feq * noise[1],
                            rng.uniform(-1e-6, 1e-6, (2, R, C))])
    else:
        amp, phase = rng.uniform(0.05, 0.15), rng.uniform(0.0, 2.0 * np.pi)
        r = np.arange(R)[:, None] * np.ones((1, C))
        s = R / 2.0 + amp * C * np.cos(2.0 * np.pi * np.arange(C) / C + phase)[None, :]
        r0, b0 = red0 * (r < s), blue0 * (r >= s)
        feq = feq * rng.uniform(0.99, 1.01, (2, 9, R, C))
        S = np.stack([r0[None] * feq[0] / (r0 + b0)[None], b0[None] * feq[1] / (r0 + b0)[None]])
    return np.asarray(jp.reduce_mrtcg_state(jnp.asarray(S), surface_tension))


def _bench_state(R, C, surface_tension):
    """bench.py's reduced state for --model mrtcg / csf (:89-108, :118-147):
    lbm_tpu's init_rho_cosine layers at rest, sign -1 (CSF +1 and two zero
    surface-force planes); a numpy array."""
    csf = surface_tension == "csf"
    sign = 1.0 if csf else -1.0
    st = jmodel.MRTCGModel(red=jscn.DEFAULT_RED, blue=jscn.DEFAULT_BLUE,
                           surface_tension=surface_tension, **KW).init_state(
        jscn.init_rho_cosine(R, C, jscn.DEFAULT_RED.rho_0, True, sign),
        jscn.init_rho_cosine(R, C, jscn.DEFAULT_BLUE.rho_0, False, sign), dtype=jnp.float64)
    f = (jnp.concatenate([st.red.f, st.blue.f, jnp.zeros((2, R, C), jnp.float64)]) if csf
         else jnp.stack([st.red.f, st.blue.f]))
    return np.asarray(jp.reduce_mrtcg_state(f, surface_tension))


def _port(R, C, surface_tension, substeps, lane_block, G):
    step = tk.make_mrtcg_reduced_lanes_step(R, C, RED, BLUE, dtype=torch.float64,
                                            surface_tension=surface_tension,
                                            substeps=substeps, lane_block=lane_block, **KW)
    return step(torch.tensor(G, dtype=torch.float64))


def _jkw(surface_tension):
    return dict(dtype=jnp.float64, interpret=True, surface_tension=surface_tension, **KW)


# --- (a) against lbm_tpu's lanes step ------------------------------------------------

@pytest.mark.parametrize("surface_tension", MODES)
def test_lanes_step_matches_lbm_tpu_lanes_step(surface_tension):
    """48x512, LB = 256, 2 steps a call: lbm_tpu's lanes step (interpret)
    and the port's plain lanes step within 1e-13."""
    R, C, s, LB = 48, 512, 2, 256
    G = _state(R, C, surface_tension, seed=1)
    want = jp.make_mrtcg_reduced_lanes_step(R, C, jscn.DEFAULT_RED, jscn.DEFAULT_BLUE,
                                            substeps=s, lane_block=LB,
                                            **_jkw(surface_tension))(jnp.asarray(G))
    got = _port(R, C, surface_tension, s, LB, G)
    assert tuple(got.shape) == (tk.reduced_planes(surface_tension), R, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-13)


@pytest.mark.parametrize("surface_tension", MODES)
def test_lanes_step_matches_lbm_tpu_on_bench_states(surface_tension):
    """bench.py's --lane-block states (sharp layers at rest), 48x512, LB =
    256, 2 steps a call, against lbm_tpu's lanes step (interpret): 1e-13 in
    perturbation mode; in CSF mode 1e-6, tests/test_torch_mrtcg.py's bound
    for kernel 6's CSF step, since there the normal is a round-off
    direction wherever grad(psi) cancels (the layers' interiors)."""
    R, C, s, LB = 48, 512, 2, 256
    G = _bench_state(R, C, surface_tension)
    want = jp.make_mrtcg_reduced_lanes_step(R, C, jscn.DEFAULT_RED, jscn.DEFAULT_BLUE,
                                            substeps=s, lane_block=LB,
                                            **_jkw(surface_tension))(jnp.asarray(G))
    got = _port(R, C, surface_tension, s, LB, G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 if surface_tension == "csf" else 1e-13)


# --- (b) against the port's reduced step ---------------------------------------------

@pytest.mark.parametrize("R,C,lane_block,substeps", [(32, 256, 256, 2), (40, 256, 128, 3)])
@pytest.mark.parametrize("surface_tension", MODES)
def test_lanes_step_equals_reduced_step_run_substeps_times(surface_tension, R, C, lane_block,
                                                           substeps):
    """One block as wide as the grid, and LB = 128 with 3 steps a call:
    bit for bit the reduced step (perturbation), 1e-13 (CSF)."""
    G = torch.tensor(_state(R, C, surface_tension, seed=R + lane_block), dtype=torch.float64)
    got = _port(R, C, surface_tension, substeps, lane_block, G.numpy())
    want = tk.make_mrtcg_reduced_step(R, C, RED, BLUE, dtype=torch.float64,
                                      surface_tension=surface_tension, substeps=substeps,
                                      **KW)(G)
    if surface_tension == "perturbation":
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max().item() <= 1e-13


@pytest.mark.parametrize("surface_tension", MODES)
def test_lanes_step_refuses_windows_wider_than_2C(surface_tension):
    """At LB = C = 256 the deepest call whose window, LB + 2 substeps rps
    columns, fits in 2C (42 steps, CSF 25) builds with that margin and
    equals the reduced step run that often, bit for bit, from bench.py's
    kind of state (the layers at rest; its margins wrap past C).  One step
    more is refused, though lbm_tpu's guards take it: its margin passes
    128, where lbm_tpu's margins are not valid either (mrtcg_pallas.py:
    1060-1062)."""
    R, C = 32, 256
    rps = tk.rows_per_sweep(surface_tension)
    deepest = C // (2 * rps)
    assert deepest * rps <= 128 < (deepest + 1) * rps
    kw = dict(dtype=torch.float64, surface_tension=surface_tension, lane_block=C, **KW)
    with pytest.raises(ValueError, match="wider than 2C"):
        tk.make_mrtcg_reduced_lanes_step(R, C, RED, BLUE, substeps=deepest + 1, **kw)
    step = tk.make_mrtcg_reduced_lanes_step(R, C, RED, BLUE, substeps=deepest, **kw)
    assert step.margin == deepest * rps
    G = torch.tensor(_bench_state(R, C, surface_tension))
    want = tk.make_mrtcg_reduced_step(R, C, RED, BLUE, dtype=torch.float64,
                                      surface_tension=surface_tension, substeps=deepest,
                                      **KW)(G)
    got = step(G)
    assert torch.isfinite(got).all() and torch.equal(got, want)


# --- (c) where lbm_tpu's lanes step crashes (ADVICE.md, mrtcg_pallas.py:1110) ---------

@functools.cache
def _advice_reference(surface_tension):
    """(state, lbm_tpu's reduced step run 2 steps on it) at 24x256; CSF
    takes 2 calls of one step (lbm_tpu's CSF slab needs R >= 48 at 2)."""
    R, C = 24, 256
    G = _state(R, C, surface_tension, seed=7)
    csf = surface_tension == "csf"
    step = jp.make_mrtcg_reduced_step(R, C, jscn.DEFAULT_RED, jscn.DEFAULT_BLUE,
                                      substeps=1 if csf else 2, **_jkw(surface_tension))
    out = step(jnp.asarray(G))
    return G, np.asarray(step(out) if csf else out)


@pytest.mark.parametrize("lane_block", [256, 128])
@pytest.mark.parametrize("surface_tension", MODES)
def test_lanes_step_runs_where_lbm_tpu_crashes(surface_tension, lane_block):
    """R = 24, C = 256, LB + 256 > C: lbm_tpu's guard admits the lane block
    and its lanes step then fails to trace; the port runs and matches
    lbm_tpu's reduced step within 1e-13."""
    R, C = 24, 256
    G, want = _advice_reference(surface_tension)
    got = _port(R, C, surface_tension, 2, lane_block, G)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)


def test_lbm_tpu_lanes_step_fails_where_its_guard_admits():
    """The reference-side defect the port does not copy (ADVICE.md,
    mrtcg_pallas.py:1110): a (24, 256) row-index plane against a window of
    LB + 256 lanes."""
    R, C = 24, 256
    step = jp.make_mrtcg_reduced_lanes_step(R, C, jscn.DEFAULT_RED, jscn.DEFAULT_BLUE,
                                            substeps=1, lane_block=256,
                                            **_jkw("perturbation"))
    with pytest.raises(ValueError, match="Incompatible shapes"):
        step(jnp.asarray(_state(R, C, "perturbation", seed=3)))


# --- (d) the arguments lbm_tpu refuses -----------------------------------------------

@pytest.mark.parametrize("C,lane_block", [(512, 100), (384, 256), (128, 128)])
@pytest.mark.parametrize("surface_tension", MODES)
def test_lanes_step_refuses_what_lbm_tpu_refuses(surface_tension, C, lane_block):
    """LB not a multiple of 128, C not a multiple of LB, LB + 256 > 2C:
    the port's ValueError carries lbm_tpu's message."""
    with pytest.raises(ValueError) as want:
        jp.make_mrtcg_reduced_lanes_step(32, C, jscn.DEFAULT_RED, jscn.DEFAULT_BLUE,
                                         substeps=1, lane_block=lane_block,
                                         **_jkw(surface_tension))
    with pytest.raises(ValueError) as got:
        tk.make_mrtcg_reduced_lanes_step(32, C, RED, BLUE, dtype=torch.float64,
                                         surface_tension=surface_tension, lane_block=lane_block,
                                         **KW)
    assert str(got.value) == str(want.value)


def test_lanes_step_rejects_what_it_does_not_take():
    step = tk.make_mrtcg_reduced_lanes_step(32, 256, RED, BLUE, dtype=torch.float64,
                                            substeps=2, lane_block=128, **KW)
    with pytest.raises(ValueError, match="step built for"):
        step(torch.zeros((10, 32, 256), dtype=torch.float32))
    with pytest.raises(ValueError, match="step built for"):
        step(torch.zeros((12, 32, 256), dtype=torch.float64))
    with pytest.raises(ValueError, match="substeps"):
        tk.make_mrtcg_reduced_lanes_step(32, 256, RED, BLUE, substeps="auto", lane_block=128,
                                         **KW)
    with pytest.raises(ValueError, match="surface_tension"):
        tk.make_mrtcg_reduced_lanes_step(32, 256, RED, BLUE, surface_tension="capillary", **KW)
    # the kernel's wrapper takes CUDA tensors only: a CPU state never reaches it
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.launch_mrtcg_lanes(torch.zeros((10, 32, 256)), tk.kernel_params(
            RED, BLUE, 1e-4, (0.0, 0.0), 0.1, True), False, 128, 1)


# --- (e) the overhead factor (ADVICE.md, mrtcg_pallas.py:1125) -----------------------

def test_lane_overhead_is_exact():
    """1.5 for lbm_tpu's 128-lane margins at LB = 512, where its
    floor-divided ``1 + 2 * CHALO // LB`` reads 1; the port's step reports
    (LB + 2 m) / LB for its margins m = substeps * rows_per_sweep."""
    assert tk.lane_overhead(512, jp.CHALO) == 1.5
    assert 1 + 2 * jp.CHALO // 512 == 1  # the reference's floor division
    assert tk.lane_overhead(256, jp.CHALO) == 2.0
    for surface_tension, rps in (("perturbation", 3), ("csf", 5)):
        assert tk.rows_per_sweep(surface_tension) == rps
        for LB, s in ((256, 1), (256, 5), (512, 2), (2048, 4)):
            step = tk.make_mrtcg_reduced_lanes_step(64, 2048, RED, BLUE,
                                                    surface_tension=surface_tension,
                                                    substeps=s, lane_block=LB, **KW)
            assert step.margin == s * rps
            assert step.overhead == (LB + 2 * s * rps) / LB
