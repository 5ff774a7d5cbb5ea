"""The boundary rules of lbm_tpu_torch against lbm_tpu.boundary.bc.

The same numpy-seeded planes go through both packages in float64 on the CPU:
specular, anti-bounce-back (constant and per-node wall velocity, scaled),
ADE-Dirichlet (all eight directions and incoming only), zero-gradient and
the obstacle assignments, on every side, over the whole wall and over a
lane.  The rules copy or negate entries and add one term, so the two agree
to 1e-13 (in fact exactly).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.boundary import bc as jbc

from lbm_tpu_torch.boundary import bc as tbc

TOL = 1e-13
SIDES = ["row0", "rowN", "col0", "colN"]
LANES = [slice(None), slice(1, -1), slice(2, 5)]
R, C = 9, 7


def _planes(seed, planes=9):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.05, 0.3, (planes, R, C)), rng.uniform(0.05, 0.3, (planes, R, C))


def _wall_length(side):
    return C if side.startswith("row") else R


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("side", SIDES)
def test_specular_matches_lbm_tpu(side, lane):
    fa, fc = _planes(1)
    _close(tbc.specular(torch.as_tensor(fa), torch.as_tensor(fc), side, lane),
           jbc.specular(jnp.asarray(fa), jnp.asarray(fc), side, lane))


@pytest.mark.parametrize("per_node", [False, True])
@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("side", SIDES)
def test_anti_bounce_back_matches_lbm_tpu(side, lane, per_node):
    fa, fc = _planes(2)
    rng = np.random.default_rng(3)
    u_w = rng.uniform(-0.1, 0.1, (2, _wall_length(side)) if per_node else (2,))
    got = tbc.anti_bounce_back(torch.as_tensor(fa), torch.as_tensor(fc), side,
                               torch.as_tensor(u_w), lane, scale=0.75)
    _close(got, jbc.anti_bounce_back(jnp.asarray(fa), jnp.asarray(fc), side,
                                     jnp.asarray(u_w), lane, scale=0.75))


@pytest.mark.parametrize("incoming_only", [False, True])
@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("side", SIDES)
def test_ade_dirichlet_matches_lbm_tpu(side, lane, incoming_only):
    fa, fc = _planes(4)
    g_eq = np.random.default_rng(5).uniform(0.0, 0.2, (9, _wall_length(side)))
    got = tbc.ade_dirichlet(torch.as_tensor(fa), torch.as_tensor(fc), side,
                            torch.as_tensor(g_eq), lane, incoming_only=incoming_only)
    _close(got, jbc.ade_dirichlet(jnp.asarray(fa), jnp.asarray(fc), side,
                                  jnp.asarray(g_eq), lane, incoming_only=incoming_only))


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("side", SIDES)
def test_zero_gradient_matches_lbm_tpu(side, lane):
    _, fc = _planes(6)
    _close(tbc.zero_gradient(torch.as_tensor(fc), side, lane),
           jbc.zero_gradient(jnp.asarray(fc), side, lane))


def test_obstacle_bounce_back_matches_lbm_tpu():
    """Raw assignments in order, a later one overwriting an earlier one
    (the sedimentation rectangle's double write)."""
    fa, fc = _planes(7)
    assignments = [
        (1, (slice(2, 5), 3), 3, 1.0),
        (3, (slice(2, 5), 4), 1, 1.0),
        (6, (2, slice(1, 4)), 8, -1.0),
        (1, (3, 3), 7, 0.5),
    ]
    _close(tbc.obstacle_bounce_back(torch.as_tensor(fa), torch.as_tensor(fc), assignments),
           jbc.obstacle_bounce_back(jnp.asarray(fa), jnp.asarray(fc), assignments))


def test_new_rules_leave_their_inputs_alone():
    fa, fc = (torch.as_tensor(a) for a in _planes(8))
    fa0, fc0 = fa.clone(), fc.clone()
    tbc.specular(fa, fc, "col0")
    tbc.anti_bounce_back(fa, fc, "row0", (0.1, 0.0))
    tbc.ade_dirichlet(fa, fc, "rowN", torch.zeros((9, C), dtype=torch.float64))
    tbc.zero_gradient(fc, "colN")
    tbc.obstacle_bounce_back(fa, fc, [(1, (2, 2), 3, 1.0)])
    assert torch.equal(fa, fa0) and torch.equal(fc, fc0)


def test_anti_bounce_back_takes_the_state_dtype():
    """A wall velocity given as python floats is taken in the state's dtype,
    as the plain version of kernel 9 computes its coefficients."""
    fa, fc = (torch.as_tensor(a, dtype=torch.float32) for a in _planes(9))
    got = tbc.anti_bounce_back(fa, fc, "row0", (0.1, 0.0))
    want = tbc.anti_bounce_back(fa, fc, "row0", torch.tensor([0.1, 0.0]))
    assert got.dtype == torch.float32 and torch.equal(got, want)
