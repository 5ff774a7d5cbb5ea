"""The port's immersed boundary (ops/ibm.py) and the plain version of CUDA
kernel 16 (kernels/ibm.py) against lbm_tpu.

Every IBM field equals lbm_tpu's exactly (both build them in float64 numpy);
force_density_roi and the plain forcing step match lbm_tpu's jnp operator
and its Pallas forcing kernel (interpret mode) at 1e-13 in float64.  The
plain version's interpolation and spreading are matmuls, so float32 is held
to float64 at 1e-6 relative with TF32 off.  Kernel 16 itself is held to the
plain version on the card by tests/test_torch_cuda.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.kernels.ibm_pallas import make_ibm_forcing_step as jax_forcing_step
from lbm_tpu.ops import d2q9 as jd
from lbm_tpu.ops import ibm as jibm

from lbm_tpu_torch.io import convert
from lbm_tpu_torch.kernels import ibm as kibm
from lbm_tpu_torch.ops import ibm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARKERS = os.path.join(REPO, "configs", "cylinder-markers.toml")


def _builds(port, jax):
    """(port IBM, lbm_tpu IBM) pairs over the constructors and both pairings."""
    theta = np.linspace(0.0, 2.0 * np.pi, 19, endpoint=False)
    xs, ys = 31.3 + 7.7 * np.cos(theta), 12.6 + 5.1 * np.sin(theta)
    return {
        "circle": (port.IBM.circle(60.0, 60.0, 20.0, 64),
                   jax.IBM.circle(60.0, 60.0, 20.0, 64)),
        "markers": (port.IBM.from_markers(xs, ys, m_max=3),
                    jax.IBM.from_markers(xs, ys, m_max=3)),
        "markers_transposed": (
            port.IBM.from_markers(xs, ys, reference_transposed_weights=True),
            jax.IBM.from_markers(xs, ys, reference_transposed_weights=True)),
        "toml": (port.IBM.from_toml(MARKERS, "cylinder-a"),
                 jax.IBM.from_toml(MARKERS, "cylinder-a")),
        "toml_transposed": (
            port.IBM.from_toml(MARKERS, "cylinder-a", reference_transposed_weights=True),
            jax.IBM.from_toml(MARKERS, "cylinder-a", reference_transposed_weights=True)),
    }


FIELDS = ("weights", "flat_idx", "spread", "row_w", "col_w", "rows0", "cols0")


def _field(ib, name):
    v = getattr(ib, name)
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def test_peskin4_matches_lbm_tpu():
    r = np.linspace(-2.5, 2.5, 1001)
    assert np.array_equal(ibm.peskin4(r), jibm.peskin4(r))
    assert ibm.peskin4(np.array([0.0, 1.0, 2.0, 2.5])).tolist() == \
        jibm.peskin4(np.array([0.0, 1.0, 2.0, 2.5])).tolist()


@pytest.mark.parametrize("case", ["circle", "markers", "markers_transposed", "toml",
                                  "toml_transposed"])
def test_ibm_fields_equal_lbm_tpu(case):
    got, want = _builds(ibm, jibm)[case]
    for name in FIELDS:
        a, b = _field(got, name), _field(want, name)
        assert a.shape == b.shape and np.array_equal(a, b), name
    assert got.weights.dtype == torch.float64 and got.flat_idx.dtype == torch.int32
    assert (got.roi_rows, got.roi_cols, got.roi_shape, got.m_max) == \
        (want.roi_rows, want.roi_cols, want.roi_shape, want.m_max)
    # kernel 16's tables: the separable products are the dense weights
    w16, tap, sup, cell_ptr, ent_j, ent_w = kibm.forcing_tables(got)
    assert np.array_equal(w16, got.weights.numpy())
    assert tap.dtype == sup.dtype == cell_ptr.dtype == ent_j.dtype == np.int32
    # each tap's support cell is the dense operator's flat_idx
    flat = got.flat_idx.numpy()
    assert np.array_equal(sup[tap], flat) and np.array_equal(sup, np.unique(flat))
    # the compressed table: support cell s's entries, in ascending marker,
    # are exactly the nonzero pattern of its row of the dense operator, the
    # weights inline
    assert cell_ptr.shape == (sup.size + 1,) and cell_ptr[-1] == ent_j.size == w16.size
    for s in range(0, sup.size, 7):
        js, ts = np.nonzero(flat == sup[s])
        assert np.array_equal(ent_j[cell_ptr[s]:cell_ptr[s + 1]], js)
        assert np.array_equal(ent_w[cell_ptr[s]:cell_ptr[s + 1]], w16[js, ts])


def test_ibm_from_numpy_equals_from_markers():
    """lbm_tpu's IBM, carried across as numpy, is the port's own build."""
    for got, want in _builds(ibm, jibm).values():
        carried = convert.ibm_from_numpy(want)
        for name in FIELDS:
            a, b = _field(carried, name), _field(got, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert (carried.roi_rows, carried.roi_cols, carried.roi_shape, carried.m_max) == \
            (got.roi_rows, got.roi_cols, got.roi_shape, got.m_max)


def _flow(H, W, seed):
    rng = np.random.default_rng(seed)
    return 0.05 * rng.standard_normal((2, H, W)), 1.0 + 0.01 * rng.standard_normal((H, W))


@pytest.mark.parametrize("case", ["circle", "markers_transposed", "toml"])
def test_force_density_matches_lbm_tpu_f64(case):
    got_ib, want_ib = _builds(ibm, jibm)[case]
    u, rho = _flow(130, 110, seed=3)
    got = got_ib.eulerian_force_density(torch.as_tensor(u), torch.as_tensor(rho))
    want = np.asarray(want_ib.eulerian_force_density(jnp.asarray(u), jnp.asarray(rho)))
    assert got.shape == want.shape == (2,) + got_ib.roi_shape
    assert np.abs(got.numpy() - want).max() <= 1e-13


def test_plain_forcing_step_matches_pallas_kernel_f64():
    """The plain kernel-16 step against lbm_tpu's Pallas forcing kernel
    (interpret mode) on its test's window: 64x256, circle (30, 130, 9, 40)."""
    H, W = 64, 256
    ib, jib = ibm.IBM.circle(30.0, 130.0, 9.0, 40), jibm.IBM.circle(30.0, 130.0, 9.0, 40)
    u, rho = _flow(H, W, seed=0)
    f = jd.equilibrium(jnp.asarray(u), jnp.asarray(rho))
    fn = jax_forcing_step(H, W, jib, dtype=jnp.float64, interpret=True)
    want = np.asarray(fn(f, jnp.zeros((2, H, W))))
    got = kibm.make_ibm_forcing_step(H, W, ib, torch.float64)(torch.as_tensor(np.array(f)))
    (r0, r1), (c0, c1) = ib.roi_rows, ib.roi_cols
    assert np.abs(got.numpy() - want[:, r0:r1, c0:c1]).max() <= 1e-13
    # the port returns the ROI only; lbm_tpu's carry is zero elsewhere
    outside = want.copy()
    outside[:, r0:r1, c0:c1] = 0.0
    assert not outside.any()


def test_plain_forcing_f32_matches_f64():
    """The plain version's matmuls in float32 (TF32 off, as the package
    pins it) against float64: 1e-6 relative to the force's magnitude."""
    assert not torch.backends.cuda.matmul.allow_tf32
    H, W = 160, 120
    ib = ibm.IBM.circle(60.0, 60.0, 20.0, 64)
    u, rho = _flow(H, W, seed=5)
    f64 = torch.as_tensor(np.array(jd.equilibrium(jnp.asarray(u), jnp.asarray(rho))))
    want = kibm.make_ibm_forcing_step(H, W, ib, torch.float64)(f64)
    got = kibm.make_ibm_forcing_step(H, W, ib, torch.float32)(f64.float())
    assert got.dtype == torch.float32
    assert (got.double() - want).abs().max().item() <= 1e-6 * want.abs().max().item()


def test_forcing_step_checks_its_roi_and_state():
    ib = ibm.IBM.circle(4.0, 16.0, 3.0, 16)   # rows from -1
    with pytest.raises(ValueError, match="leaves the 32x32 grid"):
        kibm.make_ibm_forcing_step(32, 32, ib, torch.float64)
    ib = ibm.IBM.circle(16.0, 16.0, 3.0, 16)
    step = kibm.make_ibm_forcing_step(32, 32, ib, torch.float64)
    with pytest.raises(ValueError, match="step built for"):
        step(torch.zeros((9, 32, 31), dtype=torch.float64))
    n_sup = kibm.forcing_tables(ib)[2].size
    assert kibm.scratch_bytes(n_sup, 16, 8) == \
        (5 * n_sup + 19 * 16) * 8 + 4 * (16 * 16 + n_sup + 1)
    # a ROI up to two cells from every edge is taken as it lies
    edge = ibm.IBM.circle(20.0, 20.0, 15.0, 48)
    assert edge.roi_rows == (3, 38) and edge.roi_cols == (3, 38)
    kibm.make_ibm_forcing_step(40, 40, edge, torch.float64)
    assert jibm.IBM.circle(20.0, 20.0, 15.0, 48).aligned_window(40, 40) is None
