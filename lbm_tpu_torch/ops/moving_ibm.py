"""Moving-marker immersed boundary (counterpart of lbm_tpu/ops/moving_ibm.py).

The static IBM (ops/ibm.py) precomputes its operators on the host because
the reference's markers never move (src/ibm.cpp:15-191).  Moving bodies
rebuild the Peskin factors from the marker positions every step.  The
4-point kernel vanishes for |r| >= 2, so the factors are evaluated densely
over the window axes,

    X[i, j] = phi(rows[i] - x_j)        (rw, M)
    Y[i, j] = phi(cols[i] - y_j)        (cw, M)

which equals the static separable operator (phi is zero at every node
outside the 4-point support), and interpolation and spreading are two
matmuls:

    interp(g) = colsum(X * (g @ Y))     -> (M,) marker values
    spread(s) = (X * s) @ Y.T           -> (rw, cw)

Multi-direct forcing targets the marker velocity U_b (Uhlmann's direct
forcing; the reference's static case is U_b = 0, ibm.cpp:169-183):
f_j = 2 rho_j (U_bj - u_j).  The per-marker force summed over the
iterations is what the forcing adds to the fluid, so the body feels its
negation (momentum exchange).  These functions are the plain versions the
moving-forcing kernels 19-21 (kernels/moving_ibm.py) are held to; the
package keeps TF32 off, so the float32 matmuls sum in float32.
"""

from __future__ import annotations

import numpy as np
import torch


def peskin4j(r: torch.Tensor) -> torch.Tensor:
    """Peskin 4-point kernel on a tensor.  cites src/ibm.cpp:39-45

    The sqrt arguments are clamped with the double-where pattern (not a
    clamp): each is positive wherever its branch is selected, but reverse
    mode would carry d sqrt(0) = inf from the unselected branch through a
    plain where as NaN (differentiable rollouts go through this kernel)."""
    r = torch.abs(r)
    in1 = 1.0 + 4.0 * r - 4.0 * r * r
    in2 = -7.0 + 12.0 * r - 4.0 * r * r
    one = torch.ones_like(r)
    zero = torch.zeros_like(r)
    s1 = torch.sqrt(torch.where(in1 > 0.0, in1, one))
    s2 = torch.sqrt(torch.where(in2 > 0.0, in2, one))
    inner = 0.125 * (3.0 - 2.0 * r + torch.where(in1 > 0.0, s1, zero))
    outer = 0.125 * (5.0 - 2.0 * r - torch.where(in2 > 0.0, s2, zero))
    return torch.where(r <= 1.0, inner, torch.where(r <= 2.0, outer, zero))


def window_factors(xs: torch.Tensor, ys: torch.Tensor, ra0, ca0, rw: int,
                   cw: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense separable Peskin factors X (rw, M) and Y (cw, M) for markers at
    absolute grid coordinates (xs, ys) on the window [ra0, ra0 + rw) x
    [ca0, ca0 + cw)."""
    dtype, device = xs.dtype, xs.device
    rows = torch.as_tensor(ra0, dtype=dtype, device=device) \
        + torch.arange(rw, dtype=dtype, device=device)
    cols = torch.as_tensor(ca0, dtype=dtype, device=device) \
        + torch.arange(cw, dtype=dtype, device=device)
    X = peskin4j(rows[:, None] - xs[None, :])
    Y = peskin4j(cols[:, None] - ys[None, :])
    return X, Y


def forcing_window(u_win, rho_win, X, Y, ub, m_max: int = 5):
    """Multi-direct forcing over a window toward the body velocity ``ub``
    ((2,) or per marker (2, M)): (F_win (2, rw, cw), f_sum (2,)), the
    Eulerian force density and the summed Lagrangian force, the momentum the
    forcing adds to the fluid.  ``m_max`` is iterations + 1, the reference's
    convention (ibm.cpp:59-66)."""
    F, fj = forcing_window_markers(u_win, rho_win, X, Y, ub, m_max)
    return F, fj.sum(dim=1)


def forcing_window_markers(u_win, rho_win, X, Y, ub, m_max: int = 5):
    """forcing_window returning the per-marker force sum (2, M) over all
    iterations.  X / Y may hold several bodies' markers concatenated: the
    iterations then apply the combined operator, and each body feels minus
    the sum over its own markers."""
    dtype = u_win.dtype
    X = X.to(dtype)
    Y = Y.to(dtype)
    ub = torch.as_tensor(ub, dtype=dtype, device=u_win.device)
    if ub.ndim == 1:
        ub = ub[:, None]

    def interp(g):
        return ((g @ Y) * X).sum(dim=0)                  # (M,)

    def spread(s):
        return (X * s[None, :]) @ Y.T                    # (rw, cw)

    rho_j = interp(rho_win)
    inv_rho = 1.0 / rho_win
    u_work = u_win
    F = torch.zeros_like(u_win)
    fj = torch.zeros((2,) + X.shape[1:], dtype=dtype, device=u_win.device)
    for _ in range(m_max - 1):
        fx_j = 2.0 * rho_j * (ub[0] - interp(u_work[0]))
        fy_j = 2.0 * rho_j * (ub[1] - interp(u_work[1]))
        F_n = torch.stack([spread(fx_j), spread(fy_j)])
        u_work = u_work + 0.5 * F_n * inv_rho[None]
        F = F + F_n
        fj = fj + torch.stack([fx_j, fy_j])
    return F, fj


def barrier_forces(cen: torch.Tensor, radii, H: int, W: int, zeta: float = 2.0,
                   eps: float = 50.0, eps_wall: float | None = None) -> torch.Tensor:
    """Short-range repulsive barrier forces between rigid circles and against
    the box walls, the Glowinski collision model of particulate DKT runs:
    for a pair at distance d, (c_ij / d) max(0, R_i + R_j + zeta - d)^2 /
    eps pushes the bodies apart; the walls (halfway bounce-back, at -0.5 and
    N - 0.5) take the mirror-image form with ``eps_wall`` (default eps / 2).
    Returns (B, 2)."""
    dtype, device = cen.dtype, cen.device
    radii = torch.broadcast_to(torch.as_tensor(radii, dtype=dtype, device=device),
                               cen.shape[:1])
    if eps_wall is None:
        eps_wall = 0.5 * eps
    B = cen.shape[0]
    eye = torch.eye(B, dtype=dtype, device=device)
    d_vec = cen[:, None, :] - cen[None, :, :]              # (B, B, 2)
    d2 = (d_vec * d_vec).sum(dim=-1) + eye                 # keep the diagonal finite
    d = torch.sqrt(d2)
    overlap = torch.clamp_min(radii[:, None] + radii[None, :] + zeta - d, 0.0)
    overlap = overlap * (1.0 - eye)
    F_pair = (d_vec / d[..., None] * (overlap * overlap)[..., None] / eps).sum(dim=1)
    lo = cen - (radii[:, None] + zeta)
    hi = torch.tensor([H - 0.5, W - 0.5], dtype=dtype, device=device) - cen \
        - (radii[:, None] + zeta)
    below = torch.clamp_min(-0.5 - lo, 0.0)
    above = torch.clamp_min(-hi, 0.0)
    return F_pair + (below * below - above * above) / eps_wall


def ellipse_markers(a: float, b: float, n_markers: int | None = None):
    """Marker offsets (dx, dy), numpy float64, on an ellipse with semi-axes
    (a, b) along (rows, cols), spaced uniformly in arc length; n_markers
    defaults to ceil(perimeter), ~1-cell spacing."""
    t = np.linspace(0.0, 2.0 * np.pi, 4096, endpoint=False)
    px = a * np.cos(t)
    py = b * np.sin(t)
    seg = np.hypot(np.diff(px, append=px[:1]), np.diff(py, append=py[:1]))
    s = np.concatenate([[0.0], np.cumsum(seg)])      # s[k] = arc to node k
    P = s[-1]
    if n_markers is None:
        n_markers = int(np.ceil(P))
    ti = np.interp(np.arange(n_markers) * P / n_markers, s,
                   np.concatenate([t, [2.0 * np.pi]]))
    return a * np.cos(ti), b * np.sin(ti)


def cayley_rotate(c, s, w):
    """Advance the orientation (c, s) by one step of angular velocity ``w``
    with the Cayley map, t = w / 2: exactly orthogonal for any w, the angle
    2 atan(w / 2) = w + O(w^3), no trigonometry."""
    t = 0.5 * w
    t2 = t * t
    den = 1.0 / (1.0 + t2)
    return ((c * (1.0 - t2) - s * (2.0 * t)) * den,
            (s * (1.0 - t2) + c * (2.0 * t)) * den)


def circle_markers(center: torch.Tensor, radius: float, n_markers: int,
                   dtype: torch.dtype | None = None):
    """A ring of ``n_markers`` markers at ``center`` (2,); ~ceil(2 pi r)
    markers keep the ~1-cell spacing direct forcing needs."""
    dtype = dtype or center.dtype
    theta = torch.arange(n_markers, dtype=dtype, device=center.device) \
        * (2.0 * np.pi / n_markers)
    return (center[0] + radius * torch.cos(theta),
            center[1] + radius * torch.sin(theta))
