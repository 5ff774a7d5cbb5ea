"""The moving-body IBM forcing steps: plain versions and CUDA kernels 19-21
(counterpart of lbm_tpu/kernels/moving_ibm_pallas.py).

A rigid body's state is a row of ``STATE_LANES`` values in the lane order
of lbm_tpu's state row (:59): centre, velocity, hydrodynamic force, and for
the rotating body its orientation (cos, sin), angular velocity and torque.
lbm_tpu pads the row to 128 lanes, Mosaic's lane width; the port keeps the
10 that carry values (io/convert.py carries rows across).

Each builder returns ``fn(f, state) -> (F_win, origin, state_new)``, one
step's forcing side as lbm_tpu's jnp falling-body steps compute it
(scenes/obstacles.py:1040-1071, :670-704, :735-773): the window origin from
the centre (``round`` half to even, as jnp.round; clipped to the grid), the
window's macroscopics, the Peskin factors rebuilt at the markers, m_max - 1
multi-direct-forcing iterations toward the rigid velocity, and the rigid
update.  F_win (2, wr, wc) is the Eulerian force over the window, ``origin``
its first cell as an int32 tensor (2,) on the state's device, which the box
step (kernels/cylinder.py, kernel 18) reads there.

  * ``make_moving_forcing_step`` - one translating body (falling_cylinder;
    lbm_tpu's :163), kernel 19;
  * ``make_moving_rot_step`` - one rotating body (falling_ellipse; :301):
    marker targets U_b + w x r_j, the torque T_h = -sum r_j x f_j and the
    Cayley update of the orientation, kernel 20;
  * ``make_moving_bodies_step`` - B translating bodies in one union window of
    ``rw`` rows x the full width that follows the lowest centre row, their
    markers forced together, per-body momentum exchange and the Glowinski
    barriers (falling_cylinders; :452), kernel 21.

On a CPU state each runs its plain version (the ops/moving_ibm.py matmuls);
on a CUDA state it launches its kernel (csrc/moving_ibm.cu: one block
forces the bodies' boxes, the others zero the rest of the window) or
raises.  lbm_tpu's kernels widen the window to an 8x128-aligned, margined
one, carry F on the full grid aliased in and out, pad the markers to 128
lanes at FAR and return None (a jnp fallback) when the window does not fit
their VMEM budget; the port has none of that (ROADMAP item 15): the kernels
take the jnp window where it lies, and spill to a global scratch buffer
past 227 KiB of shared memory.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import d2q9
from ..ops.moving_ibm import barrier_forces, cayley_rotate, forcing_window_markers, \
    window_factors
from ..utils.xmath import resolve_fused, rounded
from . import _build
from .collide_stream import check_step_state
from .ibm import SMEM_LIMIT

CEN_X, CEN_Y, UB_X, UB_Y, FH_X, FH_Y, ORI_C, ORI_S, ANG_W, TRQ = range(10)
STATE_LANES = 10
THREADS = 1024  # the most threads of csrc/moving_ibm.cu's blocks
# the kernels' largest window, in cells: csrc/moving_ibm.cu indexes F's two
# window planes with int32 (2 wr wc < 2^31); rows and columns are otherwise
# bounded only by the grid's
MAX_WINDOW_CELLS = ((1 << 31) - 1) // 2
# a marker covers the cells within 2 sqrt 2 of it (4x4 box); the body-frame
# buckets are unit squares, and both reaches keep a margin for the rounding
# of the positions and a rotating body's (cos, sin) drifting off norm 1
REACH = 3.0
BUCKET_REACH = 2.0 * np.sqrt(2.0) + 0.5 * np.sqrt(2.0) + 0.1

_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13 \
    + [ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_void_p]
MOVING_FORCING = _build.CudaKernel("lbm_moving_forcing", _ARGS)
MOVING_ROT = _build.CudaKernel("lbm_moving_rot", _ARGS)
MOVING_BODIES = _build.CudaKernel("lbm_moving_bodies", _ARGS)


def _row(values, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(values, np.float64), dtype=dtype, device=device)


def pack_state(center, velocity=(0.0, 0.0), dtype=torch.float32, device=None) -> torch.Tensor:
    """The (1, STATE_LANES) initial state of make_moving_forcing_step."""
    row = np.zeros((1, STATE_LANES))
    row[0, CEN_X:CEN_Y + 1] = center
    row[0, UB_X:UB_Y + 1] = velocity
    return _row(row, dtype, device)


def pack_states(centers, velocities=None, dtype=torch.float32, device=None) -> torch.Tensor:
    """The (B, STATE_LANES) initial states of make_moving_bodies_step."""
    centers = np.asarray(centers, np.float64)
    rows = np.zeros((centers.shape[0], STATE_LANES))
    rows[:, CEN_X:CEN_Y + 1] = centers
    if velocities is not None:
        rows[:, UB_X:UB_Y + 1] = np.asarray(velocities, np.float64)
    return _row(rows, dtype, device)


def pack_state_rot(center, orientation=(1.0, 0.0), velocity=(0.0, 0.0), omega_body=0.0,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """The (1, STATE_LANES) initial state of make_moving_rot_step."""
    row = np.zeros((1, STATE_LANES))
    row[0, CEN_X:CEN_Y + 1] = center
    row[0, UB_X:UB_Y + 1] = velocity
    row[0, ORI_C:ORI_S + 1] = orientation
    row[0, ANG_W] = omega_body
    return _row(row, dtype, device)


def window_origin(row, col, half: int, H: int, W: int, wr: int, wc: int) -> torch.Tensor:
    """(r0, c0) int32: round(centre) - half, clipped so the wr x wc window
    lies in the grid.  ``round`` is half to even (jnp.round, lbm_tpu's jnp
    oracle, obstacles.py:1047-1050); lbm_tpu's kernel takes floor(cen + 0.5)
    instead (moving_ibm_pallas.py:220).  A ``col`` of None pins c0 at 0."""
    r0 = torch.clamp(torch.round(row).to(torch.int32) - half, 0, H - wr)
    c0 = (torch.zeros_like(r0) if col is None
          else torch.clamp(torch.round(col).to(torch.int32) - half, 0, W - wc))
    return torch.stack([r0, c0])


def _window_fields(f, origin, wr, wc):
    """(u_win, rho_win) of f over the window at ``origin``."""
    r0, c0 = (int(v) for v in origin.tolist())
    fw = f[:, r0:r0 + wr, c0:c0 + wc]
    rho = d2q9.calc_rho(fw)
    return d2q9.calc_u(fw, rho), rho, r0, c0


def _factors(xs, ys, r0, c0, wr, wc):
    dt = xs.dtype
    return window_factors(xs, ys, torch.tensor(float(r0), dtype=dt),
                          torch.tensor(float(c0), dtype=dt), wr, wc)


def plain_moving_forcing(f, state, dx, dy, *, half: int, wr: int, wc: int, g_net: float,
                         m_eff: float, m_max: int):
    """The plain version of kernel 19 (the forcing side of lbm_tpu's jnp
    falling_cylinder step, scenes/obstacles.py:1045-1071)."""
    H, W = f.shape[1:]
    cen, ub = state[0, CEN_X:CEN_Y + 1], state[0, UB_X:UB_Y + 1]
    origin = window_origin(cen[0], cen[1], half, H, W, wr, wc)
    u_win, rho_win, r0, c0 = _window_fields(f, origin, wr, wc)
    X, Y = _factors(cen[0] + dx, cen[1] + dy, r0, c0, wr, wc)
    F_win, fj = forcing_window_markers(u_win, rho_win, X, Y, ub, m_max)
    F_h = -fj.sum(dim=1)
    g_vec = torch.tensor([g_net, 0.0], dtype=f.dtype, device=f.device)
    ub = ub + (F_h + g_vec) / m_eff
    new = torch.cat([cen + ub, ub, F_h, state[0, ORI_C:]])[None]
    return F_win, origin, new


def plain_moving_rot(f, state, dx, dy, *, half: int, wr: int, wc: int, g_net: float,
                     m_eff: float, i_eff: float, m_max: int):
    """The plain version of kernel 20 (the forcing side of lbm_tpu's
    ellipse_fsi_step, scenes/obstacles.py:735-773)."""
    H, W = f.shape[1:]
    s = state[0]
    cen, ub = s[CEN_X:CEN_Y + 1], s[UB_X:UB_Y + 1]
    c, sn, w = s[ORI_C], s[ORI_S], s[ANG_W]
    rx = c * dx - sn * dy                      # world offsets (M,)
    ry = sn * dx + c * dy
    origin = window_origin(cen[0], cen[1], half, H, W, wr, wc)
    u_win, rho_win, r0, c0 = _window_fields(f, origin, wr, wc)
    X, Y = _factors(cen[0] + rx, cen[1] + ry, r0, c0, wr, wc)
    ub_m = torch.stack([ub[0] - w * ry, ub[1] + w * rx])
    F_win, fj = forcing_window_markers(u_win, rho_win, X, Y, ub_m, m_max)
    F_h = -fj.sum(dim=1)
    T_h = -(rx * fj[1] - ry * fj[0]).sum()
    g_vec = torch.tensor([g_net, 0.0], dtype=f.dtype, device=f.device)
    ub = ub + (F_h + g_vec) / m_eff
    w = w + T_h / i_eff
    c2, s2 = cayley_rotate(c, sn, w)
    new = torch.cat([cen + ub, ub, F_h, torch.stack([c2, s2, w, T_h])])[None]
    return F_win, origin, new


def plain_moving_bodies(f, states, dx, dy, *, half: int, rw: int, g_net: float, m_eff: float,
                        radius: float, m_max: int, zeta: float, eps: float):
    """The plain version of kernel 21 (the forcing side of lbm_tpu's jnp
    falling_cylinders step, scenes/obstacles.py:670-704)."""
    H, W = f.shape[1:]
    B, M = states.shape[0], dx.shape[0]
    cen, ub = states[:, CEN_X:CEN_Y + 1], states[:, UB_X:UB_Y + 1]
    origin = window_origin(cen[:, 0].min(), None, half, H, W, rw, W)
    u_win, rho_win, r0, _ = _window_fields(f, origin, rw, W)
    xs = (cen[:, 0:1] + dx[None]).reshape(-1)      # (B M,)
    ys = (cen[:, 1:2] + dy[None]).reshape(-1)
    X, Y = _factors(xs, ys, r0, 0, rw, W)
    ub_m = torch.repeat_interleave(ub, M, dim=0).T   # (2, B M)
    F_win, fj = forcing_window_markers(u_win, rho_win, X, Y, ub_m, m_max)
    F_h = -fj.reshape(2, B, M).sum(dim=-1).T        # (B, 2)
    F_rep = barrier_forces(cen, radius, H, W, zeta=zeta, eps=eps)
    g_vec = torch.tensor([g_net, 0.0], dtype=f.dtype, device=f.device)
    ub = ub + (F_h + g_vec[None] + F_rep) / m_eff
    new = torch.cat([cen + ub, ub, F_h, states[:, ORI_C:]], dim=1)
    return F_win, origin, new


class Boxes:
    """The kernels' static geometry from the body-frame marker offsets (dx,
    dy) (csrc/moving_ibm.cu): a body's box has side ``side`` = 2 K + 5 from
    floor(centre) - K - 1, K = ceil(max |offset|) + 1, so it holds every
    cell its markers' 4x4 supports reach; a cell can be reached only within
    [r_min - REACH, r_max + REACH] of the centre (``near``, squared); the
    body frame is cut into unit buckets over [-QB, QB)^2, QB = ceil(r_max)
    + 5, and bucket k lists (``ptr``, ``ent``) in ascending order the markers
    within BUCKET_REACH of its centre: every marker whose support can hold a
    cell of the bucket."""

    def __init__(self, dx, dy):
        norm = np.hypot(dx, dy)
        r_min, r_max = float(norm.min()), float(norm.max())
        reach = int(np.ceil(r_max - 1e-9))   # a ring of radius 12 has norms 12 + 1 ulp
        self.K = reach + 1
        self.side = 2 * self.K + 5
        self.QB = reach + 5
        self.near = (max(r_min - REACH, 0.0) ** 2, (r_max + REACH) ** 2)
        centres = np.arange(-self.QB, self.QB) + 0.5                      # (2 QB,)
        d2 = ((centres[:, None, None] - dx[None, None, :]) ** 2
              + (centres[None, :, None] - dy[None, None, :]) ** 2)         # (2QB, 2QB, Mb)
        hit = (d2 <= BUCKET_REACH ** 2).reshape(-1, dx.size)
        self.ptr = np.concatenate([[0], np.cumsum(hit.sum(axis=1))]).astype(np.int32)
        self.ent = np.nonzero(hit)[1].astype(np.int32)   # row-major: ascending per bucket

    def slots(self, n_bodies: int) -> int:
        return n_bodies * self.side * self.side


def scratch_bytes(boxes: Boxes, n_bodies: int, markers: int, threads: int,
                  itemsize: int) -> int:
    """Bytes of block 0's working set (csrc/moving_ibm.cu Work): the bodies'
    boxes and frames (2 ints and 4 values each, 16-byte aligned), per slot
    of the boxes 5 values and 2 ints (the live list), per marker 17 values
    and 3 ints, per thread EREG = 6 covering markers (an int each), the
    bucket lists and a counter."""
    ns = boxes.slots(n_bodies)
    body = -(-n_bodies * (8 + 4 * itemsize) // 16) * 16
    return body + (5 * ns + 17 * markers) * itemsize \
        + 4 * (3 * markers + boxes.ptr.size + boxes.ent.size + 2 * ns + 6 * threads + 1)


def launch_shape(boxes: Boxes, n_bodies: int, markers: int, n: int) -> tuple[int, int]:
    """(threads, fill blocks): block 0 takes 4 lanes a marker or a thread a
    slot, whichever is more, in whole warps, at most THREADS (it loops past
    that); the other blocks zero the n window cells, 4 a thread."""
    threads = min(THREADS, -(-max(4 * markers, boxes.slots(n_bodies)) // 32) * 32)
    return threads, max(1, min(32, -(-n // (4 * threads))))


def check_window(wr: int, wc: int) -> None:
    """The kernels take a window of at most MAX_WINDOW_CELLS cells."""
    if wr * wc > MAX_WINDOW_CELLS:
        raise ValueError(f"the {wr}x{wc} forcing window exceeds the kernels' largest, "
                         f"{MAX_WINDOW_CELLS} cells")


def _consts(dtype, boxes, g_net, m_eff, i_eff=1.0, radius=0.0, zeta=0.0, eps=1.0, H=0, W=0):
    """The kernels' 11 scalars, each rounded to ``dtype`` as the plain
    version rounds it: g_net, m_eff, i_eff, radius, zeta, eps, eps / 2,
    H - 0.5, W - 0.5, and the boxes' squared reach."""
    return _build.c_doubles([rounded(x, dtype) for x in (
        g_net, m_eff, i_eff, radius, zeta, eps, 0.5 * eps, H - 0.5, W - 0.5, *boxes.near)])


def _builder(kernel, plain, H, W, dx, dy, *, n_bodies, wr, wc, half, m_max, consts, dtype):
    """fn(f, state) -> (F_win, origin, state_new): ``kernel`` on a CUDA state,
    ``plain`` on a CPU state; ``fn.plain`` is the plain version on any
    device.  ``consts`` maps the kernel's Boxes to its scalars."""
    dx = np.asarray(dx, np.float64)
    dy = np.asarray(dy, np.float64)
    if dx.ndim != 1 or dx.shape != dy.shape or dx.size == 0:
        raise ValueError("the marker offsets must be two nonempty (M,) arrays")
    if wr > H or wc > W or wr < 1 or wc < 1:
        raise ValueError(f"the {wr}x{wc} forcing window does not fit the {H}x{W} grid")
    M = dx.size
    boxes = Boxes(dx, dy)
    consts = consts(boxes)
    threads, fill = launch_shape(boxes, n_bodies, n_bodies * M, wr * wc)
    itemsize = torch.empty((), dtype=dtype).element_size()
    need = scratch_bytes(boxes, n_bodies, n_bodies * M, threads, itemsize)
    offsets: dict = {}

    def marker_offsets(device):
        if device not in offsets:
            offsets[device] = (torch.as_tensor(dx, dtype=dtype, device=device),
                               torch.as_tensor(dy, dtype=dtype, device=device),
                               torch.as_tensor(boxes.ptr, device=device),
                               torch.as_tensor(boxes.ent, device=device))
        return offsets[device]

    def launch(f, state):
        R, C = _build.check_state(f)
        check_window(wr, wc)
        if state.device != f.device or not state.is_contiguous():
            raise ValueError("the body state must be a contiguous tensor of the state's "
                             "device")
        dxt, dyt, ptr, ent = marker_offsets(f.device)
        F_win = torch.empty((2, wr, wc), dtype=dtype, device=f.device)
        origin = torch.empty(2, dtype=torch.int32, device=f.device)
        new = torch.empty_like(state)
        scratch = (torch.empty(-(-need // itemsize), dtype=dtype, device=f.device)
                   if need > SMEM_LIMIT else None)
        with torch.cuda.device(f.device):
            kernel.launch(f.data_ptr(), state.data_ptr(), dxt.data_ptr(), dyt.data_ptr(),
                          F_win.data_ptr(), origin.data_ptr(), new.data_ptr(),
                          None if scratch is None else scratch.data_ptr(), ptr.data_ptr(),
                          ent.data_ptr(), ent.numel(), R, C, half, wr, wc, M, n_bodies,
                          m_max - 1, boxes.K, boxes.QB, threads, fill, consts,
                          int(dtype == torch.float64), _build.stream_handle(f))
        return F_win, origin, new

    def step(f: torch.Tensor, state: torch.Tensor):
        check_step_state(f, H, W, dtype)
        if tuple(state.shape) != (n_bodies, STATE_LANES) or state.dtype != dtype:
            raise ValueError(f"body state {tuple(state.shape)} {state.dtype}, step built for "
                             f"({n_bodies}, {STATE_LANES}) {dtype}")
        if resolve_fused(f):
            return launch(f, state)
        return step.plain(f, state)

    step.plain = lambda f, state: plain(f, state, *marker_offsets(f.device)[:2])
    return step


def make_moving_forcing_step(H: int, W: int, marker_dx, marker_dy, *, half: int,
                             g_net: float, m_eff: float, m_max: int = 5,
                             dtype: torch.dtype = torch.float32):
    """Forcing step of one translating body with markers at the offsets
    (marker_dx, marker_dy) from its centre, over the 2 half x 2 half window:
    kernel 19 on a CUDA state.  ``g_net`` and ``m_eff`` are the rigid
    closure's net gravity force and inertia (falling_cylinder's docstring);
    ``m_max`` is iterations + 1 (ibm.cpp:59-66)."""
    wr = wc = 2 * half

    def plain(f, state, dx, dy):
        return plain_moving_forcing(f, state, dx, dy, half=half, wr=wr, wc=wc, g_net=g_net,
                                    m_eff=m_eff, m_max=m_max)

    return _builder(MOVING_FORCING, plain, H, W, marker_dx, marker_dy, n_bodies=1, wr=wr,
                    wc=wc, half=half, m_max=m_max,
                    consts=lambda boxes: _consts(dtype, boxes, g_net, m_eff), dtype=dtype)


def make_moving_rot_step(H: int, W: int, marker_dx, marker_dy, *, half: int, g_net: float,
                         m_eff: float, i_eff: float, m_max: int = 5,
                         dtype: torch.dtype = torch.float32):
    """Forcing step of one rotating body, with body-frame marker offsets
    rotated by the state's orientation: kernel 20 on a CUDA state."""
    wr = wc = 2 * half

    def plain(f, state, dx, dy):
        return plain_moving_rot(f, state, dx, dy, half=half, wr=wr, wc=wc, g_net=g_net,
                                m_eff=m_eff, i_eff=i_eff, m_max=m_max)

    return _builder(MOVING_ROT, plain, H, W, marker_dx, marker_dy, n_bodies=1, wr=wr, wc=wc,
                    half=half, m_max=m_max,
                    consts=lambda boxes: _consts(dtype, boxes, g_net, m_eff, i_eff), dtype=dtype)


def make_moving_bodies_step(H: int, W: int, marker_dx, marker_dy, *, n_bodies: int, rw: int,
                            half: int, g_net: float, m_eff: float, radius: float | None = None,
                            m_max: int = 5, zeta: float = 2.0, eps: float = 50.0,
                            dtype: torch.dtype = torch.float32):
    """Forcing step of ``n_bodies`` translating bodies sharing the marker
    offsets, over one union window of ``rw`` rows x W following the lowest
    centre row, with the Glowinski barriers (radius default: the markers'
    largest offset): kernel 21 on a CUDA state."""
    if not 1 <= n_bodies <= THREADS:
        raise ValueError(f"need 1 to {THREADS} bodies, got {n_bodies}")
    if radius is None:
        radius = float(np.hypot(marker_dx, marker_dy).max())

    def plain(f, state, dx, dy):
        return plain_moving_bodies(f, state, dx, dy, half=half, rw=rw, g_net=g_net,
                                   m_eff=m_eff, radius=radius, m_max=m_max, zeta=zeta, eps=eps)

    return _builder(MOVING_BODIES, plain, H, W, marker_dx, marker_dy, n_bodies=n_bodies,
                    wr=rw, wc=W, half=half, m_max=m_max,
                    consts=lambda boxes: _consts(dtype, boxes, g_net, m_eff, radius=radius,
                                                 zeta=zeta, eps=eps, H=H, W=W),
                    dtype=dtype)
