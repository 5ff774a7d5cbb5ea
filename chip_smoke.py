#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port, lbm_tpu_torch, once on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, no arguments

Builds the CUDA kernels from lbm_tpu_torch/csrc with nvcc, holds each
kernel to its plain PyTorch version on the card, drives the port's main path
through the entry points a user calls, times kernels and plain versions
with CUDA events, and prints as its last line

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}

Phases (each prints its results; an exception in any phase ends the run
with a nonzero exit code):
  1. toolchain: torch and CUDA versions, the card, nvcc, triton, nvidia-smi;
  2. build: the kernels from csrc/, timed, with ptxas' registers and spills
     per kernel;
  3. the periodic kernels against their plain versions: kernel 1 (BGK) at
     4096x2048 float32 (1 and 8 steps; the 302 MB-per-buffer grid of
     bench.py), 1024x512 float64 and the reference's 21x21, 100x100 and
     101x101 in float64; kernel 3 (KBC) at 4096x2048 float32 (1 and 8
     steps), 1024x512 float64 and 128x128 float64 with both gamma
     implementations; kernel 5 (Smagorinsky LES) at 4096x2048 float32 (1
     and 8 steps) and 128x128 float64.  The KBC and LES states are off
     equilibrium (seeded_state(noisy=True)).  The MRT-CG kernels, both
     surface-tension modes, from the scenes' initial states: kernel 6
     (reduced) at 4096x2048 float32 (1 and 8 steps), 256x128 RT, 100x100
     droplet and 21x13 in float64 (8 steps); kernel 7 (split) at 4096x2048
     float32, 256x128 and 100x100 float64 (1 step); kernel 8 (full) at
     4096x2048 float32 (1 step), 256x128 and 21x13 float64 (4 steps); and
     reduced x7 + split == full x8 in float64 at 256x128 (<= 1e-12);
     kernel 10 (TRT, bench.py's rates) on noisy states at 4096x2048 float32
     (1 and 8 steps) and 128x128 float64; kernel 11 (power law) from
     bench.py's double-shear state at 4096x2048 float32 (1 and 8 steps) and
     at 128x128 float64 in its three branches (n = 0.5, n = 1.5, and
     Newton with sigma_y = 5e-4, n = 0.8);
  4. the channel kernels against their plain versions, 10 steps: kernel 2
     (BGK) at 4096x2048 float32, 21x21 and 101x101 float64; kernel 4 (KBC)
     at 4096x2048 float32, 128x128 and 24x24 float64, at
     ulbm_poiseuille's default relaxation and inlet density; kernel 9 in
     the gravity, specular, free-stream (faithful and corner-consistent),
     vertical (compressible and incompressible) and TRT configurations at
     4096x2048 float32 (twice, bit-identical: no entry has two writers)
     and at the reference's 21x21, 51x51 and 54x42 in float64;
  5. the main path, with every launch count set to 0 just before and read
     just after: the periodic BGK run at 4096x2048 float32 through
     kernels.bgk.make_fused_step; horizontal_poiseuille at the reference's
     defaults in float64 (L2 <= 1e-11, one kernel-2 launch per step); its
     CLI in a subprocess; the same scene at 4096x2048 float32, 1000 steps;
     ulbm_poiseuille at the reference's defaults in float64, 300k steps
     watched (lbm_tpu's hardware gates, one kernel-4 launch per step);
     ulbm_double_shear at the reference's defaults in float64 (10k steps,
     finite); the resolved KBC shear at 256x256 float32 and
     les_double_shear at 128x128 float32 with their gates; the
     ulbm_double_shear CLI; the MRT-CG scenes through kernels 6 (T-1
     launches) and 7 (one): the Laplace droplet at 128x128 for 40k steps
     in float64 and float32, the reference's RT horizon (256x128, 100k
     steps) in float32 and float64, RT growth and CSF growth in float32,
     each with lbm_tpu's hardware gates (scripts/validate_tpu.py laplace,
     laplace_df64's mass drift, rt_100k, rt_growth, csf_growth); the
     mrtcg_static_droplet CLI; the periodic TRT and power-law runs at
     4096x2048 float32 (kernels 10 and 11); the kernel-9 scenes with
     lbm_tpu's gates: vertical_poiseuille (incompressible, L2 <= 1e-11 in
     float64; compressible, watched to a stop), trt_poiseuille (L2 <= 1e-11
     in float64; 128x128 float32 for 200k steps, L2 <= 5e-4,
     validate_tpu.py trt), gravity_channel's parabola, specular_channel's
     flat accelerating plug, free_stream's bulk and walls, its
     corner-consistent fixed point in float64, and free_stream from
     configs/channel.toml in float64 (2700x2100, 1580 steps, 20 snapshot
     frames per field streamed to disk); power_law_channel (no kernel) on
     the card against the CPU; the vertical_poiseuille and free_stream CLIs;
  6. times at 4096x2048 float32 of every kernel and its plain version:
     MLUPS, and effective bandwidth at the kernel's bytes per cell against
     a device-to-device copy of the same bytes, taken in turns; the kernels
     in float64; kernel 6 at 256x128; each kernel's bound (bytes over
     HBM3's rate against operations, counted on its plain version, over
     the fp32 peak; exp, log, expm1, clamp, where, maximum and minimum
     count one operation per element).
It exits nonzero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = {"float32": 2e-6, "float64": 1e-13}  # max abs error, kernel vs plain
BIG = (4096, 2048)
OMEGA = 1.0 / 0.8  # bench.py's BGK and KBC relaxation
LES = {"tau0": 0.5 + 3e-4, "cs_smag": 0.17}  # bench.py's LES constants
# ulbm_poiseuille's defaults (128x128, nu=1e-4, u_max=0.05): s2 and rho_inlet
ULBM_S2 = 1.0 / (0.5 + 3.0 * 1e-4)
ULBM_RHO_IN = 3.0 * 127 * (8.0 * 1e-4 * 0.05 / 128 ** 2) + 1.0
# the MRT-CG scenes' constants: Rayleigh-Taylor (mrtcg_rayleigh_taylor's
# defaults) and the Laplace droplet (mrtcg_static_droplet's)
RT = {"sigma": 1e-4, "gravity": (6.25e-7, 0.0)}
DROPLET = {"sigma": 0.1, "gravity": (0.0, -6.25e-6), "apply_gravity_source": False}
TRT_OMEGA = 1.0 / 0.9  # bench.py's TRT rate; the odd rate keeps Lambda = 3/16
PLAW = {"cons_K": 0.01, "n": 0.5}  # bench.py's power-law constants
TAU_MAGIC = (3.0 / 16.0) ** 0.5 + 0.5  # the reference's Poiseuille tau


def variants():
    """Kernel 9's configurations, those of lbm_tpu's scenes with a 0.1%
    pressure drop: name -> make_channel_variant_step keywords."""
    from lbm_tpu_torch.models.trt import omega_minus_from_magic

    om = 1.0 / TAU_MAGIC
    return {
        "gravity": dict(omega=om, incompressible=True, pressure=(1.0, 1.0, 0),
                        force=(-3e-4, 0.0), col_walls="bounce"),
        "specular": dict(omega=om, incompressible=False, pressure=(1.001, 1.0, 0),
                         col_walls="specular"),
        "free_stream": dict(omega=1 / 0.55, incompressible=True, row_walls="abb",
                            abb_u=(0.1, 0.0), col_walls="specular"),
        "free_stream_cc": dict(omega=1 / 0.55, incompressible=False, row_walls="abb",
                               abb_u=(0.1, 0.0), col_walls="specular",
                               corner_consistent=True),
        "vertical": dict(omega=om, incompressible=False, pressure=(1.001, 1.0, 1),
                         row_walls="bounce"),
        "vertical_incomp": dict(omega=om, incompressible=True, pressure=(1.001, 1.0, 1),
                                row_walls="bounce"),
        "trt": dict(omega=1 / 1.2, incompressible=True, pressure=(1.001, 1.0, 0),
                    col_walls="bounce", omega_minus=omega_minus_from_magic(1 / 1.2)),
    }


def shear_state(R, C, dtype, device, noisy_seed=None):
    """bench.py's power-law state, the double-shear equilibrium at u_max 0.05;
    with ``noisy_seed`` each population scaled by a seeded 1 + U(-3%, 3%)."""
    import numpy as np
    import torch

    from lbm_tpu_torch.ops import d2q9
    from lbm_tpu_torch.scenes.ulbm import double_shear_init

    m0, u = double_shear_init(R, C, 0.05, device=device, dtype=dtype)
    f = d2q9.equilibrium(u, m0)
    if noisy_seed is not None:
        rng = np.random.default_rng(noisy_seed)
        f = f * torch.as_tensor(rng.uniform(0.97, 1.03, (9, R, C)), dtype=dtype,
                                device=device)
    return f.contiguous()
# NVIDIA H100 SXM data sheet: HBM3 bytes/s; fp32 and fp64 FLOP/s outside the
# tensor cores (dense, at the 700 W limit)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def seeded_state(R, C, dtype, device, seed, incompressible=False, noisy=False):
    """An equilibrium at a numpy-seeded random flow (|u| <= 0.05, rho within
    1%), made on the card, so every population differs.  ``noisy`` scales
    each population by a seeded 1 + U(-0.03, 0.03): a state off
    equilibrium, where the KBC gamma ratio is well defined (at an
    equilibrium it is 0/0 and only its regulariser speaks)."""
    import numpy as np
    import torch

    from lbm_tpu_torch.ops import d2q9

    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.uniform(-0.05, 0.05, (2, R, C)), dtype=dtype, device=device)
    rho = torch.as_tensor(1.0 + rng.uniform(-0.01, 0.01, (R, C)), dtype=dtype, device=device)
    eq = d2q9.incomp_equilibrium if incompressible else d2q9.equilibrium
    f = eq(u, rho)
    if noisy:
        f = f * torch.as_tensor(rng.uniform(0.97, 1.03, (9, R, C)), dtype=dtype,
                                device=device)
    return f.contiguous()


def hold_periodic(name, kernel_step, plain_step, cases, device, seed, noisy=True):
    """Each case (dtype, (R, C), steps): ``kernel_step(R, C, dtype, steps)``
    against ``plain_step(...)`` from one seeded state, off equilibrium unless
    ``noisy`` is False.  Returns the max error per dtype."""
    errs = {}
    for dtype, (R, C), steps in cases:
        f = seeded_state(R, C, dtype, device, seed=seed + R + C, noisy=noisy)
        got = kernel_step(R, C, dtype, steps)(f)
        want = plain_step(R, C, dtype, steps)(f)
        e = compare(f"{name} {R}x{C} {dtype} {steps} step(s)", got, want, dtype)
        errs[dtype] = max(errs.get(dtype, 0.0), e)
        del f, got, want
    return errs


def compare(name, got, want, dtype):
    import torch

    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = TOL[str(dtype).removeprefix("torch.")]
    ok = err <= tol and bool(torch.isfinite(got).all())
    log(f"{name}: max_abs_err={err!r} tol={tol!r} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def check_gates(name, gates) -> None:
    """Each gate is (value, lo, hi), inclusive; log them all, then fail if
    any value lies outside its bounds."""
    bad = [k for k, (v, lo, hi) in gates.items() if not lo <= v <= hi]
    log(f"{name}: " + ", ".join(f"{k}={v!r} in [{lo!r}, {hi!r}]"
                                for k, (v, lo, hi) in gates.items())
        + (f" FAIL {bad}" if bad else " ok"))
    if bad:
        raise AssertionError(f"{name}: gates failed: {bad}")


def run_cli(*args: str) -> None:
    """``python -m lbm_tpu_torch.run *args`` in a subprocess; fail unless it
    exits with 0."""
    cli = subprocess.run([sys.executable, "-m", "lbm_tpu_torch.run", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    err = cli.stderr.strip()
    log(f"[5] CLI {' '.join(args)}: rc={cli.returncode} "
        f"{err.splitlines()[-1] if err else ''}")
    if cli.returncode != 0:
        raise AssertionError(f"CLI failed:\n{cli.stderr[-3000:]}")


def mrtcg_state(R, C, dtype, device, csf=False, droplet=False):
    """A scene's initial full MRT-CG state as flat planes (18, or 20 in CSF
    mode): the RT layers of init_rho_cosine (sign -1, or +1 with the fst0
    seed in CSF mode, as the scenes build them) or the Laplace droplet of
    radius R/4 at u = 0.5 Fg/rho."""
    import torch

    from lbm_tpu_torch.models.mrt_cg import MRTCGModel
    from lbm_tpu_torch.scenes import multiphase as mp

    red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
    if droplet:
        model = MRTCGModel(red=red, blue=blue, **DROPLET)
        st = model.init_state(mp.init_rho_droplet(R, C, red.rho_0, True, R / 4),
                              mp.init_rho_droplet(R, C, blue.rho_0, False, R / 4),
                              dtype=dtype, u_init_gravity_shift=True, device=device)
        return torch.cat([st.red.f, st.blue.f]).contiguous()
    sign = 1.0 if csf else -1.0
    model = MRTCGModel(red=red, blue=blue, **RT)
    st = model.init_state(mp.init_rho_cosine(R, C, red.rho_0, True, sign),
                          mp.init_rho_cosine(R, C, blue.rho_0, False, sign),
                          dtype=dtype, device=device)
    planes = [st.red.f, st.blue.f]
    if csf:
        fg = torch.as_tensor(RT["gravity"], dtype=dtype, device=device)[:, None, None]
        planes.append(fg * ((st.red.rho + st.blue.rho)[None] / red.rho_0 - 1.0))
    return torch.cat(planes).contiguous()


def mrtcg_steps(layout, R, C, dtype, csf, droplet=False):
    """(kernel step, plain step, input) of one MRT-CG kernel on flat planes:
    layout "reduced" (kernel 6), "split" (kernel 7) or "full" (kernel 8)."""
    from lbm_tpu_torch.kernels import mrtcg
    from lbm_tpu_torch.scenes import multiphase as mp

    red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
    mode = "csf" if csf else "perturbation"
    kw = DROPLET if droplet else RT
    plain = mrtcg.make_plain_step(red, blue, surface_tension=mode,
                                  reduced_in=layout != "full",
                                  reduced_out=layout == "reduced", **kw)
    if layout == "full":
        if csf:
            kstep = mrtcg.make_csf_fused_step(R, C, red, blue, dtype=dtype, **kw)
        else:
            full = mrtcg.make_mrtcg_fused_step(R, C, red, blue, dtype=dtype, **kw)
            kstep = lambda S: full(S.reshape(2, 9, R, C)).reshape(18, R, C)  # noqa: E731
        return kstep, plain
    factory = (mrtcg.make_mrtcg_reduced_step if layout == "reduced"
               else mrtcg.make_mrtcg_split_step)
    step = factory(R, C, red, blue, dtype=dtype, surface_tension=mode, **kw)
    return (lambda G: step(G).reshape(-1, R, C)), plain


def reduced_input(S, csf):
    from lbm_tpu_torch.kernels import mrtcg

    R, C = S.shape[1:]
    return mrtcg.reduce_mrtcg_state(S if csf else S.reshape(2, 9, R, C),
                                    "csf" if csf else "perturbation")


def hold_mrtcg(name, layout, csf, cases, device):
    """Each case (dtype, (R, C), steps, droplet): the kernel against its
    plain version from one scene state.  Returns the max error per dtype."""
    errs = {}
    for dtype, (R, C), steps, droplet in cases:
        S = mrtcg_state(R, C, dtype, device, csf, droplet)
        x = S if layout == "full" else reduced_input(S, csf)
        kstep, plain = mrtcg_steps(layout, R, C, dtype, csf, droplet)
        got, want = x, x
        for _ in range(steps):
            got, want = kstep(got), plain(want)
        what = "droplet" if droplet else "RT"
        e = compare(f"{name} {'CSF' if csf else 'perturbation'} {what} {R}x{C} {dtype} "
                    f"{steps} step(s)", got, want, dtype)
        errs[dtype] = max(errs.get(dtype, 0.0), e)
        del S, x, got, want
    return errs


def ops_per_cell(fn, x) -> float:
    """Floating-point operations per cell of ``fn(x)``, a plain version on a
    small CPU state: the elements every arithmetic aten op writes (a sum
    over planes counts its adds), counted under a dispatch mode, over the
    cells.  The kernels do the same arithmetic.  A transcendental, a clip or
    a select counts one operation per element, as an add does."""
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {"add", "sub", "mul", "div", "neg", "sqrt", "reciprocal", "rsub", "pow",
             "exp", "log", "expm1", "clamp", "clamp_min", "clamp_max", "where",
             "maximum", "minimum"}
    count = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in arith and hasattr(out, "numel"):
                count[0] += out.numel()
            elif name == "sum" and hasattr(out, "numel"):
                count[0] += args[0].numel() - out.numel()
            return out

    with Count():
        fn(x)
    return count[0] / (x.shape[-2] * x.shape[-1])


def bound(bytes_per_cell, ops, cells, dtype):
    """(least ms, "bytes" or "operations") for ``cells`` cells: the larger of
    the bytes over HBM3's rate and the operations over the peak rate."""
    t_bytes = bytes_per_cell * cells / HBM_BYTES_S
    t_ops = ops * cells / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def cuda_ms(fn, n: int) -> float:
    """Device milliseconds per call of ``fn`` over ``n`` calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2
    if not (ROOT / "lbm_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(no lbm_tpu_torch/csrc)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from lbm_tpu_torch.kernels import (_build, bgk, channel, collide_stream, les, mrtcg,
                                       power_law, trt)
    from lbm_tpu_torch.models import kbc
    from lbm_tpu_torch.models.mrt_cg import phase_field
    from lbm_tpu_torch.models.trt import omega_minus_from_magic
    from lbm_tpu_torch.scenes import multiphase as mp
    from lbm_tpu_torch.ops import d2q9
    from lbm_tpu_torch.scenes import channel as chs
    from lbm_tpu_torch.scenes import ulbm
    from lbm_tpu_torch.scenes.channel import TAU_DEFAULT, horizontal_poiseuille

    f32, f64 = torch.float32, torch.float64
    k1, k2 = collide_stream.COLLIDE_STREAM_BGK, channel.CHANNEL_BGK
    k3, k4, k5 = collide_stream.COLLIDE_STREAM_KBC, channel.CHANNEL_KBC, les.COLLIDE_STREAM_LES
    k6, k7, k8 = mrtcg.MRTCG_REDUCED, mrtcg.MRTCG_SPLIT, mrtcg.MRTCG_FULL
    k9, k10 = channel.CHANNEL_VARIANT, trt.COLLIDE_STREAM_TRT
    k11 = power_law.COLLIDE_STREAM_POWER_LAW
    counted = {"collide_stream_bgk": k1, "channel_bgk": k2, "collide_stream_kbc": k3,
               "channel_kbc": k4, "collide_stream_les": k5, "mrtcg_reduced": k6,
               "mrtcg_split": k7, "mrtcg_full": k8, "channel_variant": k9,
               "collide_stream_trt": k10, "collide_stream_power_law": k11}
    trt_minus = omega_minus_from_magic(TRT_OMEGA)
    VARIANTS = variants()
    card = nvidia_smi("name,power.limit")

    # 1. toolchain
    log(f"[1] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    log(f"[1] device {torch.cuda.get_device_name(0)}  capability "
        f"{torch.cuda.get_device_capability(0)}  count {torch.cuda.device_count()}")
    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    log(f"[1] nvcc {nvcc}: {ver[-1]}")
    try:
        import triton
        log(f"[1] triton {triton.__version__} imports")
    except ImportError as e:
        log(f"[1] triton does not import: {e}")
    log(f"[1] nvidia-smi name,power.limit: {card}")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"[2] built {lib.relative_to(ROOT)} from lbm_tpu_torch/csrc "
        f"({' '.join(_build.NVCC_FLAGS)}) in {time.perf_counter() - t0:.3f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"[2]   {line.strip()}")

    # 3. the periodic kernels against their plain versions
    err1 = hold_periodic(
        "[3] kernel 1",
        lambda R, C, dt, n: bgk.make_fused_step(R, C, OMEGA, dt, substeps=n),
        lambda R, C, dt, n: collide_stream.make_fused_step(
            R, C, bgk.bgk_collide_fn(OMEGA, dt), dt, substeps=n),
        [(f32, BIG, 1), (f32, BIG, 8), (f64, (1024, 512), 1), (f64, (1024, 512), 8),
         (f64, (21, 21), 8), (f64, (100, 100), 8), (f64, (101, 101), 8)],
        dev, seed=0, noisy=False)
    err3 = {}
    for gamma_impl, cases in (
            ("factored", [(f32, BIG, 1), (f32, BIG, 8), (f64, (1024, 512), 8),
                          (f64, (128, 128), 8)]),
            ("direct", [(f32, BIG, 1), (f64, (128, 128), 8)])):
        e = hold_periodic(
            f"[3] kernel 3 ({gamma_impl} gamma)",
            lambda R, C, dt, n, g=gamma_impl: collide_stream.make_kbc_fused_step(
                R, C, OMEGA, dt, substeps=n, gamma_impl=g),
            lambda R, C, dt, n, g=gamma_impl: collide_stream.make_fused_step(
                R, C, collide_stream.kbc_collide_fn(OMEGA, g), dt, substeps=n),
            cases, dev, seed=1000)
        for dt, v in e.items():
            err3[dt] = max(err3.get(dt, 0.0), v)
    err5 = hold_periodic(
        "[3] kernel 5",
        lambda R, C, dt, n: les.make_les_fused_step(R, C, dtype=dt, substeps=n, **LES),
        lambda R, C, dt, n: collide_stream.make_fused_step(
            R, C, les.les_collide_fn(dtype=dt, **LES), dt, substeps=n),
        [(f32, BIG, 1), (f32, BIG, 8), (f64, (128, 128), 8)], dev, seed=2000)

    # the MRT-CG kernels 6-8, both modes, from the scenes' initial states
    mrt_cases = {
        ("reduced", False): [(f32, BIG, 1, False), (f32, BIG, 8, False),
                             (f64, (256, 128), 8, False), (f64, (100, 100), 8, True),
                             (f64, (21, 13), 8, False)],
        ("reduced", True): [(f32, BIG, 1, False), (f32, BIG, 8, False),
                            (f64, (256, 128), 8, False), (f64, (21, 13), 8, False)],
        ("split", False): [(f32, BIG, 1, False), (f64, (256, 128), 1, False),
                           (f64, (100, 100), 1, True)],
        ("split", True): [(f32, BIG, 1, False), (f64, (256, 128), 1, False),
                          (f64, (100, 100), 1, False)],
        ("full", False): [(f32, BIG, 1, False), (f64, (256, 128), 4, False),
                          (f64, (21, 13), 4, False)],
        ("full", True): [(f32, BIG, 1, False), (f64, (256, 128), 4, False),
                         (f64, (21, 13), 4, False)],
    }
    err_mrt = {}
    for (layout, csf), cases in mrt_cases.items():
        kernel = {"reduced": 6, "split": 7, "full": 8}[layout]
        e = hold_mrtcg(f"[3] kernel {kernel}", layout, csf, cases, dev)
        for dt, v in e.items():
            err_mrt.setdefault(layout, {})
            err_mrt[layout][dt] = max(err_mrt[layout].get(dt, 0.0), v)
        torch.cuda.empty_cache()

    # reduced^(T-1) then the split step == the full step T times
    # (lbm_tpu tests/test_mrtcg_pallas.py:137-206), f64 at 256x128, T = 8:
    # 1e-12 in the perturbation mode; in CSF mode lbm_tpu's own 1e-6 (the
    # two layouts round rho differently, and the normal turns that into a
    # noise direction where grad(psi) vanishes) with each colour's mass at
    # 1e-12 relative
    for csf in (False, True):
        S = mrtcg_state(256, 128, f64, dev, csf)
        full, _ = mrtcg_steps("full", 256, 128, f64, csf)
        red_step, _ = mrtcg_steps("reduced", 256, 128, f64, csf)
        split, _ = mrtcg_steps("split", 256, 128, f64, csf)
        G = reduced_input(S, csf)
        for _ in range(7):
            G = red_step(G)
        for _ in range(8):
            S = full(S)
        out = split(G)
        torch.cuda.synchronize()
        err = (out - S).abs().max().item()
        mass = max(abs(out[a:a + 9].sum().item() / S[a:a + 9].sum().item() - 1.0)
                   for a in (0, 9))
        limit = 1e-6 if csf else 1e-12
        log(f"[3] reduced x7 + split == full x8, {'CSF' if csf else 'perturbation'} "
            f"256x128 float64: max_abs_err={err!r} (limit {limit!r}), colour mass "
            f"rel diff={mass!r} (limit 1e-12)")
        if not (err <= limit and mass <= 1e-12):
            raise AssertionError("the reduced and full MRT-CG kernels disagree")

    # kernel 10 (TRT) on noisy states, bench.py's rates
    err10 = hold_periodic(
        "[3] kernel 10",
        lambda R, C, dt, n: trt.make_trt_fused_step(
            R, C, omega_plus=TRT_OMEGA, omega_minus=trt_minus, dtype=dt, substeps=n),
        lambda R, C, dt, n: collide_stream.make_fused_step(
            R, C, trt.trt_collide_fn(TRT_OMEGA, trt_minus, dt), dt, substeps=n),
        [(f32, BIG, 1), (f32, BIG, 8), (f64, (128, 128), 8)], dev, seed=3000)

    # kernel 11 (power law): bench.py's state at 4096x2048, and its three
    # branches on a noisy sheared state at 128x128 (tests/test_power_law.py)
    err11 = {}
    for dtype, (R, C), steps, n, sigma_y, noisy in (
            (f32, BIG, 1, 0.5, 0.0, None), (f32, BIG, 8, 0.5, 0.0, None),
            (f64, (128, 128), 8, 0.5, 0.0, 1), (f64, (128, 128), 8, 1.5, 0.0, 2),
            (f64, (128, 128), 8, 0.8, 5e-4, 3)):
        f = shear_state(R, C, dtype, dev, noisy)
        kw = dict(cons_K=PLAW["cons_K"], n=n, sigma_y=sigma_y)
        got = power_law.make_power_law_fused_step(R, C, dtype=dtype, substeps=steps, **kw)(f)
        want = collide_stream.make_fused_step(
            R, C, power_law.power_law_collide_fn(tau_min=0.52, tau_max=50.0, iters=8,
                                                 dtype=dtype, **kw), dtype, steps)(f)
        e = compare(f"[3] kernel 11 n={n} sigma_y={sigma_y} {R}x{C} {dtype} "
                    f"{steps} step(s)", got, want, dtype)
        err11[dtype] = max(err11.get(dtype, 0.0), e)
        del f, got, want
    torch.cuda.empty_cache()

    # 4. the channel kernels against their plain versions, 10 steps
    tau, rho_in = TAU_DEFAULT, 1.001  # the Poiseuille tau; a 0.1% pressure drop
    err2, err4 = {}, {}
    for family, errs, cases in (
            ("bgk", err2, [(f32, BIG), (f64, (21, 21)), (f64, (101, 101))]),
            ("kbc", err4, [(f32, BIG), (f64, (128, 128)), (f64, (24, 24))])):
        for dtype, (R, C) in cases:
            if family == "bgk":
                f = seeded_state(R, C, dtype, dev, seed=R * C, incompressible=True)
                args = (1 / tau, rho_in, 1.0)
                plain = channel.channel_model(*args).step
            else:
                f = seeded_state(R, C, dtype, dev, seed=R * C + 1, noisy=True)
                args = (ULBM_S2, ULBM_RHO_IN, 1.0)
                plain = channel.kbc_channel_step(*args)
            step = channel.make_channel_fused_step(R, C, *args, dtype, family=family)
            got, want = f, f
            for _ in range(10):
                got, want = step(got), plain(want)
            kernel = {"bgk": 2, "kbc": 4}[family]
            e = compare(f"[4] kernel {kernel} {R}x{C} {dtype} 10 steps", got, want, dtype)
            errs[dtype] = max(errs.get(dtype, 0.0), e)
            del f, got, want

    # kernel 9 in each configuration; at 4096x2048 the kernel runs twice and
    # must repeat itself bit for bit (a second writer of an entry would race)
    err9 = {}
    for name, kw in VARIANTS.items():
        for dtype, (R, C) in ((f32, BIG), (f64, (21, 21)), (f64, (51, 51)), (f64, (54, 42))):
            f = seeded_state(R, C, dtype, dev, seed=R + C + len(name),
                             incompressible=kw["incompressible"], noisy=True)
            step = channel.make_channel_variant_step(R, C, dtype=dtype, **kw)
            plain = channel.ChannelVariant(**kw).model().step
            got, want = f, f
            for _ in range(10):
                got, want = step(got), plain(want)
            e = compare(f"[4] kernel 9 {name} {R}x{C} {dtype} 10 steps", got, want, dtype)
            err9[dtype] = max(err9.get(dtype, 0.0), e)
            if dtype == f32:
                again = f
                for _ in range(10):
                    again = step(again)
                same = bool(torch.equal(again, got))
                log(f"[4] kernel 9 {name} {R}x{C} float32, second run bit-identical: {same}")
                if not same:
                    raise AssertionError(f"kernel 9 {name}: two runs differ (a race)")
                del again
            del f, got, want
    torch.cuda.empty_cache()

    # 5. the main path
    for k in counted.values():
        k.launches = 0
    R, C = BIG
    f = seeded_state(R, C, f32, dev, seed=5)
    mass0, mom0 = f.double().sum().item(), d2q9.calc_momentum(f.double()).sum((1, 2))
    step = bgk.make_fused_step(R, C, OMEGA, f32, substeps=8)
    for _ in range(25):
        f = step(f)
    torch.cuda.synchronize()
    mass, mom = f.double().sum().item(), d2q9.calc_momentum(f.double()).sum((1, 2))
    drift = abs(mass / mass0 - 1.0)
    mom_drift = (mom - mom0).abs().max().item() / (R * C)
    log(f"[5] periodic BGK {R}x{C} float32, 200 steps: finite="
        f"{bool(torch.isfinite(f).all())} mass drift={drift!r} "
        f"momentum drift per cell={mom_drift!r}")
    if not (torch.isfinite(f).all() and drift < 1e-5 and mom_drift < 1e-6):
        raise AssertionError("periodic BGK run lost mass or momentum")
    del f

    before = k2.launches
    t0 = time.perf_counter()
    res = horizontal_poiseuille(device=dev, dtype=f64)
    wall = time.perf_counter() - t0
    log(f"[5] horizontal_poiseuille 21x21 float64 on {res.f.device}: steps={res.steps} "
        f"L2={res.l2!r} (gate 1e-11), kernel-2 launches={k2.launches - before}, "
        f"host wall time {wall!r} s")
    if not (res.l2 <= 1e-11 and k2.launches - before == res.steps
            and res.f.is_cuda):
        raise AssertionError("Poiseuille gate failed on the card")

    run_cli("horizontal_poiseuille", "--x64", "--device", "cuda")

    before = k2.launches
    big = horizontal_poiseuille(H=R, W=C, T=1000, device=dev, dtype=f32)
    log(f"[5] horizontal_poiseuille {R}x{C} float32: steps={big.steps} finite="
        f"{bool(torch.isfinite(big.f).all())} max|u_x|={big.u[0].abs().max().item()!r} "
        f"kernel-2 launches={k2.launches - before}")
    if not (big.steps == 1000 and torch.isfinite(big.f).all()
            and k2.launches - before == 1000):
        raise AssertionError("large channel run failed")
    del big

    # ulbm_poiseuille at the reference's defaults, float64, with the watcher
    # at lbm_tpu's hardware-gate cadence (scripts/validate_tpu.py ulbm_300k)
    before = k4.launches
    t0 = time.perf_counter()
    up = ulbm.ulbm_poiseuille(tolerance=1e-12, t_interval=1000, device=dev, dtype=f64)
    wall = time.perf_counter() - t0
    ux = up.m1[0]
    tail = statistics.median(r for _, r in up.watch[-5:])
    log(f"[5] ulbm_poiseuille 128x128 float64: kernel-4 launches={k4.launches - before}, "
        f"host wall time {wall!r} s ({wall / up.steps * 1e6!r} us/step), "
        f"watch tail {up.watch[-5:]}")
    check_gates("[5] ulbm_poiseuille", {
        "steps": (up.steps, 299000, 300000),
        "finite": (float(torch.isfinite(up.f).all()), 1.0, 1.0),
        "max|u_x|": (ux.abs().max().item(), 1e-4, 0.02),
        "l2 vs parabola": (up.l2, 0.90, 0.99),
        "watch tail x 300": (tail * 300.0, 0.8, 1.2),
        "kernel-4 launches - steps": (k4.launches - before - up.steps, 0, 0),
    })
    del up

    # ulbm_double_shear at the reference's defaults, float64: finite through
    # all 10k steps (lbm_tpu on the CPU: |f|max 0.445 -> 0.505)
    m0, u = ulbm.double_shear_init(128, 128, 0.02, device=dev, dtype=f64)
    fmax0 = kbc.equilibrium(m0, u).abs().max().item()
    before = k3.launches
    t0 = time.perf_counter()
    ds = ulbm.ulbm_double_shear(device=dev, dtype=f64)
    wall = time.perf_counter() - t0
    log(f"[5] ulbm_double_shear 128x128 float64, 10000 steps: |f|max {fmax0!r} -> "
        f"{ds.f.abs().max().item()!r}, host wall time {wall!r} s")
    check_gates("[5] ulbm_double_shear", {
        "finite": (float(torch.isfinite(ds.f).all()), 1.0, 1.0),
        "kernel-3 launches": (k3.launches - before, 10000, 10000),
    })
    del ds

    # the resolved shear layer in float32 (validate_tpu.py kbc)
    H = W = 256
    before = k3.launches
    rs = ulbm.ulbm_double_shear(H=H, W=W, T=5000, nu=1e-3, u_max=0.04, device=dev,
                                dtype=f32)
    _, u0 = ulbm.double_shear_init(H, W, 0.04, device=dev, dtype=f32)
    energy = (rs.m1.double() ** 2).sum().item() / (u0.double() ** 2).sum().item()
    check_gates("[5] resolved KBC shear 256x256 float32, 5000 steps", {
        "mass error": (abs(rs.m0.double().sum().item() / (H * W) - 1.0), 0.0, 1e-6),
        "max|u|": (rs.m1.abs().max().item(), 0.04, 0.09),
        "energy ratio": (energy, 0.90, 0.99),
        "kernel-3 launches": (k3.launches - before, 5000, 5000),
    })
    del rs

    # les_double_shear at the reference's shear defaults, float32, 8 substeps
    # per call (validate_tpu.py les)
    before = k5.launches
    ls = ulbm.les_double_shear(T=10000, substeps=8, device=dev, dtype=f32)
    check_gates("[5] les_double_shear 128x128 float32, 10000 steps", {
        "finite": (float(torch.isfinite(ls.f).all()), 1.0, 1.0),
        "|f|max": (ls.f.abs().max().item(), 0.3, 0.6),
        "|u|max": (ls.m1.abs().max().item(), 0.01, 0.1),
        "kernel-5 launches": (k5.launches - before, 10000, 10000),
    })
    del ls

    run_cli("ulbm_double_shear", "--x64", "--device", "cuda", "--set", "T=200")

    # the MRT-CG scenes: kernel 6 for T-1 steps and kernel 7 once per run
    red, blue = mp.DEFAULT_RED, mp.DEFAULT_BLUE
    mrt_wall = {}

    def scene(label, fn, **kw):
        b6, b7 = k6.launches, k7.launches
        t0 = time.perf_counter()
        res = fn(device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mrt_wall[label] = (wall, res.steps)
        log(f"[5] {label}: kernel-6 launches={k6.launches - b6}, kernel-7 launches="
            f"{k7.launches - b7}, host wall time {wall!r} s "
            f"({wall / res.steps * 1e6!r} us/step)")
        return res, {"kernel-6 launches - (T-1)": (k6.launches - b6 - res.steps + 1, 0, 0),
                     "kernel-7 launches": (k7.launches - b7, 1, 1)}

    # the Laplace law (validate_tpu.py laplace; in f64 also the red mass
    # drift of its df64 gate, :380-382)
    r0_mass = mp.init_rho_droplet(128, 128, red.rho_0, True, 25.0).sum()
    for dtype in (f64, f32):
        res, gates = scene(f"mrtcg_static_droplet 128x128 {dtype} 40000 steps",
                           mp.mrtcg_static_droplet, R=128, C=128, T=40000, radius=25.0,
                           sigma=0.1, dtype=dtype)
        st = res.state
        p = (st.red.rho.double() * red.cs2 + st.blue.rho.double() * blue.cs2).cpu().numpy()
        dp = p[61:67, 61:67].mean() - np.concatenate([p[:4].ravel(), p[-4:].ravel()]).mean()
        gates["dp / (2 sigma / R)"] = (dp / (2 * 0.1 / 25.0), 0.95, 1.1)
        gates["|u|max"] = (st.u.abs().max().item(), 0.0, 5e-3)
        drift = abs(st.red.rho.double().sum().item() / r0_mass - 1.0)
        if dtype == f64:
            gates["red mass drift"] = (drift, 0.0, 1e-9)
        else:
            log(f"[5] Laplace float32: red mass drift {drift!r} (not gated)")
        check_gates(f"[5] Laplace {dtype}", gates)
        del res, st

    # the reference's RT horizon, 256x128 for 100k steps (validate_tpu.py rt_100k)
    mass0 = (mp.init_rho_cosine(256, 128, red.rho_0, True, -1.0)
             + mp.init_rho_cosine(256, 128, blue.rho_0, False, -1.0)).sum()
    for dtype in (f32, f64):
        res, gates = scene(f"mrtcg_rayleigh_taylor 256x128 {dtype} 100000 steps",
                           mp.mrtcg_rayleigh_taylor, dtype=dtype)
        st = res.state
        psi = phase_field(st.red.rho.double(), red.rho_0, st.blue.rho.double(),
                          blue.rho_0).cpu().numpy()
        rho = (st.red.rho.double() + st.blue.rho.double()).cpu().numpy()
        gates.update({
            "finite": (float(torch.isfinite(st.red.f).all() and torch.isfinite(st.blue.f).all()),
                       1.0, 1.0),
            "mass rel drift": (abs(rho.sum() / mass0 - 1.0), 0.0, 1e-3),
            "interface std": (float((psi > 0).sum(axis=0).astype(float).std()), 1.5, 2.1),
            "|psi|max": (float(np.abs(psi).max()), 0.9, 1.001),
        })
        check_gates(f"[5] RT 100k {dtype}", gates)
        del res, st

    # RT growth in the unstable regime (validate_tpu.py rt_growth)
    res, gates = scene("mrtcg_rayleigh_taylor growth 256x128 float32 20000 steps",
                       mp.mrtcg_rayleigh_taylor, T=20000, sigma=1e-5,
                       gravity_magnitude=5e-6, dtype=f32)
    psi = phase_field(res.state.red.rho.double(), red.rho_0, res.state.blue.rho.double(),
                      blue.rho_0).cpu().numpy()
    gates["interface std"] = (float((psi > 0).sum(axis=0).astype(float).std()), 18.0, 40.0)
    check_gates("[5] RT growth float32", gates)

    # CSF growth (validate_tpu.py csf_growth)
    res, gates = scene("mrt_csf_rayleigh_taylor 256x128 float32 6000 steps",
                       mp.mrt_csf_rayleigh_taylor, T=6000, dtype=f32)
    rho = res.state.red.rho.double().cpu().numpy()
    gates.update({
        "finite": (float(np.isfinite(rho).all()), 1.0, 1.0),
        "interface std": (float((rho > 1.5).sum(axis=0).astype(float).std()), 2.0, 60.0),
        "mass rel drift": (abs(rho.sum() / (128 * 128 * 3.0) - 1.0), 0.0, 0.05),
    })
    check_gates("[5] CSF growth float32", gates)
    del res

    run_cli("mrtcg_static_droplet", "--x64", "--device", "cuda", "--set", "T=200")

    # the full per-colour layout (kernel 8, lbm_tpu's make_mrtcg_fused_step /
    # make_csf_fused_step) from the scenes' initial states gives the scenes'
    # results over 20 steps: 1e-12 in the perturbation mode, lbm_tpu's 1e-6
    # in CSF mode, the colour masses at 1e-12 relative.  (The two layouts
    # round rho differently and RT amplifies that: 2.8e-6 apart after 2000
    # float64 steps in the perturbation mode, on the H100.)
    for csf, fn in ((False, mp.mrtcg_rayleigh_taylor), (True, mp.mrt_csf_rayleigh_taylor)):
        T = 20
        res = fn(T=T, device=dev, dtype=f64)
        S = mrtcg_state(256, 128, f64, dev, csf)
        full, _ = mrtcg_steps("full", 256, 128, f64, csf)
        before = k8.launches
        for _ in range(T):
            S = full(S)
        want = torch.cat([res.state.red.f, res.state.blue.f])
        err = (S[:18] - want).abs().max().item()
        mass = max(abs(S[a:a + 9].sum().item() / want[a:a + 9].sum().item() - 1.0)
                   for a in (0, 9))
        check_gates(f"[5] full layout (kernel 8) vs {fn.__name__} 256x128 float64 {T} steps", {
            "max_abs_err": (err, 0.0, 1e-6 if csf else 1e-12),
            "colour mass rel diff": (mass, 0.0, 1e-12),
            "kernel-8 launches": (k8.launches - before, T, T),
        })
        del res, S, want

    # the periodic TRT and power-law runs at 4096x2048 float32, 8 steps per
    # call (bench.py --model trt / plaw): finite, mass and momentum kept
    R, C = BIG
    for label, kernel, f, step in (
            ("TRT", k10, seeded_state(R, C, f32, dev, seed=12),
             trt.make_trt_fused_step(R, C, omega_plus=TRT_OMEGA, omega_minus=trt_minus,
                                     dtype=f32, substeps=8)),
            ("power-law", k11, shear_state(R, C, f32, dev),
             power_law.make_power_law_fused_step(R, C, dtype=f32, substeps=8, **PLAW))):
        before = kernel.launches
        mass0, mom0 = f.double().sum().item(), d2q9.calc_momentum(f.double()).sum((1, 2))
        for _ in range(25):
            f = step(f)
        torch.cuda.synchronize()
        mass, mom = f.double().sum().item(), d2q9.calc_momentum(f.double()).sum((1, 2))
        check_gates(f"[5] periodic {label} {R}x{C} float32, 200 steps", {
            "finite": (float(torch.isfinite(f).all()), 1.0, 1.0),
            "mass drift": (abs(mass / mass0 - 1.0), 0.0, 1e-5),
            "momentum drift per cell": ((mom - mom0).abs().max().item() / (R * C), 0.0, 1e-6),
            "launches": (kernel.launches - before, 200, 200),
        })
        del f

    def variant_scene(label, fn, **kw):
        """A kernel-9 scene on the card: one launch per step, host wall time."""
        before = k9.launches
        t0 = time.perf_counter()
        res = fn(device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"[5] {label}: steps={res.steps} kernel-9 launches={k9.launches - before} "
            f"host wall time {wall!r} s")
        if not (k9.launches - before == res.steps and res.f.is_cuda):
            raise AssertionError(f"{label}: not one kernel-9 launch per step")
        return res

    # the reference's 1e-11 gate in the vertical geometry (incompressible)
    # and the faithful compressible run, watched to a stop
    # (tests/test_channel.py:91-113)
    res = variant_scene("vertical_poiseuille 21x21 float64 incompressible",
                        chs.vertical_poiseuille, H=21, W=21, T=20000,
                        u_max=1.030985714e-1, incompressible=True, tolerance=1e-12,
                        dtype=f64)
    check_gates("[5] vertical_poiseuille incompressible", {"L2": (res.l2, 0.0, 1e-11)})
    res = variant_scene("vertical_poiseuille 31x31 float64", chs.vertical_poiseuille,
                        H=31, W=31, T=30000, u_max=0.05, tolerance=1e-12, dtype=f64)
    mid = res.u[1][:, 15].cpu().numpy()
    ua = chs.poiseuille_analytic(31, 0.05)
    check_gates("[5] vertical_poiseuille compressible", {
        "steps": (res.steps, 1, 29999), "L2": (res.l2, 0.0, 2e-2),
        "max|mid - parabola| - 0.05|parabola|":
            (float((np.abs(mid - ua) - 0.05 * np.abs(ua)).max()), -1.0, 4e-4)})

    # TRT at tau 1.2: the 1e-11 gate in float64, validate_tpu.py trt in float32
    res = variant_scene("trt_poiseuille 21x21 float64", chs.trt_poiseuille, dtype=f64)
    check_gates("[5] trt_poiseuille float64", {"L2": (res.l2, 0.0, 1e-11)})
    res = variant_scene("trt_poiseuille 128x128 float32", chs.trt_poiseuille, H=128, W=128,
                        T=200000, dtype=f32)
    check_gates("[5] trt_poiseuille 128x128 float32", {"L2": (res.l2, 0.0, 5e-4)})

    # gravity: the converged profile against the parabola (tests/test_channel.py:19-37)
    res = variant_scene("gravity_channel 21x21 float64", chs.gravity_channel, dtype=f64)
    nu = (2.0 * TAU_DEFAULT - 1.0) / 6.0
    ua = chs.poiseuille_analytic(21, -3e-4 * 21 * 21 / (8.0 * nu))
    mid = res.u[0][10].cpu().numpy()
    check_gates("[5] gravity_channel", {
        "max(|mid - ua| - 0.25|ua|)": (float((np.abs(mid - ua) - 0.25 * np.abs(ua)).max()),
                                        -1.0, 2e-4),
        "max|mid - mirror| / max|mid|": (float(np.abs(mid - mid[::-1]).max()
                                               / np.abs(mid).max()), 0.0, 1e-6),
        "argmax|mid|": (int(np.abs(mid).argmax()), 10, 10)})

    # specular walls: a flat plug that keeps accelerating (tests/test_channel.py:40-55)
    means = []
    for T in (300, 600):
        res = variant_scene(f"specular_channel 31x21 float64 T={T}", chs.specular_channel,
                            H=31, W=21, T=T, dtype=f64)
        mid = (res.u[0] / res.rho)[15].cpu().numpy()
        means.append(float(mid.mean()))
        check_gates(f"[5] specular_channel T={T}", {
            "finite": (float(np.isfinite(mid).all()), 1.0, 1.0),
            "ptp(mid) / |mean|": (float(np.ptp(mid) / abs(mid.mean())), 0.0, 2e-2)})
    check_gates("[5] specular_channel accelerates", {
        "mean(T=600) - mean(T=300)": (means[1] - means[0], 1e-12, 1.0)})

    # the faithful free stream (tests/test_channel.py:58-73) and the
    # corner-consistent fixed point (:76-88)
    res = variant_scene("free_stream 30x24 float64", chs.free_stream, H=30, W=24, T=100,
                        dtype=f64)
    ux = (res.u[0] / res.rho).cpu().numpy()
    check_gates("[5] free_stream", {
        "bulk mean u_x": (float(ux[6:-6, 6:-6].mean()), 0.08, 0.14),
        "ptp wall rows": (float(max(np.ptp(ux[0]), np.ptp(ux[-1]))), 0.0, 1e-5),
        "|u_x(0, 0) - 0.1|": (float(abs(ux[0, 0] - 0.1)), 0.0, 5e-3)})
    res = variant_scene("free_stream 30x24 float64 corner-consistent", chs.free_stream,
                        H=30, W=24, T=500, corner_consistent=True, dtype=f64)
    check_gates("[5] free_stream corner-consistent fixed point", {
        "max|u_x - 0.1|": ((res.u[0] - 0.1).abs().max().item(), 0.0, 1e-12),
        "max|u_y|": (res.u[1].abs().max().item(), 0.0, 1e-12),
        "max|rho - 1|": ((res.rho - 1.0).abs().max().item(), 0.0, 1e-12)})

    # the full-width run: free_stream from configs/channel.toml in float64,
    # 2700x2100 for 1580 steps, (ux, uy, ps) every 79 steps streamed to disk
    with tempfile.TemporaryDirectory() as tmp:
        prefix = str(Path(tmp) / "free_stream")
        res = variant_scene("free_stream configs/channel.toml float64", chs.free_stream,
                            config_path=str(ROOT / "configs" / "channel.toml"),
                            snapshot_prefix=prefix, dtype=f64)
        frames = {k: np.load(f"{prefix}-{k}.npy", mmap_mode="r") for k in ("ux", "uy", "ps")}
        finite = all(bool(np.isfinite(frames[k][-1]).all()) for k in frames)
        check_gates("[5] free_stream configs/channel.toml", {
            "grid": (res.f.shape[1] * 10000 + res.f.shape[2], 27002100, 27002100),
            "steps": (res.steps, 1580, 1580),
            "frames per field": (min(v.shape[0] for v in frames.values()), 20, 20),
            "frame shape": (max(v.shape[1] * 10000 + v.shape[2] for v in frames.values()),
                            27002100, 27002100),
            "last frames finite": (float(finite), 1.0, 1.0),
            "state finite": (float(torch.isfinite(res.f).all()), 1.0, 1.0)})
        del res, frames

    # power_law_channel has no kernel: plain ops on the card against the CPU
    t0 = time.perf_counter()
    got = chs.power_law_channel(H=4, W=41, T=2000, device=dev, dtype=f64)
    wall = time.perf_counter() - t0
    want = chs.power_law_channel(H=4, W=41, T=2000, device="cpu", dtype=f64)
    check_gates(f"[5] power_law_channel 4x41 float64 on the card vs the CPU (card host "
                f"wall time {wall!r} s)", {
        "steps": (got.steps - want.steps, 0, 0),
        "max|f_card - f_cpu|": ((got.f.cpu() - want.f).abs().max().item(), 0.0, 1e-10)})
    del got, want

    run_cli("vertical_poiseuille", "--x64", "--device", "cuda")
    run_cli("free_stream", "--config", "configs/channel.toml", "--set", "T=158",
            "--device", "cuda")

    launches = {name: k.launches for name, k in counted.items()}
    log(f"[5] main-path launches: {launches}")
    if not all(launches.values()):
        raise AssertionError("a kernel of the main path was never launched")

    # 6. times at 4096x2048 float32, in turns (kernel, plain, ..., then the
    # reverse order, then again); the states are bench.py's where it has one
    cells = R * C
    f = seeded_state(R, C, f32, dev, seed=6)
    fi = seeded_state(R, C, f32, dev, seed=7, incompressible=True)
    u = torch.zeros((2, R, C), dtype=f32, device=dev)
    u[0] = 0.05  # bench.py's KBC state: the equilibrium at u = (0.05, 0)
    fk = kbc.equilibrium(torch.ones((R, C), dtype=f32, device=dev), u)
    fc = seeded_state(R, C, f32, dev, seed=10, noisy=True)
    m0, u = ulbm.double_shear_init(R, C, 0.05, device=dev, dtype=f32)
    fl = d2q9.equilibrium(u, m0).contiguous()
    plain1 = collide_stream.make_fused_step(R, C, bgk.bgk_collide_fn(OMEGA, f32), f32)
    model = channel.channel_model(1 / tau, rho_in, 1.0)
    plain3 = collide_stream.make_fused_step(R, C, collide_stream.kbc_collide_fn(OMEGA), f32)
    plain4 = channel.kbc_channel_step(ULBM_S2, ULBM_RHO_IN, 1.0)
    plain5 = collide_stream.make_fused_step(R, C, les.les_collide_fn(dtype=f32, **LES), f32)
    dst = torch.empty_like(f)
    S8 = mrtcg_state(R, C, f32, dev)
    G6 = reduced_input(S8, False)
    G6c = reduced_input(mrtcg_state(R, C, f32, dev, csf=True), True)
    mrt = {layout_csf: mrtcg_steps(layout_csf[0], R, C, f32, layout_csf[1])
           for layout_csf in (("reduced", False), ("reduced", True), ("split", False),
                              ("full", False))}
    grav, free = (channel.ChannelVariant(**VARIANTS[k]) for k in ("gravity", "free_stream"))
    grav_c, free_c = grav.constants(f32), free.constants(f32)
    fs = seeded_state(R, C, f32, dev, seed=13, incompressible=True, noisy=True)
    fp = shear_state(R, C, f32, dev)
    plain9g, plain9f = grav.model().step, free.model().step
    plain10 = collide_stream.make_fused_step(
        R, C, trt.trt_collide_fn(TRT_OMEGA, trt_minus, f32), f32)
    plain11 = collide_stream.make_fused_step(
        R, C, power_law.power_law_collide_fn(tau_min=0.52, tau_max=50.0, iters=8, dtype=f32,
                                             **PLAW), f32)
    fns = {
        "collide_stream_bgk": (lambda: collide_stream.collide_stream_bgk(f, OMEGA), 50),
        "collide_stream_bgk_plain": (lambda: plain1(f), 10),
        "channel_bgk": (lambda: channel.channel_bgk(fi, 1 / tau, rho_in, 1.0), 50),
        "channel_bgk_plain": (lambda: model.step(fi), 10),
        "collide_stream_kbc": (lambda: collide_stream.collide_stream_kbc(fk, OMEGA), 50),
        "collide_stream_kbc_direct": (lambda: collide_stream.collide_stream_kbc(
            fk, OMEGA, gamma_impl="direct"), 50),
        "collide_stream_kbc_plain": (lambda: plain3(fk), 5),
        "channel_kbc": (lambda: channel.channel_kbc(fc, ULBM_S2, ULBM_RHO_IN, 1.0), 50),
        "channel_kbc_plain": (lambda: plain4(fc), 5),
        "collide_stream_les": (lambda: les.collide_stream_les(fl, **LES), 50),
        "collide_stream_les_plain": (lambda: plain5(fl), 10),
        "mrtcg_reduced": (lambda: mrt["reduced", False][0](G6), 30),
        "mrtcg_reduced_plain": (lambda: mrt["reduced", False][1](G6), 3),
        "mrtcg_reduced_csf": (lambda: mrt["reduced", True][0](G6c), 30),
        "mrtcg_reduced_csf_plain": (lambda: mrt["reduced", True][1](G6c), 3),
        "mrtcg_split": (lambda: mrt["split", False][0](G6), 30),
        "mrtcg_split_plain": (lambda: mrt["split", False][1](G6), 3),
        "mrtcg_full": (lambda: mrt["full", False][0](S8), 30),
        "mrtcg_full_plain": (lambda: mrt["full", False][1](S8), 3),
        "channel_variant": (lambda: channel.channel_variant(fi, grav, grav_c), 50),
        "channel_variant_plain": (lambda: plain9g(fi), 10),
        "channel_variant_free_stream": (lambda: channel.channel_variant(fs, free, free_c), 50),
        "channel_variant_free_stream_plain": (lambda: plain9f(fs), 10),
        "collide_stream_trt": (lambda: trt.collide_stream_trt(f, TRT_OMEGA, trt_minus), 50),
        "collide_stream_trt_plain": (lambda: plain10(f), 10),
        "collide_stream_power_law": (lambda: power_law.collide_stream_power_law(fp, **PLAW), 50),
        "collide_stream_power_law_plain": (lambda: plain11(fp), 5),
        "copy": (lambda: dst.copy_(f), 50),
    }
    runs = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1], list(fns)):
        for k in order:
            fn, n = fns[k]
            runs[k].append(cuda_ms(fn, n))
    ms = {k: sorted(v)[1] for k, v in runs.items()}  # median of 3
    copy_gbs = 2 * f.numel() * 4 / (ms["copy"] * 1e-3) / 1e9
    log(f"[6] {card}; copy of {f.numel() * 4 / 1e6:.1f} MB: {ms['copy']!r} ms "
        f"= {copy_gbs!r} GB/s (read + write)")
    # bytes per cell in float32: each input plane read once, each output
    # plane written once
    bytes32 = {"mrtcg_reduced": 80, "mrtcg_reduced_csf": 96, "mrtcg_split": 112,
               "mrtcg_full": 144}
    for k in fns:
        if k == "copy":
            continue
        b = bytes32.get(k.removesuffix("_plain"), 72)
        mlups = cells / (ms[k] * 1e-3) / 1e6
        gbs = b * cells / (ms[k] * 1e-3) / 1e9
        log(f"[6] {k}: {ms[k]!r} ms/step (runs {runs[k]}) = {mlups!r} MLUPS, "
            f"{gbs!r} GB/s at {b} B/cell = {gbs / copy_gbs!r} of copy")
    del f, fi, fk, fc, fl, dst, S8, G6, G6c, mrt, fs, fp
    torch.cuda.empty_cache()
    f = seeded_state(R, C, f64, dev, seed=8)
    fs = seeded_state(R, C, f64, dev, seed=14, incompressible=True, noisy=True)
    fp = shear_state(R, C, f64, dev)
    grav_c, free_c = grav.constants(f64), free.constants(f64)
    fi = seeded_state(R, C, f64, dev, seed=9, incompressible=True)
    fc = seeded_state(R, C, f64, dev, seed=11, noisy=True)
    S8 = mrtcg_state(R, C, f64, dev)
    G6 = reduced_input(S8, False)
    G6c = reduced_input(mrtcg_state(R, C, f64, dev, csf=True), True)
    mrt = {layout_csf: mrtcg_steps(layout_csf[0], R, C, f64, layout_csf[1])[0]
           for layout_csf in (("reduced", False), ("reduced", True), ("split", False),
                              ("full", False))}
    ms64 = {}
    for k, fn in (
            ("collide_stream_bgk", lambda: collide_stream.collide_stream_bgk(f, OMEGA)),
            ("channel_bgk", lambda: channel.channel_bgk(fi, 1 / tau, rho_in, 1.0)),
            ("collide_stream_kbc", lambda: collide_stream.collide_stream_kbc(f, OMEGA)),
            ("collide_stream_kbc_direct", lambda: collide_stream.collide_stream_kbc(
                f, OMEGA, gamma_impl="direct")),
            ("channel_kbc", lambda: channel.channel_kbc(fc, ULBM_S2, ULBM_RHO_IN, 1.0)),
            ("collide_stream_les", lambda: les.collide_stream_les(f, **LES)),
            ("mrtcg_reduced", lambda: mrt["reduced", False](G6)),
            ("mrtcg_reduced_csf", lambda: mrt["reduced", True](G6c)),
            ("mrtcg_split", lambda: mrt["split", False](G6)),
            ("mrtcg_full", lambda: mrt["full", False](S8)),
            ("channel_variant", lambda: channel.channel_variant(fi, grav, grav_c)),
            ("channel_variant_free_stream", lambda: channel.channel_variant(fs, free, free_c)),
            ("collide_stream_trt", lambda: trt.collide_stream_trt(f, TRT_OMEGA, trt_minus)),
            ("collide_stream_power_law",
             lambda: power_law.collide_stream_power_law(fp, **PLAW))):
        t = ms64[k] = cuda_ms(fn, 20 if k.startswith("mrtcg") else 50)
        b = 2 * bytes32.get(k, 72)
        gbs = b * cells / (t * 1e-3) / 1e9
        log(f"[6] {k} float64: {t!r} ms/step = {cells / (t * 1e-3) / 1e6!r} MLUPS, "
            f"{gbs!r} GB/s at {b} B/cell = {gbs / copy_gbs!r} of copy")
    # the plain versions of kernels 9-11 in float64
    plain10_64 = collide_stream.make_fused_step(
        R, C, trt.trt_collide_fn(TRT_OMEGA, trt_minus, f64), f64)
    plain11_64 = collide_stream.make_fused_step(
        R, C, power_law.power_law_collide_fn(tau_min=0.52, tau_max=50.0, iters=8, dtype=f64,
                                             **PLAW), f64)
    plain64 = {}
    for k, fn in (("channel_variant", lambda: plain9g(fi)),
                  ("channel_variant_free_stream", lambda: plain9f(fs)),
                  ("collide_stream_trt", lambda: plain10_64(f)),
                  ("collide_stream_power_law", lambda: plain11_64(fp))):
        plain64[k] = cuda_ms(fn, 5)
        log(f"[6] {k}_plain float64: {plain64[k]!r} ms/step")
    del f, fi, fc, S8, G6, G6c, mrt, fs, fp
    torch.cuda.empty_cache()

    # kernel 6 at the reference's RT grid, 256x128: the device time per
    # step from a CUDA graph of 100 steps (one step issues in ~30 us on the
    # host, longer than the kernel runs, so events around eager launches
    # time the host), and the host time per step of the 100k-step runs
    for dtype in (f32, f64):
        G = reduced_input(mrtcg_state(256, 128, dtype, dev), False)
        step, _ = mrtcg_steps("reduced", 256, 128, dtype, False)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(G)  # warm up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = G
            for _ in range(100):
                y = step(y)
        t_graph = cuda_ms(graph.replay, 10) / 100
        t_eager = cuda_ms(lambda: step(G), 500)
        wall, steps = mrt_wall[f"mrtcg_rayleigh_taylor 256x128 {dtype} 100000 steps"]
        log(f"[6] mrtcg_reduced 256x128 {dtype}: {t_graph!r} device ms/step (CUDA graph "
            f"of 100 steps), {t_eager!r} ms/step issued eagerly, "
            f"{wall / steps * 1e6!r} host us/step over the 100k-step run")
        del graph, y

    log(f"[6] nvidia-smi clocks.sm,power.draw,temperature.gpu: "
        f"{nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")

    # the bound of each kernel at 4096x2048 float32: its bytes over HBM3's
    # rate against its operations (counted on its plain version at 64x64 on
    # the CPU) over the fp32 peak
    small = 64
    cpu = torch.device("cpu")
    S_small = mrtcg_state(small, small, f32, cpu)
    plains = {
        "collide_stream_bgk": (collide_stream.make_fused_step(
            small, small, bgk.bgk_collide_fn(OMEGA, f32), f32),
            seeded_state(small, small, f32, cpu, seed=1)),
        "channel_bgk": (channel.channel_model(1 / tau, rho_in, 1.0).step,
                        seeded_state(small, small, f32, cpu, seed=2, incompressible=True)),
        "collide_stream_kbc": (collide_stream.make_fused_step(
            small, small, collide_stream.kbc_collide_fn(OMEGA), f32),
            seeded_state(small, small, f32, cpu, seed=3, noisy=True)),
        "collide_stream_kbc_direct": (collide_stream.make_fused_step(
            small, small, collide_stream.kbc_collide_fn(OMEGA, "direct"), f32),
            seeded_state(small, small, f32, cpu, seed=3, noisy=True)),
        "channel_kbc": (channel.kbc_channel_step(ULBM_S2, ULBM_RHO_IN, 1.0),
                        seeded_state(small, small, f32, cpu, seed=4, noisy=True)),
        "collide_stream_les": (collide_stream.make_fused_step(
            small, small, les.les_collide_fn(dtype=f32, **LES), f32),
            seeded_state(small, small, f32, cpu, seed=5)),
        "mrtcg_reduced": (mrtcg_steps("reduced", small, small, f32, False)[1],
                          reduced_input(S_small, False)),
        "mrtcg_reduced_csf": (mrtcg_steps("reduced", small, small, f32, True)[1],
                              reduced_input(mrtcg_state(small, small, f32, cpu, True), True)),
        "mrtcg_split": (mrtcg_steps("split", small, small, f32, False)[1],
                        reduced_input(S_small, False)),
        "mrtcg_full": (mrtcg_steps("full", small, small, f32, False)[1], S_small),
        "channel_variant": (grav.model().step,
                            seeded_state(small, small, f32, cpu, seed=6, incompressible=True)),
        "channel_variant_free_stream": (free.model().step, seeded_state(
            small, small, f32, cpu, seed=7, incompressible=True, noisy=True)),
        "collide_stream_trt": (collide_stream.make_fused_step(
            small, small, trt.trt_collide_fn(TRT_OMEGA, trt_minus, f32), f32),
            seeded_state(small, small, f32, cpu, seed=8, noisy=True)),
        "collide_stream_power_law": (collide_stream.make_fused_step(
            small, small, power_law.power_law_collide_fn(
                tau_min=0.52, tau_max=50.0, iters=8, dtype=f32, **PLAW), f32),
            shear_state(small, small, f32, cpu)),
    }
    bounds = {}
    for name, (fn, x) in plains.items():
        ops = ops_per_cell(fn, x)
        b = bytes32.get(name, 72)
        bounds[name] = bound(b, ops, cells, "float32")
        b64 = bound(2 * b, ops, cells, "float64")
        log(f"[6] bound {name} at {R}x{C}: {b} B/cell, {ops!r} flops/cell -> float32 "
            f"{bounds[name][0]!r} ms ({bounds[name][1]}), float64 {b64[0]!r} ms ({b64[1]})")

    rows = [
        ("collide_stream_bgk", "lbm_tpu/kernels/bgk_pallas.py:74", err1),
        ("channel_bgk", "lbm_tpu/kernels/channel_pallas.py:128", err2),
        ("collide_stream_kbc", "lbm_tpu/kernels/collide_stream.py:154", err3),
        ("channel_kbc", "lbm_tpu/kernels/channel_pallas.py:128", err4),
        ("collide_stream_les", "lbm_tpu/kernels/les_pallas.py:78", err5),
        ("mrtcg_reduced", "lbm_tpu/kernels/mrtcg_pallas.py:1004", err_mrt["reduced"]),
        ("mrtcg_split", "lbm_tpu/kernels/mrtcg_pallas.py:1129", err_mrt["split"]),
        ("mrtcg_full", "lbm_tpu/kernels/mrtcg_pallas.py:876", err_mrt["full"]),
        ("channel_variant", "lbm_tpu/kernels/channel_pallas.py:158", err9),
        ("collide_stream_trt", "lbm_tpu/kernels/trt_pallas.py:74", err10),
        ("collide_stream_power_law", "lbm_tpu/kernels/power_law_pallas.py:144", err11),
    ]
    kernels = [
        {"name": name, "route": "cuda", "source": f"lbm_tpu_torch/csrc/{name}.cu",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": errs[f32], "max_abs_err_f64": errs[f64],
         "ms": ms[name], "plain_ms": ms[f"{name}_plain"],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None,
         "ms_f64": ms64[name]}
        for name, replaces, errs in rows]
    kernels[2].update(ms_direct=ms["collide_stream_kbc_direct"],
                      ms_direct_f64=ms64["collide_stream_kbc_direct"],
                      bound_ms_direct=bounds["collide_stream_kbc_direct"][0])
    kernels[5].update(ms_csf=ms["mrtcg_reduced_csf"],
                      plain_ms_csf=ms["mrtcg_reduced_csf_plain"],
                      ms_csf_f64=ms64["mrtcg_reduced_csf"],
                      bound_ms_csf=bounds["mrtcg_reduced_csf"][0])
    kernels[8].update(ms_free_stream=ms["channel_variant_free_stream"],
                      plain_ms_free_stream=ms["channel_variant_free_stream_plain"],
                      ms_free_stream_f64=ms64["channel_variant_free_stream"],
                      plain_ms_free_stream_f64=plain64["channel_variant_free_stream"],
                      bound_ms_free_stream=bounds["channel_variant_free_stream"][0])
    for entry in kernels[8:]:
        entry["plain_ms_f64"] = plain64[entry["name"]]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
