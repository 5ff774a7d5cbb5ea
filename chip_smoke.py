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
     equilibrium (seeded_state(noisy=True));
  4. the channel kernels against their plain versions, 10 steps: kernel 2
     (BGK) at 4096x2048 float32, 21x21 and 101x101 float64; kernel 4 (KBC)
     at 4096x2048 float32, 128x128 and 24x24 float64, at
     ulbm_poiseuille's default relaxation and inlet density;
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
     ulbm_double_shear CLI;
  6. times at 4096x2048 float32 of every kernel and its plain version:
     MLUPS, and effective bandwidth at 72 B/cell against a device-to-device
     copy of the same bytes, taken in turns; the kernels in float64.
It exits nonzero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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

    from lbm_tpu_torch.kernels import _build, bgk, channel, collide_stream, les
    from lbm_tpu_torch.models import kbc
    from lbm_tpu_torch.ops import d2q9
    from lbm_tpu_torch.scenes import ulbm
    from lbm_tpu_torch.scenes.channel import TAU_DEFAULT, horizontal_poiseuille

    f32, f64 = torch.float32, torch.float64
    k1, k2 = collide_stream.COLLIDE_STREAM_BGK, channel.CHANNEL_BGK
    k3, k4, k5 = collide_stream.COLLIDE_STREAM_KBC, channel.CHANNEL_KBC, les.COLLIDE_STREAM_LES
    counted = {"collide_stream_bgk": k1, "channel_bgk": k2, "collide_stream_kbc": k3,
               "channel_kbc": k4, "collide_stream_les": k5}
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
    for k in fns:
        if k == "copy":
            continue
        mlups = cells / (ms[k] * 1e-3) / 1e6
        gbs = 72 * cells / (ms[k] * 1e-3) / 1e9
        log(f"[6] {k}: {ms[k]!r} ms/step (runs {runs[k]}) = {mlups!r} MLUPS, "
            f"{gbs!r} GB/s at 72 B/cell = {gbs / copy_gbs!r} of copy")
    del f, fi, fk, fc, fl, dst
    f = seeded_state(R, C, f64, dev, seed=8)
    fi = seeded_state(R, C, f64, dev, seed=9, incompressible=True)
    fc = seeded_state(R, C, f64, dev, seed=11, noisy=True)
    ms64 = {}
    for k, fn in (
            ("collide_stream_bgk", lambda: collide_stream.collide_stream_bgk(f, OMEGA)),
            ("channel_bgk", lambda: channel.channel_bgk(fi, 1 / tau, rho_in, 1.0)),
            ("collide_stream_kbc", lambda: collide_stream.collide_stream_kbc(f, OMEGA)),
            ("collide_stream_kbc_direct", lambda: collide_stream.collide_stream_kbc(
                f, OMEGA, gamma_impl="direct")),
            ("channel_kbc", lambda: channel.channel_kbc(fc, ULBM_S2, ULBM_RHO_IN, 1.0)),
            ("collide_stream_les", lambda: les.collide_stream_les(f, **LES))):
        t = ms64[k] = cuda_ms(fn, 50)
        log(f"[6] {k} float64: {t!r} ms/step = {cells / (t * 1e-3) / 1e6!r} MLUPS, "
            f"{144 * cells / (t * 1e-3) / 1e9!r} GB/s at 144 B/cell")
    log(f"[6] nvidia-smi clocks.sm,power.draw,temperature.gpu: "
        f"{nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")

    rows = [
        ("collide_stream_bgk", "lbm_tpu/kernels/bgk_pallas.py:74", err1),
        ("channel_bgk", "lbm_tpu/kernels/channel_pallas.py:128", err2),
        ("collide_stream_kbc", "lbm_tpu/kernels/collide_stream.py:154", err3),
        ("channel_kbc", "lbm_tpu/kernels/channel_pallas.py:128", err4),
        ("collide_stream_les", "lbm_tpu/kernels/les_pallas.py:78", err5),
    ]
    kernels = [
        {"name": name, "route": "cuda", "source": f"lbm_tpu_torch/csrc/{name}.cu",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": errs[f32], "max_abs_err_f64": errs[f64],
         "ms": ms[name], "plain_ms": ms[f"{name}_plain"], "ms_f64": ms64[name]}
        for name, replaces, errs in rows]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
