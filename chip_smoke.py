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
  2. build: the kernels from csrc/, timed;
  3. kernel 1 (periodic BGK collide-stream) against its plain version at
     4096x2048 float32 (1 and 8 steps; the 302 MB-per-buffer grid of
     bench.py), 1024x512 float64 and the reference's 21x21, 100x100 and
     101x101 in float64;
  4. kernel 2 (the channel step) against its plain version: 10 steps at
     4096x2048 float32 and at 21x21 and 101x101 float64;
  5. the main path, with every launch count set to 0 just before and read
     just after: the periodic BGK run at 4096x2048 float32 through
     kernels.bgk.make_fused_step; horizontal_poiseuille at the reference's
     defaults in float64 (L2 <= 1e-11, one kernel-2 launch per step); the
     CLI in a subprocess; the same scene at 4096x2048 float32, 1000 steps;
  6. times at 4096x2048 float32: MLUPS, and effective bandwidth at
     72 B/cell against a device-to-device copy of the same bytes.
It exits nonzero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = {"float32": 2e-6, "float64": 1e-13}  # max abs error, kernel vs plain
BIG = (4096, 2048)
OMEGA = 1.0 / 0.8  # bench.py's BGK relaxation


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def seeded_state(R, C, dtype, device, seed, incompressible=False):
    """An equilibrium at a numpy-seeded random flow (|u| <= 0.05, rho within
    1%), made on the card, so every population differs."""
    import numpy as np
    import torch

    from lbm_tpu_torch.ops import d2q9

    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.uniform(-0.05, 0.05, (2, R, C)), dtype=dtype, device=device)
    rho = torch.as_tensor(1.0 + rng.uniform(-0.01, 0.01, (R, C)), dtype=dtype, device=device)
    eq = d2q9.incomp_equilibrium if incompressible else d2q9.equilibrium
    return eq(u, rho).contiguous()


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

    from lbm_tpu_torch.kernels import _build, bgk, channel, collide_stream
    from lbm_tpu_torch.ops import d2q9
    from lbm_tpu_torch.scenes.channel import TAU_DEFAULT, horizontal_poiseuille

    f32, f64 = torch.float32, torch.float64
    k1, k2 = collide_stream.COLLIDE_STREAM_BGK, channel.CHANNEL_BGK
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

    # 3. kernel 1 against its plain version
    err1 = {}
    for dtype, (R, C), steps in [(f32, BIG, 1), (f32, BIG, 8), (f64, (1024, 512), 1),
                                 (f64, (1024, 512), 8), (f64, (21, 21), 8),
                                 (f64, (100, 100), 8), (f64, (101, 101), 8)]:
        f = seeded_state(R, C, dtype, dev, seed=R + C)
        got = bgk.make_fused_step(R, C, OMEGA, dtype, substeps=steps)(f)
        want = collide_stream.make_fused_step(
            R, C, bgk.bgk_collide_fn(OMEGA, dtype), dtype, substeps=steps)(f)
        e = compare(f"[3] kernel 1 {R}x{C} {dtype} {steps} step(s)", got, want, dtype)
        err1[dtype] = max(err1.get(dtype, 0.0), e)
        del f, got, want

    # 4. kernel 2 against its plain version
    tau, rho_in = TAU_DEFAULT, 1.001  # the Poiseuille tau; a 0.1% pressure drop
    err2 = {}
    for dtype, (R, C) in [(f32, BIG), (f64, (21, 21)), (f64, (101, 101))]:
        f = seeded_state(R, C, dtype, dev, seed=R * C, incompressible=True)
        step = channel.make_channel_fused_step(R, C, 1 / tau, rho_in, 1.0, dtype)
        model = channel.channel_model(1 / tau, rho_in, 1.0)
        got, want = f, f
        for _ in range(10):
            got, want = step(got), model.step(want)
        e = compare(f"[4] kernel 2 {R}x{C} {dtype} 10 steps", got, want, dtype)
        err2[dtype] = max(err2.get(dtype, 0.0), e)
        del f, got, want

    # 5. the main path
    k1.launches = k2.launches = 0
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

    cli = subprocess.run(
        [sys.executable, "-m", "lbm_tpu_torch.run", "horizontal_poiseuille",
         "--x64", "--device", "cuda"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    log(f"[5] CLI horizontal_poiseuille --x64 --device cuda: rc={cli.returncode} "
        f"{cli.stderr.strip().splitlines()[-1] if cli.stderr.strip() else ''}")
    if cli.returncode != 0:
        raise AssertionError(f"CLI failed:\n{cli.stderr[-3000:]}")

    before = k2.launches
    big = horizontal_poiseuille(H=R, W=C, T=1000, device=dev, dtype=f32)
    log(f"[5] horizontal_poiseuille {R}x{C} float32: steps={big.steps} finite="
        f"{bool(torch.isfinite(big.f).all())} max|u_x|={big.u[0].abs().max().item()!r} "
        f"kernel-2 launches={k2.launches - before}")
    if not (big.steps == 1000 and torch.isfinite(big.f).all()
            and k2.launches - before == 1000):
        raise AssertionError("large channel run failed")
    del big
    launches = {"collide_stream_bgk": k1.launches, "channel_bgk": k2.launches}
    log(f"[5] main-path launches: {launches}")
    if not all(launches.values()):
        raise AssertionError("a kernel of the main path was never launched")

    # 6. times at 4096x2048 float32, in turns (kernel, plain, plain, kernel, ...)
    cells = R * C
    f = seeded_state(R, C, f32, dev, seed=6)
    fi = seeded_state(R, C, f32, dev, seed=7, incompressible=True)
    plain1 = collide_stream.make_fused_step(R, C, bgk.bgk_collide_fn(OMEGA, f32), f32)
    model = channel.channel_model(1 / tau, rho_in, 1.0)
    dst = torch.empty_like(f)
    fns = {
        "collide_stream_bgk": (lambda: collide_stream.collide_stream_bgk(f, OMEGA), 50),
        "collide_stream_bgk_plain": (lambda: plain1(f), 10),
        "channel_bgk": (lambda: channel.channel_bgk(fi, 1 / tau, rho_in, 1.0), 50),
        "channel_bgk_plain": (lambda: model.step(fi), 10),
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
    del f, fi, dst
    f = seeded_state(R, C, f64, dev, seed=8)
    fi = seeded_state(R, C, f64, dev, seed=9, incompressible=True)
    for k, fn in (("collide_stream_bgk", lambda: collide_stream.collide_stream_bgk(f, OMEGA)),
                  ("channel_bgk", lambda: channel.channel_bgk(fi, 1 / tau, rho_in, 1.0))):
        t = cuda_ms(fn, 50)
        log(f"[6] {k} float64: {t!r} ms/step = {cells / (t * 1e-3) / 1e6!r} MLUPS, "
            f"{144 * cells / (t * 1e-3) / 1e9!r} GB/s at 144 B/cell")
    log(f"[6] nvidia-smi clocks.sm,power.draw,temperature.gpu: "
        f"{nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")

    kernels = [
        {"name": "collide_stream_bgk", "route": "cuda",
         "source": "lbm_tpu_torch/csrc/collide_stream_bgk.cu",
         "replaces": "lbm_tpu/kernels/bgk_pallas.py:74",
         "launches": launches["collide_stream_bgk"],
         "max_abs_err": err1[f32], "max_abs_err_f64": err1[f64],
         "ms": ms["collide_stream_bgk"], "plain_ms": ms["collide_stream_bgk_plain"]},
        {"name": "channel_bgk", "route": "cuda",
         "source": "lbm_tpu_torch/csrc/channel_bgk.cu",
         "replaces": "lbm_tpu/kernels/channel_pallas.py:128",
         "launches": launches["channel_bgk"],
         "max_abs_err": err2[f32], "max_abs_err_f64": err2[f64],
         "ms": ms["channel_bgk"], "plain_ms": ms["channel_bgk_plain"]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
