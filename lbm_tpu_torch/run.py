"""Scene runner CLI of the PyTorch port (counterpart of lbm_tpu/run.py).

    python -m lbm_tpu_torch.run <scene> [--config cfg.toml] [--markers m.toml]
           [--set key=value ...] [--out prefix] [--checkpoint-dir dir]
           [--checkpoint-every N] [--resume] [--x64] [--device cuda|cpu] [--yes]

`--config` passes a TOML to the scenes that take one (``config_path``),
`--markers` an IBM marker TOML to cylinder_flow (``markers_path``).
`--set` overrides any scene keyword (ints/floats/bools parsed as python
literals).  `--checkpoint-dir` checkpoints the scenes that take it every
`--checkpoint-every` steps (the scene's default, 10000, otherwise) and
resumes from the newest checkpoint there; `--resume` fails unless there is
one.  `--x64` runs in float64, the reference's precision (else
float32).  `--device` defaults to cuda; `--device cpu` runs the plain
PyTorch versions.  Result tensors are written as .npy files under --out,
recorded snapshots as {out}-snap-{name}.npy.  The closing log line names
the result's scalars and its 1-D fields of at most 4 entries (cylinder_flow's
surface_force, a falling body's centre and velocity, a thermal scene's
Nusselt number; a trajectory or the DKT pair's (B, 2) centres go only to
--out).  Registered: the channel, ULBM, multiphase (MRT-CG/CSF, RK, CSF
droplet), Shan-Chen, obstacle (IBM cylinder, rectangle sedimentation, the
falling cylinder, DKT pair and ellipse), ring-cavity, thermal
(Rayleigh-Benard, heated cavity) and D3Q19 (3-D Poiseuille, Taylor-Green,
lid-driven cavity) scenes, 32 of lbm_tpu's 35, under lbm_tpu's names.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import inspect
import sys

import numpy as np
import torch

from .io.checkpoint import latest
from .utils.observe import confirm, logger
from .utils.xmath import default_device


def _scenes() -> dict:
    from .scenes import (cavity, channel, multiphase, obstacles, shan_chen, thermal,
                         three_d, ulbm)

    return {
        "horizontal_poiseuille": channel.horizontal_poiseuille,
        "vertical_poiseuille": channel.vertical_poiseuille,
        "gravity_channel": channel.gravity_channel,
        "specular_channel": channel.specular_channel,
        "trt_poiseuille": channel.trt_poiseuille,
        "power_law_channel": channel.power_law_channel,
        "free_stream": channel.free_stream,
        "mrtcg_static_droplet": multiphase.mrtcg_static_droplet,
        "mrtcg_rayleigh_taylor": multiphase.mrtcg_rayleigh_taylor,
        "mrtcg_multimode_rayleigh_taylor": multiphase.mrtcg_multimode_rayleigh_taylor,
        "mrt_csf_rayleigh_taylor": multiphase.mrt_csf_rayleigh_taylor,
        "rk_static_droplet": multiphase.rk_static_droplet,
        "csf_static_droplet": multiphase.csf_static_droplet,
        "rk_rayleigh_taylor": multiphase.rk_rayleigh_taylor,
        "ulbm_poiseuille": ulbm.ulbm_poiseuille,
        "ulbm_double_shear": ulbm.ulbm_double_shear,
        "les_double_shear": ulbm.les_double_shear,
        "sc_phase_separation": shan_chen.sc_phase_separation,
        "sc_static_droplet": shan_chen.sc_static_droplet,
        "sc_flat_interface": shan_chen.sc_flat_interface,
        "sc_cs_interface": shan_chen.sc_cs_interface,
        "cylinder_flow": obstacles.cylinder_flow,
        "rectangle_sedimentation": obstacles.rectangle_sedimentation,
        "falling_cylinder": obstacles.falling_cylinder,
        "falling_cylinders": obstacles.falling_cylinders,
        "falling_ellipse": obstacles.falling_ellipse,
        "ring_cavity": cavity.ring_cavity,
        "rayleigh_benard": thermal.rayleigh_benard,
        "heated_cavity": thermal.heated_cavity,
        "poiseuille_3d": three_d.poiseuille_3d,
        "taylor_green_3d": three_d.taylor_green_3d,
        "lid_cavity_3d": three_d.lid_cavity_3d,
    }


def _tensors(name: str, val):
    """(name, tensor) pairs of a result field: a tensor, or a NamedTuple of
    them (a two-phase state), flattened with '-' joined names."""
    if isinstance(val, torch.Tensor):
        yield name, val
    elif isinstance(val, tuple) and hasattr(val, "_fields"):
        for sub in val._fields:
            yield from _tensors(f"{name}-{sub}", getattr(val, sub))


def _save_result(out: str, result) -> None:
    for fld in dataclasses.fields(result):
        val = getattr(result, fld.name)
        if fld.name == "snapshots" and isinstance(val, dict):
            for name, arr in val.items():
                path = f"{out}-snap-{name}.npy"
                np.save(path, arr)
                logger.info(f"wrote {path}")
            continue
        for name, val in _tensors(fld.name, val):
            path = f"{out}-{name}.npy"
            np.save(path, val.detach().cpu().numpy())
            logger.info(f"wrote {path}")


def _summarise(result) -> str:
    """The result's headline numbers: its int and float fields, and its 1-D
    tensor fields of at most 4 entries (lbm_tpu/run.py:101-118)."""
    parts = []
    for fld in dataclasses.fields(result):
        val = getattr(result, fld.name)
        if isinstance(val, float):
            parts.append(f"{fld.name}={val:g}")
        elif isinstance(val, int):
            parts.append(f"{fld.name}={val}")
        elif isinstance(val, torch.Tensor) and val.ndim == 1 and val.shape[0] <= 4:
            vec = ", ".join(f"{float(x):.6g}" for x in val.tolist())
            parts.append(f"{fld.name}=({vec})")
    return "  ".join(parts)


def main(argv=None) -> int:
    scenes = _scenes()
    ap = argparse.ArgumentParser(
        prog="python -m lbm_tpu_torch.run", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("scene", choices=sorted(scenes))
    ap.add_argument("--config", help="TOML config (scenes that accept one)")
    ap.add_argument("--markers", help="IBM marker TOML (cylinder_flow), the "
                    "reference's second argv file (cylinder_test.cpp:27-28)")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="override a scene keyword, e.g. --set T=1000")
    ap.add_argument("--out", default=None, help="output prefix for .npy dumps")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="enable periodic checkpoint/resume (scenes that support it): "
                    "checkpoints land here, and a run started with a non-empty dir "
                    "resumes from its newest checkpoint")
    ap.add_argument("--checkpoint-every", type=int, default=None, metavar="N",
                    help="checkpoint cadence in steps")
    ap.add_argument("--resume", action="store_true",
                    help="require an existing checkpoint in --checkpoint-dir (fail fast "
                    "instead of silently starting fresh)")
    ap.add_argument("--x64", action="store_true",
                    help="float64 (the reference's precision); else float32")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain versions)")
    ap.add_argument("--yes", action="store_true", default=True,
                    help="skip the interactive confirmation gate (default)")
    ap.add_argument("--confirm", dest="yes", action="store_false",
                    help="ask before running (reference's behaviour)")
    args = ap.parse_args(argv)

    kwargs = {}
    params = inspect.signature(scenes[args.scene]).parameters
    if args.config:
        if "config_path" not in params:
            ap.error(f"scene {args.scene} does not take --config")
        kwargs["config_path"] = args.config
    if args.markers:
        if "markers_path" not in params:
            ap.error(f"scene {args.scene} does not take --markers")
        kwargs["markers_path"] = args.markers
    if args.checkpoint_dir:
        if "checkpoint_dir" not in params:
            ap.error(f"scene {args.scene} does not support --checkpoint-dir")
        kwargs["checkpoint_dir"] = args.checkpoint_dir
        if args.checkpoint_every is not None:
            kwargs["checkpoint_every"] = args.checkpoint_every
        if args.resume and latest(args.checkpoint_dir) is None:
            ap.error(f"--resume: no checkpoint found in {args.checkpoint_dir}")
    elif args.resume:
        ap.error("--resume requires --checkpoint-dir")
    for item in args.set:
        key, _, val = item.partition("=")
        try:
            kwargs[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            kwargs[key] = val
    kwargs["device"] = default_device(args.device)
    kwargs["dtype"] = torch.float64 if args.x64 else torch.float32

    if not confirm(args.yes):
        return 0
    logger.info(f"scene {args.scene} kwargs={kwargs}")
    result = scenes[args.scene](**kwargs)
    logger.info(f"scene finished  {_summarise(result)}")
    if args.out:
        _save_result(args.out, result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
