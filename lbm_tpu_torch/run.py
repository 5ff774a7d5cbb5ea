"""Scene runner CLI of the PyTorch port (counterpart of lbm_tpu/run.py).

    python -m lbm_tpu_torch.run <scene> [--config cfg.toml] [--set key=value ...]
           [--out prefix] [--x64] [--device cuda|cpu] [--yes]

`--config` passes a TOML to the scenes that take one (``config_path``).
`--set` overrides any scene keyword (ints/floats/bools parsed as python
literals).  `--x64` runs in float64, the reference's precision (else
float32).  `--device` defaults to cuda; `--device cpu` runs the plain
PyTorch versions.  Result tensors are written as .npy files under --out,
recorded snapshots as {out}-snap-{name}.npy.  Registered: the channel,
ULBM and MRT-CG/CSF multiphase scenes ported so far, under lbm_tpu's names.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import inspect
import sys

import numpy as np
import torch

from .utils.observe import confirm, logger
from .utils.xmath import default_device


def _scenes() -> dict:
    from .scenes import channel, multiphase, ulbm

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
        "ulbm_poiseuille": ulbm.ulbm_poiseuille,
        "ulbm_double_shear": ulbm.ulbm_double_shear,
        "les_double_shear": ulbm.les_double_shear,
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
    parts = []
    for fld in dataclasses.fields(result):
        val = getattr(result, fld.name)
        if isinstance(val, float):
            parts.append(f"{fld.name}={val:g}")
        elif isinstance(val, int):
            parts.append(f"{fld.name}={val}")
    return "  ".join(parts)


def main(argv=None) -> int:
    scenes = _scenes()
    ap = argparse.ArgumentParser(
        prog="python -m lbm_tpu_torch.run", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("scene", choices=sorted(scenes))
    ap.add_argument("--config", help="TOML config (scenes that accept one)")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="override a scene keyword, e.g. --set T=1000")
    ap.add_argument("--out", default=None, help="output prefix for .npy dumps")
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
    if args.config:
        if "config_path" not in inspect.signature(scenes[args.scene]).parameters:
            ap.error(f"scene {args.scene} does not take --config")
        kwargs["config_path"] = args.config
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
