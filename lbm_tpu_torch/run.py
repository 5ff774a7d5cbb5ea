"""Scene runner CLI of the PyTorch port (counterpart of lbm_tpu/run.py).

    python -m lbm_tpu_torch.run <scene> [--set key=value ...] [--out prefix]
           [--x64] [--device cuda|cpu] [--yes]

`--set` overrides any scene keyword (ints/floats/bools parsed as python
literals).  `--x64` runs in float64, the reference's precision (else
float32).  `--device` defaults to cuda when a card is present, else cpu.
Result tensors are written as .npy files under --out.  Only the scenes
ported so far are registered.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import sys

import numpy as np
import torch

from .utils.observe import confirm, logger
from .utils.xmath import default_device


def _scenes() -> dict:
    from .scenes import channel, ulbm

    return {
        "horizontal_poiseuille": channel.horizontal_poiseuille,
        "ulbm_poiseuille": ulbm.ulbm_poiseuille,
        "ulbm_double_shear": ulbm.ulbm_double_shear,
        "les_double_shear": ulbm.les_double_shear,
    }


def _save_result(out: str, result) -> None:
    for fld in dataclasses.fields(result):
        val = getattr(result, fld.name)
        if isinstance(val, torch.Tensor):
            path = f"{out}-{fld.name}.npy"
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
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="override a scene keyword, e.g. --set T=1000")
    ap.add_argument("--out", default=None, help="output prefix for .npy dumps")
    ap.add_argument("--x64", action="store_true",
                    help="float64 (the reference's precision); else float32")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda if present, else cpu)")
    ap.add_argument("--yes", action="store_true", default=True,
                    help="skip the interactive confirmation gate (default)")
    ap.add_argument("--confirm", dest="yes", action="store_false",
                    help="ask before running (reference's behaviour)")
    args = ap.parse_args(argv)

    kwargs = {}
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
