"""Lattice-units config tables of the multiphase drivers (counterpart of the
[domain]/[red]/[blue]/[general] part of lbm_tpu/core/params.py).

Field names and derivations match the reference, so its TOML files drive
the same scenes unchanged (test/mrtcg_static_droplet.cpp:103-117,
src/colour.cpp:11-64, test/mrtcg_rayleigh_taylor.cpp:360-362).  The
physical-units [flow]/[lattice]/[simulation] tables wait for the scenes
that read them.
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np

from .lattice import C


def load_toml(path: str) -> dict[str, Any]:
    with open(path, "rb") as fh:
        return tomllib.load(fh)


def _req(tbl: Mapping[str, Any], name: str):
    if name not in tbl:
        raise KeyError(f"{name} not defined in parameters file")
    return tbl[name]


@dataclass(frozen=True)
class DomainParams:
    """Lattice-units [domain] table.  cites reference test/mrtcg_static_droplet.cpp:103-117"""

    R: int
    C: int
    T: int
    nr_snapshots: int

    @property
    def period_snapshots(self) -> int:
        return int(self.T / self.nr_snapshots)

    @classmethod
    def from_toml(cls, tbl: Mapping[str, Any]) -> "DomainParams":
        d = _req(tbl, "domain")
        return cls(R=_req(d, "rows"), C=_req(d, "columns"),
                   T=_req(d, "time_steps"), nr_snapshots=_req(d, "nr_snapshots"))


@dataclass(frozen=True)
class ColourParams:
    """Per-fluid colour-gradient parameters and derived constants.

    Derivations cite reference src/colour.cpp:
      cs2 = 3(1-alpha)/5               (:37)
      rlx = 1/(1/2 + nu/cs2)           (:38-39)
      phi = [alpha, a x4, b x4], a=0.2(1-alpha), b=0.05(1-alpha)   (:56-64)
      eta = 1 + 0.5(3 cs2 - 1)(3|c|^2 - 4)                          (:49-54)
    """

    rho_0: float
    alpha: float
    A: float
    nu: float
    beta: float

    @property
    def mu(self) -> float:
        return self.nu * self.rho_0

    @property
    def cs2(self) -> float:
        return 3.0 * (1.0 - self.alpha) / 5.0

    @property
    def ics2(self) -> float:
        return 1.0 / self.cs2

    @property
    def rlx(self) -> float:
        return 1.0 / (0.5 + self.nu / self.cs2)

    def phi(self) -> np.ndarray:
        a = 0.2 * (1.0 - self.alpha)
        b = 0.05 * (1.0 - self.alpha)
        return np.array([self.alpha, a, a, a, a, b, b, b, b])

    def eta(self) -> np.ndarray:
        c_sq = (C.astype(np.float64) ** 2).sum(axis=0)
        return 1.0 + 0.5 * (3.0 * self.cs2 - 1.0) * (3.0 * c_sq - 4.0)

    @classmethod
    def from_toml(cls, tbl: Mapping[str, Any], key: str) -> "ColourParams":
        k = _req(tbl, key)
        return cls(rho_0=_req(k, "initial_density"), alpha=_req(k, "alpha"),
                   A=_req(k, "interfacial_tension_control"),
                   nu=_req(k, "kinematic_viscosity"),
                   beta=_req(k, "interface_thickness_control"))


@dataclass(frozen=True)
class GeneralParams:
    """[general] table required by the Rayleigh-Taylor drivers.
    cites reference test/mrtcg_rayleigh_taylor.cpp:360-362"""

    sigma: float
    gravity_magnitude: float
    name: str

    @classmethod
    def from_toml(cls, tbl: Mapping[str, Any]) -> "GeneralParams":
        g = _req(tbl, "general")
        return cls(sigma=_req(g, "sigma"),
                   gravity_magnitude=_req(g, "gravity_magnitude"),
                   name=_req(g, "name"))
