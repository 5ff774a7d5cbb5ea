"""Config dataclasses mirroring the reference's TOML schemas (counterpart of
lbm_tpu/core/params.py).

Two schema families:
  (a) physical-units [flow]/[lattice]/[simulation] tables
      (src/params.cpp:7-120), read by the single-phase programs;
  (b) lattice-units [domain]/[red]/[blue] (+[general]) tables
      (test/mrtcg_static_droplet.cpp:103-117, src/colour.cpp:11-64,
      test/mrtcg_rayleigh_taylor.cpp:360-362), read by the multiphase ones.

Field names and derivations match the reference, so its TOML files drive
the same scenes unchanged.
"""

from __future__ import annotations

import math
import tomllib
from dataclasses import dataclass, field
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
class FlowParams:
    """Physical flow parameters.  cites reference src/params.cpp:7-29"""

    rho_0: float
    nu: float
    u: float
    l: float
    Re: float = field(init=False, default=0.0)

    def __post_init__(self):
        object.__setattr__(self, "Re", self.u * self.l / self.nu)

    @classmethod
    def from_toml(cls, tbl: Mapping[str, Any]) -> "FlowParams":
        f = _req(tbl, "flow")
        return cls(rho_0=_req(f, "initial_density"), nu=_req(f, "kinematic_viscosity"),
                   u=_req(f, "characteristic_velocity"), l=_req(f, "characteristic_length"))


@dataclass(frozen=True)
class LatticeParams:
    """Derived lattice-unit parameters.

    Derivations cite reference src/params.cpp:31-66:
      l  = characteristic length rounded to the nearest odd integer (:55-56)
      nu = cs2*(tau - 1/2)                                           (:60)
      u  = Re*nu/l                                                   (:61)
      dt = cs2*(tau - 1/2)*dx^2/nu_phys                              (:62)
      T  = ceil(1/dt)  (steps per physical second)                   (:63)
      X  = ceil(l*x_multiplier), Y = ceil(l*y_multiplier)            (:64-65)
    """

    tau: float
    dx: float
    x_multiplier: float
    y_multiplier: float
    flow: FlowParams

    cs2: float = 1.0 / 3.0

    @property
    def omega(self) -> float:
        return 1.0 / self.tau

    @property
    def l(self) -> int:
        n = self.flow.l / self.dx
        if int(math.ceil(n)) % 2 != 0:
            return int(math.ceil(n))
        return int(math.floor(n))

    @property
    def Re(self) -> float:
        return self.flow.Re

    @property
    def nu(self) -> float:
        return self.cs2 * (self.tau - 0.5)

    @property
    def u(self) -> float:
        return self.flow.Re * self.nu / self.l

    @property
    def dt(self) -> float:
        return self.cs2 * (self.tau - 0.5) * (self.dx * self.dx) / self.flow.nu

    @property
    def T(self) -> int:
        return int(math.ceil(1.0 / self.dt))

    @property
    def X(self) -> int:
        return int(math.ceil(self.l * self.x_multiplier))

    @property
    def Y(self) -> int:
        return int(math.ceil(self.l * self.y_multiplier))

    @classmethod
    def from_toml(cls, tbl: Mapping[str, Any], flow: FlowParams) -> "LatticeParams":
        lt = _req(tbl, "lattice")
        return cls(tau=_req(lt, "relaxation_time"), dx=_req(lt, "lattice_spacing"),
                   x_multiplier=_req(lt, "x_multiplier"),
                   y_multiplier=_req(lt, "y_multiplier"), flow=flow)


@dataclass(frozen=True)
class SimulationParams:
    """Run length and snapshot cadence.  cites reference src/params.cpp:95-120"""

    stop_time: float
    snapshot_period: float
    file_prefix: str
    total_steps: int
    snapshot_steps: int
    total_snapshots: int

    @classmethod
    def from_toml(cls, tbl: Mapping[str, Any], lp: LatticeParams) -> "SimulationParams":
        s = _req(tbl, "simulation")
        stop_time = _req(s, "stop_time")
        snapshot_period = _req(s, "snapshot_period")
        total_steps = int(math.ceil(stop_time * lp.T))
        snapshot_steps = int(math.ceil(snapshot_period * lp.T))
        return cls(stop_time=stop_time, snapshot_period=snapshot_period,
                   file_prefix=_req(s, "file_prefix"), total_steps=total_steps,
                   snapshot_steps=snapshot_steps,
                   total_snapshots=int(math.ceil(total_steps / snapshot_steps)))

    def snapshot(self, step: int) -> bool:
        return step % self.snapshot_steps == 0


@dataclass(frozen=True)
class PhysicalConfig:
    """The [flow]/[lattice]/[simulation] bundle the reference's single-phase
    programs parse at startup (test/free_stream_test.cpp:23-36,
    src/params.cpp:7-120).  ``simulation`` is None when the TOML has no
    [simulation] table (the reference's shipped parameters.toml has none);
    scenes then keep their keyword defaults for T and the snapshot cadence."""

    flow: FlowParams
    lattice: LatticeParams
    simulation: SimulationParams | None

    @classmethod
    def load(cls, path: str) -> "PhysicalConfig":
        tbl = load_toml(path)
        flow = FlowParams.from_toml(tbl)
        lattice = LatticeParams.from_toml(tbl, flow)
        simulation = (SimulationParams.from_toml(tbl, lattice)
                      if "simulation" in tbl else None)
        return cls(flow=flow, lattice=lattice, simulation=simulation)


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
