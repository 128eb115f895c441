"""Composable simulation API: a Potential and an Ensemble under one MD loop.

The counterpart of ``repro.md.api`` for the parts this package runs:

  Potential  ``energy_forces(params, pos, typ, nlist, nmask, box)
             -> (e, f, stats)``: :class:`DPPotential` (the Deep Potential
             model at the ``mlp``/``cheb``/``cheb_pallas`` rungs; it carries
             ``impl``/``nsel_norm`` so the capacity-escalation physics pin
             survives the seam) and :class:`TabulatedDPPotential` (owns the
             Chebyshev tabulation of its parameters).
  Ensemble   ``init_state`` / ``half_kick`` / ``drift`` / ``finalize``:
             :class:`NVE` (velocity Verlet), the paper's protocol.
  Simulation ``SimulationSpec`` (what to run) + :class:`Simulation` (run it).

Not ported yet, and refused with ``NotImplementedError``: the quintic rung
(ROADMAP.md §A.7), the python and outer engines (§A.8), LJ, Langevin and
Berendsen (§A.9), and the barostats (§A.10).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.core import dp_model
from repro_torch.core.types import DPConfig
from repro_torch.device import DeviceLike
from repro_torch.md import integrator

_QUINTIC = "the quintic rung is not ported yet (ROADMAP.md §A.7)"
_THERMOSTATS = ("LJ, Langevin and Berendsen are not ported yet "
                "(ROADMAP.md §A.9)")
_BAROSTATS = "barostats are not ported yet (ROADMAP.md §A.10)"


# ============================================================== Potential

@runtime_checkable
class Potential(Protocol):
    """Force evaluator the MD engine is generic over.

    ``sel``/``rcut``/``type_map`` describe the neighbor-list layout and
    geometry the engine must provide; ``with_layout`` re-targets the adapter
    at an escalated slot layout WITHOUT changing physics.
    """

    sel: Tuple[int, ...]

    @property
    def rcut(self) -> float: ...

    @property
    def type_map(self) -> Tuple[str, ...]: ...

    def layout_cfg(self) -> DPConfig: ...

    def with_layout(self, sel: Tuple[int, ...],
                    nsel_norm: Optional[int] = None) -> "Potential": ...

    def energy_forces(self, params: Any, pos: torch.Tensor, typ: torch.Tensor,
                      nlist: torch.Tensor, nmask: Optional[torch.Tensor] = None,
                      box: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Dict[str, torch.Tensor]]: ...


@dataclasses.dataclass(frozen=True)
class DPPotential:
    """Deep Potential adapter around ``dp_model``.

    ``impl`` selects the implementation-ladder rung (mlp/cheb/cheb_pallas);
    ``nsel_norm`` pins the descriptor normalization to the model's NATIVE
    neighbor capacity when ``cfg.sel`` has been escalated past it.
    """

    cfg: DPConfig
    impl: Optional[str] = None
    nsel_norm: Optional[int] = None

    def __post_init__(self):
        if (self.impl or self.cfg.impl) == "quintic":
            raise NotImplementedError(_QUINTIC)

    @property
    def sel(self) -> Tuple[int, ...]:
        return tuple(self.cfg.sel)

    @property
    def rcut(self) -> float:
        return float(self.cfg.rcut)

    @property
    def type_map(self) -> Tuple[str, ...]:
        return tuple(self.cfg.type_map)

    def layout_cfg(self) -> DPConfig:
        return self.cfg

    def with_layout(self, sel, nsel_norm=None):
        # Re-targeting the slot layout must never move the descriptor
        # normalization: pin it to this adapter's native capacity.
        cfg = (self.cfg if tuple(sel) == tuple(self.cfg.sel)
               else dataclasses.replace(self.cfg, sel=tuple(sel)))
        return dataclasses.replace(
            self, cfg=cfg,
            nsel_norm=nsel_norm or self.nsel_norm or self.cfg.nsel)

    def init_params(self, gen: torch.Generator, device: DeviceLike = "cuda"):
        return dp_model.init_dp_params(gen, self.cfg, device=device)

    def energy_forces(self, params, pos, typ, nlist, nmask=None, box=None):
        e, f, virial = dp_model.dp_energy_forces(
            params, self.cfg, pos, nlist, typ, box, impl=self.impl,
            nsel_norm=self.nsel_norm)
        return e, f, {"virial": virial}


@dataclasses.dataclass(frozen=True)
class TabulatedDPPotential(DPPotential):
    """DP with the embedding nets compressed into tables (paper Sec. 3.2).

    Only ``kind="cheb"`` is ported; ``init_params``/``prepare_params`` own
    the tabulation so callers hold ONE object that knows both how to build
    and how to evaluate its parameters.
    """

    kind: str = "quintic"

    def __post_init__(self):
        if self.kind == "quintic":
            raise NotImplementedError(_QUINTIC)
        if self.kind != "cheb":
            raise ValueError(f"unknown table kind {self.kind!r}")
        if self.impl is None:
            object.__setattr__(self, "impl", self.kind)
        super().__post_init__()

    def init_params(self, gen: torch.Generator, device: DeviceLike = "cuda"):
        return self.prepare_params(
            dp_model.init_dp_params(gen, self.cfg, device=device))

    def prepare_params(self, params):
        """Tabulate an mlp-params dict (idempotent on cheb tables)."""
        tables = params.get("table", {}).get("nets", {})
        if tables and all("upper" in t for t in tables.values()):
            return params
        return dp_model.tabulate_model(params, self.cfg, self.kind)


# =============================================================== Ensemble

@runtime_checkable
class Ensemble(Protocol):
    """Integrator/thermostat the MD engine is generic over.

    Per step the engine runs ``half_kick(f) -> drift -> half_kick(f_new) ->
    finalize``; ``finalize`` applies the thermostat and threads the
    ensemble's extra state, which rides in the step carry.
    """

    def init_state(self) -> Any: ...

    def half_kick(self, vel, force, masses, dt) -> torch.Tensor: ...

    def drift(self, pos, vel, dt, box=None) -> torch.Tensor: ...

    def finalize(self, vel, masses, dt, state,
                 amask=None) -> Tuple[torch.Tensor, Any]: ...


@dataclasses.dataclass(frozen=True)
class NVE:
    """Velocity Verlet, no thermostat — the paper's Sec. 4 protocol."""

    def init_state(self):
        return ()

    def half_kick(self, vel, force, masses, dt):
        return integrator.verlet_half_kick(vel, force, masses, dt)

    def drift(self, pos, vel, dt, box=None):
        return integrator.verlet_drift(pos, vel, dt, box)

    def finalize(self, vel, masses, dt, state, amask=None):
        return vel, state


# ========================================================== Simulation API

@dataclasses.dataclass(frozen=True)
class SimulationSpec:
    """Everything that defines a single-process MD run.

    ``engine="scan"`` is the one ported engine (see ``md/driver.py``).
    ``ensemble`` takes an Ensemble or the registry name ``"nve"``.
    """

    potential: Potential
    ensemble: Any = NVE()
    steps: int = 99
    dt_fs: float = 1.0
    temp_k: float = 330.0        # Maxwell-Boltzmann init temperature
    rebuild_every: int = 50
    thermo_every: int = 50
    skin: float = 2.0
    seed: int = 0
    engine: str = "scan"
    escalation: Optional[Any] = None    # stepper.EscalationPolicy
    barostat: Optional[Any] = None
    pressure_gpa: Optional[float] = None

    def __post_init__(self):
        if isinstance(self.ensemble, str):
            if self.ensemble != "nve":
                raise NotImplementedError(
                    f"ensemble {self.ensemble!r}: "
                    + (_BAROSTATS if self.ensemble.startswith("npt")
                       else _THERMOSTATS))
            object.__setattr__(self, "ensemble", NVE())
        if self.barostat is not None or self.pressure_gpa is not None:
            raise NotImplementedError(_BAROSTATS)


class Simulation:
    """Entry point: ``Simulation(spec).run(params, pos, typ, box)``.

    >>> pot = make_potential("dp", COPPER_DP, impl="cheb_pallas")
    >>> params = pot.init_params(torch.Generator().manual_seed(0))
    >>> result = Simulation(SimulationSpec(pot, NVE())).run(params, pos, typ, box)
    """

    def __init__(self, spec: SimulationSpec):
        self.spec = spec

    def run(self, params: Any, pos, typ, box, device: DeviceLike = "cuda"):
        from repro_torch.md import driver
        return driver.run_simulation(self.spec, params, pos, typ, box,
                                     device=device)


def make_potential(name: str, cfg: Optional[DPConfig] = None,
                   impl: Optional[str] = None) -> Potential:
    """Build a Potential from a CLI name.

    "dp" wraps ``cfg`` (optionally with an explicit ``impl`` rung; a
    tabulated rung gets the adapter that owns its tables); "cheb" is the
    tabulated DP. "quintic" and "lj" are not ported yet.
    """
    if name == "lj":
        raise NotImplementedError(_THERMOSTATS)
    if name == "quintic" or impl == "quintic":
        raise NotImplementedError(_QUINTIC)
    if cfg is None:
        raise ValueError(f"potential {name!r} needs a DPConfig")
    if name == "dp":
        if impl in ("cheb", "cheb_pallas"):
            return TabulatedDPPotential(cfg, impl=impl, nsel_norm=cfg.nsel,
                                        kind="cheb")
        return DPPotential(cfg, impl=impl, nsel_norm=cfg.nsel)
    if name == "cheb":
        return TabulatedDPPotential(cfg, kind="cheb", nsel_norm=cfg.nsel)
    raise ValueError(f"unknown potential {name!r} (choices: dp, cheb)")
