"""Composable simulation API: a Potential, an Ensemble and a Barostat under
one MD loop — the counterpart of ``repro.md.api``.

  Potential  ``energy_forces(params, pos, typ, nlist, nmask, box)
             -> (e, f, stats)``: :class:`DPPotential` (the Deep Potential
             model at any ladder rung; it carries ``impl``/``nsel_norm`` so
             the capacity-escalation physics pin survives the seam),
             :class:`TabulatedDPPotential` (owns the tabulation of its
             parameters, quintic or Chebyshev) and :class:`LJPotential`
             (analytic Lennard-Jones: a cheap force evaluation, so the
             engines' own overhead shows).
  Ensemble   ``init_state`` / ``half_kick`` / ``drift`` / ``finalize``:
             :class:`NVE` (velocity Verlet), :class:`NVTLangevin` (plus an
             exact Ornstein-Uhlenbeck velocity mix; ``friction == 0`` is a
             static branch, op-identical to NVE) and
             :class:`BerendsenThermostat` (velocity rescaling).
  Barostat   ``apply(box, pos, vel, stress, state, dt)`` once per step
             after the thermostat: :class:`BerendsenBarostat` and
             :class:`StochasticCellRescaleBarostat`. Zero compressibility
             is a static no-op (the fixed-box program).
  Simulation ``SimulationSpec`` (what to run) + :class:`Simulation` (run it).

Random numbers come from a ``torch.Generator`` that rides in the ensemble or
barostat state, on the run's device. They differ from the reference's
threefry draws for the same seed; the deterministic halves
(:meth:`NVTLangevin.o_step`, :meth:`StochasticCellRescaleBarostat.rescale`)
take the standard-normal draws as an argument, so tests can feed both
packages the same noise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.core import dp_model
from repro_torch.core.types import DPConfig
from repro_torch.device import DeviceLike
from repro_torch.md import integrator

CPU = torch.device("cpu")


# ============================================================== Potential

@runtime_checkable
class Potential(Protocol):
    """Force evaluator the MD engines are generic over.

    ``sel``/``rcut``/``type_map`` describe the neighbor-list layout and
    geometry the engines must provide; ``with_layout`` re-targets the
    adapter at an escalated slot layout WITHOUT changing physics.
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

    ``impl`` selects the implementation-ladder rung (mlp/quintic/cheb/
    cheb_pallas); ``nsel_norm`` pins the descriptor normalization to the
    model's NATIVE neighbor capacity when ``cfg.sel`` has been escalated
    past it.
    """

    cfg: DPConfig
    impl: Optional[str] = None
    nsel_norm: Optional[int] = None

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

    ``kind`` in {"quintic", "cheb"}; ``init_params``/``prepare_params`` own
    the tabulation so callers hold ONE object that knows both how to build
    and how to evaluate its parameters.
    """

    kind: str = "quintic"

    def __post_init__(self):
        if self.kind not in ("quintic", "cheb"):
            raise ValueError(f"unknown table kind {self.kind!r}")
        if self.impl is None:
            object.__setattr__(self, "impl", self.kind)

    def init_params(self, gen: torch.Generator, device: DeviceLike = "cuda"):
        return self.prepare_params(
            dp_model.init_dp_params(gen, self.cfg, device=device))

    def prepare_params(self, params):
        """Tabulate an mlp-params dict (idempotent on SAME-kind tables).

        Tables of the other kind are rebuilt from the retained embedding
        weights: a quintic table carries ``step``, a Chebyshev one
        ``upper``.
        """
        tables = params.get("table", {}).get("nets", {})
        marker = "step" if self.kind == "quintic" else "upper"
        if tables and all(marker in t for t in tables.values()):
            return params
        return dp_model.tabulate_model(params, self.cfg, self.kind)


@dataclasses.dataclass(frozen=True)
class LJPotential:
    """Single-species Lennard-Jones (shifted at rcut), parameter-free.

    Defaults approximate copper (r_min = 2^(1/6) sigma ~ the FCC Cu nearest
    neighbor distance of 2.556 A). Type-blind: every pair uses the same
    (epsilon, sigma); ``sel`` only fixes the neighbor-list slot layout.
    """

    epsilon: float = 0.4            # eV
    sigma: float = 2.277            # A
    rcut_lj: float = 6.0            # A
    sel: Tuple[int, ...] = (128,)
    type_map: Tuple[str, ...] = ("Cu",)

    @property
    def rcut(self) -> float:
        return float(self.rcut_lj)

    def layout_cfg(self) -> DPConfig:
        """A layout-only DPConfig (sel sections / rcut) for the neighbor
        machinery; its net-shape fields are never touched."""
        return DPConfig(ntypes=len(self.sel), rcut=self.rcut_lj,
                        rcut_smth=0.0, sel=tuple(self.sel),
                        type_map=tuple(self.type_map))

    def with_layout(self, sel, nsel_norm=None):
        del nsel_norm                       # LJ has no normalization to pin
        return dataclasses.replace(self, sel=tuple(sel))

    def init_params(self, gen=None, device: DeviceLike = "cuda"):
        del gen, device
        return {}                           # nothing trainable

    def _pair_energy(self, r2, valid):
        """Per-slot pair energy, exactly zero past rcut (masked, grad-safe)."""
        gate = valid & (r2 < self.rcut_lj ** 2)
        r2s = torch.where(gate, r2, 1.0)    # safe denominator off-gate
        sr6 = (self.sigma ** 2 / r2s) ** 3
        e = 4.0 * self.epsilon * (sr6 * sr6 - sr6)
        src6 = (self.sigma / self.rcut_lj) ** 6
        e_shift = 4.0 * self.epsilon * (src6 * src6 - src6)
        return torch.where(gate, e - e_shift, 0.0)

    def atomic_energy(self, params, rij, nmask, typ):
        """Half-pair atomic energies: i gets half of every i-j bond."""
        del params, typ
        r2 = torch.sum(rij * rij, dim=-1)
        return 0.5 * torch.sum(self._pair_energy(r2, nmask), dim=-1)

    def energy_forces(self, params, pos, typ, nlist, nmask=None, box=None):
        def energy(rij, nmask_g):
            if nmask is not None:
                nmask_g = nmask_g & nmask
            return torch.sum(self.atomic_energy(params, rij, nmask_g, typ))

        e, f, virial = dp_model.energy_forces_from_rij(energy, pos, nlist,
                                                       box)
        return e, f, {"virial": virial}


# =============================================================== Ensemble

@runtime_checkable
class Ensemble(Protocol):
    """Integrator/thermostat the MD engines are generic over.

    Per step the engines run ``half_kick(f) -> drift -> half_kick(f_new) ->
    finalize``; ``finalize`` applies the thermostat and threads the
    ensemble's extra state (a ``torch.Generator`` for Langevin), which rides
    in the step carry. ``init_state(device)`` puts that state on the run's
    device; stateless ensembles return ``()``.
    """

    def init_state(self, device: torch.device = CPU) -> Any: ...

    def half_kick(self, vel, force, masses, dt) -> torch.Tensor: ...

    def drift(self, pos, vel, dt, box=None) -> torch.Tensor: ...

    def finalize(self, vel, masses, dt, state,
                 amask=None) -> Tuple[torch.Tensor, Any]: ...


@dataclasses.dataclass(frozen=True)
class NVE:
    """Velocity Verlet, no thermostat — the paper's Sec. 4 protocol."""

    def init_state(self, device=CPU):
        del device
        return ()

    def half_kick(self, vel, force, masses, dt):
        return integrator.verlet_half_kick(vel, force, masses, dt)

    def drift(self, pos, vel, dt, box=None):
        return integrator.verlet_drift(pos, vel, dt, box)

    def finalize(self, vel, masses, dt, state, amask=None):
        return vel, state


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


@dataclasses.dataclass(frozen=True)
class NVTLangevin(NVE):
    """Velocity Verlet + per-step Ornstein-Uhlenbeck velocity mixing.

    After the second half-kick: ``v <- c v + sqrt(1-c^2) sqrt(kT/m) xi``
    with ``c = exp(-friction dt)`` — the exact OU solution, so any friction
    is stable. ``friction == 0`` is a STATIC Python branch that skips the
    O-step entirely: the step is op-identical to NVE. The generator rides in
    the ensemble state.
    """

    temp_k: float = 330.0
    friction: float = 0.1        # 1/fs
    seed: int = 0

    def init_state(self, device=CPU):
        return {"gen": _generator(self.seed, torch.device(device))}

    def o_step(self, vel, masses, dt, noise, amask=None):
        """The O-step given standard-normal draws ``noise`` (N, 3)."""
        c = math.exp(-self.friction * dt)
        sigma_v = torch.sqrt(
            integrator.KB_EV * self.temp_k / masses * integrator.FORCE_TO_ACC)
        vel = c * vel + math.sqrt(1.0 - c * c) * (noise * sigma_v[:, None])
        if amask is not None:               # padded slots must stay at rest
            vel = vel * amask[:, None]
        return vel

    def finalize(self, vel, masses, dt, state, amask=None):
        if self.friction == 0.0:            # static: bit-exact NVE path
            return vel, state
        noise = torch.randn(vel.shape, generator=state["gen"],
                            dtype=vel.dtype, device=vel.device)
        return self.o_step(vel, masses, dt, noise, amask), state


@dataclasses.dataclass(frozen=True)
class BerendsenThermostat(NVE):
    """Per-step velocity rescaling toward ``temp_k`` with time constant
    ``tau_fs`` (weak coupling). Memoryless: the state is empty."""

    temp_k: float = 330.0
    tau_fs: float = 100.0

    def finalize(self, vel, masses, dt, state, amask=None):
        t = integrator.temperature(vel, masses, amask)
        lam2 = 1.0 + dt / self.tau_fs * \
            (self.temp_k / torch.clamp(t, min=1e-6) - 1.0)
        vel = vel * torch.sqrt(torch.clamp(lam2, min=0.0))
        return vel, state


# =============================================================== Barostat

@runtime_checkable
class Barostat(Protocol):
    """Pressure coupling the MD engines are generic over.

    Once per step, AFTER the thermostat finalize, the engines call
    ``apply(box, pos, vel, stress, state, dt)`` with the instantaneous
    stress tensor sigma = (K + W) / V (eV/A^3) and get back the rescaled
    ``(box, pos, vel, state)``. The box and the barostat state ride in the
    carry. A zero-coupling barostat is a STATIC no-op.
    """

    def init_state(self, device: torch.device = CPU) -> Any: ...

    def apply(self, box, pos, vel, stress, state,
              dt) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Any]: ...


@dataclasses.dataclass(frozen=True)
class BerendsenBarostat:
    """Weak-coupling box rescale toward ``pressure_gpa`` (Berendsen 1984).

    Per step: ``mu^3 = 1 + compressibility * dt / tau * (P - P0)`` with P
    the instantaneous pressure (GPa); box and positions scale affinely by
    ``mu``, velocities are untouched. ``compressibility_per_gpa == 0`` is a
    STATIC Python branch (the fixed-box program).
    """

    pressure_gpa: float = 0.0
    tau_fs: float = 500.0
    compressibility_per_gpa: float = 0.01   # ~ metals (bulk modulus 100 GPa)
    max_scale: float = 1.02                 # per-step |mu| clamp (stability)

    def init_state(self, device=CPU):
        del device
        return ()

    def apply(self, box, pos, vel, stress, state, dt):
        if self.compressibility_per_gpa == 0.0:   # static: bit-exact no-op
            return box, pos, vel, state
        p_gpa = integrator.pressure_of(stress) * integrator.EV_A3_TO_GPA
        mu3 = 1.0 + self.compressibility_per_gpa * dt / self.tau_fs * \
            (p_gpa - self.pressure_gpa)
        mu = torch.clamp(torch.pow(torch.clamp(mu3, min=1e-6), 1.0 / 3.0),
                         1.0 / self.max_scale, self.max_scale)
        return box * mu, pos * mu, vel, state


@dataclasses.dataclass(frozen=True)
class StochasticCellRescaleBarostat:
    """Isotropic stochastic cell rescale (Bernetti & Bussi 2020).

    The log-volume performs ``d ln V = (beta_T / tau)(P - P0) dt +
    sqrt(2 kB T beta_T / (V tau)) dW``; box and positions scale by
    ``mu = exp(d ln V / 3)``, velocities by ``1/mu``. The generator rides
    in the barostat state. ``compressibility_per_gpa == 0`` is a STATIC
    no-op (only a dead generator rides in the carry).
    """

    pressure_gpa: float = 0.0
    tau_fs: float = 500.0
    compressibility_per_gpa: float = 0.01
    temp_k: float = 330.0
    seed: int = 0
    max_scale: float = 1.02

    def init_state(self, device=CPU):
        return {"gen": _generator(self.seed, torch.device(device))}

    def rescale(self, box, pos, vel, stress, xi, dt):
        """The rescale given one standard-normal draw ``xi`` (0-d)."""
        # compressibility per unit pressure: beta dP is dimensionless, so
        # per-(eV/A^3) = per-GPa * (GPa per eV/A^3)
        beta = self.compressibility_per_gpa * integrator.EV_A3_TO_GPA
        p0 = self.pressure_gpa / integrator.EV_A3_TO_GPA
        p = integrator.pressure_of(stress)
        vol = integrator.volume_of(box)
        kt = integrator.KB_EV * self.temp_k
        d_eps = beta / self.tau_fs * (p - p0) * dt \
            + torch.sqrt(2.0 * kt * beta / (vol * self.tau_fs) * dt) * xi
        mu = torch.clamp(torch.exp(d_eps / 3.0),
                         1.0 / self.max_scale, self.max_scale)
        return box * mu, pos * mu, vel / mu

    def apply(self, box, pos, vel, stress, state, dt):
        if self.compressibility_per_gpa == 0.0:   # static: bit-exact no-op
            return box, pos, vel, state
        xi = torch.randn((), generator=state["gen"], dtype=box.dtype,
                         device=box.device)
        return (*self.rescale(box, pos, vel, stress, xi, dt), state)


# ========================================================== Simulation API

@dataclasses.dataclass(frozen=True)
class SimulationSpec:
    """Everything that defines a single-process MD run.

    ``engine`` in {"outer", "scan", "python"} selects the stepping machinery
    (see ``md/driver.py``). ``ensemble`` also accepts a registry name (e.g.
    ``"npt_berendsen"``, resolved with ``temp_k``/``pressure_gpa``): the NPT
    names expand to a thermostat + the matching barostat. An explicit
    ``barostat`` always wins; ``pressure_gpa`` alone attaches a
    :class:`BerendsenBarostat` at that target to whatever ensemble is set.
    """

    potential: Potential
    ensemble: Any = NVE()        # Ensemble, or a registry name (str)
    steps: int = 99
    dt_fs: float = 1.0
    temp_k: float = 330.0        # Maxwell-Boltzmann init temperature
    rebuild_every: int = 50
    thermo_every: int = 50
    skin: float = 2.0
    seed: int = 0
    engine: str = "scan"
    chunk_segments: int = 8
    escalation: Optional[Any] = None    # stepper.EscalationPolicy
    barostat: Optional[Barostat] = None
    pressure_gpa: Optional[float] = None   # target pressure convenience

    def __post_init__(self):
        ens, baro = self.ensemble, self.barostat
        if isinstance(ens, str):
            ens, named_baro = resolve_ensemble(ens, temp_k=self.temp_k,
                                               pressure_gpa=self.pressure_gpa)
            baro = baro or named_baro
        if baro is None and self.pressure_gpa is not None:
            baro = BerendsenBarostat(pressure_gpa=self.pressure_gpa)
        object.__setattr__(self, "ensemble", ens)
        object.__setattr__(self, "barostat", baro)


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


# ========================================================= CLI registries

POTENTIAL_CHOICES = ("dp", "quintic", "cheb", "lj")
ENSEMBLE_CHOICES = ("nve", "nvt_langevin", "berendsen", "npt_berendsen",
                    "npt_scr")
BAROSTAT_CHOICES = ("none", "berendsen", "scr")


def make_potential(name: str, cfg: Optional[DPConfig] = None,
                   impl: Optional[str] = None, **lj_kw) -> Potential:
    """Build a Potential from a CLI name.

    "dp" wraps ``cfg`` (optionally with an explicit ``impl`` rung; a
    tabulated rung gets the adapter that owns its tables);
    "quintic"/"cheb" are tabulated DP; "lj" takes :class:`LJPotential`
    keyword overrides and needs no DP config at all.
    """
    if name == "lj":
        return LJPotential(**lj_kw)
    if cfg is None:
        raise ValueError(f"potential {name!r} needs a DPConfig")
    if name == "dp":
        if impl in ("quintic", "cheb", "cheb_pallas"):
            kind = "quintic" if impl == "quintic" else "cheb"
            return TabulatedDPPotential(cfg, impl=impl, nsel_norm=cfg.nsel,
                                        kind=kind)
        return DPPotential(cfg, impl=impl, nsel_norm=cfg.nsel)
    if name in ("quintic", "cheb"):
        return TabulatedDPPotential(cfg, kind=name, nsel_norm=cfg.nsel)
    raise ValueError(f"unknown potential {name!r} "
                     f"(choices: {POTENTIAL_CHOICES})")


def make_ensemble(name: str, temp_k: float = 330.0, friction: float = 0.1,
                  tau_fs: float = 100.0, seed: int = 0) -> Ensemble:
    """Build an Ensemble from a CLI name (NVE/NVT names only — the NPT
    names pair a thermostat WITH a barostat; see :func:`resolve_ensemble`)."""
    if name == "nve":
        return NVE()
    if name == "nvt_langevin":
        return NVTLangevin(temp_k=temp_k, friction=friction, seed=seed)
    if name == "berendsen":
        return BerendsenThermostat(temp_k=temp_k, tau_fs=tau_fs)
    raise ValueError(f"unknown ensemble {name!r} "
                     f"(choices: {ENSEMBLE_CHOICES}; NPT names need "
                     f"resolve_ensemble — they carry a barostat too)")


def make_barostat(name: str, pressure_gpa: float = 0.0,
                  tau_fs: float = 500.0,
                  compressibility_per_gpa: float = 0.01,
                  temp_k: float = 330.0,
                  seed: int = 0) -> Optional[Barostat]:
    """Build a Barostat from a CLI name ("none" -> None: fixed box)."""
    if name == "none":
        return None
    if name == "berendsen":
        return BerendsenBarostat(
            pressure_gpa=pressure_gpa, tau_fs=tau_fs,
            compressibility_per_gpa=compressibility_per_gpa)
    if name == "scr":
        return StochasticCellRescaleBarostat(
            pressure_gpa=pressure_gpa, tau_fs=tau_fs,
            compressibility_per_gpa=compressibility_per_gpa,
            temp_k=temp_k, seed=seed)
    raise ValueError(f"unknown barostat {name!r} "
                     f"(choices: {BAROSTAT_CHOICES})")


def resolve_ensemble(name: str, temp_k: float = 330.0, friction: float = 0.1,
                     tau_fs: float = 100.0, seed: int = 0,
                     pressure_gpa: Optional[float] = None,
                     ptau_fs: float = 500.0,
                     compressibility_per_gpa: float = 0.01,
                     ) -> Tuple[Ensemble, Optional[Barostat]]:
    """Resolve a CLI ensemble name into ``(ensemble, barostat)``.

    ``npt_berendsen`` = Berendsen thermostat + Berendsen barostat,
    ``npt_scr`` = Langevin thermostat + stochastic cell rescale. NVE/NVT
    names return ``(ensemble, None)`` — unless an explicit ``pressure_gpa``
    is given, which attaches a Berendsen barostat at that target.
    """
    if name == "npt_berendsen":
        return (BerendsenThermostat(temp_k=temp_k, tau_fs=tau_fs),
                make_barostat("berendsen",
                              pressure_gpa=pressure_gpa or 0.0,
                              tau_fs=ptau_fs,
                              compressibility_per_gpa=compressibility_per_gpa))
    if name == "npt_scr":
        return (NVTLangevin(temp_k=temp_k, friction=friction, seed=seed),
                make_barostat("scr", pressure_gpa=pressure_gpa or 0.0,
                              tau_fs=ptau_fs,
                              compressibility_per_gpa=compressibility_per_gpa,
                              temp_k=temp_k, seed=seed))
    barostat = None
    if pressure_gpa is not None:
        barostat = make_barostat(
            "berendsen", pressure_gpa=pressure_gpa, tau_fs=ptau_fs,
            compressibility_per_gpa=compressibility_per_gpa)
    return (make_ensemble(name, temp_k=temp_k, friction=friction,
                          tau_fs=tau_fs, seed=seed), barostat)
