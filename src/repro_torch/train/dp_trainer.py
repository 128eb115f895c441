"""DP model training: energy+force matching with DeePMD's loss schedule (the
port of ``repro.train.dp_trainer``).

Reference data comes from a TEACHER DP model (random but smooth), standing
in for the DFT labels the paper's models train on; the student learns it,
which exercises every real code path (descriptor statistics, the loss
prefactor schedule, the exp-decay LR) end to end.

Loss (DeePMD convention):
  L = p_e(t) * (E_pred - E_ref)^2 / N_atoms^2  +  p_f(t) * mean|F_pred - F_ref|^2
with prefactors interpolating (start -> limit) as the LR decays.

The loss holds forces, so its gradient with respect to the weights runs
through dE/dr_ij: ``batch_energy_forces`` takes that derivative with
``create_graph=True`` when asked, and every leaf of the parameter tree is
trained (``dstd`` and ``ebias`` included), as ``jax.value_and_grad`` over
the reference's pytree trains them. Training runs on the ``mlp`` rung.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import descriptor, dp_model
from repro_torch.core.types import DPConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.md import lattice, neighbors
from repro_torch.train import optim, tree
from repro_torch.train.steps import TrainState


@dataclasses.dataclass(frozen=True)
class DPLossConfig:
    pref_e_start: float = 0.02
    pref_e_limit: float = 1.0
    pref_f_start: float = 1000.0
    pref_f_limit: float = 1.0
    lr_start: float = 1e-3
    lr_decay_steps: int = 500
    lr_decay_rate: float = 0.95


class DPBatch(NamedTuple):
    rij: torch.Tensor       # (B, Na, Nm, 3)
    nmask: torch.Tensor     # (B, Na, Nm) bool
    atype: torch.Tensor     # (B, Na) int64
    nlist: torch.Tensor     # (B, Na, Nm) int64, -1 padding: the force scatter
    e_ref: torch.Tensor     # (B,)
    f_ref: torch.Tensor     # (B, Na, 3)


def batch_energy_forces(params: Dict[str, Any], cfg: DPConfig,
                        batch: DPBatch, impl: Optional[str] = None,
                        create_graph: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Energies (B,) and forces (B, Na, 3) of a batch of configurations.

    With ``create_graph`` the results stay differentiable with respect to
    the parameters (forces through dE/dr_ij: the loss's double backward);
    without it they are detached. Each configuration's pair forces scatter
    into its own atoms (``index_add`` over B*Na rows); padded slots add
    their zero into atom 0 of their configuration, as in the reference.
    """
    b, na = batch.rij.shape[:2]
    amask = torch.ones((b, na), dtype=batch.rij.dtype,
                       device=batch.rij.device)
    with torch.enable_grad():
        rij = batch.rij.detach().requires_grad_(True)
        e = dp_model.dp_energy(params, cfg, rij, batch.nmask, batch.atype,
                               amask, impl)
        (de,) = torch.autograd.grad(e.sum(), rij, create_graph=create_graph)
    de = de * batch.nmask[..., None].to(de.dtype)
    offset = torch.arange(b, device=de.device)[:, None, None] * na
    j = (torch.clamp(batch.nlist, min=0) + offset).reshape(-1)
    f = torch.zeros((b * na, 3), dtype=de.dtype, device=de.device)
    f = f.index_add(0, j, -de.reshape(-1, 3)).view(b, na, 3)
    f = f + de.sum(dim=2)
    if not create_graph:
        e, f = e.detach(), f.detach()
    return e, f


class DPTrainStep:
    """One optimizer step on a minibatch: ``state, metrics = step(state,
    batch)``. ``loss_and_grads`` is the differentiation alone, for checks
    of the gradients themselves."""

    def __init__(self, cfg: DPConfig, loss_cfg: DPLossConfig,
                 opt: optim.AdamW):
        self.cfg, self.loss_cfg, self.opt = cfg, loss_cfg, opt

    def prefactors(self, step: torch.Tensor):
        """(p_e, p_f) from lr(step), read before the step's increment."""
        lc = self.loss_cfg
        frac = self.opt.lr(step) / lc.lr_start
        p_e = lc.pref_e_limit + (lc.pref_e_start - lc.pref_e_limit) * frac
        p_f = lc.pref_f_limit + (lc.pref_f_start - lc.pref_f_limit) * frac
        return p_e, p_f

    def loss_and_grads(self, params: Any, batch: DPBatch, step: torch.Tensor
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
        """(loss, {"rmse_e_atom", "rmse_f"}, grads): grads a tree like
        ``params``, one for every leaf."""
        with torch.enable_grad():
            live = tree.tree_map(lambda p: p.detach().requires_grad_(True),
                                 params)
            e, f = batch_energy_forces(live, self.cfg, batch, impl="mlp",
                                       create_graph=True)
            na = batch.rij.shape[1]
            l_e = torch.mean((e - batch.e_ref) ** 2) / na ** 2
            l_f = torch.mean((f - batch.f_ref) ** 2)
            p_e, p_f = self.prefactors(step)
            loss = p_e * l_e + p_f * l_f
            grads = torch.autograd.grad(loss, tree.leaves(live))
        aux = {"rmse_e_atom": torch.sqrt(l_e.detach()),
               "rmse_f": torch.sqrt(l_f.detach())}
        return loss.detach(), aux, tree.unflatten(params, list(grads))

    def __call__(self, state: TrainState, batch: DPBatch
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, aux, grads = self.loss_and_grads(state.params, batch,
                                               state.step)
        params, opt_state, gnorm = self.opt.update(grads, state.opt,
                                                   state.params)
        return TrainState(params=params, opt=opt_state, step=state.step + 1), {
            "loss": loss, **aux, "grad_norm": gnorm}


def make_dp_train_step(cfg: DPConfig, loss_cfg: DPLossConfig,
                       opt: optim.AdamW) -> DPTrainStep:
    """The reference's entry point: the step for this model, loss and
    optimizer."""
    return DPTrainStep(cfg, loss_cfg, opt)


def make_optimizer(loss_cfg: DPLossConfig) -> optim.AdamW:
    """The trainer's AdamW: DeePMD's exp-decay LR, clipping at 1, no decay."""
    return optim.AdamW(
        lr=optim.exp_decay_schedule(loss_cfg.lr_start, loss_cfg.lr_decay_steps,
                                    loss_cfg.lr_decay_rate),
        weight_decay=0.0, grad_clip=1.0)


# ------------------------------------------------------------ data generator

def teacher_data(cfg: DPConfig, teacher_params: Dict[str, Any], *,
                 n_configs: int, supercell: Tuple[int, int, int] = (2, 2, 2),
                 jitter: float = 0.12, seed: int = 0, system: str = "copper",
                 device: DeviceLike = "cuda") -> DPBatch:
    """Reference configurations labelled by a teacher DP model.

    Lattices with thermal jitter (numpy, so a seed gives the reference's
    positions bit for bit); energies/forces from the teacher on the ``mlp``
    rung. The neighbor search is brute force with the minimum image, as in
    the reference, also where the box edge is below 2 rcut.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if system == "copper":
        pos0, typ, box = lattice.fcc_copper(*supercell)
    else:
        pos0, typ, box = lattice.water_box(*supercell, seed=seed)
    na = len(pos0)
    spec = neighbors.NeighborSpec(rcut_nbr=cfg.rcut, sel=cfg.sel)
    typ_t = torch.as_tensor(typ, dtype=torch.int64, device=dev)
    box_t = torch.as_tensor(box, dtype=torch.float32, device=dev)

    rijs, masks, nlists = [], [], []
    for _ in range(n_configs):
        pos = np.mod(pos0 + rng.normal(0, jitter, pos0.shape), box)
        pos_t = torch.as_tensor(pos, dtype=torch.float32, device=dev)
        nlist, ovf = neighbors.brute_force_neighbors(pos_t, typ_t, spec,
                                                     box_t)
        if int(ovf) > 0:
            raise RuntimeError(f"neighbor capacity {cfg.sel} overflows by "
                               f"{int(ovf)}")
        rij, nmask = dp_model.gather_rij(pos_t, nlist, box_t)
        rijs.append(rij)
        masks.append(nmask)
        nlists.append(nlist)

    batch = DPBatch(
        rij=torch.stack(rijs), nmask=torch.stack(masks),
        atype=typ_t.expand(n_configs, na).contiguous(),
        nlist=torch.stack(nlists),
        e_ref=torch.zeros((n_configs,), device=dev),
        f_ref=torch.zeros((n_configs, na, 3), device=dev))
    e_ref, f_ref = batch_energy_forces(teacher_params, cfg, batch, impl="mlp")
    return batch._replace(e_ref=e_ref, f_ref=f_ref)


def fit_env_stats(params: Dict[str, Any], cfg: DPConfig, batch: DPBatch
                  ) -> Dict[str, Any]:
    """Set dstd from data statistics (DeePMD's descriptor normalization)."""
    with torch.no_grad():
        env, _ = descriptor.env_matrix(batch.rij, batch.nmask, cfg.rcut_smth,
                                       cfg.rcut)
        dstd = descriptor.compute_env_stats(env, batch.nmask, batch.atype,
                                            cfg.ntypes)
    out = dict(params)
    out["dstd"] = dstd
    return out


def minibatch(data: DPBatch, idx: np.ndarray) -> DPBatch:
    """The configurations ``idx`` of ``data`` (indices drawn on the host)."""
    sel = torch.as_tensor(idx, dtype=torch.int64, device=data.rij.device)
    return DPBatch(*(x[sel] for x in data))


def train_dp(cfg: DPConfig, *, steps: int = 200, n_configs: int = 16,
             batch_size: int = 4, seed: int = 0,
             loss_cfg: DPLossConfig = DPLossConfig(),
             system: str = "copper", supercell=(2, 2, 2),
             log_every: int = 50, verbose: bool = True,
             device: DeviceLike = "cuda"):
    """End-to-end DP training against a teacher model. Returns (state, log).

    Teacher and student weights are drawn from one ``torch.Generator``
    seeded ``seed`` (the reference's come from ``jax.random``, which the
    port cannot reproduce); jitter and minibatch indices are the reference's
    numpy draws.
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    teacher = dp_model.init_dp_params(gen, cfg, device=dev)
    data = teacher_data(cfg, teacher, n_configs=n_configs, seed=seed,
                        system=system, supercell=supercell, device=dev)

    opt = make_optimizer(loss_cfg)
    student = dp_model.init_dp_params(gen, cfg, device=dev)
    student = fit_env_stats(student, cfg, data)
    state = TrainState(params=student, opt=opt.init(student),
                       step=torch.zeros((), dtype=torch.int32, device=dev))
    step_fn = make_dp_train_step(cfg, loss_cfg, opt)

    rng = np.random.default_rng(seed)
    log = []
    for it in range(steps):
        mb = minibatch(data, rng.integers(0, n_configs, batch_size))
        state, metrics = step_fn(state, mb)
        if (it + 1) % log_every == 0 or it == 0:
            row = {k: float(v) for k, v in metrics.items()}
            row["step"] = it + 1
            log.append(row)
            if verbose:
                print(f"step {it+1:5d}  loss {row['loss']:.3e}  "
                      f"rmse_E/atom {row['rmse_e_atom']:.3e}  "
                      f"rmse_F {row['rmse_f']:.3e}", flush=True)
    return state, log
