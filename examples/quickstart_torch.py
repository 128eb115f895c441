"""Quickstart of the PyTorch port: train a Deep Potential model, compress it
(the paper's tabulation), and run molecular dynamics with the compressed
model -- the counterpart of ``examples/quickstart.py``.

  PYTHONPATH=src python examples/quickstart_torch.py            # on the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Imports ``torch`` and the port (``repro_torch``) only.
"""

import argparse

import torch

from repro_torch.core import dp_model
from repro_torch.core.types import DPConfig
from repro_torch.device import resolve_device
from repro_torch.md import driver, lattice, neighbors
from repro_torch.train.dp_trainer import train_dp

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
args = ap.parse_args()
dev = resolve_device(args.device)

# 1. A small copper DP model (same architecture family as the paper's,
#    scaled down so this runs in about a minute).
cfg = DPConfig(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(48,), type_map=("Cu",),
               embed_widths=(8, 16, 32), axis_neuron=4, fit_widths=(32, 32, 32))

# 2. Train it end-to-end against a teacher potential (stand-in for DFT labels).
print("== training ==")
state, log = train_dp(cfg, steps=150, n_configs=8, batch_size=4, log_every=50,
                      device=dev)
params = state.params

# 3. Compress: the Chebyshev table that feeds the fused kernel (the paper's
#    tabulation, Sec. 3.2).
print("\n== tabulating ==")
params_tab = dp_model.tabulate_model(params, cfg, "cheb")

# 4. Run MD with the paper's protocol (velocity Verlet, neighbor skin).
print("\n== molecular dynamics (tabulated model) ==")
pos, typ, box = lattice.fcc_copper(3, 3, 3)
res = driver.run_md(cfg, params_tab, pos, typ, box, steps=99, dt_fs=1.0,
                    temp_k=100.0, impl="cheb", thermo_every=33,
                    skin=0.5, rebuild_every=20, device=dev)
for row in res.thermo:
    print(f"  step {row['step']:3d}  E_pot {row['pe']:+.4f} eV  "
          f"E_tot {row['etot']:+.4f} eV  T {row['temp']:6.1f} K")
drift = abs(res.thermo[-1]["etot"] - res.thermo[0]["etot"])
print(f"\n{res.n_atoms} atoms, {res.steps} steps on {dev.type}, "
      f"energy drift {drift:.2e} eV")

# 5. Verify the compressed model against the original on the final frame.
spec = neighbors.NeighborSpec(rcut_nbr=cfg.rcut, sel=cfg.sel)
post = torch.as_tensor(res.final_pos, dtype=torch.float32, device=dev)
typt = torch.as_tensor(typ, dtype=torch.int64, device=dev)
boxt = torch.as_tensor(box, dtype=torch.float32, device=dev)
nlist, _ = neighbors.brute_force_neighbors(post, typt, spec, boxt)
e0, f0, _ = dp_model.dp_energy_forces(params, cfg, post, nlist, typt, boxt)
e1, f1, _ = dp_model.dp_energy_forces(params_tab, cfg, post, nlist, typt,
                                      boxt, impl="cheb")
print(f"compressed vs original:  dE = {abs(float(e1 - e0)):.2e} eV, "
      f"max |dF| = {float((f1 - f0).abs().max()):.2e} eV/A")
print("quickstart complete.")
