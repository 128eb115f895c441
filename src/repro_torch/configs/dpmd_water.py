"""The paper's water system (Sec. 4): rcut 6 A, N_m 138 (46 O + 92 H),
embedding 32x64x128, fitting 240^3."""

from repro_torch.core.types import WATER_DP as CONFIG  # noqa: F401

REDUCED = CONFIG  # DP configs are already CPU-scale per-atom; no reduction
