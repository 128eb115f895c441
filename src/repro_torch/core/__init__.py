"""Deep Potential core: descriptor, embedding/fitting nets, tabulation, model."""

from repro_torch.core.types import COPPER_DP, WATER_DP, DPConfig
from repro_torch.core.dp_model import (
    dp_energy,
    dp_energy_forces,
    init_dp_params,
    tabulate_model,
)

__all__ = [
    "COPPER_DP",
    "WATER_DP",
    "DPConfig",
    "init_dp_params",
    "dp_energy",
    "dp_energy_forces",
    "tabulate_model",
]
