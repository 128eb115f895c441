"""The paper's copper system (Sec. 4): rcut 8 A, N_m 512 (high-pressure
headroom -> ~80% neighbor-slot redundancy at ambient density — the
redundancy-removal target), embedding 32x64x128, fitting 240^3."""

from repro_torch.core.types import COPPER_DP as CONFIG  # noqa: F401

REDUCED = CONFIG
