"""Fused tabulated-embedding + descriptor-contraction kernels (CUDA C++).

The Hopper realization of the paper's Sec. 3.4.1 kernel fusion + Sec. 3.4.2
redundancy removal: T_i = R~_i^T G_i with G_i evaluated from the Chebyshev
table on the fly in registers — G_i never touches device memory; slots past
each atom's live count are skipped. Beside them, in the same library, the
force-and-virial reduction of Sec. 3.4 (``force.prod_force_virial``).
"""

from repro_torch.kernels.dp_fused.ops import fused_env_tab_contract

__all__ = ["fused_env_tab_contract"]
