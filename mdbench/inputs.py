"""What the benchmark makes from the seed and hands to both the port and the
reference: the system (positions, types, box), the raw model weights, and
the seed of each call's starting velocities.

The system is built by ``systems/<kind>.py`` (the traffic file's
``system.kind``), the weights by the configuration's model family
(``reference/<family>.py``), each found in the cell's directory
(``manifest``).
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from mdbench import manifest


def system(spec: Dict, base: Path = manifest.HERE
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The traffic file's ``system`` entry, built by its kind's builder:
    positions are wrapped into the box and rounded to float32, as they are
    run."""
    pos, typ, box = manifest.system_builder(spec["kind"], base).build(spec)
    pos = np.mod(pos, box).astype(np.float32)
    return pos, typ, box


def env_scale(cfg: Dict, pos: np.ndarray, typ: np.ndarray, box: np.ndarray,
              device: torch.device, centres: int = 512
              ) -> Optional[torch.Tensor]:
    """The environment scales ``dstd`` (ntypes, 4) that the configuration's
    ``env_scale`` names: ``"unit"`` gives None (all 1); ``"statistics"``
    DeePMD's statistics, per centre type the rms of s and of the three
    angular columns s x/r (pooled) over the pairs within rcut, from the
    first ``centres`` atoms of the starting system."""
    if cfg.get("env_scale", "unit") == "unit":
        return None
    x = torch.as_tensor(pos, dtype=torch.float32, device=device)
    b = torch.as_tensor(box, dtype=torch.float32, device=device)
    t = torch.as_tensor(typ, dtype=torch.int64, device=device)
    rc, rs = float(cfg["rcut"]), float(cfg["rcut_smth"])
    c = min(centres, len(pos))
    rij = x[None, :, :] - x[:c, None, :]
    rij = rij - b * torch.round(rij / b)
    r = torch.linalg.vector_norm(rij, dim=-1)
    live = (r < rc) & (r > 0)
    r = torch.where(live, r, 1.0)
    u = torch.clamp((r - rs) / (rc - rs), 0.0, 1.0)
    s = torch.where(live, (u**3 * (-6 * u * u + 15 * u - 10) + 1) / r, 0.0)
    ang = s[..., None] * rij / r[..., None]
    out = torch.ones((int(cfg["ntypes"]), 4), dtype=torch.float32,
                     device=device)
    for ct in range(int(cfg["ntypes"])):
        m = live & (t[:c] == ct)[:, None]
        if bool(m.any()):
            out[ct, 0] = torch.sqrt(torch.mean(s[m] ** 2))
            out[ct, 1:] = torch.sqrt(torch.mean(ang[m] ** 2))
    return torch.clamp(out, min=1e-2)


def weights(cfg: Dict, seed: int, device: torch.device,
            dstd: Optional[torch.Tensor] = None,
            base: Path = manifest.HERE) -> Dict:
    """The raw weights of the configuration's model family from ``seed``
    (``reference/<family>.py``: ``weights``), drawn on ``device``."""
    return manifest.family(cfg, base).weights(cfg, seed, device, dstd)


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def weights_digest(weights: Dict) -> str:
    """SHA-256 of every weight tensor's path, dtype, shape and bytes, the
    paths in sorted order: equal digests, equal weights bit for bit."""
    h = hashlib.sha256()
    for path, t in _leaves(weights):
        t = t.detach().cpu().contiguous()
        h.update(f"{path}:{t.dtype}:{tuple(t.shape)};".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def call_seed(seed: int, call: int) -> int:
    """The starting-velocity seed of the window's call number ``call``
    (-1: the warm-up call)."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), call + 1])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))
