"""What the benchmark makes from the seed and hands to both the port and the
reference: the system (positions, types, box), the raw DP weights, and the
seed of each call's starting velocities.

The system builders are frozen copies of the paper's two systems (Sec. 4):
an FCC copper lattice at a = 3.634 A, and water as a 64-molecule cell of
12.42 A (rigid molecules, OH 0.9572 A, HOH 104.52 degrees, on a 4 x 4 x 4
sub-grid, orientations from a fixed seed) replicated to size.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

WATER_CELL_A = 12.42


def fcc(cells: Sequence[int], a: float) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
    """FCC lattice of ``cells`` unit cells: (pos (N, 3), types, box (3,))."""
    base = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                     [0.0, 0.5, 0.5]])
    grid = np.stack(np.meshgrid(*[np.arange(c) for c in cells],
                                indexing="ij"), axis=-1).reshape(-1, 1, 3)
    pos = (grid + base[None]).reshape(-1, 3) * a
    box = np.asarray(cells, float) * a
    return pos, np.zeros(len(pos), np.int32), box


def water(cells: Sequence[int], orientation_seed: int
          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Replicated 64-molecule water cells; types 0 = O, 1 = H."""
    rng = np.random.default_rng(orientation_seed)
    m = 4
    spacing = WATER_CELL_A / m
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    o_pos = (grid + 0.5) * spacing
    d_oh, ang = 0.9572, np.deg2rad(104.52)
    h1 = np.array([d_oh, 0.0, 0.0])
    h2 = np.array([d_oh * np.cos(ang), d_oh * np.sin(ang), 0.0])
    q = rng.normal(size=(len(o_pos), 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    rot = np.stack([
        np.stack([1 - 2 * (y**2 + z**2), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x**2 + z**2),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x**2 + y**2)], -1)], axis=1)
    cell_pos = np.concatenate([o_pos, o_pos + np.einsum("nij,j->ni", rot, h1),
                               o_pos + np.einsum("nij,j->ni", rot, h2)])
    cell_typ = np.concatenate([np.zeros(64, np.int32), np.ones(128, np.int32)])
    rep = np.stack(np.meshgrid(*[np.arange(c) for c in cells], indexing="ij"),
                   axis=-1).reshape(-1, 1, 3)
    pos = (cell_pos[None] + rep * WATER_CELL_A).reshape(-1, 3)
    return (pos, np.tile(cell_typ, int(np.prod(cells))),
            np.asarray(cells, float) * WATER_CELL_A)


def system(spec: Dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The traffic file's ``system`` entry, built: positions are wrapped
    into the box and rounded to float32, as they are run."""
    if spec["kind"] == "fcc":
        pos, typ, box = fcc(spec["cells"], float(spec["lattice_a"]))
    elif spec["kind"] == "water":
        pos, typ, box = water(spec["cells"], int(spec["orientation_seed"]))
    else:
        raise ValueError(f"unknown system kind {spec['kind']!r}")
    pos = np.mod(pos, box).astype(np.float32)
    return pos, typ, box


def _layer(flat: torch.Tensor, at: int, d_in: int, d_out: int
           ) -> Tuple[Dict[str, torch.Tensor], int]:
    n_w = d_in * d_out
    w = flat[at:at + n_w].view(d_in, d_out) / float(d_in + d_out) ** 0.5
    b = flat[at + n_w:at + n_w + d_out] * 0.1
    return {"w": w, "b": b}, at + n_w + d_out


def _mlp_sizes(widths: Sequence[int], d_in: int) -> List[Tuple[int, int]]:
    sizes, prev = [], d_in
    for w in widths:
        sizes.append((prev, int(w)))
        prev = int(w)
    return sizes


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
            dstd: Optional[torch.Tensor] = None) -> Dict:
    """Raw DP weights from ``seed``, drawn on ``device`` in one call: the
    DeePMD initialisation, W ~ N(0, 1) / sqrt(d_in + d_out) and
    b ~ 0.1 N(0, 1); one embedding net per neighbour type and one fitting
    net per centre type; the environment scales ``dstd`` (1 if not given)
    and the energy biases 0. The dict has the port's parameter layout."""
    ntypes = int(cfg["ntypes"])
    embed = _mlp_sizes(cfg["embed_widths"], 1)
    desc = int(cfg["axis_neuron"]) * int(cfg["embed_widths"][-1])
    fit = _mlp_sizes(cfg["fit_widths"], desc) + [(int(cfg["fit_widths"][-1]),
                                                  1)]
    per_net = sum(a * b + b for a, b in embed)
    per_fit = sum(a * b + b for a, b in fit)
    total = ntypes * (per_net + per_fit)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    at = 0
    out: Dict = {"embed": {}, "fit": {}}
    for t in range(ntypes):
        net = []
        for a, b in embed:
            lyr, at = _layer(flat, at, a, b)
            net.append(lyr)
        out["embed"][str(t)] = net
    for t in range(ntypes):
        layers = []
        for a, b in fit:
            lyr, at = _layer(flat, at, a, b)
            layers.append(lyr)
        out["fit"][str(t)] = {"hidden": layers[:-1], "head": layers[-1]}
    out["dstd"] = (torch.ones((ntypes, 4), dtype=torch.float32, device=device)
                   if dstd is None else dstd.to(device))
    out["ebias"] = torch.zeros((ntypes,), dtype=torch.float32, device=device)
    return out


def call_seed(seed: int, call: int) -> int:
    """The starting-velocity seed of the window's call number ``call``
    (-1: the warm-up call)."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), call + 1])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))
