"""The plain reference against an independent hand computation: a few
atoms, float64 NumPy loops over the pairs, the embedding net itself in place
of its Chebyshev table, forces by central differences."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mdbench import inputs  # noqa: E402
from mdbench.reference import md, se_e2_a, shared  # noqa: E402

CFG = {"ntypes": 2, "rcut": 3.0, "rcut_smth": 1.0, "sel": [6, 10],
       "type_map": ["O", "H"], "embed_widths": [4, 8, 8], "axis_neuron": 3,
       "type_one_side": True, "fit_widths": [6, 6, 6], "table_lower": -2.0,
       "table_upper": 10.0, "cheb_order": 32}


def _np(t):
    return t.detach().double().numpy()


def hand_energy(w, pos, typ, box):
    """E by loops: s(r), R~, G = g(s) by the MLP, T, D, fitting."""
    rc, rs = CFG["rcut"], CFG["rcut_smth"]
    nsel, m_sub = sum(CFG["sel"]), CFG["axis_neuron"]
    dstd = _np(w["dstd"])

    def mlp(layers, h):
        for lyr in layers:
            wt, b = _np(lyr["w"]), _np(lyr["b"])
            y = np.tanh(h @ wt + b)
            if wt.shape[0] == wt.shape[1]:
                h = h + y
            elif wt.shape[1] == 2 * wt.shape[0]:
                h = np.concatenate([h, h]) + y
            else:
                h = y
        return h

    total = 0.0
    for i in range(len(pos)):
        t_mat = np.zeros((4, CFG["embed_widths"][-1]))
        for j in range(len(pos)):
            if j == i:
                continue
            d = pos[j] - pos[i]
            d -= box * np.round(d / box)
            r = np.linalg.norm(d)
            if r >= rc:
                continue
            u = min(max((r - rs) / (rc - rs), 0.0), 1.0)
            s = (u**3 * (-6 * u * u + 15 * u - 10) + 1) / r
            row = np.array([s, s * d[0] / r, s * d[1] / r, s * d[2] / r]) \
                / dstd[typ[i]]
            g = mlp(w["embed"][str(typ[j])], np.array([s / dstd[typ[i], 0]]))
            t_mat += np.outer(row, g)
        t_mat /= nsel
        desc = (t_mat[:, :m_sub].T @ t_mat).reshape(-1)
        net = w["fit"][str(typ[i])]
        h = mlp(net["hidden"], desc)
        total += float((h @ _np(net["head"]["w"]) + _np(net["head"]["b"]))[0])
        total += float(_np(w["ebias"])[typ[i]])
    return total


@pytest.fixture
def case():
    rng = np.random.default_rng(3)
    box = np.array([7.0, 7.5, 8.0])
    pos = rng.uniform(0, 1, (9, 3)) * box
    typ = np.array([0, 1, 1, 0, 1, 1, 0, 1, 1])
    w = inputs.weights(CFG, 5, torch.device("cpu"),
                       dstd=torch.tensor([[0.4, 0.2, 0.2, 0.2],
                                          [0.3, 0.15, 0.15, 0.15]]))
    return w, pos, typ, box


def _ref(w, pos, typ, box, precision="float32"):
    model = se_e2_a.Reference(CFG, w, torch.device("cpu"),
                              precision=precision, block_atoms=4)
    x = torch.tensor(pos, dtype=torch.float32)
    b = torch.tensor(box, dtype=torch.float32)
    t = torch.tensor(typ, dtype=torch.int64)
    nbr = shared.neighbor_table(x, b, CFG["rcut"] + 0.5)
    return model.energy_forces(x, t, b, nbr)


def test_energy_matches_the_hand_computation(case):
    w, pos, typ, box = case
    e, _ = _ref(w, pos, typ, box)
    want = hand_energy(w, pos, typ, box)
    assert abs(e - want) <= 2e-5 * max(1.0, abs(want)), (e, want)


def test_forces_match_central_differences(case):
    w, pos, typ, box = case
    _, f = _ref(w, pos, typ, box)
    h = 1e-4
    for i in (0, 1, 4):
        for a in range(3):
            p, q = pos.copy(), pos.copy()
            p[i, a] += h
            q[i, a] -= h
            fd = -(hand_energy(w, p, typ, box)
                   - hand_energy(w, q, typ, box)) / (2 * h)
            assert abs(float(f[i, a]) - fd) <= 1e-4 + 1e-3 * abs(fd), \
                (i, a, float(f[i, a]), fd)


def test_neighbor_table_holds_exactly_the_pairs_within_the_cutoff():
    rng = np.random.default_rng(0)
    box = np.array([10.0, 11.0, 12.0])
    pos = rng.uniform(0, 1, (300, 3)) * box
    x = torch.tensor(pos, dtype=torch.float32)
    nbr = shared.neighbor_table(x, torch.tensor(box, dtype=torch.float32),
                                4.0, block=64)
    for i in range(0, 300, 37):
        d = pos - pos[i]
        d -= box * np.round(d / box)
        want = set(np.nonzero(np.linalg.norm(d, axis=1) < 4.0)[0]) - {i}
        got = set(int(j) for j in nbr[i] if j >= 0)
        assert got == want


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.14159265])
    assert shared.round_tf32(x).tolist() == [1.0, 1.0 + 2**-9, -3.140625]


def test_start_velocities_have_no_drift_and_the_temperature():
    mass = torch.tensor(md.masses(("Cu",), np.zeros(20000, np.int64)),
                        dtype=torch.float32)
    v = md.start_velocities(2**31 + 3, mass, 330.0)
    assert float(torch.abs((v * mass[:, None]).sum(0)).max()) < 1e-3
    temp = 2 * md.kinetic(v, mass) / (3 * 20000 * md.KB_EV)
    assert abs(temp - 330.0) < 10.0


# the parent's DPReference (commit c6f8a92, before families were files) on
# this case on the CPU: the energy, and SHA-256 of the forces' bytes
PARENT_REFERENCE = {
    "float32": (2.700761705636978, "99169b5de7c83c2f6893f46148179afbee"
                "d22d41cb084a6da4cf51e72c3c6c7e"),
    "tf32": (2.7002905309200287, "9ccb731270b0e8bee3db3df0e4f77b0fe393e"
             "5dbcacc4741ab595289cb3a27ac"),
}


@pytest.mark.parametrize("precision", sorted(PARENT_REFERENCE))
def test_the_family_reference_is_the_one_before_bit_for_bit(case, precision):
    import hashlib

    w, pos, typ, box = case
    e, f = _ref(w, pos, typ, box, precision)
    assert (e, hashlib.sha256(f.numpy().tobytes()).hexdigest()) == \
        PARENT_REFERENCE[precision]
