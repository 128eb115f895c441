"""The environment-matrix op (``kernels/dp_fused/env.py``) on the CPU.

Its plain forward against ``descriptor.env_matrix`` then ``normalize_env``,
its closed-form backward against their autograd in float64, and the
``cheb_pallas`` rung through the op against the ``cheb`` rung through the
plain ops. The kernels themselves run on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.core import descriptor, dp_model  # noqa: E402
from repro_torch.core.types import DPConfig  # noqa: E402
from repro_torch.kernels.dp_fused import build, env  # noqa: E402
from repro_torch.md import lattice, neighbors  # noqa: E402

torch.set_num_threads(1)

RCUT_SMTH, RCUT = 2.0, 6.0


def _inputs(lead, n, dtype=torch.float64, seed=0):
    """rij (*lead, N, 3) whose slots cover every branch of the switch:
    padded slots (mask false, r_ij 0 as gather_rij leaves them), r <
    rcut_smth, the ramp, r >= rcut, r exactly rcut, r <= 1e-6 (0 and 1e-7);
    two centre types with their own dstd; a cotangent for the rows and s."""
    gen = torch.Generator().manual_seed(seed)
    shape = (*lead, n)
    unit = torch.nn.functional.normalize(
        torch.randn((*shape, 3), generator=gen, dtype=dtype), dim=-1)
    r = 7.5 * torch.rand(shape, generator=gen, dtype=dtype)
    flat = r.reshape(-1, n)
    flat[:, 0], flat[:, 1], flat[:, 2] = 0.0, 1e-7, RCUT
    flat[:, 3], flat[:, 4] = 0.5 * RCUT_SMTH, 0.5 * (RCUT_SMTH + RCUT)
    nmask = torch.rand(shape, generator=gen) < 0.75
    nmask.reshape(-1, n)[:, :5] = True
    rij = torch.where(nmask[..., None], unit * r[..., None], 0.0)
    atype = torch.randint(0, 2, lead, generator=gen)
    dstd = (0.5 + torch.rand((2, 4), generator=gen, dtype=dtype))
    denv = torch.randn((*shape, 4), generator=gen, dtype=dtype)
    ds = torch.randn(shape, generator=gen, dtype=dtype)
    return rij, nmask, atype, dstd, denv, ds


def _plain(rij, nmask, atype, dstd):
    e, s = descriptor.env_matrix(rij, nmask, RCUT_SMTH, RCUT)
    return descriptor.normalize_env(e, s, atype, dstd)


_SHAPES = [((5,), 24), ((3, 4), 17), ((2, 2, 3), 9), ((1,), 6)]


@pytest.mark.parametrize("lead,n", _SHAPES,
                         ids=[f"{'x'.join(map(str, l))}-{n}" for l, n in
                              _SHAPES])
def test_op_forward_is_the_plain_ops(lead, n):
    """Through the op (batch dims flattened and restored) the rows and s
    are the plain ops' bit for bit, in float64 and float32."""
    for dtype in (torch.float64, torch.float32):
        rij, nmask, atype, dstd, _, _ = _inputs(lead, n, dtype)
        env_n, s_n = env.env_mat(rij, nmask, atype, dstd, RCUT_SMTH, RCUT)
        want_env, want_s = _plain(rij, nmask, atype, dstd)
        assert env_n.shape == (*lead, n, 4) and s_n.shape == (*lead, n)
        assert torch.equal(env_n, want_env) and torch.equal(s_n, want_s)
        assert not env_n[~nmask].any()


@pytest.mark.parametrize("lead,n", _SHAPES,
                         ids=[f"{'x'.join(map(str, l))}-{n}" for l, n in
                              _SHAPES])
@pytest.mark.parametrize("path", ["closed_form", "through_the_op"])
def test_backward_equals_autograd_of_the_plain_ops(lead, n, path):
    """dE/dr_ij in float64, the closed form (``env_mat_bwd_ref``, and the
    op's backward that runs it) against autograd through the plain ops,
    rtol 1e-10; zero on padded slots and outside 1e-6 < r < rcut."""
    rij, nmask, atype, dstd, denv, ds = _inputs(lead, n, seed=len(lead) + n)
    x = rij.clone().requires_grad_(True)
    e_p, s_p = _plain(x, nmask, atype, dstd)
    (want,) = torch.autograd.grad((e_p * denv).sum() + (s_p * ds).sum(), x)
    if path == "closed_form":
        got = env.env_mat_bwd_ref(rij.reshape(-1, n, 3), nmask.reshape(-1, n),
                                  atype.reshape(-1), dstd,
                                  denv.reshape(-1, n, 4), ds.reshape(-1, n),
                                  RCUT_SMTH, RCUT).reshape(rij.shape)
    else:
        y = rij.clone().requires_grad_(True)
        e_o, s_o = env.env_mat(y, nmask, atype, dstd, RCUT_SMTH, RCUT)
        (got,) = torch.autograd.grad((e_o * denv).sum() + (s_o * ds).sum(), y)
    torch.testing.assert_close(got, want, rtol=1e-10,
                               atol=1e-10 * float(want.abs().max()))
    r = rij.norm(dim=-1)
    dead = ~nmask | (r <= 1e-6) | (r >= RCUT)
    assert not got[dead].any() and got[~dead].abs().sum() > 0


def test_the_op_takes_strided_rij_and_gives_dstd_no_gradient():
    """A non-contiguous rij (a slice of a wider list) is made contiguous;
    dE/dr_ij reaches the strided view's base; dstd gets no gradient."""
    rij, nmask, atype, dstd, denv, ds = _inputs((6,), 20)
    wide = torch.cat([rij, torch.zeros((6, 5, 3), dtype=rij.dtype)], dim=1)
    base = wide.clone().requires_grad_(True)
    sd = dstd.clone().requires_grad_(True)
    e_o, s_o = env.env_mat(base[:, :20], nmask, atype, sd, RCUT_SMTH, RCUT)
    g_base, g_sd = torch.autograd.grad(
        (e_o * denv).sum() + (s_o * ds).sum(), (base, sd), allow_unused=True)
    want = env.env_mat_bwd_ref(rij, nmask, atype, dstd, denv, ds, RCUT_SMTH,
                               RCUT)
    torch.testing.assert_close(g_base[:, :20], want, rtol=0, atol=0)
    assert not g_base[:, 20:].any()
    assert g_sd is None


@pytest.mark.parametrize("bad", ["rank", "nmask", "atype", "dstd", "cut"])
def test_the_op_refuses_inputs_it_does_not_take(bad):
    rij, nmask, atype, dstd, _, _ = _inputs((4,), 8)
    args = {"rank": (rij[0], nmask[0], atype, dstd, RCUT_SMTH, RCUT),
            "nmask": (rij, nmask[:, :5], atype, dstd, RCUT_SMTH, RCUT),
            "atype": (rij, nmask, atype[:3], dstd, RCUT_SMTH, RCUT),
            "dstd": (rij, nmask, atype, dstd[:, :3], RCUT_SMTH, RCUT),
            "cut": (rij, nmask, atype, dstd, RCUT, RCUT_SMTH)}[bad]
    with pytest.raises((ValueError, RuntimeError)):
        env.env_mat(*args)


def test_fake_trace_reaches_neither_nvcc_nor_the_counters(monkeypatch):
    """Under FakeTensorMode the ops' fake implementations give the shapes;
    nothing is built, launched or counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def refuse(*a, **k):
        raise AssertionError("a fake trace reached the kernel build")
    monkeypatch.setattr(build, "load", refuse)
    before = (env.env_fwd_launches, env.env_bwd_launches)
    rij, nmask, atype, dstd, denv, ds = _inputs((3,), 10, torch.float32)
    with FakeTensorMode() as mode:
        x = mode.from_tensor(rij).requires_grad_(True)
        e_o, s_o = env.env_mat(x, mode.from_tensor(nmask),
                               mode.from_tensor(atype),
                               mode.from_tensor(dstd), RCUT_SMTH, RCUT)
        (g,) = torch.autograd.grad(e_o.sum() + s_o.sum(), x)
    assert tuple(e_o.shape) == (3, 10, 4) and tuple(s_o.shape) == (3, 10)
    assert tuple(g.shape) == (3, 10, 3)
    assert (env.env_fwd_launches, env.env_bwd_launches) == before


# ----------------------------------------------- the rung through the op

_CU = DPConfig(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(48,), type_map=("Cu",),
               embed_widths=(8, 16, 32), axis_neuron=4,
               fit_widths=(24, 24, 24), table_lower=-1.0, table_upper=9.0,
               cheb_order=48)
_H2O = DPConfig(ntypes=2, rcut=4.0, rcut_smth=0.5, sel=(16, 32),
                type_map=("O", "H"), embed_widths=(8, 16, 32), axis_neuron=4,
                fit_widths=(24, 24, 24), table_lower=-1.0, table_upper=9.0,
                cheb_order=48)


def _system(cfg):
    if cfg.ntypes == 1:
        pos, typ, box = lattice.fcc_copper(2, 2, 2)
        rng = np.random.default_rng(0)
        pos = np.mod(pos + rng.normal(0, 0.05, pos.shape), box)
    else:
        pos, typ, box = lattice.water_box(1, 1, 1, seed=0)
    pos_t = torch.as_tensor(pos, dtype=torch.float32)
    typ_t = torch.as_tensor(typ, dtype=torch.int64)
    box_t = torch.as_tensor(np.asarray(box), dtype=torch.float32)
    nlist, ovf = neighbors.brute_force_neighbors(
        pos_t, typ_t, neighbors.NeighborSpec(rcut_nbr=cfg.rcut, sel=cfg.sel),
        box_t)
    assert int(ovf) <= 0
    return pos_t, nlist, typ_t, box_t


@pytest.mark.parametrize("cfg", [_CU, _H2O], ids=["copper", "water"])
def test_cheb_pallas_runs_the_op_and_matches_the_cheb_rung(cfg, monkeypatch):
    """cheb_pallas on the CPU goes through the op once forward and once
    backward (counted on its plain versions), and gives the cheb rung's
    energy, forces and virial to float32 tolerance (energy rtol 1e-5,
    forces atol 2e-5, virial atol 2e-4, as the parity tests)."""
    params = dp_model.tabulate_model(dp_model.init_dp_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"), cfg, "cheb")
    calls = {"fwd": 0, "bwd": 0}
    fwd_ref, bwd_ref = env.env_mat_ref, env.env_mat_bwd_ref

    def counted(kind, fn):
        def wrapped(*args):
            calls[kind] += 1
            return fn(*args)
        return wrapped
    monkeypatch.setattr(env, "env_mat_ref", counted("fwd", fwd_ref))
    monkeypatch.setattr(env, "env_mat_bwd_ref", counted("bwd", bwd_ref))
    pos, nlist, typ, box = _system(cfg)
    got = dp_model.dp_energy_forces(params, cfg, pos, nlist, typ, box,
                                    impl="cheb_pallas")
    assert calls == {"fwd": 1, "bwd": 1}
    want = dp_model.dp_energy_forces(params, cfg, pos, nlist, typ, box,
                                     impl="cheb")
    assert calls == {"fwd": 1, "bwd": 1}
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), atol=2e-5)
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), atol=2e-4)


@pytest.mark.parametrize("impl", ["mlp", "quintic", "cheb"])
def test_the_other_rungs_keep_the_plain_ops(impl, monkeypatch):
    """mlp, quintic and cheb (and so training, which runs mlp with a double
    backward) never reach the op."""
    def refuse(*a, **k):
        raise AssertionError(f"{impl} reached env.env_mat")
    monkeypatch.setattr(dp_model.env_ops, "env_mat", refuse)
    kind = {"mlp": None, "quintic": "quintic", "cheb": "cheb"}[impl]
    params = dp_model.init_dp_params(torch.Generator().manual_seed(0), _CU,
                                     device="cpu")
    if kind:
        params = dp_model.tabulate_model(params, _CU, kind)
    pos, nlist, typ, box = _system(_CU)
    e, f, _ = dp_model.dp_energy_forces(params, _CU, pos, nlist, typ, box,
                                        impl=impl)
    assert np.isfinite(float(e)) and bool(torch.isfinite(f).all())
