"""The reference's legacy DP + NVE names in the port's stepper: each shim is
the engine it names, bit for bit, over two segments on the CPU, and
``VVCarry`` is the step carry."""

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.core import dp_model  # noqa: E402
from repro_torch.core.types import DPConfig  # noqa: E402
from repro_torch.md import api, lattice, neighbors, stepper  # noqa: E402

torch.set_num_threads(1)

CFG = DPConfig(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(96,),
               type_map=("Cu",), embed_widths=(8, 16, 32), axis_neuron=4,
               fit_widths=(24, 24, 24), table_lower=-1.0, table_upper=9.0)
IMPL = "cheb_pallas"


def _system():
    pos, typ, box = lattice.fcc_copper(3, 3, 3)
    rng = np.random.default_rng(0)
    pos = np.mod(pos + rng.normal(0, 0.05, pos.shape), box)
    pos = torch.as_tensor(pos, dtype=torch.float32)
    typ = torch.as_tensor(typ, dtype=torch.int64)
    masses = torch.full((len(pos),), lattice.MASS["Cu"])
    vel = 0.01 * torch.as_tensor(rng.normal(size=pos.shape),
                                 dtype=torch.float32)
    params = dp_model.tabulate_model(dp_model.init_dp_params(
        torch.Generator().manual_seed(0), CFG, device="cpu"), CFG, "cheb")
    spec = neighbors.NeighborSpec(rcut_nbr=CFG.rcut + 1.0, sel=CFG.sel)
    return pos, vel, typ, masses, box, params, spec


def _equal(a, b):
    """Every tensor of two carries equal bit for bit."""
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)


def test_scan_segment_is_run_steps():
    assert stepper.scan_segment is stepper.run_steps


def test_vv_carry_is_the_step_carry():
    """The reference's legacy carry name, with the step carry's fields and
    defaults."""
    assert stepper.VVCarry is stepper.MDCarry
    z = torch.zeros(2, 3)
    c = stepper.VVCarry(z, z + 1.0, z)
    assert c._fields == ("pos", "vel", "force", "ens", "box", "baro")
    assert (c.ens, c.box, c.baro) == ((), None, ())


def test_vv_step_and_segment_engine_equal_the_dp_nve_engine():
    pos, vel, typ, masses, box, params, spec = _system()
    bld = stepper.build_neighbors_escalating(CFG, spec, box, pos, typ)
    boxt = stepper.pack_box(box, torch.device("cpu"))
    pot = api.DPPotential(bld.cfg_run, IMPL, CFG.nsel)
    _, f0, _ = pot.energy_forces(params, pos, typ, bld.nlist, box=boxt)
    carry = stepper.MDCarry(pos, vel, f0, (), boxt, ())
    aux = (params, bld.nlist, typ, masses, 1.0)

    def two(engine):
        c, ths = carry, []
        for _ in range(2):
            c, th = engine.run(c, 5, *aux)
            ths.append(th)
        return c, ths

    want = two(stepper.md_segment_engine(pot, api.NVE()))
    got = two(stepper.vv_segment_engine(bld.cfg_run, IMPL, CFG.nsel))
    _equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert all(torch.equal(a[k], b[k]) for k in b)
    step_shim = stepper.make_vv_step(bld.cfg_run, IMPL, CFG.nsel)
    step = stepper.make_md_step(pot, api.NVE())
    with torch.no_grad():
        a, th_a = step_shim(carry, *aux)
        b, th_b = step(carry, *aux)
    _equal(a, b)
    assert all(torch.equal(th_a[k], th_b[k]) for k in th_b)


def test_vv_outer_engine_equals_the_dp_nve_outer_engine():
    pos, vel, typ, masses, box, params, spec = _system()
    boxt = stepper.pack_box(box, torch.device("cpu"))
    pot = api.DPPotential(CFG, IMPL, CFG.nsel)
    bld = stepper.build_neighbors_escalating(CFG, spec, box, pos, typ)
    _, f0, _ = pot.energy_forces(params, pos, typ, bld.nlist, box=boxt)
    carry = stepper.OuterCarry(pos, vel, f0,
                               torch.zeros((), dtype=torch.int32), (), boxt,
                               ())
    aux = (params, typ, masses, 1.0)
    want = stepper.md_outer_engine(
        pot, api.NVE(), spec, stepper.grid_key_for(spec, box)).run(
            carry, 2, 5, *aux)
    got = stepper.vv_outer_engine(CFG, IMPL, CFG.nsel, spec,
                                  tuple(box)).run(carry, 2, 5, *aux)
    _equal(got[0], want[0])
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])
    assert got[1]["pe"].shape == (2, 5)
