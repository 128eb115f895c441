"""``repro_torch.analysis.op_cost`` against the reference's HLO cost model.

The port's counter runs a function under ``FlopCounterMode`` (and a byte and
liveness dispatch mode); the reference walks the optimised HLO of the jitted
function. Both count matmul-family FLOPs only, so the port's FLOPs of
``dp_energy_forces`` are held to the reference's dot count at rtol 1e-2 on
a small copper system (sel 48, embedding 8/16/32, fitting 32 x 3, fcc
3x3x3) for mlp, cheb and quintic. Bytes have no parity (the reference's
count is a TPU-fusion proxy; the port's is an eager run's), so they are not
compared. A fake trace must give the real trace's numbers exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.analysis import hlo_cost  # noqa: E402
from repro.core import dp_model as jax_dp  # noqa: E402
from repro.core.types import DPConfig as JaxDPConfig  # noqa: E402
from repro.md import lattice as jax_lattice  # noqa: E402
from repro.md import neighbors as jax_neighbors  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.analysis import op_cost  # noqa: E402
from repro_torch.core import dp_model  # noqa: E402
from repro_torch.core.types import DPConfig  # noqa: E402
from repro_torch.kernels.dp_fused import build, ops  # noqa: E402

torch.set_num_threads(1)

_KW = dict(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(48,), type_map=("Cu",),
           embed_widths=(8, 16, 32), axis_neuron=4, fit_widths=(32, 32, 32),
           table_lower=-1.0, table_upper=9.0)
CFG = DPConfig(**_KW)
JCFG = JaxDPConfig(**_KW)


def _system():
    pos, typ, box = jax_lattice.fcc_copper(3, 3, 3)
    spec = jax_neighbors.NeighborSpec(rcut_nbr=JCFG.rcut, sel=JCFG.sel)
    nlist, ovf = jax_neighbors.brute_force_neighbors(
        jnp.asarray(pos, jnp.float32), jnp.asarray(typ), spec,
        jnp.asarray(box, jnp.float32))
    assert int(ovf) <= 0
    return (np.asarray(pos, np.float32), np.asarray(typ, np.int32),
            np.array(nlist), np.asarray(box, np.float32))


def _params(impl):
    p = jax_dp.init_dp_params(jax.random.PRNGKey(0), JCFG)
    if impl != "mlp":
        p = jax_dp.tabulate_model(p, JCFG,
                                  "quintic" if impl == "quintic" else "cheb")
    return p


def _torch_args(p_np, system, device="cpu"):
    pos, typ, nlist, box = system
    params = bridge.params_from_numpy(p_np, device="cpu")
    return (params, torch.from_numpy(pos), torch.from_numpy(nlist).long(),
            torch.from_numpy(typ).long(), torch.from_numpy(box))


def _port_fn(impl):
    def fn(params, pos, nlist, typ, box):
        return dp_model.dp_energy_forces(params, CFG, pos, nlist, typ, box,
                                         impl=impl)
    return fn


@pytest.mark.parametrize("impl", ["mlp", "cheb", "quintic"])
def test_flops_match_the_reference_hlo_count(impl):
    system = _system()
    p = _params(impl)
    pos, typ, nlist, box = system
    compiled = jax.jit(lambda p, x, n, t, b: jax_dp.dp_energy_forces(
        p, JCFG, x, n, t, b, impl=impl)).lower(
            p, jnp.asarray(pos), jnp.asarray(nlist), jnp.asarray(typ),
            jnp.asarray(box)).compile()
    want = hlo_cost.analyze_text(compiled.as_text()).flops
    got = op_cost.analyze_fn(_port_fn(impl), *_torch_args(
        jax.tree.map(np.asarray, p), system)).flops
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-2)


def _fake_args(real_args):
    mode = FakeTensorMode()
    return mode, pytree.tree_map_only(torch.Tensor, mode.from_tensor,
                                      real_args)


@pytest.mark.parametrize("impl", ["mlp", "quintic", "cheb", "cheb_pallas"])
def test_fake_trace_equals_the_real_one(impl):
    p = _params("cheb" if impl == "cheb_pallas" else impl)
    real_args = _torch_args(jax.tree.map(np.asarray, p), _system())
    real = op_cost.analyze_fn(_port_fn(impl), *real_args)
    mode, fake_args = _fake_args(real_args)
    with mode:
        fake = op_cost.analyze_fn(_port_fn(impl), *fake_args)
    assert (fake.flops, fake.peak_bytes, fake.arg_bytes,
            fake.bytes_accessed) == (real.flops, real.peak_bytes,
                                     real.arg_bytes, real.bytes_accessed)
    assert real.peak_bytes > real.arg_bytes > 0
    assert real.bytes_accessed > real.peak_bytes


def test_cheb_pallas_traces_without_building_the_kernels(monkeypatch):
    """Fake tensors go through the custom ops' fake implementations: the
    build is never reached, and the kernels' FLOPs are the package's
    formula (every slot live, times the stated live share)."""
    def refuse():
        raise AssertionError("a fake trace reached build.load")
    monkeypatch.setattr(build, "load", refuse)
    real_args = _torch_args(jax.tree.map(np.asarray, _params("cheb")),
                            _system())
    n_atoms, nsel = real_args[2].shape
    k, m = real_args[0]["table"]["nets"]["0"]["coeffs"].shape
    base = op_cost.analyze_fn(_port_fn("cheb"), *real_args)
    for share in (1.0, 0.25):
        mode, fake_args = _fake_args(real_args)
        with mode, ops.live_fraction(share):
            got = op_cost.analyze_fn(_port_fn("cheb_pallas"), *fake_args)
        kernels = {name: flops for name, (_, flops) in ops.kernel_cost(
            share * n_atoms * nsel, n_atoms, nsel, k, m).items()}
        by_op = {k_: v for k_, v in got.flops_by_op.items()
                 if "dp_fused" in k_}
        assert by_op == {"repro_torch.dp_fused_fwd":
                         int(kernels["dp_fused_fwd"]),
                         "repro_torch.dp_fused_bwd":
                         int(kernels["dp_fused_bwd"])}, by_op
        # the rest of the step is the cheb rung's without its basis matmuls
        rest = got.flops - sum(by_op.values())
        assert 0 < rest < base.flops
