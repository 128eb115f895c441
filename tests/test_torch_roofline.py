"""The port's roofline arithmetic against the reference's, and the counting
communicator against the bytes a distributed step really moves.

``RooflineReport`` and ``_wire_factor`` are plain arithmetic copied from
``repro.analysis.roofline``: the same inputs must give the same numbers
(held on the reference's ``HW_V5E``). ``DryRunComm`` counts each
``ppermute``/``psum``/``pmax`` as a rank calls it; on a tiny 2-brick step
its counts must equal the buffers that ``LocalComm`` hands between the
ranks in the same step.
"""

import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.analysis import roofline as jax_rl  # noqa: E402
from repro_torch.analysis import roofline as rl  # noqa: E402
from repro_torch.core import dp_model  # noqa: E402
from repro_torch.core.types import DPConfig  # noqa: E402
from repro_torch.md import comm as comm_mod  # noqa: E402
from repro_torch.md import domain, lattice  # noqa: E402

torch.set_num_threads(1)

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


@pytest.mark.parametrize("kind", KINDS)
def test_wire_factor_equals_reference(kind):
    for n in range(0, 70):
        assert rl._wire_factor(kind, n) == jax_rl._wire_factor(kind, n)


_REPORTS = [
    dict(hlo_flops=3.2e12, hlo_bytes=7.5e10, by_kind=(1e6, 4e8, 0, 0, 2e9),
         ici=3e9, dcn=1e8, model_flops=1.1e15, peak=9.5 * 2**30, chips=256),
    dict(hlo_flops=1.0e9, hlo_bytes=2.0e12, by_kind=(0, 0, 0, 0, 0),
         ici=0.0, dcn=0.0, model_flops=0.0, peak=20 * 2**30, chips=512),
    dict(hlo_flops=0.0, hlo_bytes=0.0, by_kind=(5e9, 0, 1e9, 3e9, 0),
         ici=8e9, dcn=9e9, model_flops=4e12, peak=1.0, chips=1),
]


def _reports(case, mod, hw):
    stats = mod.CollectiveStats(dict(zip(KINDS, case["by_kind"])),
                                case["ici"], case["dcn"], 7)
    return mod.RooflineReport(
        name="x", n_chips=case["chips"], hlo_flops=case["hlo_flops"],
        hlo_bytes=case["hlo_bytes"], collectives=stats,
        model_flops=case["model_flops"],
        t_compute=case["hlo_flops"] / hw.peak_flops,
        t_memory=case["hlo_bytes"] / hw.hbm_bw,
        t_ici=case["ici"] / hw.ici_bw, t_dcn=case["dcn"] / hw.dcn_bw,
        peak_mem_bytes=case["peak"], hw=hw)


@pytest.mark.parametrize("case", range(len(_REPORTS)))
def test_report_equals_reference_on_v5e(case):
    c = _REPORTS[case]
    want = _reports(c, jax_rl, jax_rl.HW_V5E)
    got = _reports(c, rl, rl.HW_V5E)
    assert dataclasses.asdict(rl.HW_V5E) == dataclasses.asdict(jax_rl.HW_V5E)
    for prop in ("t_collective", "dominant", "useful_flops_ratio",
                 "bound_time", "roofline_fraction"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.fits_hbm() == want.fits_hbm()
    assert got.collectives.total_bytes == want.collectives.total_bytes
    row, ref_row = got.row(), want.row()
    assert row.pop("fits_hbm") == ref_row["fits_16GiB"]
    assert row == ref_row
    # make_report forms the same terms from the same counts
    made = rl.make_report("x", c["chips"], c["hlo_flops"], c["hlo_bytes"],
                          got.collectives, c["model_flops"], c["peak"],
                          rl.HW_V5E)
    assert made.row() == got.row()


def test_h100_entry_is_the_data_sheet():
    hw = rl.HW_H100
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.dcn_bw) == (
        67e12, 3.35e12, 450e9, 50e9)
    assert rl.h100().hbm_bytes == hw.hbm_bytes      # no card here


def test_compute_term_takes_each_product_type_at_its_peak():
    """bf16 and fp16 products at the H100's 989 TFLOP/s, f32 at 67; the
    TPU entry's one peak for all; op_cost splits the FLOPs by the type of
    the product's inputs."""
    from repro_torch.analysis import op_cost

    hw = rl.HW_H100
    assert rl.peak_for(hw, "bfloat16") == rl.peak_for(hw, "float16") \
        == 989e12
    assert rl.peak_for(hw, "float32") == rl.peak_for(rl.h100(),
                                                     "float32") == 67e12
    assert rl.peak_for(rl.HW_V5E, "bfloat16") == rl.HW_V5E.peak_flops
    r = rl.make_report("x", 1, 3e12, 0.0, rl.empty_stats(), 0.0, 0.0, hw,
                       flops_by_dtype={"bfloat16": 2e12, "float32": 1e12})
    assert r.t_compute == 2e12 / 989e12 + 1e12 / 67e12
    assert rl.make_report("x", 1, 3e12, 0.0, rl.empty_stats(), 0.0, 0.0,
                          hw).t_compute == 3e12 / 67e12
    t = op_cost.analyze_fn(lambda a, b, c: (a @ b, c @ c),
                           torch.ones(4, 8, dtype=torch.bfloat16),
                           torch.ones(8, 2, dtype=torch.bfloat16),
                           torch.ones(3, 3))
    assert t.flops_by_dtype == {"bfloat16": 2 * 4 * 8 * 2,
                                "float32": 2 * 3 * 3 * 3}
    assert t.flops == sum(t.flops_by_dtype.values())


_CFG = DPConfig(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(96,),
                type_map=("Cu",), embed_widths=(8, 16, 32), axis_neuron=4,
                fit_widths=(24, 24, 24), table_lower=-1.0, table_upper=9.0)


class _Tally(comm_mod.RankComm):
    """Wraps one ``LocalComm`` rank and logs what each of its calls hands
    over: (kind, bytes, group size)."""

    def __init__(self, inner, log):
        self.inner, self.log = inner, log
        for k in ("n_spatial", "n_model", "spatial_index", "model_index"):
            setattr(self, k, getattr(inner, k))

    def ppermute(self, xs, pairs):
        out = self.inner.ppermute(xs, pairs)
        self.log.append(("collective-permute", sum(
            t.numel() * t.element_size() for t in out), self.n_spatial))
        return out

    def _red(self, x, axis, fn):
        out = fn(x, axis)
        if self.axis_size(axis) > 1:
            self.log.append(("all-reduce", x.numel() * x.element_size(),
                             self.axis_size(axis)))
        return out

    def psum(self, x, axis):
        return self._red(x, axis, self.inner.psum)

    def pmax(self, x, axis):
        return self._red(x, axis, self.inner.pmax)


@pytest.mark.parametrize("n_model,decomp", [(1, "atoms"), (2, "atoms"),
                                            (2, "slots")])
def test_dry_run_comm_counts_what_a_step_moves(n_model, decomp):
    """Every rank of a 2-brick step: the counting communicator, run alone,
    counts the bytes (by kind and on the wire) of the calls that the same
    rank makes through ``LocalComm`` with its neighbours present."""
    pos, typ, box = lattice.fcc_copper(6, 3, 3)
    rng = np.random.default_rng(0)
    pos = np.mod(pos + rng.normal(0, 0.05, pos.shape), box)
    spec = domain.DomainSpec.for_topology(tuple(box), (2,), 400, 300, 6.0)
    state, _ = domain.partition_atoms(pos, np.zeros_like(pos), typ, spec)
    local = domain.make_local_md_step(_CFG, spec, n_model, (63.546,), 1.0,
                                      impl="cheb", decomp=decomp,
                                      neighbor="cells")
    params = dp_model.tabulate_model(dp_model.init_dp_params(
        torch.Generator().manual_seed(0), _CFG, device="cpu"), _CFG, "cheb")
    boxt = torch.as_tensor(box, dtype=torch.float32)

    def one_step(rank):
        brick = domain.SlabState(*(x[rank.spatial_index] for x in state))
        with torch.no_grad():
            return domain.run_brick_steps(rank, local.step, params,
                                          (brick, (), boxt, ()), 1)

    logs = {}
    lc = comm_mod.LocalComm(2, n_model, device="cpu")
    lc.run(lambda r: one_step(_Tally(r, logs.setdefault(r.rank, []))))
    assert sorted(logs) == list(range(2 * n_model))
    for r, log in logs.items():
        dry = comm_mod.DryRunComm(2, n_model, *divmod(r, n_model))
        one_step(dry)
        want = {k: 0.0 for k in KINDS}
        for kind, n, _ in log:
            want[kind] += n
        assert want["collective-permute"] > 0 and want["all-reduce"] > 0
        assert dry.stats.bytes_by_kind == want
        assert dry.stats.count == len(log)
        assert dry.stats.wire_bytes_ici == pytest.approx(sum(
            n * rl._wire_factor(kind, g) for kind, n, g in log), rel=1e-12)
        assert dry.stats.wire_bytes_dcn == 0.0


def test_dry_run_comm_wire_bytes_and_the_pod_axis():
    """Wire factors take the axis size as the group size; a spatial
    reduction crosses pods when the spatial axis spans more than one, a
    model reduction and a ppermute never do."""
    x = torch.zeros(25)                                     # 100 bytes
    c = comm_mod.DryRunComm(4, 3)
    c.psum(x, c.SPATIAL)
    c.pmax(x, c.MODEL)
    c.ppermute((x, x[:5]), [(0, 1)])
    assert c.stats.bytes_by_kind["all-reduce"] == 200.0
    assert c.stats.bytes_by_kind["collective-permute"] == 120.0
    assert c.stats.wire_bytes_ici == pytest.approx(
        100 * 2 * 3 / 4 + 100 * 2 * 2 / 3 + 120)
    assert c.stats.wire_bytes_dcn == 0.0
    pods = comm_mod.DryRunComm(32, 16, spatial_index=5, model_index=3,
                               pods=2)
    pods.psum(x, pods.SPATIAL)
    pods.psum(x, pods.MODEL)
    pods.ppermute((x,), [(0, 1)])
    assert pods.stats.wire_bytes_dcn == pytest.approx(100 * 2 * 31 / 32)
    assert pods.stats.wire_bytes_ici == pytest.approx(100 * 2 * 15 / 16
                                                      + 100)
    one = comm_mod.DryRunComm(4, 1)
    assert one.psum(x, one.MODEL) is x and one.stats.count == 0
    got = c.ppermute((x,), [(0, 1)])[0]
    assert got is not x and torch.equal(got, x)
    with pytest.raises(ValueError):
        comm_mod.DryRunComm(4, 2, spatial_index=4)
