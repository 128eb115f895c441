"""Model families, systems and the port's config found by name: the se_e2_a
family draws the weights the harness drew before families were files, a
family that lives only in a copy of ``mdbench/`` runs a cell, and the
kernel readers of the force-and-virial reduction.

    python -m pytest -q mdbench/tests
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _lj_family  # noqa: E402
from conftest import TINY_CONFIG, TINY_TRAFFIC  # noqa: E402
from mdbench import control, cost, inputs, manifest  # noqa: E402
from mdbench import run as bench_run  # noqa: E402
from mdbench.reference import md  # noqa: E402

# ``inputs.weights_digest`` of ``inputs.weights`` at commit c6f8a92 (before
# families were files), on the CPU from each configuration's model_seed 0;
# the copper model's dstd from its environment statistics on cu.strong's
# system, the water model's unit
PARENT_DIGESTS = {
    "cu.strong.1card":
        "cc8a0b14e1f25a9083ce500ca8428881556a82b6dda81b9176b7362038300d9d",
    "h2o.weak.1card":
        "01fc5ff5413cfd84bcd8672b6ab05301e810baddb9e76335ce38be4020ac1f0b",
}


@pytest.mark.parametrize("name", sorted(PARENT_DIGESTS))
def test_se_e2_a_weights_are_the_ones_drawn_before(name):
    cell = manifest.load(name)
    assert cell.family.__name__ == "mdbench_family_se_e2_a"
    cpu = torch.device("cpu")
    dstd = None
    if cell.config.get("env_scale") == "statistics":
        pos, typ, box = inputs.system(cell.traffic["system"])
        dstd = inputs.env_scale(cell.config, pos, typ, box, cpu)
    w = inputs.weights(cell.config, 0, cpu, dstd)
    direct = cell.family.weights(cell.config, 0, cpu, dstd)
    for (pa, a), (pb, b) in zip(inputs._leaves(w), inputs._leaves(direct)):
        assert pa == pb and torch.equal(a, b), pa
    assert inputs.weights_digest(w) == PARENT_DIGESTS[name]


@pytest.mark.parametrize("name", ["dpmd_copper", "dpmd_water"])
def test_the_ports_config_takes_every_field_the_file_gives(name):
    from repro_torch.core.types import DPConfig

    cfg = json.loads((manifest.HERE / "configs" / f"{name}.json").read_text())
    # the fixed keys that the entries passed before
    keys = ("ntypes", "rcut", "rcut_smth", "sel", "type_map", "embed_widths",
            "axis_neuron", "type_one_side", "fit_widths", "impl",
            "table_lower", "table_upper", "cheb_order", "dtype")
    before = DPConfig(**{k: tuple(cfg[k]) if isinstance(cfg[k], list)
                         else cfg[k] for k in keys})
    assert manifest.config_for(DPConfig, cfg) == before


# ------------------------------------------- a family of its own, as files

# set from the cell's own readings on the CPU: the port against the
# reference at most 3.1e-7 / 7.2e-9 / 2.1e-9 / 9.5e-7 / 2.4e-7 over twelve
# seeds, the TF32 control (pair vectors rounded to TF32) at the least
# 2.5e-5 / 2.0e-6 / 3.6e-6 / 4.7e-5 / 2.2e-6 over four
LJ_LIMITS = {"pe_rows": 2e-6, "ke_rows": 1e-7, "vel_end": 5e-8,
             "pos_end": 5e-6, "pe_end": 1e-6}


@pytest.fixture
def lj_cell(tiny_base):
    """The tiny cell's traffic under a Lennard-Jones family whose files
    exist only in the test's copy of ``mdbench/``."""
    path, base = tiny_base
    for rel, text in _lj_family.FILES.items():
        (base / rel).write_text(text)
    (base / "configs" / "lj_cu.json").write_text(
        json.dumps(_lj_family.CONFIG))
    (base / "traffic" / "lj.json").write_text(
        json.dumps(dict(TINY_TRAFFIC, entry="lj")))
    (base / "limits" / "lj.json").write_text(
        json.dumps({"limits": LJ_LIMITS}))
    bench = json.loads(path.read_text())
    bench["configs"].append({"name": "lj_cu", "source": "test",
                             "file": "mdbench/configs/lj_cu.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "lj", "config": "lj_cu",
                               "traffic": "lj", "chips": 1, "why": "test"})
    path.write_text(json.dumps(bench))
    cell = manifest.load("lj", path, base)
    assert cell.family.__name__ == "mdbench_family_lj"
    assert not (manifest.HERE / "reference" / "lj.py").exists()
    return cell


def test_a_family_in_new_files_runs_a_cell_and_is_correct(lj_cell):
    out = bench_run.run_cell(lj_cell, 2**31 + 4242, 0.2, False,
                             device="cpu")
    assert out["correct"], out["checks"]
    assert {k: v["limit"] for k, v in out["checks"].items()} == LJ_LIMITS
    assert out["metrics"]["us_per_step_atom"]["value"] > 0


def test_a_family_in_new_files_fails_an_altered_force(lj_cell, monkeypatch):
    from repro_torch.core import dp_model

    forces = dp_model.energy_forces_from_rij

    def altered(*a, **k):
        e, f, v = forces(*a, **k)
        f = f.clone()
        f[0, 0] += 0.01
        return e, f, v
    monkeypatch.setattr(dp_model, "energy_forces_from_rij", altered)
    out = bench_run.run_cell(lj_cell, 2**31 + 99, 0.0, False, device="cpu")
    assert not out["correct"], out["checks"]


def test_the_control_reaches_the_familys_reference(lj_cell):
    numbers, out = control.control_outcome(lj_cell, 2**31 + 5, "cpu")
    assert not out.correct, out.line()


# ------------------------------------- readers of the force-and-virial pass

VIRIAL = "void (anonymous namespace)::prod_force_virial_kernel(float const*)"
FINISH = "void (anonymous namespace)::prod_force_finish_kernel(float*)"


def _traced(kernels):
    return types.SimpleNamespace(
        profile={"kernels": kernels, "device_s": sum(t for _, t, _ in
                                                     kernels)},
        check=types.SimpleNamespace(live_pairs=[3000, 5000],
                                    filled_pairs=12_000),
        calls=[types.SimpleNamespace(sel=(40, 80))], atoms=100, extra={})


def test_the_reduction_readers_on_a_synthetic_profile():
    run = _traced([("gemm", 6e-3, 10), (VIRIAL, 3e-4, 10),
                   (FINISH, 1e-4, 10)])
    share = manifest.reader("model.scatter_share").read(run)
    assert share == pytest.approx(100.0 * 4e-4 / 6.4e-3)
    # bytes: (12,000 filled + 100 centres x 2 sections' -1) x 8, not the
    # 100 x 120 slots of the padded rows; 8000 live x 24; 100 rows x 12
    bound = (97_600 + 192_000 + 1_200) / cost.HBM_BYTES_PER_S
    roof = manifest.reader("prod_force_virial_roofline").read(run)
    assert roof == pytest.approx(100.0 * bound / 4e-5)
    assert cost.force_virial_bound_s(8000, 12_000, 100, 2, 100)[1] == "bytes"
    # an untraced check counts no filled slots: nothing to read
    run.check.filled_pairs = None
    assert manifest.reader("prod_force_virial_roofline").read(run) is None


def test_the_reduction_readers_find_nothing_without_its_kernels():
    run = _traced([("gemm", 6e-3, 10), ("indexFuncLargeIndex", 1e-3, 3)])
    for name in ("model.scatter_share", "prod_force_virial_roofline"):
        assert manifest.reader(name).read(run) is None


def test_a_traced_check_counts_the_filled_slots(tiny_base, monkeypatch):
    """The roofline's filled slots: every pair within rcut + skin at the
    followed call's end, by the reference's own table; none untraced."""
    from mdbench import check
    from mdbench.reference.shared import neighbor_table

    from test_mdbench_harness import _cell

    seen = []
    held = check.run_check

    def run_check(run):
        out = held(run)
        seen.append((run, out))
        return out
    monkeypatch.setattr(check, "run_check", run_check)
    bench_run.run_cell(_cell(tiny_base), 2**31 + 7, 0.0, False,
                       device="cpu")
    (run, untraced), = seen
    assert untraced.filled_pairs is None
    run.trace = True                   # a traced run's check, profiler aside
    traced = held(run)
    assert traced.numbers == untraced.numbers
    k = check.sampled_call(run.seed, len(run.calls))
    x = torch.as_tensor(run.calls[k].pos, dtype=torch.float32)
    rc = TINY_CONFIG["rcut"] + TINY_TRAFFIC["skin"]
    box = torch.as_tensor(run.box, dtype=torch.float32)
    want = int((neighbor_table(x, box, rc) >= 0).sum())
    assert traced.filled_pairs == want > sum(traced.live_pairs) > 0
