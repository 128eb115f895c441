"""The harness on the CPU: the manifest, a whole run of a tiny cell, the
faults that must turn ``correct`` false, the control, and the import guard.

    python -m pytest -q mdbench/tests
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from conftest import (MDBENCH, ROOT, TINY_BRICK_LIMITS,  # noqa: E402
                      TINY_LIMITS)
from mdbench import control, manifest  # noqa: E402
from mdbench import run as bench_run  # noqa: E402


def _cell(tiny_base):
    path, base = tiny_base
    return manifest.load("tiny", path, base)


# ------------------------------------------------------------ manifest

@pytest.mark.parametrize("name", ["cu.weak.1card", "h2o.weak.1card",
                                  "cu.strong.1card"])
def test_every_cell_of_the_benchmark_resolves(name):
    cell = manifest.load(name)
    assert cell.config["name"] == cell.config_name
    assert cell.traffic["entry"] == "simulation"
    assert {m.name for m in cell.end_to_end} >= {"us_per_step_atom",
                                                 "mem_bytes_per_atom",
                                                 "setup_s"}
    assert cell.per_layer
    assert set(cell.limits) <= {"pe_rows", "ke_rows", "vel_end", "pos_end",
                                "pe_end"}
    manifest.entry_class(cell.traffic["entry"])


def test_benchmark_json_keeps_to_its_shape():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (MDBENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()
    for w in bench["workloads"]:
        assert (MDBENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert len(w["why"]) <= 200


def test_a_new_cell_file_is_found_without_edits(tiny_base):
    path, base = tiny_base
    bench = json.loads(path.read_text())
    traffic = json.loads((base / "traffic" / "tiny.json").read_text())
    traffic["steps"] = 7
    (base / "traffic" / "tiny7.json").write_text(json.dumps(traffic))
    bench["workloads"].append({"name": "tiny7", "config": "tiny_cu",
                               "traffic": "tiny7", "chips": 1, "why": "x"})
    path.write_text(json.dumps(bench))
    cell = manifest.load("tiny7", path, base)
    assert cell.traffic["steps"] == 7 and cell.limits == {}
    # a new per-layer reader is found the same way
    (base / "metrics" / "tiny.count.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench["per_layer"].append({"name": "tiny.count", "unit": "n",
                               "better": "lower", "source": "host_clock",
                               "layer": "x", "moves": "us_per_step_atom",
                               "workloads": ["tiny7"]})
    path.write_text(json.dumps(bench))
    cell = manifest.load("tiny7", path, base)
    assert [m.read(None) for m in cell.per_layer
            if m.name == "tiny.count"] == [42.0]


# ------------------------------------------------------------ a whole run

def test_tiny_cell_runs_and_is_correct(tiny_base):
    out = bench_run.run_cell(_cell(tiny_base), 2**31 + 12345, 0.2, False,
                             device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert {k: v["limit"] for k, v in out["checks"].items()} == TINY_LIMITS
    assert out["metrics"]["us_per_step_atom"]["value"] > 0


def test_same_seed_same_inputs_and_numbers(tiny_base):
    a = bench_run.run_cell(_cell(tiny_base), 3_000_000_017, 0.0, False,
                           device="cpu")
    b = bench_run.run_cell(_cell(tiny_base), 3_000_000_017, 0.0, False,
                           device="cpu")
    assert a["checks"] == b["checks"]


def _break(monkeypatch, fault: str):
    from repro_torch.core import dp_model
    from repro_torch.md import stepper

    if fault == "state_unchanged":
        make = stepper.make_md_step

        def make_stuck(*a, **k):
            step = make(*a, **k)

            def stuck(carry, *aux):
                _, th = step(carry, *aux)
                return carry, th
            return stuck
        monkeypatch.setattr(stepper, "make_md_step", make_stuck)
    elif fault == "half_the_atoms":
        energy = dp_model.dp_energy

        def half(params, cfg, rij, nmask, atype, amask, *a, **k):
            e_i = dp_model.dp_atomic_energy(params, cfg, rij, nmask, atype,
                                            *a, **k)
            n = e_i.shape[-1] // 2
            return torch.mean(e_i[..., :n], dim=-1) * e_i.shape[-1]
        monkeypatch.setattr(dp_model, "dp_energy", half)
        assert energy is not half
    elif fault == "force_altered":
        forces = dp_model.energy_forces_from_rij

        def altered(*a, **k):
            e, f, v = forces(*a, **k)
            f = f.clone()
            f[0, 0] += 0.01
            return e, f, v
        monkeypatch.setattr(dp_model, "energy_forces_from_rij", altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_atoms",
                                   "force_altered"])
def test_a_broken_timed_path_is_not_correct(tiny_base, monkeypatch, fault):
    _break(monkeypatch, fault)
    out = bench_run.run_cell(_cell(tiny_base), 2**31 + 99, 0.0, False,
                             device="cpu")
    assert not out["correct"], (fault, out["checks"])
    assert out["failed"] >= 1


@pytest.mark.parametrize("seed", [2**31 + 5, 2**31 + 6, 2**31 + 7])
def test_the_tf32_control_is_not_correct(tiny_base, seed):
    numbers, out = control.control_outcome(_cell(tiny_base), seed, "cpu")
    assert out.limits == {k: TINY_LIMITS[k] for k in numbers}
    assert not out.correct, out.line()
    assert out.failed == 1


# ------------------------------------------------------------ imports

def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_port():
    for path in (MDBENCH / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"repro_torch", "repro", "jax", "jaxlib"}, path
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import mdbench.reference.se_e2_a, mdbench.reference.md, "
            "mdbench.reference.shared; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % (str(ROOT / "src"), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert "repro_torch" not in out and "'jax'" not in out


GUARD = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
from mdbench import manifest, run


def shrink(cell):
    cell.traffic = dict(cell.traffic, steps=2, warmup_steps=1,
                        check=dict(cell.traffic["check"], follow_steps=2))
    cell.traffic["system"] = dict(cell.traffic["system"], cells={cells!r})
    cell.config = dict(cell.config, embed_widths=[4, 8, 16],
                       fit_widths=[8, 8, 8], axis_neuron=4, cheb_order=8)
    return cell


if __name__ == "__main__":
    cell = shrink(manifest.load({name!r}))
    run.run_cell(cell, 2**31 + 1, 0.0, False, device="cpu")
    print(json.dumps(run.forbidden_modules()))
"""


@pytest.mark.parametrize("name,cells", [("cu.weak.1card", [6, 6, 6]),
                                        ("h2o.weak.1card", [2, 2, 2]),
                                        ("cu.strong.1card", [6, 6, 6])])
def test_a_cpu_run_of_each_cell_loads_no_jax(name, cells, tmp_path):
    """Each cell's own entry and check, at a tiny size and narrow widths on
    the CPU, in a fresh interpreter: no module whose whole top-level name is
    jax, jaxlib, flax or repro is loaded."""
    script = tmp_path / "guard.py"
    script.write_text(GUARD.format(src=str(ROOT / "src"), root=str(ROOT),
                                   name=name, cells=cells))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


# ------------------------------------------------------- several ranks

def _bricks(tiny_base, **kw):
    from mdbench import ranks
    path, base = tiny_base
    return ranks.launch("tiny_bricks", 2**31 + 5, 0.0, False, "cpu", 4,
                        str(path), str(base), **kw)


def test_four_ranks_over_gloo_run_and_are_correct(tiny_base):
    out = _bricks(tiny_base)
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4
    assert set(out["checks"]) == set(TINY_BRICK_LIMITS)


def test_the_exchange_left_out_is_not_correct(tiny_base):
    import _mdbench_ranks
    out = _bricks(tiny_base, target=_mdbench_ranks.no_exchange)
    assert not out["correct"], out["checks"]
