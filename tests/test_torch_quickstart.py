"""``examples/quickstart_torch.py``, the port's counterpart of
``examples/quickstart.py``, run whole on the CPU in a subprocess that
refuses any import of JAX or of the reference package: train, tabulate to
``cheb``, 99 MD steps, the compressed model against the original on the
last frame."""

from __future__ import annotations

import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "examples", "quickstart_torch.py")


def test_quickstart_runs_on_the_cpu_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            f"sys.argv = [{SCRIPT!r}, '--device', 'cpu']; "
            f"exec(compile(open({SCRIPT!r}).read(), {SCRIPT!r}, 'exec'))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    out = r.stdout
    assert "quickstart complete." in out
    assert "108 atoms, 99 steps on cpu" in out
    drift = float(re.search(r"energy drift ([0-9.e+-]+) eV", out).group(1))
    de, df = map(float, re.search(
        r"dE = ([0-9.e+-]+) eV, max \|dF\| = ([0-9.e+-]+)", out).groups())
    assert drift < 1e-3 and de < 1e-3 and df < 1e-3, (drift, de, df)
