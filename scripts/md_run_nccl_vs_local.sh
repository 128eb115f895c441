#!/bin/bash
# Distributed MD on several cards against the same run on one card.
#
#   bash scripts/md_run_nccl_vs_local.sh [OUT_DIR]     # needs 4 NVIDIA GPUs
#
# Runs `python -m repro_torch.launch.md_run` with the same flags, for two
# rank grids (2x2 bricks x model axis 1, and 2 slabs x model axis 2), three
# ways: under torchrun on 4 processes (DistComm over NCCL, one card each)
# with --engine outer, where each process captures its rank's segments as
# CUDA graphs and replays them; under torchrun with --engine scan, eager;
# and with --local-ranks 4 (LocalComm: 4 threads on card 0). Prints each
# run's thermo lines and the captured run's captures line, then the largest
# relative difference of the printed energies: captured against eager
# (limit 1e-6) and against --local-ranks (1e-5). Each run's output is kept
# in OUT_DIR (default build/md_run_compare). torchrun --standalone picks a
# free localhost port for its rendezvous, so two checkouts can run the
# script on one machine at once. Exits non-zero if a run or a comparison
# failed.
set -u
cd "$(dirname "$0")/.."
out=${1:-build/md_run_compare}
mkdir -p "$out"
export PYTHONPATH=src
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
common="--nx 6 --nyz 6 --steps 99 --rebuild-every 33 --impl cheb_pallas"
status=0
i=0
for grid in "--topology 2x2 --model-axis 1" "--topology 2 --model-axis 2"; do
  i=$((i + 1))
  for engine in outer scan; do
    timeout 300 python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.md_run $grid $common \
        --engine $engine > "$out/nccl_$engine$i.txt" 2> "$out/nccl_$engine$i.err"
    rc=$?
    echo "== $grid: torchrun (NCCL) --engine $engine rc=$rc"
    [ $rc -eq 0 ] || status=1
    cat "$out/nccl_$engine$i.txt"
  done
  timeout 300 python -m repro_torch.launch.md_run --local-ranks 4 $grid \
      $common > "$out/local$i.txt" 2>&1
  rc=$?
  echo "== $grid: --local-ranks 4 (LocalComm) rc=$rc"
  [ $rc -eq 0 ] || status=1
  cat "$out/local$i.txt"
  python - "$out/nccl_outer$i.txt" "$out/nccl_scan$i.txt" \
      "$out/local$i.txt" <<'PY' || status=1
import re
import sys


def energies(path):
    return [float(v) for line in open(path) if line.startswith("step")
            for v in re.findall(r"E_(?:pot|tot) ([-+0-9.]+)", line)]


graph, eager, local = (energies(p) for p in sys.argv[1:])
bad = False
for what, other, rtol in (("eager (torchrun --engine scan)", eager, 1e-6),
                          ("--local-ranks 4", local, 1e-5)):
    rel = max((abs(x - y) / max(abs(y), 1e-30) for x, y in zip(graph, other)),
              default=float("nan"))
    ok = len(graph) == len(other) > 0 and rel <= rtol
    bad |= not ok
    print(f"compare captured vs {what}: {len(graph)} vs {len(other)} "
          f"energies, max rel diff {rel:.3e} (limit {rtol:g}) "
          f"{'ok' if ok else 'FAIL'}")
sys.exit(1 if bad else 0)
PY
done
exit $status
