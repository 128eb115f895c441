#!/bin/bash
# Distributed MD on several cards against the same run on one card.
#
#   bash scripts/md_run_nccl_vs_local.sh [OUT_DIR]     # needs 4 NVIDIA GPUs
#
# Runs `python -m repro_torch.launch.md_run` under torchrun on 4 processes
# (DistComm over NCCL, one card each) and again with --local-ranks 4
# (LocalComm: 4 threads on card 0), with the same flags, for two rank grids:
# 2x2 bricks x model axis 1, and 2 slabs x model axis 2. Prints both runs'
# thermo lines and the largest relative difference of the printed energies;
# each run's output is kept in OUT_DIR (default build/md_run_compare).
# torchrun --standalone picks a free localhost port for its rendezvous, so
# two checkouts can run the script on one machine at once.
set -u
cd "$(dirname "$0")/.."
out=${1:-build/md_run_compare}
mkdir -p "$out"
export PYTHONPATH=src
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
common="--nx 6 --nyz 6 --steps 99 --rebuild-every 33 --impl cheb_pallas"
i=0
for grid in "--topology 2x2 --model-axis 1" "--topology 2 --model-axis 2"; do
  i=$((i + 1))
  timeout 300 python -m torch.distributed.run --standalone \
      --nproc-per-node 4 -m repro_torch.launch.md_run $grid $common \
      > "$out/nccl$i.txt" 2> "$out/nccl$i.err"
  echo "== $grid: torchrun (NCCL) rc=$?"
  cat "$out/nccl$i.txt"
  timeout 300 python -m repro_torch.launch.md_run --local-ranks 4 $grid \
      $common > "$out/local$i.txt" 2>&1
  echo "== $grid: --local-ranks 4 (LocalComm) rc=$?"
  cat "$out/local$i.txt"
  python - "$out/nccl$i.txt" "$out/local$i.txt" <<'PY'
import re
import sys


def energies(path):
    return [float(v) for line in open(path) if line.startswith("step")
            for v in re.findall(r"E_(?:pot|tot) ([-+0-9.]+)", line)]


a, b = energies(sys.argv[1]), energies(sys.argv[2])
rel = max((abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b)),
          default=float("nan"))
ok = len(a) == len(b) > 0 and rel < 1e-5
print(f"compare: {len(a)} vs {len(b)} energies, max rel diff {rel:.3e} "
      f"{'ok' if ok else 'FAIL'}")
PY
done
