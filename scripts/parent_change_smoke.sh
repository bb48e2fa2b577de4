#!/bin/bash
# Parent against change on one card, in one call: profile_lv on the LV
# adaptive path (pallas and xla, direct adjoint, parent, change, change,
# parent; then the change's continuous adjoints), and the whole
# chip_smoke.py in the same alternating order, every output line stamped
# with its seconds since the script's start.
#
#   git archive <parent> | tar -x -C chipcheck/parent
#   git archive $(git write-tree) | tar -x -C chipcheck/change
#   chiprun --timeout 3600 -- bash scripts/parent_change_smoke.sh
#   python3 scripts/smoke_phase_seconds.py chiprun_out/m20
#
# Both trees lie in a gitignored directory of the repo (chipcheck/ by
# default; PARENT= and CHANGE= name others). Writes chiprun_out/m20/:
# profile.jsonl (a label line before each profile_lv record), smoke_<run>.log,
# smoke_summary.txt. The profiler's own processing of an adjoint
# iteration's ~50k launches takes minutes on the host: keep their
# --iters small.
set -u
cd "$(dirname "$0")/.."
ROOT=$(pwd)
PARENT=${PARENT:-chipcheck/parent}
CHANGE=${CHANGE:-chipcheck/change}
OUT=$ROOT/chiprun_out/m20
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
stamp() { python3 -c '
import sys, time
t0 = time.time()
for l in sys.stdin:
    sys.stdout.write(f"{time.time() - t0:.3f} {l}"); sys.stdout.flush()'; }
tree() { if [ "$1" = parent ]; then echo "$PARENT"; else echo "$CHANGE"; fi; }
prof() {  # parent|change impl adjoint iters warmup
  echo "{\"tree\": \"$1\", \"impl\": \"$2\", \"adjoint\": \"$3\"}" >> "$OUT/profile.jsonl"
  (cd "$(tree "$1")" && timeout 400 python3 -m kanodes_tpu_torch.experiments.profile_lv \
     --solve_mode=adaptive --impl="$2" --adjoint="$3" --lr=5e-3 --iters="$4" --warmup="$5") \
     >> "$OUT/profile.jsonl" 2>> "$OUT/profile.err"
  echo "profile $1 $2 $3 rc=$?"
}
smoke() {  # parent|change label
  local t0=$(date +%s.%N)
  (cd "$(tree "$1")" && timeout 1200 python3 chip_smoke.py) 2>&1 | stamp > "$OUT/smoke_$2.log"
  local rc=${PIPESTATUS[0]}
  local t1=$(date +%s.%N)
  echo "smoke $2 rc=$rc seconds=$(python3 -c "print($t1 - $t0)")" | tee -a "$OUT/smoke_summary.txt"
  tail -n 2 "$OUT/smoke_$2.log"
}
for t in parent change change parent; do prof $t pallas direct 20 5; done
for t in parent change change parent; do prof $t xla direct 10 3; done
for a in backsolve interpolating; do prof change pallas $a 8 2; prof change xla $a 5 2; done
smoke parent p1
smoke change c1
smoke change c2
smoke parent p2
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee -a "$OUT/card.txt"
