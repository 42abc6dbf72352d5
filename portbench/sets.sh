# Measure cells on the card as the bounds of BENCHMARK.json were set:
# for each cell, one short run that builds the kernels (its set-up is kept
# apart), two sets of 6 runs on the same 6 seeds, 6 runs on further seeds
# and 3 traced runs, each a process of its own. Each run's result line is
# appended to chiprun_out/meas/<cell>.jsonl with its tag, seed and wall
# time; its output and errors are kept beside it.
#
#   bash portbench/sets.sh <run_seconds> <cell> [<cell> ...]
set -u
SEC=$1; shift
OUT=chiprun_out/meas; mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
one() { # cell tag seed trace seconds
  local f="$OUT/$1_$2_$3_$4" t0
  t0=$(date +%s%N)
  python3 portbench/run.py --workload "$1" --seed "$3" --seconds "$5" --trace "$4" > "$f.out" 2> "$f.err"
  local rc=$? wall=$(( ($(date +%s%N) - t0) / 1000000 ))
  local line; line=$(tail -1 "$f.out" | grep '^{' || echo null)
  echo "{\"cell\": \"$1\", \"tag\": \"$2\", \"seed\": $3, \"trace\": $4, \"rc\": $rc, \"wall_ms\": $wall, \"result\": $line}" >> "$OUT/$1.jsonl"
  echo "$1 $2 seed $3 trace $4 rc=$rc wall=${wall}ms"
}
for c in "$@"; do
  base=$(( 7000000000 + $(echo "$c" | cksum | cut -c1-5) * 1000 ))
  one "$c" build $((base + 999)) 0 3
  for s in 1 2 3 4 5 6; do one "$c" setA $((base + s)) 0 "$SEC"; done
  for s in 1 2 3 4 5 6; do one "$c" setB $((base + s)) 0 "$SEC"; done
  for s in 7 8 9 10 11 12; do one "$c" extra $((base + s)) 0 "$SEC"; done
  for s in 13 14 15; do one "$c" trace $((base + s)) 1 "$SEC"; done
done
