# Measure one cell as the benchmark's bounds need it, from the root of a checkout:
#   OUT=<dir> bash portbench/measure.sh <cell> "<set seeds>" "<traced seeds>" "<extra seeds>" "<control seeds, comma-separated>" <control seconds>
# Two sets of untraced runs on the same seeds, the traced runs, more untraced
# runs on new seeds, then the control; each result line goes to $OUT/lines.tsv
# under its tag (A, B, T, X), each run's output and errors to files of its own.
cell=$1; out=${OUT:?set OUT to the output directory}; mkdir -p "$out"
secs=$(python3 -c "import json; print(json.load(open('BENCHMARK.json'))['run_seconds'])")
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
run() {
  tag=$1; seed=$2; tr=$3; s=$(date +%s)
  timeout 330 python3 -m portbench.run --workload "$cell" --seed "$seed" --seconds "$secs" --trace "$tr" \
    > "$out/$tag-$seed.out" 2> "$out/$tag-$seed.err"
  rc=$?
  printf '%s\t' "$tag" >> "$out/lines.tsv"; tail -n 1 "$out/$tag-$seed.out" >> "$out/lines.tsv"
  echo "$tag $seed rc=$rc wall=$(( $(date +%s) - s )) $(tail -n 1 "$out/$tag-$seed.out" | cut -c1-300)"
}
for s in $2; do run A "$s" 0; done
for s in $2; do run B "$s" 0; done
for s in $3; do run T "$s" 1; done
for s in $4; do run X "$s" 0; done
if [ -n "$5" ]; then
  s0=$(date +%s)
  timeout 1200 python3 -m portbench.control --workload "$cell" --seeds "$5" --seconds "$6" \
    > "$out/control.jsonl" 2> "$out/control.err"
  echo "control rc=$? wall=$(( $(date +%s) - s0 ))"; grep '"control"' "$out/control.jsonl" | cut -c1-400
fi
