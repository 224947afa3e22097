#!/usr/bin/env bash
# Parent against change on one card, in one call: digests of whole 2-D jobs
# on both sides (digests.py: bit-equal results), untraced runs of
# d2q9-cavity.f32 in turns (parent, change, change, parent; each pair on a
# seed of its own), a traced run of it on each side through
# experiments/tracing-spans/traced_split.py (the passes inside the warm-up
# and timed runs), then two pairs of each 3-D cell. The parent is a
# checkout of its program and benchmark under _archive/parent, with this
# tree's benchmark laid over it.
#
#   bash experiments/runner-warm-up/ab.sh <out-dir> <parent-tarball> [<rounds>]
set -u
out=$1
tarball=$2
rounds=${3:-3}
mkdir -p "$out"
here=$(pwd)
parent=$here/_archive/parent
rm -rf "$parent" && mkdir -p "$parent"
tar -xf "$tarball" -C "$parent" || exit 1
cp -r benchmark BENCHMARK.json "$parent"/
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))'
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader
build='from lbm_tpu_torch.ops import _build; _build.load("d2q9_kstep"); _build.load("d2q9_manual"); _build.load("d3q19_kstep")'
(cd "$parent" && python -X pycache_prefix=build/pycache -c "$build") &&
  python -X pycache_prefix=build/pycache -c "$build" || exit 1
seed=2147485100
for side in parent change; do
  root=$here
  [ $side = parent ] && root=$parent
  python3 experiments/runner-warm-up/digests.py --root "$root" --seed $seed \
    > "$out/digests.$side.jsonl" 2> "$out/digests.$side.err"
  echo "digests $side rc=$? lines=$(wc -l < "$out/digests.$side.jsonl")"
done
python3 - "$out" <<'PY'
import json, sys
rows = {s: [json.loads(l) for l in open(f"{sys.argv[1]}/digests.{s}.jsonl")]
        for s in ("parent", "change")}
key = lambda r: (r["engine"], r["ran"], r["dtype"], r["steps"], r["state"], r["av_vels"])
same = [key(p) == key(c) for p, c in zip(rows["parent"], rows["change"])]
print("digests equal", sum(same), "of", len(same), "cases;",
      len(rows["parent"]), "parent,", len(rows["change"]), "change")
for p, c in zip(rows["parent"], rows["change"]):
    print(p["engine"], p["ran"], p["dtype"], p["steps"], key(p) == key(c),
          "compute_seconds", round(p["compute_seconds"], 4), round(c["compute_seconds"], 4))
PY
run() {  # side cell seed
  local dir=$here
  [ "$1" = parent ] && dir=$parent
  (cd "$dir" && python3 benchmark/run.py --workload "$2" --seed "$3" --seconds 10 --trace 0) \
    > "$out/$2.$1.$3.json" 2> "$out/$2.$1.$3.err"
  echo "$1 $2 $3 rc=$? $(tail -n 1 "$out/$2.$1.$3.json" | cut -c1-700)"
}
cell=d2q9-cavity.f32
for r in $(seq "$rounds"); do
  run parent $cell $((seed + 1)); run change $cell $((seed + 1))
  run change $cell $((seed + 2)); run parent $cell $((seed + 2))
  seed=$((seed + 10))
done
seed=$((seed + 1))
for side in parent change; do
  root=$here
  [ $side = parent ] && root=$parent
  python3 experiments/tracing-spans/traced_split.py --root "$root" --workload $cell \
    --seed $seed --seconds 10 > "$out/$cell.$side.traced.json" 2> "$out/$cell.$side.traced.err"
  echo "traced $side $cell $seed rc=$? $(tail -n 2 "$out/$cell.$side.traced.json" | cut -c1-1500)"
done
for cell in d3q19-channel.f32 d3q19-channel.bf16; do
  seed=$((seed + 10))
  run parent $cell $((seed + 1)); run change $cell $((seed + 1))
  run change $cell $((seed + 2)); run parent $cell $((seed + 2))
done
