#!/usr/bin/env bash
# Traced runs of d2q9-cavity.f32, parent against change on one card, in
# turns (parent, change, change, parent; each pair on a seed of its own),
# through experiments/tracing-spans/traced_split.py: the runner's split and
# where in the warm-up and timed loops the device waits. The parent as in
# ab.sh.
#
#   bash experiments/runner-warm-up/traced.sh <out-dir> <parent-tarball> [<pairs>]
set -u
out=$1
pairs=${3:-2}
mkdir -p "$out"
here=$(pwd)
parent=$here/_archive/parent
rm -rf "$parent" && mkdir -p "$parent"
tar -xf "$2" -C "$parent" || exit 1
cp -r benchmark BENCHMARK.json "$parent"/
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader
build='from lbm_tpu_torch.ops import _build; _build.load("d2q9_kstep")'
(cd "$parent" && python -X pycache_prefix=build/pycache -c "$build") &&
  python -X pycache_prefix=build/pycache -c "$build" || exit 1
cell=d2q9-cavity.f32
traced() {  # side seed
  local root=$here
  [ "$1" = parent ] && root=$parent
  python3 experiments/tracing-spans/traced_split.py --root "$root" --workload $cell \
    --seed "$2" --seconds 10 > "$out/$cell.$1.$2.traced.json" 2> "$out/$cell.$1.$2.traced.err"
  echo "traced $1 $2 rc=$?"
  tail -n 2 "$out/$cell.$1.$2.traced.json" | python3 -c '
import json, sys
lines = sys.stdin.read().splitlines()
run, split = json.loads(lines[0]), json.loads(lines[1])
print(json.dumps({"metrics": {k: v["value"] for k, v in run["metrics"].items()},
                  "device": {k: run["device"][k] for k in ("busy_s", "window_s")},
                  **{k: split.get(k) for k in ("passes_in", "gap_profile", "terms_ms_per_job",
                                               "runner_ms_per_job")}}))'
}
seed=2147485300
for p in $(seq "$pairs"); do
  if [ $((p % 2)) = 1 ]; then traced parent $((seed + p)); traced change $((seed + p))
  else traced change $((seed + p)); traced parent $((seed + p)); fi
done
