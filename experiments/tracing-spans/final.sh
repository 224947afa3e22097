#!/usr/bin/env bash
# The committed files alone, on one card: a checkout unpacked from
# `git archive $(git write-tree)` runs a traced run of every cell as the
# driver starts it (benchmark/run.py --trace 1), then untraced runs of every
# cell in turns against the parent (parent, change, change, parent; each
# pair on a seed of its own), twice.
#
#   bash experiments/tracing-spans/final.sh <out-dir> <parent-tarball> <change-tarball>
set -u
out=$1
mkdir -p "$out"
here=$(pwd)
parent=$here/_archive/parent
change=$here/_archive/change
rm -rf "$parent" "$change" && mkdir -p "$parent" "$change"
tar -xf "$2" -C "$parent" && tar -xf "$3" -C "$change" || exit 1
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader
build='from lbm_tpu_torch.ops import _build; _build.load("d2q9_kstep"); _build.load("d3q19_kstep")'
(cd "$parent" && python -X pycache_prefix=build/pycache -c "$build") &&
  (cd "$change" && python -X pycache_prefix=build/pycache -c "$build") || exit 1
run() {  # side cell seed trace
  local dir=$change
  [ "$1" = parent ] && dir=$parent
  (cd "$dir" && python3 benchmark/run.py --workload "$2" --seed "$3" --seconds 10 --trace "$4") \
    > "$out/$2.$1.$3.t$4.json" 2> "$out/$2.$1.$3.t$4.err"
  echo "$1 $2 $3 trace=$4 rc=$? $(tail -n 1 "$out/$2.$1.$3.t$4.json" | cut -c1-900)"
}
cells="d2q9-cavity.f32 d3q19-channel.f32 d3q19-channel.bf16"
seed=2147484300
for cell in $cells; do
  seed=$((seed + 1)); run change $cell $seed 1
done
for round in 1 2; do
  for cell in $cells; do
    run parent $cell $((seed + 1)) 0; run change $cell $((seed + 1)) 0
    run change $cell $((seed + 2)) 0; run parent $cell $((seed + 2)) 0
    seed=$((seed + 10))
  done
done
