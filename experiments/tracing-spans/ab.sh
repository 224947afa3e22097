#!/usr/bin/env bash
# Parent against change on one card, in one call: untraced runs of every
# cell in turns (parent, change, change, parent; each pair on a seed of its
# own), then a traced run of each cell on each side through traced_split.py.
# The parent is a checkout of its program and benchmark under
# _archive/parent, with this tree's benchmark laid over it, as traced runs
# are checked.
#
#   bash experiments/tracing-spans/ab.sh <out-dir> <parent-commit-tarball>
set -u
out=$1
tarball=$2
mkdir -p "$out"
here=$(pwd)
parent=$here/_archive/parent
rm -rf "$parent" && mkdir -p "$parent"
tar -xf "$tarball" -C "$parent"
cp -r benchmark BENCHMARK.json "$parent"/
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))'
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader
build='from lbm_tpu_torch.ops import _build; _build.load("d2q9_kstep"); _build.load("d3q19_kstep")'
(cd "$parent" && python -c "$build") && python -c "$build" || exit 1
seed=2147484200
run() {  # side cell seed trace
  local dir=$here
  [ "$1" = parent ] && dir=$parent
  (cd "$dir" && python3 benchmark/run.py --workload "$2" --seed "$3" --seconds 10 --trace 0) \
    > "$out/$2.$1.$3.json" 2> "$out/$2.$1.$3.err"
  echo "$1 $2 $3 rc=$? $(tail -c 400 "$out/$2.$1.$3.json")"
}
for cell in d2q9-cavity.f32 d3q19-channel.f32 d3q19-channel.bf16; do
  run parent $cell $((seed + 1)); run change $cell $((seed + 1))
  run change $cell $((seed + 2)); run parent $cell $((seed + 2))
  seed=$((seed + 10))
done
for cell in d2q9-cavity.f32 d3q19-channel.f32 d3q19-channel.bf16; do
  seed=$((seed + 1))
  for side in parent change; do
    root=$here
    [ $side = parent ] && root=$parent
    python3 experiments/tracing-spans/traced_split.py --root "$root" --workload $cell \
      --seed $seed --seconds 10 > "$out/$cell.$side.traced.json" \
      2> "$out/$cell.$side.traced.err"
    echo "traced $side $cell $seed rc=$? $(tail -n 1 "$out/$cell.$side.traced.json")"
  done
done
