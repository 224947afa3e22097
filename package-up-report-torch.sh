#!/bin/bash
# Bundle a performance/debug report of one D2Q9 run of the PyTorch/CUDA port.
#
# The port's counterpart of package-up-report.sh. The tarball holds:
#   trace/trace.json    torch.profiler trace of the run (cli.lbm --trace-dir;
#                       on the card it names each kernel with its device time)
#   trace/summary.json  the trace's kernels, launches and device idle share
#                       in the timed run (utils.profiling.kernel_summary)
#   partitioning.json   the device partitioning (--partition-json)
#   out/                av_vels.dat + final_state.dat of the traced run
#   run.txt             what the CLI printed
#   step.graph.txt      the torch.export graph of the plain step (dump_graph)
#   res-usage.txt       `cuobjdump -res-usage` of the CUDA library of the
#                       engine that ran (registers, shared memory of each
#                       kernel), or why there is none
#
# Usage: [DEVICE=cuda|cpu] [ENGINE=auto] [ITERS=20] [PARAMS=...] [OBST=...] \
#        ./package-up-report-torch.sh [report.tar.gz]
# Without PARAMS and OBST it writes a 128x128 case with an obstacle block.
set -eo pipefail
cd "$(dirname "$0")"
OUT=${1:-report.tar.gz}
DEVICE=${DEVICE:-cuda}
ENGINE=${ENGINE:-auto}
TMP=$(mktemp -d)
trap 'rm -rf "$TMP"' EXIT

if [ -z "$PARAMS" ]; then
  PARAMS="$TMP/input_128x128.params"
  OBST="$TMP/obstacles_128x128.dat"
  PARAMS="$PARAMS" OBST="$OBST" python - <<'EOF'
import os

import numpy as np

from lbm_tpu_torch.core.params import Obstacles, Params

Params(nx=128, ny=128, max_iters=20, reynolds_dim=10, density=0.1, accel=0.005,
       omega=1.85).to_file(os.environ["PARAMS"])
mask = np.zeros((128, 128), bool)
mask[40:80, 30:40] = True
Obstacles(mask).to_file(os.environ["OBST"])
EOF
fi

python -m lbm_tpu_torch.cli.lbm --params "$PARAMS" --obstacles "$OBST" \
  --device "$DEVICE" --engine "$ENGINE" --num-steps "${ITERS:-20}" \
  --trace-dir "$TMP/trace" --partition-json "$TMP/partitioning.json" \
  --out-dir "$TMP/out" | tee "$TMP/run.txt"

PARAMS="$PARAMS" WORK="$TMP" DEVICE="$DEVICE" python - <<'EOF'
import json
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np

from lbm_tpu_torch.core import state
from lbm_tpu_torch.core.params import Params
from lbm_tpu_torch.ops import _build, d2q9
from lbm_tpu_torch.utils import profiling

p = Params.from_file(os.environ["PARAMS"])
tmp = Path(os.environ["WORK"])
device = os.environ["DEVICE"]
f0, mask = state.to_torch(state.initial_distributions(p, np.float32),
                          np.zeros((p.ny, p.nx), bool), device=device)
profiling.dump_graph(d2q9.Step(p, device=device), f0, mask, path=tmp / "step.graph.txt")
print("dumped the graph of the plain step")

summary = profiling.kernel_summary(tmp / "trace" / profiling.TRACE_FILE)
(tmp / "trace" / "summary.json").write_text(json.dumps(summary, indent=2))
print(f"trace: {summary['device_events']} device events in the timed run, "
      f"idle share {summary['idle_share']}")

engine = re.search(r"^engine:\s+(\S+)", (tmp / "run.txt").read_text(), re.M).group(1)
source = {"cuda": "d2q9_kstep", "cuda-inplace": "d2q9_kstep",
          "cuda-manual": "d2q9_manual"}.get(engine)
cuobjdump = shutil.which("cuobjdump") or shutil.which(
    "cuobjdump", path=os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin"))
lib = _build.library_path(source) if source else None
if source is None or device != "cuda":
    note = f"engine {engine} on {device}: no CUDA library ran\n"
elif cuobjdump is None:
    note = "cuobjdump is not on the PATH: no resource usage of the kernels\n"
elif not lib.exists():
    note = f"{lib} was not built\n"
else:
    res = subprocess.run([cuobjdump, "-res-usage", str(lib)], capture_output=True, text=True)
    note = res.stdout + res.stderr
(tmp / "res-usage.txt").write_text(note)
print(f"res-usage.txt: {note.splitlines()[0] if note else ''}")
EOF

tar -czf "$OUT" -C "$TMP" .
echo "wrote $OUT ($(du -h "$OUT" | cut -f1))"
