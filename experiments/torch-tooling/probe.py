"""The tooling's measurements at more than one length, on the card, in one call.

chip_smoke.py's phase 7e measures a 200-step flagship run. This harness
measures, with chip_smoke's helpers:
  * the flagship (1024^2, f32, the golden blob's mask) through `cli.lbm
    --engine auto --trace-dir` at 200, 2,000 and 20,000 steps, each beside
    the same run untraced: B2's launches and summed device time in the
    trace's timed run, the CUDA-event time traced and untraced, and the
    device's idle share in the timed window (`profiling.kernel_summary`);
  * `cli.lbm_runner` on the exported plain step against `--engine torch`,
    two runs each, at 200 and 1,000 steps (MLUPS);
  * `cli.halo_bench` at 1024^2 for 200 and 1,000 steps, every strategy, in
    a NCCL group of one.
Prints one JSON line and writes it to --out (default: results_probe.json
beside this file).

Run from the root of the repository on a machine with a card:
    python3 experiments/torch-tooling/probe.py [--out FILE]
"""
import argparse
import json
import re
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402
from lbm_tpu_torch.cli import halo_bench, lbm as cli, lbm_runner  # noqa: E402
from lbm_tpu_torch.core.params import Obstacles, Params  # noqa: E402
from lbm_tpu_torch.models import lbm as lbm_model  # noqa: E402
from lbm_tpu_torch.ops import _build  # noqa: E402
from lbm_tpu_torch.utils import profiling  # noqa: E402

def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(Path(__file__).parent / "results_probe.json"))
    args = parser.parse_args()
    print(cs.card_line())
    _build.load("d2q9_kstep")
    _, mask = cs.load_golden()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        Params(**cs.FLAGSHIP).to_file(tmp / "p.params")
        Obstacles(mask).to_file(tmp / "o.dat")
        files = ["--params", str(tmp / "p.params"), "--obstacles", str(tmp / "o.dat")]
        for steps in (200, 2000, 20000):
            with cs.Capture(lbm_model, "run_simulation") as cap:
                rc, text = cs.run_cli(cli.main, files + ["--num-steps", str(steps), "--out-dir",
                                                         str(tmp / "a"), "--trace-dir",
                                                         str(tmp / f"t{steps}")])
            s = profiling.kernel_summary(tmp / f"t{steps}" / profiling.TRACE_FILE)
            b2 = [v for k, v in s["kernels"].items() if "kstep_box_kernel" in k][0]
            res = cap.results[0]
            with cs.Capture(lbm_model, "run_simulation") as cap2:
                cs.run_cli(cli.main, files + ["--num-steps", str(steps), "--out-dir",
                                              str(tmp / "b")])
            plain = cap2.results[0]
            row = dict(steps=steps, b2_launches=b2["launches"], b2_ms=b2["device_us"] / 1e3,
                       events_ms=res.compute_seconds * 1e3, untraced_ms=plain.compute_seconds * 1e3,
                       window_ms=s["window_us"] / 1e3, busy_ms=s["busy_us"] / 1e3,
                       idle_share=s["idle_share"], device_events=s["device_events"])
            print("traced auto:", json.dumps(row))
            out[f"trace_{steps}"] = row
        rc, text = cs.run_cli(cli.main, ["--params", str(tmp / "p.params"), "--compile-only",
                                         "--export", str(tmp / "step.pt2")])
        for steps in (200, 1000):
            t = {}
            for label, fn, argv in (("runner", lbm_runner.main, ["--exe", str(tmp / "step.pt2")]),
                                    ("torch", cli.main, ["--engine", "torch"]),
                                    ("runner2", lbm_runner.main, ["--exe", str(tmp / "step.pt2")]),
                                    ("torch2", cli.main, ["--engine", "torch"])):
                rc, text = cs.run_cli(fn, argv + files + ["--num-steps", str(steps), "--out-dir",
                                                         str(tmp / "c")])
                t[label] = float(re.search(r"MLUPS:\s+([0-9.]+)", text).group(1))
            print(f"runner vs torch, {steps} steps:", t)
            out[f"runner_{steps}"] = t
    with cs.nccl_world_of_one(torch):
        for n in (200, 1000):
            rc, text = cs.run_cli(halo_bench.main, ["--ny", "1024", "--nx", "1024", "-n", str(n),
                                                    "--num-devices", "1"])
            print(text)
            out[f"halo_{n}"] = {l.split(",")[0]: float(l.split(",")[7])
                                for l in text.strip().splitlines()[1:]}
    print(json.dumps(out))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
