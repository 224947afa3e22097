"""Helpers of the benchmark's CPU tests: a copy of the benchmark in a
temporary root, with small configurations of its own, run on the CPU
through the harness (the look for a card skipped)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def small_root(tmp_path: Path) -> Path:
    """A checkout-like root in tmp_path: BENCHMARK.json and benchmark/, plus
    a small cell for each real one, held to its limits: small2.f32 (D2Q9
    32x32, a barrier, 40 steps), small3.f32 and small3.bf16 (D3Q19 8x8x16,
    40 steps)."""
    root = tmp_path / "root"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    configs = root / "benchmark" / "configs"
    mask = np.zeros((32, 32), bool)
    mask[0] = mask[-1] = True
    mask[:, 0] = mask[:, -1] = True
    mask[1:-1, 10] = True
    np.savez_compressed(configs / "small2.mask.npz", bits=np.packbits(mask.ravel()))
    c2 = json.loads((configs / "d2q9-cavity-1024.json").read_text())
    c2.update(nx=32, ny=32, steps=40, mask="small2.mask.npz")
    (configs / "small2.json").write_text(json.dumps(c2))
    c3 = json.loads((configs / "d3q19-channel-64x128x256.json").read_text())
    c3.update(nz=8, ny=8, nx=16, steps=40)
    (configs / "small3.json").write_text(json.dumps(c3))
    base = {c["name"]: c for c in spec["configs"]}
    spec["configs"] += [dict(base["d2q9-cavity-1024"], name="small2",
                             file="benchmark/configs/small2.json"),
                        dict(base["d3q19-channel-64x128x256"], name="small3",
                             file="benchmark/configs/small3.json")]
    limits = root / "benchmark" / "limits"
    for cell in sorted({w["name"] for w in spec["workloads"]}):
        cfg, t = cell.split(".")
        small = "small2" if cfg.startswith("d2q9") else "small3"
        spec["workloads"].append({"name": f"{small}.{t}", "config": small,
                                  "traffic": f"back_to_back.{t}", "chips": 1, "why": "test"})
        shutil.copy(limits / f"{cell}.json", limits / f"{small}.{t}.json")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def ranks_cell(root: Path, name: str, chips: int, **config) -> str:
    """Adds to `root` the cell `name` on `chips` ranks: the test driver
    drivers/d3q19_ranks_job.py (copied into the root's benchmark) on the
    plain multi-device engine "sharded" at 8x8x16, 40 steps, with
    `config`'s keys over those; held to d3q19-channel.f32's limits."""
    bench = root / "benchmark"
    shutil.copy(Path(__file__).parent / "drivers" / "d3q19_ranks_job.py", bench / "drivers")
    c = json.loads((bench / "configs" / "d3q19-channel-64x128x256.json").read_text())
    c.update(driver="d3q19_ranks_job", nz=8, ny=8, nx=16, steps=40, engine="sharded")
    c.update(config)
    (bench / "configs" / f"{name}.json").write_text(json.dumps(c))
    shutil.copy(bench / "limits" / "d3q19-channel.f32.json", bench / "limits" / f"{name}.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": name, "source": "test", "file": f"benchmark/configs/{name}.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": name, "config": name, "traffic": "back_to_back.f32",
                              "chips": chips, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return name


@pytest.fixture
def root(tmp_path):
    return small_root(tmp_path)
