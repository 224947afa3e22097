"""`benchmark/run.py` on the CPU, for the tests: every rank's device is the
CPU (the look for a card skipped; a multi-rank run's groups on gloo), and
the harness's time limit is BENCH_TEST_TIMEOUT_S where that is set. Run it
from a checkout-like root (`conftest.small_root`), with the program on
PYTHONPATH:

    python3 <repo>/benchmark/tests/cpu_run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

It reports on standard error each temporary directory that a multi-device
entry of the program makes to start ranks of its own ("ranks started:
<path>"): a job inside the harness's group starts none.
"""

import os
import sys

sys.path.insert(0, os.getcwd())

from benchmark import harness  # noqa: E402

SPAWN_PREFIX = "lbm_torch_ranks_"


def cpu(n, rank=0):
    import torch

    return torch.device("cpu")


def _audit(event, args):
    if event == "tempfile.mkdtemp" and SPAWN_PREFIX in str(args[0]):
        print(f"ranks started: {args[0]}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    if "BENCH_TEST_TIMEOUT_S" in os.environ:
        harness.TIMEOUT_S = float(os.environ["BENCH_TEST_TIMEOUT_S"])
    sys.addaudithook(_audit)
    sys.exit(harness.main(devices=cpu))
