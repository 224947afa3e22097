"""Run one cell of the benchmark once (see benchmark/harness.py):

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, in place of this folder: the program and the benchmark
# are imported as packages from there
sys.path[0] = str(ROOT)
# the compiled bytecode of every module a run imports, written (whatever
# PYTHONDONTWRITEBYTECODE says) to a fixed path in the checkout: where the
# installed packages carry none, every run would compile their sources again
# in its set-up
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
