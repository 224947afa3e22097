"""Run one cell of the benchmark once (see benchmark/harness.py):

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell whose `chips` is n > 1 runs as n ranks, one process a card: this
process is rank 0, and it starts ranks 1..n-1 as this same command with
`--rank <r> --group <dir>` added (the rendezvous directory it made), once a
run. They meet in one process group, run the same jobs, each judges its
part of the answer, and rank 0 alone prints the result; the other ranks'
output comes out on its standard error, each line after "rank <r>: ". A job
driver of such a cell is built on every rank inside that group: its `run()`
and `reference(storage)` return this rank's part, its `updates`, `flop` and
`bytes` count the whole job.
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
