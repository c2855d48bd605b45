"""Run every example module at its default size, one process each, and
time each on the host clock (interpreter start and kernel builds
included).

    PYTHONPATH=src python -m repro_torch.examples              # the card
    PYTHONPATH=src python -m repro_torch.examples --only quickstart,trace_sim

Arguments after ``--`` go to every module (e.g. ``-- --device cpu``; the
defaults are minutes of work on the CPU).  Prints each module's output
as it comes, then one line of seconds by module and, on a card, its name
and power limit as ``nvidia-smi`` gives them.  Exits non-zero if any
module failed.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

NAMES = ("quickstart", "trace_sim", "hierarchy_sim", "serve_engine",
         "train_small")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(NAMES))
    args = ap.parse_args(argv[:argv.index("--")] if "--" in argv else argv)
    seconds, failed = {}, []
    for name in args.only.split(","):
        if name not in NAMES:
            raise SystemExit(f"unknown example {name!r}; known: {NAMES}")
        print(f"=== python -m repro_torch.examples.{name} "
              f"{' '.join(extra)}".rstrip(), flush=True)
        t0 = time.perf_counter()
        rc = subprocess.call([sys.executable, "-m",
                              f"repro_torch.examples.{name}", *extra],
                             env=os.environ.copy())
        seconds[name] = round(time.perf_counter() - t0, 2)
        if rc:
            failed.append(name)
    print(json.dumps({"seconds": seconds, "failed": failed}), flush=True)
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(smi.stdout.strip(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
