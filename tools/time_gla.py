#!/usr/bin/env python3
"""Run ``chip_smoke.phase_gla()`` of checkouts of this repository on the card.

    python3 tools/time_gla.py ROOT [ROOT ...]

For each ROOT (a checkout holding ``chip_smoke.py`` and ``src/``), in a
process of its own, runs that checkout's phase 6: ``gla_chunk`` held
against its plain version over the sweep, then timed (median CUDA-event
time of one call) at xLSTM-350M's and Hymba-1.5B's prefill shapes beside
the plain version.  Give two checkouts in turns (parent, change, change,
parent) to compare them on one card.  Needs one CUDA card.
"""
import json
import os
import subprocess
import sys


def run_one(root: str) -> None:
    sys.path.insert(0, root)
    import chip_smoke
    res = chip_smoke.phase_gla()
    src = os.path.dirname(sys.modules["repro_torch"].__file__)
    print(json.dumps({"src": src, **{k: {m: v[m] for m in ("ms", "plain_ms")}
                                     for k, v in res.items()}}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_one(os.path.abspath(sys.argv[2]))
        return 0
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True,
                       timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
