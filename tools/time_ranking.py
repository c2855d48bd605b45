#!/usr/bin/env python3
"""Time the ranking kernels of a checkout of this repository on the card.

    python3 tools/time_ranking.py ROOT [ROOT ...]

For each ROOT (a checkout holding ``chip_smoke.py`` and ``src/``), in a
process of its own, times ``ranking_victim_order`` (top 8) and
``ranking_scores`` at N = 100 (fig2's table) and N = 2^20 (the deployment
table) with that checkout's ``chip_smoke.ranking_inputs`` and
``chip_smoke.time_ms`` (median CUDA-event time of one call).  Give two
checkouts in turns (parent, change, change, parent) to compare them on
one card.  Needs one CUDA card.
"""
import os
import subprocess
import sys


def time_one(root: str) -> None:
    sys.path.insert(0, root)
    import chip_smoke
    from repro_torch.kernels.ranking_score import (ranking_scores,
                                                   ranking_victim_order)
    src = os.path.dirname(sys.modules["repro_torch"].__file__)
    for n in (100, 1 << 20):
        args = chip_smoke.ranking_inputs(n, 0.5, seed=1234)
        a = chip_smoke.time_ms(lambda: ranking_victim_order(
            *args, omega=1.0, top=8))
        b = chip_smoke.time_ms(lambda: ranking_scores(*args, omega=1.0))
        print(f"{src}: N={n}: ranking_victim_order {a * 1e3:.2f} us, "
              f"ranking_scores {b * 1e3:.2f} us", flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        time_one(os.path.abspath(sys.argv[2]))
        return 0
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True,
                       timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main())
