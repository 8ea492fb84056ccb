#!/usr/bin/env python3
"""Seconds per step of the 184-site D=30 chain on one GPU, for one tree.

    python3 scripts/chain_step.py ROOT [--steps N]

imports ``pytdscf_torch`` and ``chip_smoke.build_engine`` from the checkout
at ROOT (each tree builds its own kernels into ``ROOT/pytdscf_torch/_build``),
runs one warm-up step and then N timed steps (``TDVPEngine.propagate``,
synchronised after each) with the separate kernels, then the same with the
fused site kernel (``Config.fused_site``).  Where the tree has the fused
multi-step driver it also times ``bench.py``'s driver on a fresh engine
(``propagate_steps(dt, 1)``, then 5 blocks of 4 steps, each block's s/step)
and ``Simulator.propagate`` of the chain over 17 steps at the default
stride (16), separate kernels (its loop s/step from the Simulator's phase
timers); a tree without it reports null.  Prints one JSON line: the step
times of each path, their medians, and the card.  To compare two trees run
them in one session, in the order a, b, b, a.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", type=Path)
    ap.add_argument("--steps", type=int, default=5)
    opts = ap.parse_args()
    root = opts.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke
    from pytdscf_torch import units

    if not torch.cuda.is_available():
        print("chain_step: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    dt_au = chip_smoke.DT_FS / units.au_in_fs
    engine = chip_smoke.build_engine("cuda")
    out = {"root": str(root), "card": card}
    for path, fused in (("separate", False), ("fused", True)):
        engine.config = engine.config.replace(fused_site=fused)
        engine.propagate(dt_au)  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(opts.steps):
            t0 = time.perf_counter()
            engine.propagate(dt_au)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[path] = {"s_per_step": times, "median": statistics.median(times)}
    del engine
    out["graph"] = out["simulator_stride16"] = None
    if hasattr(chip_smoke, "run_simulator"):
        engine = chip_smoke.build_engine("cuda")
        engine.propagate_steps(dt_au, 1)  # a host step, then the capture
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            engine.propagate_steps(dt_au, 4)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / 4)
        out["graph"] = {"s_per_step": times,
                        "median": statistics.median(times),
                        "graph_steps": engine.graph_steps}
        del engine
        steps = chip_smoke.STRIDE_STEPS
        run = chip_smoke.run_simulator(chip_smoke.chain_model(), None,
                                       fused=False, steps=steps)
        elapsed = run.sim.diagnostics.elapsed
        out["simulator_stride16"] = {
            "loop_s_per_step": sum(elapsed.values()) / steps,
            "graph_steps": run.engine.graph_steps}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
