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
timers); a tree without it reports null.  It then also traces one more
replayed block under ``torch.profiler`` and splits the MGS kernel's
device time by operand shape (the trace's MGS kernels in time order
follow the launch order of a host step, recorded beforehand with the dead
columns of each of its operands), beside one launch of each shape timed
alone with CUDA events, with L2 warm (the same operand again) and cold
(64 MB written between launches).  Prints one JSON line: the step times
of each path, their medians, the MGS split, and the card.  To compare two
trees run them on one card in turn, in the order a, b, b, a.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

#: Reps of each alone-timed MGS launch
MGS_REPS = 50
#: Bytes written between two cold MGS launches (above the 50 MB L2)
FLUSH_BYTES = 64 << 20


def _mgs_shapes(run) -> tuple[list, dict]:
    """The MGS operand shapes of ``run()`` in launch order, and the dead
    columns (zero R diagonals) of its launches by shape (a recorder stands
    for ``kernels.cuda_qr`` meanwhile)."""
    from pytdscf_torch.mps import cuda_qr as CQ
    from pytdscf_torch.mps import kernels as K

    shapes, dead = [], {}

    def mgs_qr(m):
        shapes.append(tuple(m.shape))
        q, r = CQ.mgs_qr(m)
        dead.setdefault(str(tuple(m.shape)), []).append(
            int((r.diagonal() == 0).sum()))
        return q, r

    K.cuda_qr = SimpleNamespace(mgs_qr=mgs_qr)
    try:
        run()
    finally:
        K.cuda_qr = CQ
    return shapes, dead


def _mgs_alone(shape) -> dict:
    """One MGS launch of ``shape`` on seeded operands, ms: the mean over a
    batch with L2 warm, and the mean of launches each after FLUSH_BYTES
    written (CUDA events around the launch alone)."""
    import numpy as np
    import torch

    from pytdscf_torch.mps import cuda_qr as CQ

    rng = np.random.default_rng(0)
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    m = torch.as_tensor(a / np.linalg.norm(a), dtype=torch.complex64,
                        device="cuda")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for _ in range(2):
        CQ.mgs_qr(m)
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(MGS_REPS):
        CQ.mgs_qr(m)
    ev[1].record()
    torch.cuda.synchronize()
    warm = ev[0].elapsed_time(ev[1]) / MGS_REPS
    cold = 0.0
    for _ in range(MGS_REPS):
        flush.fill_(1.0)
        ev[0].record()
        CQ.mgs_qr(m)
        ev[1].record()
        torch.cuda.synchronize()
        cold += ev[0].elapsed_time(ev[1])
    return {"warm_ms": warm, "cold_ms": cold / MGS_REPS}


def _mgs_replayed(engine, dt_au, shapes, steps: int) -> dict:
    """The MGS kernel's device time in a trace of one block of ``steps``
    replayed steps, by operand shape, and every kernel's device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.propagate_steps(dt_au, steps)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = [e for e in json.load(fh)["traceEvents"]
                      if e.get("cat") == "kernel"]
    mgs = sorted((float(e["ts"]), float(e["dur"])) for e in events
                 if "mgs_qr_kernel(" in e.get("name", ""))
    out = {"steps": steps, "traced_mgs": len(mgs),
           "device_ms_per_step": sum(float(e["dur"]) for e in events)
           / 1e3 / steps,
           "mgs_ms_per_step": sum(d for _, d in mgs) / 1e3 / steps}
    if len(mgs) != steps * len(shapes):  # a trace lost kernels
        out["by_shape"] = None
        return out
    acc = {}
    for i, (_, dur) in enumerate(mgs):
        acc.setdefault(shapes[i % len(shapes)], []).append(dur / 1e3)
    out["by_shape"] = sorted(
        ({"shape": list(shape), "per_step": len(d) // steps,
          "ms_per_step": sum(d) / steps, "mean_ms": sum(d) / len(d),
          **_mgs_alone(shape)} for shape, d in acc.items()),
        key=lambda x: -x["ms_per_step"])
    return out


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
        # one host step, its MGS launch order recorded; then a host step
        # and the capture
        shapes, dead = _mgs_shapes(lambda: engine.propagate(dt_au))
        engine.propagate_steps(dt_au, 1)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            engine.propagate_steps(dt_au, 4)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / 4)
        out["graph"] = {"s_per_step": times,
                        "median": statistics.median(times),
                        "graph_steps": engine.graph_steps,
                        "mgs": _mgs_replayed(engine, dt_au, shapes, 4),
                        "mgs_dead_columns": {
                            k: {"launches": len(v), "mean": sum(v) / len(v),
                                "min": min(v), "max": max(v)}
                            for k, v in dead.items()}}
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
