#!/usr/bin/env python3
"""Improved relaxation on one GPU, for one tree: the relax stages' step
times, the ground-state kernel per call and per iteration, and the Krylov
control step's device time with no host in the loop.

    python3 scripts/relax_step.py ROOT [--sweep] [--ctl-only]

imports ``pytdscf_torch`` and ``chip_smoke`` from the checkout at ROOT
(each tree builds its own kernels into ``ROOT/pytdscf_torch/_build``) and:

* relaxes H2O (10 improved steps of 0.1 fs) and butadiene (8) through
  ``Simulator.relax``, as ``chip_smoke.py`` does (s/step of the whole
  stage, the ground states' passes), then times 3 more improved steps of
  each relaxed engine one by one (``TDVPEngine.propagate``, synchronised
  after each), and traces one more butadiene step under ``torch.profiler``:
  its device time by kernel name, the busy share;
* times the ground-state kernel (``cuda_lanczos.ground_state``, CUDA
  events over repeated launches) on each relaxed state's own operands at
  every distinct (M, r, channels) of its sites, the centre moved to the
  site (``chip_smoke.centred_operands``): ms a call, the passes and
  iterations of the call, and ms a matvec-iteration, ms / (iterations +
  passes) (each pass runs one more matvec for its energy); with
  ``--sweep``, and where the tree's wrapper takes ``cluster`` and
  ``threads``, each shape on every cluster size and block size that
  ``cuda_lanczos.gs_candidates`` lists;
* times the Krylov control step (``cuda_krylov.krylov_ctl``) as the step
  graph runs it: N launches on seeded operands (the leading blocks of one
  Arnoldi Hessenberg T at k_used 2 to 8, and of a Lanczos T with its Gram
  matrix at 8, 12 and 16) captured into one CUDA graph,
  replayed, the events' time divided by N; the same for a kernel that
  does no work (``torch.cuda._sleep(0)``), the floor of a launch in a
  graph; and ``torch.linalg.matrix_exp`` of the same scaled block, first
  column, as the library's time (events around back-to-back calls: it
  reads a norm to the host, so it does not capture).

``--ctl-only`` runs the control step's part alone.  ``--site NC,M,R``
(repeatable) runs only the ground-state kernel on a random Hermitian site
of that shape, seeded as ``chip_smoke.py``'s wide-layout check makes it
(``chip_smoke.GS_WIDE``): ms a call, its passes and iterations, ms a
matvec-iteration.  Prints the card, one
line per measurement and one JSON object last.  To
compare two trees run them on one card in turn, a, b, b, a.  Imports no
JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

#: improved steps of each relax stage (chip_smoke.py's), and the steps
#: timed one by one after it
RELAX_STEPS = {"h2o": 10, "c4h6": 8}
MORE_STEPS = 3
#: launches of the ground-state kernel timed per shape (the bulk: fewer)
GS_REPS = 20
GS_REPS_BULK = 5
#: control-step launches captured into one graph
CTL_LAUNCHES = 200
CTL_REPLAYS = 5
#: (k_used, Gram matrix, k_max) of the control-step cases: the leading
#: blocks of one seeded T, so that the cases differ only in their size
CTL_CASES = ((2, False, 8), (4, False, 8), (5, False, 7), (5, False, 8),
             (6, False, 8), (7, False, 7), (7, False, 8), (8, False, 8),
             (8, True, 20), (12, True, 20), (16, True, 20))
CTL_SCALE = -0.25j  # the radical pair's Arnoldi scale, -i dt / 2


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]


def _events_ms(fn, reps: int) -> float:
    import torch

    for _ in range(2):
        fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def _graph_ms(fn, launches: int = CTL_LAUNCHES) -> float:
    """Device ms of one ``fn()``: ``launches`` calls captured into one
    CUDA graph, replayed CTL_REPLAYS times, the events' time divided by
    the launches replayed."""
    import torch

    fn()  # any one-time set-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(CTL_REPLAYS):
        graph.replay()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / (CTL_REPLAYS * launches)


def _profile_step(engine, dt) -> dict:
    """One improved step under torch.profiler: wall ms, device ms by
    kernel name, busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.propagate(dt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.propagate(dt)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key[:90]] = (e.self_device_time_total / 1e3, e.count)
    busy = sum(ms for ms, _ in by_name.values())
    rows = sorted(({"kernel": k, "ms": ms, "launches": n,
                    "share_of_device": ms / busy}
                   for k, (ms, n) in by_name.items()), key=lambda x: -x["ms"])
    return {"wall_ms": wall, "device_ms": busy, "busy": busy / wall,
            "by_kernel": rows}


def _relax(S, name: str) -> tuple[dict, object]:
    import torch

    from pytdscf_torch import Simulator

    model = S.ir_models(name)[0]
    steps = RELAX_STEPS[name]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e_gs, wf = Simulator(name, model, verbose=0).relax(
                maxstep=steps, stepsize=0.1, improved=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
    engine = wf.engine
    stats = engine.ground_state_stats()
    dt = S.fs(0.1)
    more = []
    for _ in range(MORE_STEPS):
        t0 = time.perf_counter()
        engine.propagate(dt)
        torch.cuda.synchronize()
        more.append(time.perf_counter() - t0)
    out = {"e_gs": e_gs, "stage_s_per_step": wall / steps,
           "steps": steps, "more_steps_s": more,
           "passes": stats["passes"], "calls": stats["calls"],
           "iterations": stats["iterations"]}
    print(f"{name}: relax {wall / steps:.4f} s/step over {steps} steps "
          f"(E_gs {e_gs!r}; {stats['calls']} ground states, "
          f"{stats['passes']} passes, {stats['iterations']} iterations); "
          f"then {', '.join(f'{t:.4f}' for t in more)} s a step")
    if name == "c4h6":
        out["profile"] = _profile_step(engine, dt)
        p = out["profile"]
        print(f"{name}: one step traced: wall {p['wall_ms']:.2f} ms, device "
              f"{p['device_ms']:.2f} ms ({100 * p['busy']:.1f} %)")
        for row in p["by_kernel"][:8]:
            print(f"  {row['ms']:9.3f} ms {row['launches']:5d}x "
                  f"{100 * row['share_of_device']:5.1f} %  {row['kernel']}")
    return out, engine


def _gs_shapes(S, name: str, engine, sweep: bool) -> list:
    """The ground-state kernel at every distinct shape of the engine's
    sites, on the state's own operands."""
    import torch

    from pytdscf_torch.mps import cuda_lanczos as CL

    can_sweep = sweep and hasattr(CL, "_ground_state_on")
    out, seen = [], set()
    for p in range(engine.nsite):
        (L, lL), W, (R, lR), psi, _ = S.centred_operands(engine, p)
        l, d, r = psi.shape
        M, nc = l * d, W.shape[-1]
        if (M, r, nc) in seen:
            continue
        seen.add((M, r, nc))
        ch = CL.heff_channels(L, W, R, torch.exp(lL + lR))
        v = psi.reshape(M, r).contiguous()
        reps = GS_REPS_BULK if M * r * nc > 20000 else GS_REPS
        plan = CL.gs_plan(M, r, nc)
        configs = [{}]
        if can_sweep:
            configs += [{"cluster": C, "threads": t}
                        for C, t in CL.gs_candidates(M, r, nc)]
        for kw in configs:
            def run(kw=kw):
                if kw:
                    return CL._ground_state_on(ch, v, **kw)
                return CL.ground_state(ch, v)

            _, st = run()
            passes, iters, _ = st.tolist()
            ms = _events_ms(run, reps)
            row = {"model": name, "site": p, "shape": [M, r, nc],
                   "plan": list(plan[:2]) if not kw else None, **kw,
                   "ms": ms, "passes": passes, "iterations": iters,
                   "ms_per_iteration": ms / (iters + passes)}
            out.append(row)
            what = (f"{plan[0]} of {plan[1]}" if not kw else
                    f"C {kw['cluster']}, {kw['threads']} threads")
            print(f"ground state {name} ({M}, {r}), {nc} channels, {what}: "
                  f"{ms:.4f} ms, {passes} passes, {iters} iterations, "
                  f"{1e3 * row['ms_per_iteration']:.2f} µs an iteration")
    return out


def _ctl_inputs(m: int, kmax: int, gram: bool):
    """A Krylov step's control inputs at k_used = m, the leading blocks of
    one seeded reduced matrix: T upper Hessenberg (Arnoldi) or symmetric
    tridiagonal (Lanczos, with a Gram matrix near the identity),
    ‖scale·T‖₁ of a few; T[m, m−1] = 1 (no breakdown); the previous
    coefficients."""
    import torch

    rng = np.random.default_rng(11)
    n = 21

    def cx(*shape):
        a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return a / np.sqrt(2.0)

    hess = np.triu(cx(n, n), -1) * 2.0
    a, b = rng.standard_normal(n) * 4.0, np.abs(rng.standard_normal(n)) + 0.5
    tri = np.diag(a) + np.diag(b[:-1], 1) + np.diag(b[:-1], -1)
    A = cx(n, n)
    gmat = np.eye(n) + 0.01 * (A @ A.conj().T)
    cprev = 0.1 * cx(n)
    T = np.zeros((kmax + 1, kmax + 1), dtype=complex)
    T[:m, :m] = (tri if gram else hess)[:m, :m]
    T[m, m - 1] = 1.0
    if gram:
        T[m - 1, m] = 1.0
    c = np.zeros(kmax, dtype=complex)
    c[:m - 1] = cprev[:m - 1]

    def dev(x):
        return torch.as_tensor(x, dtype=torch.complex64, device="cuda")

    G = dev(gmat[:kmax + 1, :kmax + 1]) if gram else None
    return dev(T), G, dev(c)


def _ctl() -> dict:
    import torch

    from pytdscf_torch.mps import cuda_krylov as CK

    dev = torch.device("cuda", torch.cuda.current_device())
    # a launch inside a capture counts itself on the device
    CK.krylov_ctl.replayed.setdefault(
        dev.index, torch.zeros(1, dtype=torch.int32, device=dev))
    out = {"floor_ms": _graph_ms(lambda: torch.cuda._sleep(0)), "cases": []}
    print(f"krylov_ctl: an empty kernel in a graph {out['floor_ms']:.5f} ms "
          "a launch")
    for m, gram, kmax in CTL_CASES:
        T, G, c = _ctl_inputs(m, kmax, gram)
        flags = torch.zeros(kmax + 1, dtype=torch.bool, device=dev)
        status = torch.zeros(3, dtype=torch.int32, device=dev)
        kw = dict(k=m - 1, scale=CTL_SCALE, thresh=1e-6, exact=False,
                  relax_after=1)
        ms = _graph_ms(lambda: CK.krylov_ctl(T, G, c, flags, status, **kw))
        A = (CTL_SCALE * T[:m, :m]).contiguous()
        # matrix_exp reads the norm to the host to pick its degree: it does
        # not capture, so back-to-back calls, the host in the loop
        lib_ms = _events_ms(lambda: torch.linalg.matrix_exp(A)[:, 0], 50)
        norm1 = float(torch.max(torch.sum(torch.abs(A.cpu()), dim=0)))
        sq = int(min(max(math.ceil(math.log2(max(norm1, 1e-30))) + 3, 0), 64))
        row = {"k_used": m, "gram": gram, "kmax": kmax, "squarings": sq,
               "ms": ms, "matrix_exp_ms": lib_ms}
        out["cases"].append(row)
        print(f"krylov_ctl k_used {m} ({'Lanczos, G' if gram else 'Arnoldi'}, "
              f"k_max {kmax}, {sq} squarings): {ms:.5f} ms a launch in a "
              f"graph; torch.linalg.matrix_exp {lib_ms:.5f} ms")
    return out


def _gs_site(nc: int, M: int, r: int) -> dict:
    """The ground-state kernel on a seeded random Hermitian site."""
    import torch

    from pytdscf_torch.mps import cuda_lanczos as CL

    rng = np.random.default_rng(13)
    H = rng.normal(size=(nc, M, M)) + 1j * rng.normal(size=(nc, M, M))
    Rt = rng.normal(size=(nc, r, r)) + 1j * rng.normal(size=(nc, r, r))
    ch = tuple(torch.tensor((x + x.conj().transpose(0, 2, 1))
                            / (2 * x.shape[1]), dtype=torch.complex64,
                            device="cuda") for x in (H, Rt))
    v = torch.tensor(rng.normal(size=(M, r)) + 1j * rng.normal(size=(M, r)),
                     dtype=torch.complex64, device="cuda")
    _, st = CL.ground_state(ch, v)
    passes, iters, _ = st.tolist()
    ms = _events_ms(lambda: CL.ground_state(ch, v), GS_REPS_BULK)
    row = {"shape": [M, r, nc], "plan": list(CL.gs_plan(M, r, nc)[:3]),
           "ms": ms, "passes": passes, "iterations": iters,
           "ms_per_iteration": ms / (iters + passes)}
    print(f"ground state random ({M}, {r}), {nc} channels: {ms:.4f} ms, "
          f"{passes} passes, {iters} iterations, "
          f"{1e3 * row['ms_per_iteration']:.2f} µs an iteration")
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", type=Path)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--ctl-only", action="store_true")
    ap.add_argument("--site", action="append", default=[])
    opts = ap.parse_args()
    root = opts.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as S

    if not torch.cuda.is_available():
        print("relax_step: no CUDA device", file=sys.stderr)
        return 1
    card = _card()
    print(card)
    out = {"root": str(root), "card": card}
    from pytdscf_torch import _cuda

    _cuda.load()
    if opts.site:
        out["sites"] = [_gs_site(*map(int, s.split(","))) for s in opts.site]
        print(json.dumps(out))
        return 0
    gs = []
    for name in () if opts.ctl_only else ("h2o", "c4h6"):
        out[name], engine = _relax(S, name)
        gs += _gs_shapes(S, name, engine, opts.sweep)
        del engine
        torch.cuda.empty_cache()
    out["ground_state"] = gs
    out["krylov_ctl"] = _ctl()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
