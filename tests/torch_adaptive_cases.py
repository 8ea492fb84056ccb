"""The a1TDVP runs that ``tests/test_torch_adaptive.py`` holds the port to.

Each run takes a package, ``"tpu"`` (the JAX package, the reference) or
``"torch"`` (the port, on the CPU), builds the same model from the same
numbers through that package's own classes, and returns what the test
compares: dense states, ⟨H⟩, populations and bond dimensions, all
gauge-invariant but the last.  ``scripts/a9_gold.py tests --write`` runs the
JAX side once and stores it in :data:`FIXTURE`: one adaptive JAX step
recompiles its Krylov programs at every bond (about 0.3 s each on a CPU),
so the whole matrix takes minutes through JAX and under ten seconds
through the port.  ``tests/test_torch_adaptive.py`` runs one short case
through both packages live, ``tests/test_torch_adaptive_live.py`` one of
each other kind.

The gauges.  The JAX package completes QR with LAPACK on the CPU and with
MGS(×2) on accelerators; the port runs MGS on every device.  A gauge move
of a rank-deficient site (a padded start, a product state) picks its dead
columns by the completion, and the a1TDVP sweep then enriches and evolves
within that frame, so the two runs are compared on one gauge:

* ``mgs`` (the LVC and two-state cases): the JAX package pinned to its MGS
  gauge (``kernels._PALLAS_QR_FORCE``/``_PALLAS_QR_OFF``), the port's own.
  The JAX MGS gauge returns a Q with more columns than rows where a sweep
  has widened a bond past what the next site holds (N < r: its completion
  then runs out of directions), so these cases keep ``adaptive_Dmax`` at
  or below what every site holds (the LVC model's last bond holds 2).
* ``lapack`` (the LH2 chain): the JAX package's own CPU gauge, and the
  port's thin QR pinned to SciPy's LAPACK QR, which is the same routine
  (``jnp.linalg.qr`` on the CPU calls SciPy's LAPACK; ``torch.linalg.qr``
  another build, whose completions differ).
"""

from __future__ import annotations

import contextlib
import importlib
import os
import types

import numpy as np

#: the JAX package's runs, written by ``scripts/a9_gold.py tests --write``
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "a9_jax.npz")

#: the LVC exciton model of ``tests/test_exciton_propagate.py`` (4 sites:
#: three modes of 8 grid points and a 2-level exciton), 5 steps of 0.1 fs
LVC_STEPS = 5
LVC_DT_FS = 0.1
LVC_ADAPTIVE = dict(adaptive=True, adaptive_Dmax=2, adaptive_dD=2,
                    adaptive_p_proj=1.0e-9, adaptive_p_svd=1.0e-6,
                    thresh_exp=1.0e-11)
LVC_RELAX = ("none", "imaginary", "improved")
LVC_BONDS = (1, 4)

#: ``tests/test_adaptive.py:157``'s two-state model under the variable form
MS_KW = dict(stepsize=0.1, maxstep=10)
MS_ADAPTIVE = dict(adaptive=True, adaptive_Dmax=4, adaptive_dD=2,
                   adaptive_p_proj=1.0e-09, adaptive_p_svd=1.0e-09)

#: a small LH2 chain (``lh2_chain(nmol=1, nfock=3)``: 9 sites) at D=6 with
#: the example's adaptive settings, 3 steps of 0.2 fs through the Simulator
LH2_NMOL, LH2_NFOCK, LH2_BOND, LH2_STEPS, LH2_DT_FS = 1, 3, 6, 3, 0.2
LH2_ADAPTIVE = dict(adaptive=True, adaptive_Dmax=6, adaptive_p_svd=1.0e-20,
                    adaptive_p_proj=1.0e-09)


def mod(pkg: str, path: str):
    return importlib.import_module(f"pytdscf_{pkg}.{path}")


def dense(cores) -> np.ndarray:
    """The state vector of an MPS's numpy cores (l, n, r)."""
    out = cores[0]
    for c in cores[1:]:
        out = np.einsum("...r,rns->...ns", out, c)
    return out[0, ..., 0]


@contextlib.contextmanager
def gauge(pkg: str, kind: str):
    """The QR gauge of a run: ``mgs`` pins the JAX package to its MGS(×2)
    gauge (the port's own); ``lapack`` pins the port to SciPy's LAPACK QR
    (the JAX package's own on the CPU).  Either is undone on exit."""
    if pkg == "tpu" and kind == "mgs":
        import jax

        JK = mod("tpu", "mps.kernels")
        saved = JK._PALLAS_QR_FORCE, JK._PALLAS_QR_OFF
        JK._PALLAS_QR_FORCE = JK._PALLAS_QR_OFF = True
        jax.clear_caches()
        try:
            yield
        finally:
            JK._PALLAS_QR_FORCE, JK._PALLAS_QR_OFF = saved
            jax.clear_caches()
    elif pkg == "torch" and kind == "lapack":
        import scipy.linalg
        import torch

        K = mod("torch", "mps.kernels")

        def thin_qr(m):
            q, r = scipy.linalg.qr(m.cpu().numpy(), mode="economic")
            return torch.from_numpy(q), torch.from_numpy(r)

        saved = K.thin_qr
        K.thin_qr = thin_qr
        try:
            yield
        finally:
            K.thin_qr = saved
    else:
        yield


def _engine(pkg: str, cores, ham, cfg):
    TDVPEngine = mod(pkg, "mps.tdvp").TDVPEngine
    if pkg == "torch":
        return TDVPEngine(cores, ham, cfg, "cpu")
    return TDVPEngine(cores, ham, cfg)


def _simulator(pkg: str, job: str, model):
    Simulator = mod(pkg, "simulator").Simulator
    if pkg == "torch":
        return Simulator(job, model, verbose=0, device="cpu")
    return Simulator(job, model, verbose=0)


# ------------------------------------------------------------ LVC model
def lvc_hamiltonian(pkg: str):
    """``tests/test_exciton_propagate.py``'s basis and Hamiltonian, built
    by its own code from the package's classes."""
    from tests import test_exciton_propagate as jt

    basis = mod(pkg, "basis")
    prim = [basis.HarmonicOscillator(8, f, units="cm-1")
            for f in jt.freqs_cm1] + [basis.Exciton(nstate=2,
                                                    names=["S0", "S1"])]
    build = jt._build_hamiltonian
    scope = dict(build.__globals__, prim_info=prim,
                 TensorOperator=mod(pkg, "operators.tensor_op").TensorOperator,
                 TensorHamiltonian=mod(
                     pkg, "operators.hamiltonian").TensorHamiltonian)
    return prim, types.FunctionType(build.__code__, scope)()


def lvc_run(pkg: str, relax: str, bond: int, steps: int = LVC_STEPS,
            qr: str = "mgs") -> dict:
    """The LVC model from its Hartree product at bond dimension ``bond``,
    ``steps`` steps in mode ``relax`` through the package's engine on the
    ``qr`` gauge (:func:`gauge`): the dense state, ⟨H⟩ and the bond
    dimensions after them."""
    prim, ham = lvc_hamiltonian(pkg)
    units = mod(pkg, "units")
    vecs = [np.asarray(ho.get_unitary()[0]) for ho in prim[:3]] + [
        np.array([0.0, 1.0])]
    cores = [mod(pkg, "mps.lattice").alloc_hartree_product(
        [b.nprim for b in prim], bond, vecs)]
    Config = mod(pkg, "config").Config
    cfg = Config(relax=relax, **LVC_ADAPTIVE)
    if pkg == "tpu":
        cfg = cfg.replace(pallas_site=False)
    with gauge(pkg, qr):
        engine = _engine(pkg, cores, ham, cfg)
        for _ in range(steps):
            engine.propagate(LVC_DT_FS / units.au_in_fs)
        energy = engine.expectation(ham) if pkg == "tpu" else (
            engine.expectation())
        return {"dense": dense(engine.to_numpy()[0]),
                "energy": float(np.real(energy)),
                "bonds": np.asarray(engine.bond_dims())}


# ---------------------------------------------------- two-state model
def two_state_model(pkg: str):
    """``tests/test_adaptive.py:157``'s model: two molecules with two HO
    modes each (5 primitives), coupleJ 1e-3, D=4, the weight on state 0."""
    ho = mod(pkg, "basis").PrimBas_HO
    freqs, disps = [763.31, 1556.64], [0.317, 0.429]
    s0 = [ho(0.0, f, 5) for f in freqs]
    s1 = [ho(d, f, 5) for f, d in zip(freqs, disps)]
    prim, _, _, matJ = mod(pkg, "util.helper_input").matJ_1D_exciton(
        2, 5, s0, s1, 1.0e-03)
    basinfo = mod(pkg, "model").BasInfo(prim)
    ham = mod(pkg, "operators.sop").PolynomialHamiltonian(
        basinfo.get_ndof(), basinfo.get_nstate())
    ham.coupleJ = matJ
    ham.set_HO_potential(basinfo)
    model = mod(pkg, "model").Model(basinfo, {"hamiltonian": ham},
                                    bond_dim=4)
    model.init_weight_ESTATE = [1.0, 0.0]
    return model


def two_state_run(pkg: str, adaptive: bool,
                  steps: int = MS_KW["maxstep"]) -> dict:
    """The two-state model through the package's ``Simulator.propagate``
    (``steps`` steps on the MGS gauge), with :data:`MS_ADAPTIVE` or at
    fixed bonds: the populations, each state's dense vector and bond
    dimensions after the run.  Runs in the current directory."""
    kw = dict(MS_KW, maxstep=steps, **(MS_ADAPTIVE if adaptive else {}))
    with gauge(pkg, "mgs"):
        _, wf = _simulator(pkg, "ms_adp" if adaptive else "ms_fix",
                           two_state_model(pkg)).propagate(**kw)
        states = wf.engine.to_numpy()
        return {"pops": np.asarray(wf.engine.pop_states()),
                "dense": np.stack([dense(s) for s in states]),
                "bonds": np.asarray([[c.shape[2] for c in s[:-1]]
                                     for s in states])}


# ------------------------------------------------------ small LH2 chain
def lh2_model(pkg: str, nfock: int = LH2_NFOCK, bond: int = LH2_BOND):
    """``lh2_chain(nmol=LH2_NMOL, nfock)`` at D=``bond`` with the example's
    start (the γ exciton of the molecule excited) and its three chromophore
    projectors as observables: (model, projectors)."""
    lh2 = mod(pkg, "models.lh2")
    TensorHamiltonian = mod(pkg, "operators.hamiltonian").TensorHamiltonian
    TensorOperator = mod(pkg, "operators.tensor_op").TensorOperator
    basis, ham, site_map = lh2.lh2_chain(nmol=LH2_NMOL, nfock=nfock)
    proj = np.zeros((1, 2, 2, 1))
    proj[0, 1, 1, 0] = 1.0
    ops = {f"0{kind}": TensorHamiltonian(
        ndof=len(basis), potential=[[{
            (s, s): TensorOperator(mpo=[proj], legs=(s, s))}]], kinetic=None)
        for kind in ("gamma", "beta", "alpha")
        for s in site_map[kind]}
    model = mod(pkg, "model").Model(basis, {"hamiltonian": ham, **ops},
                                    bond_dim=bond)
    model.init_HartreeProduct = [lh2.lh2_initial_weights(basis, site_map)]
    return model, ops


def lh2_run(pkg: str, steps: int = LH2_STEPS) -> dict:
    """The small LH2 chain through the package's ``Simulator.propagate``
    (``steps`` steps on LAPACK's gauge; energy, populations and the
    projectors every step):
    the dense state, ⟨H⟩, the chromophore populations and the bond
    dimensions after the run, and the text of its ``bonddim.dat`` and
    ``expectations.dat``.  Runs in the current directory."""
    model, ops = lh2_model(pkg)
    with gauge(pkg, "lapack"):
        _, wf = _simulator(pkg, "lh2s", model).propagate(
            maxstep=steps, stepsize=LH2_DT_FS, energy=True,
            autocorr=False, observables=True, **LH2_ADAPTIVE)
        engine = wf.engine
        out = {"dense": dense(engine.to_numpy()[0]),
               "energy": float(np.real(engine.expectation(
                   model.hamiltonian))),
               "pops": np.asarray([float(np.real(engine.expectation(op)))
                                   for op in ops.values()]),
               "bonds": np.asarray(engine.bond_dims())}
    for name in ("bonddim", "expectations"):
        with open(os.path.join("lh2s_prop", f"{name}.dat")) as fh:
            out[f"{name}_dat"] = np.asarray(fh.read())
    return out


def all_runs(pkg: str) -> dict:
    """Every run of the fixture, flat (``"lvc/none/1/dense"``, ...), in
    the current directory."""
    out = {}
    for relax in LVC_RELAX:
        for bond in LVC_BONDS:
            for key, val in lvc_run(pkg, relax, bond).items():
                out[f"lvc/{relax}/{bond}/{key}"] = np.asarray(val)
    for adaptive in (True, False):
        tag = "adaptive" if adaptive else "fixed"
        for key, val in two_state_run(pkg, adaptive).items():
            out[f"ms/{tag}/{key}"] = np.asarray(val)
    for key, val in lh2_run(pkg).items():
        out[f"lh2/{key}"] = np.asarray(val)
    return out
