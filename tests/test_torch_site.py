"""The fused whole-site update of the port (``mps/cuda_site.py``).

Its plain PyTorch version is held on the CPU against the JAX package, on
the operands of ``tests/test_pallas_site.py`` (l=4, d=3, r=5, nc=3):

* in complex64 against ``pallas_site.site_step_fused`` in interpret mode,
  with that test's bars: 5e-6 on the cores and blocks, |Δlog| < 5e-6, the
  same Krylov counts (both are float32 with the same Lanczos recurrence and
  Taylor exponential, summed in other orders; the JAX kernel factors the
  backward ψ in (l, d·r) order, the port in (r·d, l) order, which gives the
  same factors for a full-rank ψ).  The threshold is the chain's float32
  one, 1e-6: at that test's 1e-9, below what a float32 stopping test
  resolves, the JAX kernel's ‖ψ(k) − ψ(k−1)‖ stays at its rounding floor
  and runs to the cap (20) while the port's stops at k = 5, with results
  7e-8 apart, so the counts there say nothing about the port;
* in complex128 against ``tdvp._site_step_impl`` at 1e-10 (the same
  update in float64, the Taylor form of exp(scale·T)e₀ against ``eigh``,
  ~1e-11 apart per call).

The JAX side is pinned to its XLA MGS gauge (``K._PALLAS_QR_FORCE`` and
``_PALLAS_QR_OFF``) with its caches cleared, as ``tests/test_torch_engine.py``
does.  The CUDA kernel is
held against the plain version by the tests marked ``cuda``, which need an
NVIDIA GPU and skip elsewhere; JAX is imported inside the ``jx`` fixture,
so they also run where JAX is not installed.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_cluster_replay as replay
from pytdscf_torch import _cuda
from pytdscf_torch.config import Config
from pytdscf_torch.mps import cuda_lanczos as CL
from pytdscf_torch.mps import cuda_site as CS
from pytdscf_torch.mps.tdvp import _site_step

torch.set_num_threads(1)

L_, D_, R_, NC = 4, 3, 5, 3


@pytest.fixture(scope="module")
def jx():
    """The JAX functions, pinned for the whole module (its traces are
    reused from test to test; the caches are cleared around it)."""
    import jax
    import jax.numpy as jnp

    import pytdscf_tpu.mps.kernels as JK
    from pytdscf_tpu.mps import pallas_site
    from pytdscf_tpu.mps.tdvp import _site_step_impl

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JK, "_PALLAS_QR_FORCE", True)
        # the XLA MGS: the Pallas one is float32 even in a complex128 step
        mp.setattr(JK, "_PALLAS_QR_OFF", True)
        jax.clear_caches()
        yield SimpleNamespace(jnp=jnp, PS=pallas_site, impl=_site_step_impl)
        jax.clear_caches()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _rand_case(seed, l, d, r, nc):
    """``tests/test_pallas_site.py``'s operands: ψ, Hermitian W, L, R."""
    rng = np.random.default_rng(seed)

    def cplx(*shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) \
            / np.sqrt(np.prod(shape))

    psi = cplx(l, d, r)
    W = cplx(nc, d, d, nc)
    W = W + np.transpose(W, (0, 2, 1, 3)).conj()
    L = cplx(l, nc, l)
    L = 0.5 * (L + np.transpose(L, (2, 1, 0)).conj())
    R = cplx(r, nc, r)
    R = 0.5 * (R + np.transpose(R, (2, 1, 0)).conj())
    return psi, W, L / np.linalg.norm(L), R / np.linalg.norm(R)


def _case(forward):
    """(ψ, next core, L, W, R) of tests/test_pallas_site.py's parity test."""
    psi, W, L, R = _rand_case(7 if forward else 11, L_, D_, R_, NC)
    nxt = (_rand_case(23, R_, 3, 6, NC)[0] if forward
           else np.transpose(_rand_case(29, L_, 3, 6, NC)[0], (2, 1, 0)))
    return psi, nxt, L, W, R


def _port(arrays, dtype, logs, thresh=1e-9, **kw):
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    t = [torch.as_tensor(a).to(dtype) for a in arrays]
    lL, lR = (torch.tensor(x, dtype=rdt) for x in logs)
    return CS.site_step_fused_plain(*t, -0.05j, thresh, lL, lR, **kw)


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("conserve", [True, False])
def test_plain_matches_pallas_kernel(jx, forward, conserve, thresh=1e-6):
    psi, nxt, L, W, R = _case(forward)
    c64 = jx.jnp.complex64
    out, pn, blocks, log_new, kry = jx.PS.site_step_fused(
        *(jx.jnp.asarray(a, c64) for a in (psi, nxt, L, W, R)),
        jx.jnp.asarray(-0.05j, c64), jx.jnp.asarray(thresh, jx.jnp.float32),
        jx.jnp.asarray(0.37, jx.jnp.float32),
        jx.jnp.asarray(-0.21, jx.jnp.float32),
        forward=forward, max_dim=20, conserve=conserve,
    )
    got = _port((psi, nxt, L, W, R), torch.complex64, (0.37, -0.21),
                thresh=thresh, forward=forward, max_dim=20,
                conserve=conserve)
    for a, b in zip(got[:3], (out, pn, blocks)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-6)
    assert abs(float(got[3]) - float(log_new)) < 5e-6
    kH, badH, kK, badK = got[4].tolist()
    assert [kH + kK, 2, badH + badK] == np.asarray(kry).tolist()


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("conserve", [True, False])
def test_plain_matches_site_step_impl_c128(jx, forward, conserve):
    psi, nxt, L, W, R = _case(forward)
    c128 = jx.jnp.complex128
    f64 = jx.jnp.float64
    sites, nxts, blocks, logs, kry = jx.impl(
        (jx.jnp.asarray(psi, c128),), (jx.jnp.asarray(nxt, c128),),
        (jx.jnp.asarray(L, c128),), (jx.jnp.asarray(W, c128),),
        (jx.jnp.asarray(R, c128),), jx.jnp.asarray(-0.05j, c128), 1e-9,
        (jx.jnp.asarray(0.37, f64),), (jx.jnp.asarray(-0.21, f64),),
        pairs=((0, 0),), nstate=1, mode="real", conserve_norm=conserve,
        arnoldi=False, max_dim=20, last=False, forward=forward,
    )
    got = _port((psi, nxt, L, W, R), torch.complex128, (0.37, -0.21),
                forward=forward, max_dim=20, conserve=conserve)
    for a, b in zip(got[:3], (sites[0], nxts[0], blocks[0])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10)
    assert abs(float(got[3]) - float(logs[0])) < 1e-10
    kH, badH, kK, badK = got[4].tolist()
    assert [kH + kK, 2, badH + badK] == np.asarray(kry).tolist()


@pytest.mark.parametrize("forward", [True, False])
def test_plain_matches_the_unfused_route(forward):
    """On a rank-deficient ψ (dead columns in the gauge) the fused update
    equals the engine's separate steps, completions included."""
    psi, nxt, L, W, R = _case(forward)
    if forward:
        psi[:, :, 1] = 0.0  # a dead column of ψ as (l·d, r)
    else:
        psi[1] = 0.0  # a dead column of ψ as (r·d, l)
    c = torch.complex128
    t = [torch.as_tensor(a, dtype=c) for a in (psi, nxt, L, W, R)]
    lL, lR = torch.tensor(0.37, dtype=torch.float64), torch.tensor(-0.21, dtype=torch.float64)
    kw = dict(forward=forward, last=False)
    on = _site_step(*t, -0.05j, lL, lR, cfg=Config(fused_site=True), **kw)
    off = _site_step(*t, -0.05j, lL, lR, cfg=Config(fused_site=False), **kw)
    for a, b in ((on[0], off[0]), (on[1], off[1]), (on[2][0], off[2][0])):
        assert float(torch.max(torch.abs(a - b))) < 1e-10
    assert abs(float(on[2][1] - off[2][1])) < 1e-12
    assert torch.equal(torch.stack(on[3]), torch.stack(off[3]))


def test_site_fits_gates():
    # tests/test_pallas_site.py's cases
    assert CS.site_fits((4, 3, 5), (3, 3, 3, 3), (5, 3, 6), 20)
    assert not CS.site_fits((4, 3, 5), (2, 3, 3, 4), (5, 3, 6), 20)
    assert not CS.site_fits((4, 3, 5), (3, 3, 3, 3), (5, 3, 6), 64)
    assert not CS.site_fits((16, 1, 2), (3, 1, 1, 3), None, 20)
    # the chain's four non-square fused MPO cores (sites 0, 1, 182, 183)
    for W_shape, shape in (((1, 8, 8, 3), (1, 8, 8)), ((3, 8, 8, 4), (8, 8, 30)),
                           ((4, 8, 8, 3), (30, 8, 8)), ((3, 8, 8, 1), (8, 8, 1))):
        assert not CS.site_fits(shape, W_shape, None, 10)
    # its bulk and exciton sites fit, at every max_krylov up to the cap
    assert CS.site_fits((30, 8, 30), (4, 8, 8, 4), (30, 8, 30), 32)
    assert CS.site_fits((30, 3, 30), (4, 3, 3, 4), (30, 8, 30), 10)
    assert not CS.site_fits((30, 8, 30), (4, 8, 8, 4), (30, 8, 30), 33)


def test_route_by_shape():
    """Every fused site of the chain takes the cluster route in both
    directions; small sites the one-block route; the gate takes every
    shape that either route fits, as it took every one-block shape."""
    for shape, W_shape in (((30, 8, 30), (4, 8, 8, 4)),
                           ((30, 3, 30), (4, 3, 3, 4)),
                           ((8, 8, 30), (4, 8, 8, 4))):
        l, d, r = shape
        assert CS.route(W_shape[-1], l * d, r) == "cluster"
        assert CS.route(W_shape[0], r * d, l) == "cluster"
    assert CS.route(3, 12, 5) == "block"
    # the work area, T, w and prev, Q's rows, c1..c3 and two inboxes, σ, H's
    # slice and Q whole (the MGS factor works in place: no work vectors)
    assert CS.smem_bytes(4, 240, 30, "cluster", 16) == 8 * (
        7200 + 6 * 15 * 30 + 15 * 31 + (3 + 32) * 30 + 900 + 4 * 15 * 33
        + 7200)
    # on 8 CTAs the bulk fits too, with 0.9 KB to spare
    assert CS.smem_bytes(4, 240, 30, "cluster", 8) <= CS.MAX_SMEM
    # a site past the cluster's shared memory keeps the one-block route
    assert CS.route(2, 2048, 16) == "block"
    assert CS.site_fits((16, 128, 16), (2, 128, 128, 2), None, 10)
    assert CS.route(8, 4096, 64) is None


def test_wrapper_runs_plain_version_on_cpu():
    arrays = _case(True)
    t = [torch.as_tensor(a, dtype=torch.complex64) for a in arrays]
    lL, lR = torch.tensor(0.37), torch.tensor(-0.21)
    kw = dict(forward=True, max_dim=20, conserve=True)
    before = CS.site_step_fused.plain_calls, CS.site_step_fused.launches
    got = CS.site_step_fused(*t, -0.05j, 1e-9, lL, lR, **kw)
    ref = CS.site_step_fused_plain(*t, -0.05j, 1e-9, lL, lR, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert CS.site_step_fused.plain_calls == before[0] + 1
    assert CS.site_step_fused.launches == before[1]


def test_lanczos_fac_scales_the_matvec():
    """``fac`` on the matvec output equals ``fac`` folded into H."""
    psi, W, L, R = _rand_case(5, 4, 3, 5, 3)
    c = torch.complex128
    fac = torch.tensor(1.3, dtype=torch.float64)
    v = torch.as_tensor(psi, dtype=c).reshape(12, 5)
    folded = CL.heff_channels(*(torch.as_tensor(a, dtype=c) for a in (L, W, R)), fac)
    plain = CL.heff_channels(*(torch.as_tensor(a, dtype=c) for a in (L, W, R)))
    a, st_a = CL.lanczos_expm_plain(*folded, v, -0.1j, 1e-9, 20, True)
    b, st_b = CL.lanczos_expm_plain(*plain, v, -0.1j, 1e-9, 20, True, fac=fac)
    assert torch.equal(st_a, st_b)
    assert float(torch.max(torch.abs(a - b))) < 1e-13


@pytest.mark.parametrize("header", [False, True])
def test_build_digest_covers_headers(tmp_path, header):
    """An edit of a shared header renames the build, as an edit of a source
    does, so a stale library is never loaded."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    before = _cuda.source_digest(tmp_path)
    (tmp_path / ("h.cuh" if header else "a.cu")).write_text("// v2\n")
    assert _cuda.source_digest(tmp_path) != before
    assert _cuda.source_digest(_cuda.CSRC) == _cuda.source_digest()


@pytest.mark.parametrize("conserve", [False, True])
@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("shape,forward", [
    ((2, 4, 4, 3, 3, 6), True), ((4, 6, 5, 3, 3, 6), False),
    ((9, 3, 5, 3, 3, 6), True), ((30, 8, 30, 4, 8, 30), True),
])
def test_cluster_replay_matches_plain_c128(shape, forward, C, conserve):
    """The cluster route's algorithm (``tests/torch_cluster_replay.py``:
    the row split with empty ranks, rank-ordered partial sums, the x and Q
    gathers, the gauge on ψ₁ gathered whole, and the renormalisation's
    reduce-scatter of partial blocks) at M = 8, 24, 27 and 240, with and
    without norm conservation, equals the plain version in complex128,
    Krylov status included."""
    l, d, r, nc, d2, r2 = shape
    psi, W, L, R = _rand_case(51, l, d, r, nc)
    nxt = (_rand_case(52, r, d2, r2, nc)[0] if forward
           else np.transpose(_rand_case(53, l, d2, r2, nc)[0], (2, 1, 0)))
    c = torch.complex128
    t = [torch.as_tensor(a, dtype=c) for a in (psi, nxt, L, W, R)]
    lL, lR = torch.tensor(0.37, dtype=torch.float64), torch.tensor(
        -0.21, dtype=torch.float64)
    kw = dict(forward=forward, max_dim=10, conserve=conserve)
    got = replay.site_step(*t, -0.1j, 1e-6, lL, lR, C=C, **kw)
    ref = CS.site_step_fused_plain(*t, -0.1j, 1e-6, lL, lR, **kw)
    assert got[4].tolist() == ref[4].tolist()
    for a, b in zip(got[:4], ref[:4]):
        assert a.shape == b.shape
        assert float(torch.max(torch.abs(a - b))) < 1e-12


# ------------------------------------------------------------ on the card
def _card_case(seed, l, d, r, nc, d2, r2, device):
    psi, W, L, R = _rand_case(seed, l, d, r, nc)
    nxt_f = _rand_case(seed + 1, r, d2, r2, nc)[0]
    nxt_b = np.transpose(_rand_case(seed + 2, l, d2, r2, nc)[0], (2, 1, 0))
    t = lambda a: torch.as_tensor(a).to(device, torch.complex64)  # noqa: E731
    return t(psi), (t(nxt_f), t(nxt_b)), t(L), t(W), t(R)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 3, 5, 3, 3, 6), (30, 8, 30, 4, 8, 30),
                                   (30, 3, 30, 4, 8, 30), (8, 8, 30, 4, 8, 30)])
@pytest.mark.parametrize("forward", [True, False])
def test_kernel_matches_plain_on_card(cuda, shape, forward):
    l, d, r, nc, d2, r2 = shape
    psi, nxts, L, W, R = _card_case(41, l, d, r, nc, d2, r2, cuda)
    nxt = nxts[0] if forward else nxts[1]
    lL = torch.tensor(0.37, device=cuda)
    lR = torch.tensor(-0.21, device=cuda)
    args = (psi, nxt, L, W, R, -0.1j, 1e-6, lL, lR)
    kw = dict(forward=forward, max_dim=10, conserve=True)
    launches = CS.site_step_fused.launches
    got = CS.site_step_fused(*args, **kw)
    again = CS.site_step_fused(*args, **kw)
    ref = CS.site_step_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    assert CS.site_step_fused.launches == launches + 2
    assert torch.equal(got[4], ref[4])
    for a, b, c in zip(got[:3], ref[:3], again[:3]):
        assert a.shape == b.shape
        assert torch.equal(a, c)
        assert float(torch.max(torch.abs(a - b))) < 5e-6
    assert abs(float(got[3]) - float(ref[3])) < 5e-6


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    psi, nxts, L, W, R = _card_case(43, 4, 3, 5, 3, 3, 6, cuda)
    lL = lR = torch.tensor(0.0, device=cuda)
    with pytest.raises(TypeError):
        CS.site_step_fused(psi.to(torch.complex128), nxts[0], L, W, R, -0.1j,
                           1e-6, lL, lR, forward=True, max_dim=10,
                           conserve=True)
    with pytest.raises(ValueError):
        CS.site_step_fused(psi, nxts[0], L, W, R, -0.1j, 1e-6, lL, lR,
                           forward=True, max_dim=33, conserve=True)


@pytest.mark.cuda
@pytest.mark.parametrize("way,cluster", [("block", 16), ("cluster", 8),
                                         ("cluster", 16)])
@pytest.mark.parametrize("shape", [(30, 8, 30, 4, 8, 30), (30, 3, 30, 4, 8, 30),
                                   (2, 4, 8, 4, 8, 30), (9, 3, 5, 3, 3, 6)])
@pytest.mark.parametrize("forward", [True, False])
def test_kernel_routes_match_plain_on_card(cuda, way, cluster, shape,
                                           forward):
    """Both routes at the chain's bulk and exciton sites, the edge M = 8
    and M = 27 (which 8 and 16 do not divide): 5e-6 on the cores and
    blocks, |Δlog| < 5e-6, the plain version's status, and a second launch
    equal bit for bit."""
    l, d, r, nc, d2, r2 = shape
    psi, nxts, L, W, R = _card_case(47, l, d, r, nc, d2, r2, cuda)
    nxt = nxts[0] if forward else nxts[1]
    lL = torch.tensor(0.37, device=cuda)
    lR = torch.tensor(-0.21, device=cuda)
    args = (psi, nxt, L, W, R, -0.1j, 1e-6, lL, lR)
    kw = dict(forward=forward, max_dim=10, conserve=True)
    route = dict(way=way, cluster=cluster)
    M, rf = (l * d, r) if forward else (r * d, l)
    if CS.smem_bytes(nc, M, rf, way, cluster) > CS.MAX_SMEM:
        # (the bulk on 8 CTAs): refused, not run
        with pytest.raises(ValueError, match="does not take"):
            CS.site_step_fused(*args, **kw, **route)
        return
    before = CS.site_step_fused.route_launches[way]
    got = CS.site_step_fused(*args, **kw, **route)
    again = CS.site_step_fused(*args, **kw, **route)
    ref = CS.site_step_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    assert CS.site_step_fused.route_launches[way] == before + 2
    assert torch.equal(got[4], ref[4]) and torch.equal(got[4], again[4])
    for a, b, c in zip(got[:4], ref[:4], again[:4]):
        assert a.shape == b.shape
        assert torch.equal(a, c)
        assert float(torch.max(torch.abs(a - b))) < 5e-6


@pytest.mark.cuda
def test_cluster_that_cannot_be_scheduled_raises(cuda):
    psi, nxts, L, W, R = _card_case(49, 30, 8, 30, 4, 8, 30, cuda)
    lL = lR = torch.tensor(0.0, device=cuda)
    before = CS.site_step_fused.launches
    with pytest.raises(RuntimeError, match="cluster route"):
        CS.site_step_fused(psi, nxts[0], L, W, R, -0.1j, 1e-6, lL, lR,
                           forward=True, max_dim=10, conserve=True,
                           way="cluster", cluster=32)
    assert CS.site_step_fused.launches == before
