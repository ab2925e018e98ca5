"""The error budget of the panels' split-TF32 arithmetic, on the CPU.

The CUDA lane, positioned and dual panels at dim 128 (``csrc/panels.cu``,
namespace ``tc``) run each real product on the tensor cores as three
TF32 products, ``a_hi b_hi + a_hi b_lo + a_lo b_hi`` (3xTF32), with
``hi = cvt.rna.tf32.f32(x)`` and ``lo = cvt.rna.tf32.f32(x - hi)``, and
accumulate in float32; a complex product takes four real ones.  This
file emulates that arithmetic in numpy (the rounding below is PTX's
``cvt.rna``: 10 mantissa bits, to nearest, ties away from zero) and holds
it to the complex128 product: <= 2e-6 in ||diff||_2 per pass on a
unit-norm state, <= 1e-5 over the chain of nonstab33 and its inverse as
scheduled (24 positioned and 6 dual passes).  A dual pass is two such
contractions on one (128, 128) tile, the first's result rounded to
float32 in the tile between them, with its straddlers (float32) before
and after.  Single-pass TF32 misses 1e-5, which shows the bounds have
teeth.  The emulation sums in float32 rounded to nearest; the
tensor cores truncate when they accumulate, so the kernel adds each k8
step's products into its float32 sum with a rounded add.  The card holds
the kernels to the same numbers (chip_smoke.py phase 2;
tests/test_torch_cuda.py::test_panel_chain_drift_against_float64).
"""
import numpy as np
import pytest
import torch

from quantum_simulations_tpu_torch.circuit import library
from quantum_simulations_tpu_torch.circuit.panelize import (
    DualPanelOp, WindowPanelOp,
)
from quantum_simulations_tpu_torch.ops import panel_kernels as pk
from quantum_simulations_tpu_torch.runtime.simulator import schedule

TOL_PASS = 2e-6
TOL_CHAIN = 1e-5


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """float32 -> TF32 as ``cvt.rna.tf32.f32``: keep 10 mantissa bits,
    round to nearest with ties away from zero (the sign is apart from the
    magnitude bits, so adding half a unit of the kept last bit rounds
    both signs away)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = rna_tf32(x)
    return hi, rna_tf32(np.float32(x) - hi)


def mm3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as 3xTF32: three products of TF32 operands (each exact in
    float32), summed in float32."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as single-pass TF32 (not allowed in the port)."""
    return rna_tf32(a) @ rna_tf32(b)


def cmm(ar, ai, br, bi, mm):
    """The four-product complex form of the kernel: re = ar br + (-ai) bi,
    im = ar bi + ai br."""
    return mm(ar, br) + mm(-ai, bi), mm(ar, bi) + mm(ai, br)


def panel(x: np.ndarray, W: np.ndarray, layout: str, mm) -> np.ndarray:
    """One dim-128 pass on the complex (128, 128) view ``x``: the lane
    layout out[r, i] = sum_k W[i, k] x[r, k], the
    positioned one out[i, c] = sum_k W[i, k] x[k, c], computed as the
    kernel does it, out^T = x^T W^T."""
    f32 = np.float32
    xr, xi = x.real.astype(f32), x.imag.astype(f32)
    wr, wi = W.real.astype(f32).T.copy(), W.imag.astype(f32).T.copy()
    if layout == "lane":
        o_re, o_im = cmm(xr, xi, wr, wi, mm)
        return o_re + 1j * o_im.astype(np.float64)
    o_re, o_im = cmm(xr.T.copy(), xi.T.copy(), wr, wi, mm)
    return (o_re + 1j * o_im.astype(np.float64)).T


def reference(x: np.ndarray, W: np.ndarray, layout: str) -> np.ndarray:
    return x @ W.T if layout == "lane" else W @ x


def unit_state(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((128, 128)) + 1j * rng.standard_normal((128, 128))
    x /= np.linalg.norm(x)
    return x.astype(np.complex64).astype(np.complex128)


def unitary(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.standard_normal((128, 128))
                        + 1j * rng.standard_normal((128, 128)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def nonstab_panels(n: int = 14) -> list[np.ndarray]:
    """The 128 x 128 W's of non_stabilizer(n, depth=4, seed=7)'s window
    schedule (the chip's nonstab28 at a small n), each as float32 operands
    would hold it."""
    Ws = []
    for op, _ in schedule(library.non_stabilizer(n, depth=4, seed=7)):
        for p in (op, getattr(op, "first", None), getattr(op, "second", None)):
            W = getattr(p, "W", None)
            if W is not None and np.shape(W) == (128, 128):
                Ws.append(np.asarray(W, np.complex64).astype(np.complex128))
    return Ws


def test_rna_rounds_to_nearest_ties_away():
    one = np.float32(1)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                  1 + 3 * 2.0 ** -12, 0.0, -2.5], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, one + ulp, 0.0, -2.5],
                    np.float32)
    np.testing.assert_array_equal(rna_tf32(x), want)
    y = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    hi, lo = split(y)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    # hi + lo carries 21-22 significant bits: within 2^-21 of y.
    assert np.all(np.abs((hi.astype(np.float64) + lo) - y) <= 2.0 ** -21 * np.abs(y))


@pytest.mark.parametrize("layout", ["lane", "positioned"])
@pytest.mark.parametrize("source", ["nonstab", "random"])
def test_one_pass_within_budget(layout, source):
    Ws = nonstab_panels() if source == "nonstab" else [unitary(s) for s in range(4)]
    assert Ws, "the schedule has 128-wide panels"
    for s, W in enumerate(Ws):
        x = unit_state(100 + s)
        err = np.linalg.norm(panel(x, W, layout, mm3) - reference(x, W, layout))
        assert err <= TOL_PASS, (s, err)


def chain(Ws, mm) -> float:
    """24 passes, alternating layouts, each from the last pass's float32
    result; the distance to the complex128 chain at the end."""
    x = unit_state(7)
    ref = x.copy()
    for p in range(24):
        W, layout = Ws[p % len(Ws)], ("lane", "positioned")[p % 2]
        x = panel(x, W, layout, mm).astype(np.complex64).astype(np.complex128)
        ref = reference(ref, W, layout)
    return float(np.linalg.norm(x - ref))


@pytest.mark.parametrize("source", ["nonstab", "random"])
def test_24_pass_chain_within_budget(source):
    Ws = nonstab_panels() if source == "nonstab" else [unitary(s) for s in range(6)]
    assert chain(Ws, mm3) <= TOL_CHAIN


@pytest.mark.parametrize("source", ["nonstab", "random"])
def test_single_pass_tf32_misses_the_budget(source):
    Ws = nonstab_panels() if source == "nonstab" else [unitary(s) for s in range(4)]
    x = unit_state(3)
    err = np.linalg.norm(panel(x, Ws[0], "lane", mm1) - reference(x, Ws[0], "lane"))
    assert err > TOL_CHAIN
    assert chain(Ws, mm1) > TOL_CHAIN


# ---------------------------------------------------------------------------
# The dual pass: the tile (d, l) of the (A, 128, 128) view
# ---------------------------------------------------------------------------

LAYOUT = {0: "lane", 7: "positioned"}  # dual mode 0 contracts l, mode 1 d


def straddle(x: np.ndarray, qb: int, U, dtype) -> np.ndarray:
    """The (6, qb) gate on a (128, 128) tile (U in (6, qb) order, basis
    2 * lane bit 6 + row bit qb - 7), computed in ``dtype``."""
    dbit = qb - 7
    v = x.astype(dtype).reshape(128 >> (dbit + 1), 2, 1 << dbit, 2, 64)
    U4 = np.asarray(U).astype(dtype).reshape(2, 2, 2, 2)
    return np.einsum("LQlq,aqblc->aQbLc", U4, v).reshape(128, 128)


def dual(x, W1, p1, W2, p2, pre=None, post=None, mm=None) -> np.ndarray:
    """One dual pass on the tile: with ``mm`` as the kernel computes it
    (float32 tile between the steps), without in complex128."""
    c64 = np.complex64
    f = (lambda y: y.astype(c64).astype(np.complex128)) if mm else (lambda y: y)
    if pre is not None:
        x = f(straddle(x, *pre, c64 if mm else np.complex128))
    for W, p in ((W1, p1), (W2, p2)):
        x = f(panel(x, W, LAYOUT[p], mm) if mm else reference(x, W, LAYOUT[p]))
    if post is not None:
        x = f(straddle(x, *post, c64 if mm else np.complex128))
    return x


def test_dual_reference_is_the_twin():
    """The complex128 dual above is dual_panel_plain on one tile."""
    x = unit_state(5)
    W1, W2 = unitary(1), unitary(2)
    pre, post = (10, unitary(3)[:4, :4]), (13, unitary(4)[:4, :4])
    for p1, p2 in ((0, 7), (7, 0)):
        got = dual(x, W1, p1, W2, p2, pre, post)
        t = pk.dual_panel_plain(torch.from_numpy(x.real.ravel().copy()),
                                torch.from_numpy(x.imag.ravel().copy()),
                                W1, p1, W2, p2, straddle=(6, *pre),
                                post_straddle=(6, *post))
        want = (t[0].numpy() + 1j * t[1].numpy()).reshape(128, 128)
        assert np.abs(got - want).max() < 1e-12


def _four(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).standard_normal((4, 4))
                        + 1j * np.random.default_rng(seed + 1).standard_normal((4, 4)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


@pytest.mark.parametrize("order", [(0, 7), (7, 0)], ids=["lane_first", "full_first"])
@pytest.mark.parametrize("strad", ["none", "pre", "pre_post"])
def test_dual_pass_within_budget(order, strad):
    pre = (7 + 3 * order[0] // 7, _four(1)) if strad != "none" else None
    post = (13, _four(3)) if strad == "pre_post" else None
    for s in range(3):
        x = unit_state(200 + s)
        W1, W2 = unitary(10 + s), unitary(20 + s)
        got = dual(x, W1, order[0], W2, order[1], pre, post, mm3)
        want = dual(x, W1, order[0], W2, order[1], pre, post)
        assert np.linalg.norm(got - want) <= TOL_PASS, (s, np.linalg.norm(got - want))


def nonstab33_chain(mm) -> float:
    """nonstab33 and its inverse as scheduled (24 positioned and 6 dual
    passes; the diagonal runs are left out: they do not run on the tensor
    cores), each pass on the tile from the last pass's float32 result;
    the distance to the complex128 chain at the end."""
    cd = library.non_stabilizer(33, depth=4, seed=7)
    swap = {"T": "TDG", "TDG": "T"}
    inv = dict(cd, gates=[dict(g, gate=swap.get(g["gate"], g["gate"]))
                          for g in reversed(cd["gates"])])
    ops = [op for c in (cd, inv) for op, _ in schedule(c)]
    kinds = [type(op).__name__ for op in ops]
    assert kinds.count("WindowPanelOp") == 24 and kinds.count("DualPanelOp") == 6

    def strad(s):
        return None if s is None else (s[1], s[2])

    x = unit_state(33)
    ref = x.copy()
    for op in ops:
        if isinstance(op, WindowPanelOp):
            x = panel(x, op.W, "positioned", mm).astype(np.complex64).astype(np.complex128)
            ref = reference(ref, op.W, "positioned")
        elif isinstance(op, DualPanelOp):
            args = (op.first.W, op.first.pos, op.second.W, op.second.pos,
                    strad(op.pre_straddle), strad(op.post_straddle))
            x = dual(x, *args, mm=mm)
            ref = dual(ref, *args)
    return float(np.linalg.norm(x - ref))


def test_nonstab33_chain_within_budget():
    assert nonstab33_chain(mm3) <= TOL_CHAIN


def test_nonstab33_chain_single_pass_tf32_misses_the_budget():
    assert nonstab33_chain(mm1) > TOL_CHAIN
