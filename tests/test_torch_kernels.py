"""Each kernel's plain torch twin against the JAX package's Pallas entry.

The JAX side runs as its own tests run it: on the CPU, ``interpret=True``,
float64 planes (x64 is on through ``tests/conftest.py``).  The port's
wrappers get CPU tensors, so they run their plain twins.  Both sides see
the same seeded numpy state and operators; float64 on both sides, so the
tolerance is 1e-10 (round-off of 128-term sums is ~1e-15).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from quantum_simulations_tpu.circuit import gates as G
from quantum_simulations_tpu.ops import pallas_kernels as rk
from quantum_simulations_tpu_torch.ops import panel_kernels as pk

ATOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    """pytest-xdist runs several workers on the machine's cores: numpy's
    and torch's thread pools then oversubscribe them, and the 128-wide
    panel products of these tests ran over 10x slower (174 s vs 11 s for
    tests/test_torch_schedule.py under 6 workers)."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _state(n, seed):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return psi / np.linalg.norm(psi)


def _unitary(dim, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim))
                        + 1j * rng.standard_normal((dim, dim)))
    return q


def _ref(fn, psi, *args, **kw):
    re, im = fn(jnp.asarray(psi.real), jnp.asarray(psi.imag), *args,
                interpret=True, **kw)
    return np.asarray(re) + 1j * np.asarray(im)


def _port(fn, psi, *args, **kw):
    re, im = fn(torch.from_numpy(psi.real.copy()),
                torch.from_numpy(psi.imag.copy()), *args, **kw)
    return re.numpy() + 1j * im.numpy()


def _check(got, want):
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) < ATOL


@pytest.mark.parametrize("n", [9, 12])
def test_lane_panel_matches_panel_apply_planar(n):
    psi, W = _state(n, n), _unitary(128, n + 1)
    _check(_port(pk.lane_panel, psi, W), _ref(rk.panel_apply_planar, psi, W))


@pytest.mark.parametrize("n,pos", [(14, 7), (15, 8), (16, 9), (17, 10), (18, 11)])
def test_positioned_panel_matches_reference(n, pos):
    psi, W = _state(n, pos), _unitary(128, pos + 1)
    _check(_port(pk.positioned_panel, psi, W, pos),
           _ref(rk.positioned_panel_planar, psi, W, pos))


@pytest.mark.parametrize("n,pos,w", [(12, 7, 5), (13, 9, 4), (10, 7, 3)])
def test_positioned_panel_ragged_top_window(n, pos, w):
    psi, W = _state(n, n), _unitary(1 << w, w)
    _check(_port(pk.positioned_panel, psi, W, pos),
           _ref(rk.positioned_panel_planar, psi, W, pos))


def _cnot(control_first: bool):
    return G.gate_matrix("CNOT", {}) if control_first else G.gate_matrix(
        "CNOT", {})[np.ix_((0, 2, 1, 3), (0, 2, 1, 3))]


STRADDLES = {
    "none": (None, None),
    "pre_cnot_qb7": ((6, 7, _cnot(True)), None),           # select path
    "pre_cnot_rev_qb13": ((6, 13, _cnot(False)), None),    # select, other mask
    "pre_cz_qb10": ((6, 10, np.diag([1, 1, 1, -1]).astype(complex)), None),  # real
    "pre_u4_qb13": ((6, 13, _unitary(4, 13)), None),       # complex terms
    "post_u4_qb10": (None, (6, 10, _unitary(4, 10))),
    "pre_u4_qb7_post_cnot_qb10": ((6, 7, _unitary(4, 7)), (6, 10, _cnot(True))),
}


@pytest.mark.parametrize("n", [14, 16])
@pytest.mark.parametrize("order", [(0, 7), (7, 0)], ids=["lane_first", "full_first"])
@pytest.mark.parametrize("strad", list(STRADDLES), ids=list(STRADDLES))
def test_dual_panel_matches_reference(n, order, strad):
    pre, post = STRADDLES[strad]
    psi = _state(n, n + order[0])
    W1, W2 = _unitary(128, 1), _unitary(128, 2)
    args = (W1, order[0], W2, order[1])
    _check(_port(pk.dual_panel, psi, *args, straddle=pre, post_straddle=post),
           _ref(rk.dual_panel_planar, psi, *args, straddle=pre,
                post_straddle=post))


@pytest.mark.parametrize("order", [(0, 7), (7, 0)], ids=["lane_first", "full_first"])
def test_dual_panel_small_state_branch(order):
    """n < 14: no (128, 128) tile; the reference's two-pass branch with a
    ragged pos-7 window and plain straddlers."""
    n = 12
    psi = _state(n, 5)
    Ws = {0: _unitary(128, 3), 7: _unitary(32, 4)}
    args = (Ws[order[0]], order[0], Ws[order[1]], order[1])
    pre, post = (6, 9, _cnot(True)), (6, 8, _unitary(4, 8))
    pk.reset_counts()
    got = _port(pk.dual_panel, psi, *args, straddle=pre, post_straddle=post)
    assert {k: v for k, v in pk.PLAIN_CALLS.items() if v} == {
        "lane_panel": 1, "positioned_panel": 1}
    _check(got, _ref(rk.dual_panel_planar, psi, *args, straddle=pre,
                     post_straddle=post))


def test_straddle_plan_matches_reference():
    for qb, U in ((7, _cnot(True)), (13, _cnot(False)), (10, _unitary(4, 1)),
                  (8, np.diag([1, 1, 1, -1]).astype(complex))):
        r = rk._straddle_plan(qb, U, jnp.float64)
        p = pk._straddle_plan(qb, U, np.float64)
        assert p[2] == r[2]
        np.testing.assert_array_equal(p[0], r[0])
        assert (p[1] is None) == (r[1] is None)
        if p[1] is not None:
            np.testing.assert_array_equal(p[1], r[1])


def test_planar_round_trip_and_float32_twin():
    psi = _state(14, 0).astype(np.complex64)
    t = torch.from_numpy(psi)
    re, im = pk.to_planar(t)
    assert re.dtype == torch.float32 and re.is_contiguous()
    assert torch.equal(pk.from_planar(re, im), t)
    W = _unitary(128, 9)
    got = _port(pk.lane_panel, psi, W)
    want = _ref(rk.panel_apply_planar, psi, W)
    assert float(np.max(np.abs(got - want))) < 2e-6  # float32 on both sides


def test_wrapper_rejects_bad_planes():
    re = torch.zeros(1 << 14, dtype=torch.float64)
    with pytest.raises(ValueError):
        pk.lane_panel(re, torch.zeros(1 << 13, dtype=torch.float64),
                      np.eye(128))
    with pytest.raises(ValueError, match="positions"):
        pk.dual_panel(re, re, np.eye(128), 0, np.eye(128), 8)
    with pytest.raises(ValueError, match="straddler"):
        pk.dual_panel(re, re, np.eye(128), 0, np.eye(128), 7,
                      straddle=(5, 7, np.eye(4)))
