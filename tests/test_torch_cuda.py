"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips without a card (decided inside the
fixture, never at import).  On a machine with a card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Float32 kernels against float32 twins (cuBLAS products, TF32 off): the
two sum 128 terms in different orders, so they differ by float32
round-off, ~1e-7 in ||diff||_2 for a unit-norm state; the bound is 1e-5.
"""
import numpy as np
import pytest
import torch

from quantum_simulations_tpu_torch.circuit import library
from quantum_simulations_tpu_torch.ops import panel_kernels as pk

pytestmark = pytest.mark.cuda
TOL_L2 = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _state(n, seed, dev):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi /= np.linalg.norm(psi)
    return (torch.as_tensor(psi.real, dtype=torch.float32, device=dev),
            torch.as_tensor(psi.imag, dtype=torch.float32, device=dev))


def _unitary(dim, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim))
                        + 1j * rng.standard_normal((dim, dim)))
    return q


def _l2(a, b):
    return float(torch.sqrt(((a[0] - b[0]).double() ** 2).sum()
                            + ((a[1] - b[1]).double() ** 2).sum()))


@pytest.mark.parametrize("n,w", [(14, 7), (13, 6), (9, 3), (3, 3)])
def test_lane_panel(dev, n, w):
    x, W = _state(n, n, dev), _unitary(1 << w, w)
    before = pk.LAUNCHES["lane_panel"]
    got = pk.lane_panel(*x, W)
    assert pk.LAUNCHES["lane_panel"] == before + 1
    assert _l2(got, pk.lane_panel_plain(*x, W)) < TOL_L2


@pytest.mark.parametrize("n,pos,w", [(16, 7, 7), (17, 10, 7), (16, 9, 7),
                                     (12, 7, 5), (10, 8, 2), (9, 2, 4)])
def test_positioned_panel(dev, n, pos, w):
    x, W = _state(n, pos, dev), _unitary(1 << w, pos + w)
    got = pk.positioned_panel(*x, W, pos)
    assert _l2(got, pk.positioned_panel_plain(*x, W, pos)) < TOL_L2


@pytest.mark.parametrize("order", [(0, 7), (7, 0)])
@pytest.mark.parametrize("qb", [7, 10, 13])
def test_dual_panel_straddlers(dev, order, qb):
    x = _state(15, qb, dev)
    W1, W2 = _unitary(128, 1), _unitary(128, 2)
    pre, post = (6, qb, _unitary(4, qb)), (6, 20 - qb, _unitary(4, 3))
    got = pk.dual_panel(*x, W1, order[0], W2, order[1], straddle=pre,
                        post_straddle=post)
    want = pk.dual_panel_plain(*x, W1, order[0], W2, order[1], straddle=pre,
                               post_straddle=post)
    assert _l2(got, want) < TOL_L2


def test_float64_planes_raise(dev):
    x = torch.zeros(1 << 14, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError, match="float32"):
        pk.lane_panel(x, x, np.eye(128))


def test_simulate_on_card_matches_float64_twins(dev):
    from quantum_simulations_tpu_torch.runtime import simulator

    cd = library.non_stabilizer(18)
    pk.reset_counts()
    got = simulator.simulate(cd, mode="window", device=dev)
    assert pk.LAUNCHES["dual_panel"] == 2 and not any(pk.PLAIN_CALLS.values())
    want = simulator.simulate(cd, mode="window", dtype="complex128",
                              device=dev, plain=True)
    assert float(torch.linalg.vector_norm(got.to(torch.complex128) - want)) < TOL_L2
