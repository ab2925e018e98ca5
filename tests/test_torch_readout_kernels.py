"""``ops/sampling.zstring_sums``: every Z-string of a call from one pass
over the state, through the ``zstring_sum`` kernel
(``ops/readout_kernels``) on the card and its plain twin elsewhere.

On the CPU the plain twin is held to the per-mask readout the port had
before the kernel (``_per_mask_readout``, kept here as the oracle) within
1e-12, for complex64, planar float32 and complex128 input, with the chunk
width lowered so that masks have bits above and below it.  The tests
marked ``cuda`` hold the kernel to the twin on the card (skipped without
one; decided inside the fixture).  On a machine with a card and without
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_readout_kernels.py
"""
import numpy as np
import pytest
import torch

from quantum_simulations_tpu_torch.circuit import library
from quantum_simulations_tpu_torch.ops import observables
from quantum_simulations_tpu_torch.ops import readout_kernels as rk
from quantum_simulations_tpu_torch.ops import sampling

TOL_TWIN = 1e-12   # the twin repeats the per-mask arithmetic
TOL_CARD = 1e-6    # float32 |psi|^2 summed in another order, unit norm


def _per_mask_readout(re, im, qubits) -> float:
    """<Z...Z> as the port read it before the kernel: one pass a string,
    the sign table of the bits below the chunk width shared by every
    chunk, one sign a chunk for the bits above."""
    mask = 0
    for q in qubits:
        mask |= 1 << q
    L = sampling._chunk(re)
    signs = 1.0 - 2.0 * sampling._bit_parity(L, mask & (L - 1),
                                             re.device).to(re.dtype)
    acc = torch.zeros((), dtype=torch.float64, device=re.device)
    for start, p in sampling._prob_chunks(re, im):
        sign = -1.0 if bin(start & mask).count("1") & 1 else 1.0
        acc += sign * p.mul_(signs).sum(dtype=torch.float64)
        del p
    return float(acc)


def _state(n, seed, kind):
    """A random unit state as the readout gets it: a complex tensor's
    views ("complex64", "complex128") or two contiguous float32 planes."""
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi /= np.linalg.norm(psi)
    if kind == "planes":
        return (torch.tensor(psi.real, dtype=torch.float32),
                torch.tensor(psi.imag, dtype=torch.float32))
    t = torch.tensor(psi, dtype=getattr(torch, kind))
    return t.real, t.imag


def _strings(n, seed):
    """Weight 0 to 4 (at most n) strings, and the top qubit alone and with
    qubit 0."""
    rng = np.random.default_rng(seed)
    out = [sorted(int(q) for q in rng.choice(n, min(w, n), replace=False))
           for w in range(5)]
    return out + [[n - 1], [0, n - 1]]


def _edges(n, seed):
    rng = np.random.default_rng(seed)
    pairs = {tuple(sorted(int(q) for q in rng.choice(n, 2, replace=False)))
             for _ in range(2 * n)}
    return sorted(pairs)


@pytest.fixture(params=[False, True], ids=["chunk26", "chunks"])
def chunked(request, monkeypatch):
    """With ``True`` the chunk width is lowered to n // 2 bits (set by the
    test through the returned setter), so a state has several chunks."""
    def set_for(n):
        if request.param:
            monkeypatch.setattr(sampling, "CHUNK_BITS", max(1, n // 2))
    return set_for


@pytest.mark.parametrize("kind", ["complex64", "planes", "complex128"])
@pytest.mark.parametrize("n", [3, 10, 14])
def test_twin_matches_the_per_mask_readout(n, kind, chunked):
    chunked(n)
    re, im = _state(n, n, kind)
    strings = _strings(n, n + 1)
    got = sampling.zstring_sums(re, im, [sampling.qubit_mask(s) for s in strings])
    assert got.dtype == torch.float64 and got.shape == (len(strings),)
    for k, s in enumerate(strings):
        want = _per_mask_readout(re, im, s)
        assert abs(float(got[k]) - want) < TOL_TWIN
        assert abs(sampling.expectation_z_planar(re, im, s) - want) < TOL_TWIN
    assert abs(float(got[0]) - 1.0) < 1e-5   # weight 0: the norm


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("kind", ["complex64", "planes", "complex128"])
@pytest.mark.parametrize("n", [10, 14])
def test_maxcut_energy_matches_the_per_edge_sum(n, kind, weighted, chunked):
    chunked(n)
    re, im = _state(n, 2 * n, kind)
    edges = _edges(n, n)
    w = (list(np.random.default_rng(n).uniform(0.1, 2.0, len(edges)))
         if weighted else None)
    want = sum(0.5 * wij * (1.0 - _per_mask_readout(re, im, [i, j]))
               for (i, j), wij in zip(edges, w or [1.0] * len(edges)))
    psi = (re, im) if kind == "planes" else torch.complex(re, im)
    assert abs(observables.maxcut_energy(psi, edges, w) - want) < TOL_TWIN


def test_one_pass_a_call():
    re, im = _state(8, 1, "complex64")
    rk.reset_counts()
    sampling.reset_counts()
    sampling.zstring_sums(re, im, [1, 3, 6, 0, 255])
    assert (sampling.READOUT_PASSES, rk.PLAIN_CALLS["zstring_sum"],
            rk.LAUNCHES["zstring_sum"]) == (1, 1, 0)
    sampling.expectation_z_planar(re, im, [2, 5])
    assert (sampling.READOUT_PASSES, rk.PLAIN_CALLS["zstring_sum"]) == (2, 2)
    observables.maxcut_energy(torch.complex(re, im), _edges(8, 2))
    assert (sampling.READOUT_PASSES, rk.PLAIN_CALLS["zstring_sum"],
            rk.LAUNCHES["zstring_sum"]) == (3, 3, 0)


@pytest.mark.parametrize("cap,K", [(3, 7), (rk.CAP, rk.CAP + 2)],
                         ids=["cap3", "cap128"])
def test_more_masks_than_the_cap(monkeypatch, cap, K):
    monkeypatch.setattr(rk, "CAP", cap)
    re, im = _state(9, 5, "planes")
    masks = [int(m) for m in np.random.default_rng(K).integers(0, 1 << 9, K)]
    sampling.reset_counts()
    rk.reset_counts()
    got = sampling.zstring_sums(re, im, masks)
    groups = -(-K // cap)
    assert sampling.READOUT_PASSES == groups
    assert rk.PLAIN_CALLS["zstring_sum"] == groups
    for k, m in enumerate(masks):
        qubits = [q for q in range(9) if m >> q & 1]
        assert abs(float(got[k]) - _per_mask_readout(re, im, qubits)) < TOL_TWIN


def test_no_masks_read_nothing():
    re, im = _state(5, 2, "planes")
    sampling.reset_counts()
    assert sampling.zstring_sums(re, im, []).shape == (0,)
    assert observables.maxcut_energy((re, im), []) == 0.0
    assert sampling.READOUT_PASSES == 0


def test_masks_of_the_top_bits():
    """Mask bits at or above n read as 0: the index has none there."""
    re, im = _state(6, 3, "planes")
    got = sampling.zstring_sums(re, im, [(1 << 63) | 1, 1, 1 << 40])
    assert abs(float(got[0]) - float(got[1])) < TOL_TWIN
    assert abs(float(got[2]) - 1.0) < 1e-5
    with pytest.raises(ValueError):
        sampling.zstring_sums(re, im, [1 << 64])


def test_planes_no_path_takes_raise():
    re, im = _state(6, 3, "planes")
    with pytest.raises(ValueError):
        sampling.zstring_sums(re, im[:32], [1])
    with pytest.raises(RuntimeError):
        sampling.zstring_sums(re.to("meta"), im.to("meta"), [1])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_state(n, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    psi = torch.randn(1 << n, dtype=torch.complex64, device=dev, generator=g)
    return psi / torch.linalg.vector_norm(psi)


def _qaoa_edges(n):
    return sorted({tuple(g["qubits"]) for g in library.qaoa_maxcut(n)["gates"]
                   if g["gate"] == "RZZ"})


def _card_masks(n):
    rng = np.random.default_rng(n)
    strings = _strings(n, n) + [[n - 2, n - 1], [5, 13, n - 1],
                                [0, 7, 8, 12, 13, n - 1]]
    strings += [sorted(int(q) for q in rng.choice(n, 3, replace=False))
                for _ in range(8)]
    return ([sampling.qubit_mask(s) for s in strings]
            + [(1 << i) | (1 << j) for i, j in _qaoa_edges(n)])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["interleaved", "planar"])
@pytest.mark.parametrize("n", [20, 28])
def test_kernel_matches_twin(dev, n, layout):
    psi = _card_state(n, n, dev)
    re, im = ((psi.real, psi.imag) if layout == "interleaved"
              else (psi.real.contiguous(), psi.imag.contiguous()))
    masks = _card_masks(n)
    assert len(masks) <= rk.CAP
    before = rk.LAUNCHES["zstring_sum"]
    got = sampling.zstring_sums(re, im, masks)
    again = sampling.zstring_sums(re, im, masks)
    assert rk.LAUNCHES["zstring_sum"] == before + 2
    assert got.device == re.device
    assert torch.equal(got, again)
    want = sampling.zstring_sums_plain(re, im, masks)
    assert float((got - want).abs().max()) < TOL_CARD


@pytest.mark.cuda
def test_maxcut_energy_of_qaoa28_on_card(dev):
    n = 28
    psi = _card_state(n, 3, dev)
    edges = _qaoa_edges(n)
    assert len(edges) == 50
    w = list(np.random.default_rng(3).uniform(0.1, 2.0, len(edges)))
    before = rk.LAUNCHES["zstring_sum"]
    got = observables.maxcut_energy(psi, edges, w)
    assert rk.LAUNCHES["zstring_sum"] == before + 1
    zz = sampling.zstring_sums_plain(psi.real, psi.imag,
                               [(1 << i) | (1 << j) for i, j in edges])
    want = sum(0.5 * wij * (1.0 - float(z)) for z, wij in zip(zz, w))
    assert abs(got - want) < 0.5 * sum(w) * TOL_CARD


@pytest.mark.cuda
def test_more_masks_than_the_cap_on_card(dev):
    psi = _card_state(16, 4, dev)
    masks = [int(m) for m in np.random.default_rng(1).integers(0, 1 << 16, 2 * rk.CAP + 5)]
    before = rk.LAUNCHES["zstring_sum"]
    got = sampling.zstring_sums(psi.real, psi.imag, masks)
    assert rk.LAUNCHES["zstring_sum"] == before + 3
    want = sampling.zstring_sums_plain(psi.real, psi.imag, masks)
    assert float((got - want).abs().max()) < TOL_CARD


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 2, 5])
def test_tiny_states_on_card(dev, n):
    psi = _card_state(n, 6, dev)
    masks = [0, 1, (1 << n) - 1, 1 << 63]
    for re, im in ((psi.real, psi.imag),
                   (psi.real.contiguous(), psi.imag.contiguous())):
        got = sampling.zstring_sums(re, im, masks)
        want = sampling.zstring_sums_plain(re, im, masks)
        assert float((got - want).abs().max()) < TOL_CARD


@pytest.mark.cuda
def test_float64_on_card_runs_the_twin(dev):
    psi = _card_state(12, 5, dev).to(torch.complex128)
    masks = [1, 6, 1 << 11]
    before = (rk.LAUNCHES["zstring_sum"], rk.PLAIN_CALLS["zstring_sum"])
    got = sampling.zstring_sums(psi.real, psi.imag, masks)
    assert (rk.LAUNCHES["zstring_sum"], rk.PLAIN_CALLS["zstring_sum"]) == (
        before[0], before[1] + 1)
    want = sampling.zstring_sums(psi.real.cpu(), psi.imag.cpu(), masks)
    assert float((got.cpu() - want).abs().max()) < TOL_TWIN


@pytest.mark.cuda
def test_strided_float32_planes_raise(dev):
    psi = _card_state(12, 7, dev)
    re, im = psi.real.contiguous(), psi.imag.contiguous()
    with pytest.raises(ValueError):
        sampling.zstring_sums(re[::2], im[::2], [1])
    with pytest.raises(TypeError):
        sampling.zstring_sums(re.half(), im.half(), [1])
