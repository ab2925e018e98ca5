"""Readout of a statevector: norm, expectation values, qubit
probabilities, top amplitudes and sampling, in plain torch.

Port of ``quantum_simulations_tpu/ops/sampling.py``.  The dense half
(``probabilities``, ``norm``, ``expectation_z``, ``qubit_probability``,
``sample``, ``sample_bits``, :16-124) takes a complex tensor or its
``(re, im)`` planes and reads the planes through the planar half below:
the same sums and the same sampler at every size.  The planar half
(``_parity_fold`` / ``_bit_parity`` :28-42, :141-285) is the capacity
tier's readout; ``collapse_planar_`` is the trajectory tier's collapse
in place, and ``normalize`` / ``project`` / ``measure_qubit`` /
``fidelity`` (:24, :62, :75, :124) work on complex tensors.  The reference
leans on XLA fusing ``re * re + im * im`` into each reduction.  Here every
reduction runs over chunks of at most 2^``CHUNK_BITS`` = 2^26 amplitudes and no
temporary is larger than a chunk (256 MiB of float32), one at a time: at
n = 33 the probability vector alone would be 32 GiB, and the card holds
about 15 GiB beside the two planes; the sampler at n = 30 holds under
1 GiB beside its 8 GiB of planes.  <Z...Z> is the exception:
``zstring_sums`` reads every Z-string of a call in one pass through the
``zstring_sum`` kernel (``readout_kernels``: no temporary), or, on the CPU
and for float64 planes, through its plain twin, chunked as above.
Sums accumulate in float64 (the reference sums in float32).  Indices are
int64 (the reference keeps int32 for n <= 31; qpe(32)'s answer lies above
2^32), and random draws come from an explicit seeded ``torch.Generator``:
samples follow the same distribution as the reference's, not its bits.
"""
from __future__ import annotations

import torch

from ..utils import timing
from . import readout_kernels

CHUNK_BITS = 26
# One per pass of a dense readout over a whole state's planes (norm,
# <Z...Z> of up to readout_kernels.CAP strings, a qubit's probability, the
# top amplitudes' block maxima, the sampler's block masses); the rows a
# sampler or top-k gathers are not.
READOUT_PASSES = 0


def reset_counts() -> None:
    global READOUT_PASSES
    READOUT_PASSES = 0


def _n_of(re: torch.Tensor) -> int:
    return re.numel().bit_length() - 1


def _chunk(re: torch.Tensor, at_least: int = 1) -> int:
    return min(re.numel(), max(1 << CHUNK_BITS, at_least))


def _prob_chunks(re: torch.Tensor, im: torch.Tensor, at_least: int = 1):
    """``(start, p)`` for each chunk [start, start + len): p = |psi|^2 of
    its amplitudes, one float temporary of the chunk's length (at least
    ``at_least`` amplitudes, a readout block).  One ``READOUT_PASSES``."""
    global READOUT_PASSES
    READOUT_PASSES += 1
    step = _chunk(re, at_least)
    for start in range(0, re.numel(), step):
        r, i = re[start:start + step], im[start:start + step]
        p = r * r
        p.addcmul_(i, i)
        yield start, p
        del p  # before the next chunk's: the caller drops its own first


def _block_bits(n: int, floor: int = 3, cap: int = 15) -> int:
    """Block width for hierarchical planar readout: ~sqrt(N), <= 2^15
    (keeps per-shot gathered rows small), >= 2^3 (clamped to n)."""
    return min(n, max(floor, min(cap, n // 2)))


def _parity_fold(bits: torch.Tensor) -> torch.Tensor:
    """Popcount parity of each element by xor folds (int32 or int64)."""
    if bits.dtype == torch.int64:
        bits = bits ^ (bits >> 32)
    for s in (16, 8, 4, 2, 1):
        bits = bits ^ (bits >> s)
    return (bits & 1).to(torch.int32)


def _bit_parity(n_amps: int, mask: int, device) -> torch.Tensor:
    """Parity of ``i & mask`` for i < n_amps (int32 indices up to 2^31)."""
    dt = torch.int32 if n_amps <= (1 << 31) else torch.int64
    idx = torch.arange(n_amps, dtype=dt, device=device)
    return _parity_fold(idx & mask)


def norm2_planar(re: torch.Tensor, im: torch.Tensor) -> float:
    acc = torch.zeros((), dtype=torch.float64, device=re.device)
    for _, p in _prob_chunks(re, im):
        acc += p.sum(dtype=torch.float64)
        del p
    return float(acc)


def qubit_mask(qubits) -> int:
    m = 0
    for q in qubits:
        m |= 1 << q
    return m


def zstring_sums_plain(re: torch.Tensor, im: torch.Tensor,
                       masks) -> torch.Tensor:
    """The plain twin of one ``zstring_sum`` launch: each chunk's |psi|^2
    once, and for each mask in turn its signs over the chunk's index bits
    as the outer product of two tables of about sqrt(chunk) entries (the
    low and the high half of the bits; built once a call), one sign a
    chunk for the bits above.  The float32 products are exact sign flips,
    summed in float64 by rows, then signed rows in float64."""
    readout_kernels.PLAIN_CALLS["zstring_sum"] += 1
    L = _chunk(re)
    bits = L.bit_length() - 1
    lo = bits // 2
    signs = [(1.0 - 2.0 * _bit_parity(1 << lo, m & ((1 << lo) - 1),
                                      re.device).to(re.dtype),
              1.0 - 2.0 * _bit_parity(L >> lo, (m & (L - 1)) >> lo,
                                      re.device).to(torch.float64))
             for m in masks]
    acc = torch.zeros(len(masks), dtype=torch.float64, device=re.device)
    for start, p in _prob_chunks(re, im):
        rows = p.view(-1, 1 << lo)
        for k, m in enumerate(masks):
            low, high = signs[k]
            part = (rows * low).sum(dim=1, dtype=torch.float64) @ high
            acc[k] += -part if bin(start & m).count("1") & 1 else part
        del p, rows
    return acc


def zstring_sums(re: torch.Tensor, im: torch.Tensor, masks) -> torch.Tensor:
    """S_k = sum_i |psi_i|^2 (-1)^popcount(i & m_k) for each of ``masks``
    (ints of up to 64 bits: the qubits of a Z-string), a (K,) float64
    tensor on the planes' device: <Z...Z> of a normalised state.  One pass
    over the state, and one ``READOUT_PASSES``, for each
    ``readout_kernels.CAP`` masks: the kernel where it takes the planes
    (CUDA float32), else the plain twin."""
    global READOUT_PASSES
    masks = [int(m) for m in masks]
    if any(m < 0 or m >> 64 for m in masks):
        raise ValueError("zstring_sums: masks are unsigned 64-bit")
    card = readout_kernels.takes(re, im)
    parts = []
    for g in range(0, len(masks), readout_kernels.CAP):
        group = masks[g:g + readout_kernels.CAP]
        if card:
            parts.append(readout_kernels.zstring_sum(re, im, group))
            READOUT_PASSES += 1
        else:  # _prob_chunks counts the pass
            parts.append(zstring_sums_plain(re, im, group))
    if not parts:
        return torch.zeros(0, dtype=torch.float64, device=re.device)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def expectation_z_planar(re: torch.Tensor, im: torch.Tensor, qubits) -> float:
    """<Z...Z> on planes (or a complex tensor's ``.real`` / ``.imag``): one
    ``zstring_sums`` pass, one host read."""
    return float(zstring_sums(re, im, [qubit_mask(qubits)])[0])


def qubit_probability_planar(re: torch.Tensor, im: torch.Tensor, q: int,
                             acc_dtype=torch.float64) -> float:
    """P(qubit q = 1) from the planes, summed in ``acc_dtype`` (the
    trajectory tier sums in float32, as the reference's does)."""
    acc = torch.zeros((), dtype=acc_dtype, device=re.device)
    step = _chunk(re)
    for start, p in _prob_chunks(re, im):
        if (1 << q) >= step:
            if (start >> q) & 1:
                acc += p.sum(dtype=acc_dtype)
        else:
            acc += p.view(-1, 2, 1 << q)[:, 1].sum(dtype=acc_dtype)
        del p
    return float(acc)


def collapse_planar_(re: torch.Tensor, im: torch.Tensor, q: int,
                     outcome: int, to_zero: bool = False) -> None:
    """Project qubit q onto |outcome> in place and renormalize: the other
    half of each plane's (A, 2, B) view is zeroed (``to_zero``, RESET:
    the kept half moves to the |0> slot first), then both planes are
    scaled by rsqrt of the kept half's norm2, computed on the device (no
    host sync; a zero norm gives NaN planes, as the reference's rsqrt).
    No temporary beyond one half plane."""
    dest = 0 if to_zero else outcome
    B = 1 << q
    views = [p.view(-1, 2, B) for p in (re, im)]
    for v in views:
        if dest != outcome:
            v[:, dest].copy_(v[:, outcome])
        v[:, 1 - dest].zero_()
    r, i = (v[:, dest] for v in views)
    nrm2 = (r * r).sum(dtype=torch.float64) + (i * i).sum(dtype=torch.float64)
    scale = torch.rsqrt(nrm2).to(re.dtype)
    re.mul_(scale)
    im.mul_(scale)


def top_amplitudes_planar(re: torch.Tensor, im: torch.Tensor, k: int = 8):
    """Global top-k |amplitude|^2 indices + complex values, hierarchical.

    Two-level top-k: per-block maxima (one chunked pass, only the (B,)
    maxima stay), the top-k blocks, then top-k within those blocks and a
    top-k of the k*k candidates.  Exact: any global top-k item is top-k
    within its own block, and its block is among the top-k blocks by max
    (otherwise k larger items exist).  Returns (idx int64, probs, amp_re,
    amp_im) as (k,) tensors.
    """
    n = _n_of(re)
    lb = _block_bits(n)
    L = 1 << lb
    B = re.numel() >> lb
    kb = min(k, B)
    kl = min(k, L)
    bm = torch.empty(B, dtype=re.dtype, device=re.device)
    for start, p in _prob_chunks(re, im, L):
        rows = p.view(-1, L)
        bm[start >> lb:(start >> lb) + rows.shape[0]] = rows.amax(dim=1)
        del p, rows
    _, blocks = torch.topk(bm, kb)
    rr = re.view(B, L)[blocks]
    ri = im.view(B, L)[blocks]
    pr = rr * rr + ri * ri                          # (kb, L): small
    vals, loc = torch.topk(pr, kl, dim=1)
    cand_idx = blocks[:, None].to(torch.int64) * L + loc
    topv, sel = torch.topk(vals.reshape(-1), min(k, kb * kl))
    idx = cand_idx.reshape(-1)[sel]
    row = sel // kl
    col = loc.reshape(-1)[sel]
    return idx, topv, rr[row, col], ri[row, col]


def _chunked_invcdf(cdf, prob_rows, u_b, u_l, shots: int, L: int, B: int,
                    chunk: int = 512):
    """Exact two-level inverse-CDF draw with a bounded working set.

    ``cdf`` is the (B,) cumulative block mass; ``prob_rows(blk)`` returns
    the (chunk, L) probability rows of a chunk of block picks.  Shots go
    in chunks, so the gathered footprint is (chunk, L) whatever the shot
    count.  Returns per-shot (block, offset) int64 tensors.
    """
    blks, locs = [], []
    for s in range(0, shots, chunk):
        blk = torch.searchsorted(cdf, u_b[s:s + chunk], right=True).clamp_(0, B - 1)
        c = torch.cumsum(prob_rows(blk), dim=1)
        tgt = u_l[s:s + chunk, None].to(c.dtype) * c[:, -1:]
        loc = (c < tgt).sum(dim=1).clamp_(0, L - 1)
        blks.append(blk)
        locs.append(loc)
    return torch.cat(blks), torch.cat(locs)


def _hier_sample(re, im, generator: torch.Generator, shots: int, n: int):
    """Hierarchical exact sampler over (re, im) planes.

    Level 1: block masses (one chunked pass; only (B,) stays) and an
    inverse-CDF block pick per shot.  Level 2: a chunked within-block
    inverse CDF on the gathered rows.  Both use the exact cumulative
    distribution (float64), so this samples |psi|^2 with O(B + chunk * L)
    memory.  Returns (blocks, offsets, block_bits).
    """
    lb = _block_bits(n)
    L = 1 << lb
    B = re.numel() >> lb
    s = torch.empty(B, dtype=torch.float64, device=re.device)
    for start, p in _prob_chunks(re, im, L):
        rows = p.view(-1, L)
        s[start >> lb:(start >> lb) + rows.shape[0]] = rows.sum(
            dim=1, dtype=torch.float64)
        del p, rows
    cdf = torch.cumsum(s, dim=0)
    kw = dict(generator=generator, dtype=torch.float64, device=re.device)
    u_b = torch.rand(shots, **kw) * cdf[-1]
    u_l = torch.rand(shots, **kw)
    rr, ri = re.view(B, L), im.view(B, L)

    def prob_rows(blk):
        p = rr[blk].double()
        p.mul_(p)
        i = ri[blk].double()
        return p.addcmul_(i, i)

    blocks, local = _chunked_invcdf(cdf, prob_rows, u_b, u_l, shots, L, B)
    return blocks, local, lb


def sample_bits_planar(re: torch.Tensor, im: torch.Tensor,
                       generator: torch.Generator, shots: int,
                       n: int) -> torch.Tensor:
    """Bitstring samples from the planes, hierarchical inverse CDF: no
    2^n probability vector and no (shots, B) noise tensor.  Returns
    (shots, n) int8, column q = qubit q."""
    return index_bits(_sample_planar(re, im, generator, shots, n), n)


def _sample_planar(re, im, generator: torch.Generator, shots: int,
                   n: int) -> torch.Tensor:
    blocks, local, lb = _hier_sample(re, im, generator, shots, n)
    return blocks * (1 << lb) + local


def index_bits(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(shots, n) int8 bits of int64 indices, column q = qubit q."""
    qs = torch.arange(n, dtype=torch.int64, device=idx.device)
    return ((idx[:, None] >> qs[None, :]) & 1).to(torch.int8)


# ---------------------------------------------------------------------------
# The dense half: a complex tensor, or its (re, im) planes
# ---------------------------------------------------------------------------

def _planes(psi) -> tuple[torch.Tensor, torch.Tensor]:
    """``(re, im)`` of a complex tensor (views, no copy) or of a planes
    pair."""
    if isinstance(psi, torch.Tensor):
        return psi.real, psi.imag
    re, im = psi
    return re, im


def probabilities(psi) -> torch.Tensor:
    re, im = _planes(psi)
    return re * re + im * im


def norm(psi) -> float:
    return norm2_planar(*_planes(psi)) ** 0.5


@timing.spanned("qst.readout.expectation_z")
def expectation_z(psi, qubits) -> float:
    """<Z_{q1} Z_{q2} ...>: the diagonal Pauli-string expectation."""
    return expectation_z_planar(*_planes(psi), list(qubits))


def qubit_probability(psi, q: int) -> float:
    """P(qubit q = 1)."""
    return qubit_probability_planar(*_planes(psi), q)


def sample(psi, generator: torch.Generator, shots: int) -> torch.Tensor:
    """Bitstring samples as int64 indices drawn from |psi|^2: the exact
    hierarchical inverse CDF at every size (the reference switches to a
    Gumbel-max draw below 2^16 amplitudes; both sample |psi|^2, neither
    gives the other's bits)."""
    re, im = _planes(psi)
    return _sample_planar(re, im, generator, shots, _n_of(re))


@timing.spanned("qst.readout.sample")
def sample_bits(psi, generator: torch.Generator, shots: int,
                n: int) -> torch.Tensor:
    """Samples as a (shots, n) int8 bit matrix, column q = qubit q."""
    return index_bits(sample(psi, generator, shots), n)


def normalize(psi: torch.Tensor) -> torch.Tensor:
    return psi / norm(psi)


def project(psi: torch.Tensor, q: int, value: int, *,
            renormalize: bool = True) -> torch.Tensor:
    """Project qubit q onto |value> (and renormalize by default)."""
    x = psi.reshape(-1, 2, 1 << q)
    out = torch.zeros_like(x)
    out[:, value] = x[:, value]
    out = out.reshape(psi.shape)
    return normalize(out) if renormalize else out


def measure_qubit(psi: torch.Tensor, q: int, generator: torch.Generator):
    """Sample qubit q; returns (outcome, collapsed state).  The draw is
    ``u < P(1)`` with u from ``generator`` (float64 uniform): the
    reference's ``jax.random.bernoulli`` draws from a JAX key, so the two
    follow the same distribution, not the same bits."""
    p1 = qubit_probability(psi, q)
    u = float(torch.rand((), generator=generator, dtype=torch.float64,
                         device=generator.device))
    outcome = int(u < p1)
    return outcome, project(psi, q, outcome)


def fidelity(a: torch.Tensor, b: torch.Tensor) -> float:
    """|<a|b>| — phase-invariant overlap."""
    return float(torch.vdot(a.reshape(-1), b.reshape(-1)).abs())



# ---------------------------------------------------------------------------
# The sharded readout: a ``parallel.mesh.ShardedState``, never gathered
# ---------------------------------------------------------------------------

def expectation_z_sharded(state, qubits) -> float:
    """<Z...Z> on a sharded state: per-shard partial sums over the local
    bits' parities, each signed by the parity of its position's mesh
    bits, summed over the mesh (``comm.psum``).  No gather of the 2^n
    vector."""
    from ..parallel import comm

    k = state.k
    lo = [q for q in qubits if q < k]
    hi_mask = sum(1 << (q - k) for q in qubits if q >= k)
    parts = {s: expectation_z_planar(re, im, lo)
             * (-1.0 if bin(s & hi_mask).count("1") & 1 else 1.0)
             for s, (re, im) in state.shards.items()}
    return comm.psum(state.mesh, parts)


def qubit_probability_sharded(state, q: int) -> float:
    """P(qubit q = 1) on a sharded state: a local qubit sums its half of
    each shard, a mesh qubit the shards whose bit is 1."""
    from ..parallel import comm

    k = state.k
    parts = {s: (qubit_probability_planar(re, im, q) if q < k
                 else norm2_planar(re, im) * ((s >> (q - k)) & 1))
             for s, (re, im) in state.shards.items()}
    return comm.psum(state.mesh, parts)


def project_sharded(state, q: int, value: int, *, renormalize: bool = True):
    """Collapse qubit q onto |value> (a new sharded state): a local qubit
    zeroes the other half of each shard, a mesh qubit whole shards."""
    from ..parallel import comm
    from ..parallel.mesh import ShardedState

    k = state.k
    out = {}
    for s, (re, im) in state.shards.items():
        if q < k:
            planes = []
            for pl in (re, im):
                x = torch.zeros_like(pl)
                x.view(-1, 2, 1 << q)[:, value] = pl.view(-1, 2, 1 << q)[:, value]
                planes.append(x)
            out[s] = tuple(planes)
        elif ((s >> (q - k)) & 1) == value:
            out[s] = (re.clone(), im.clone())
        else:
            out[s] = (torch.zeros_like(re), torch.zeros_like(im))
    if renormalize:
        n2 = comm.psum(state.mesh, {s: norm2_planar(*pl)
                                    for s, pl in out.items()})
        for re, im in out.values():
            re.div_(n2 ** 0.5)
            im.div_(n2 ** 0.5)
    return ShardedState(state.mesh, state.n, out)


def measure_qubit_sharded(state, q: int, generator: torch.Generator):
    """Projective measurement on the mesh; (outcome, collapsed state).
    ``generator`` is seeded alike on every rank, so the outcome is the
    same everywhere without a broadcast (``u < P(1)``, u a float64
    uniform)."""
    p1 = qubit_probability_sharded(state, q)
    u = float(torch.rand((), generator=generator, dtype=torch.float64,
                         device=generator.device))
    outcome = int(u < p1)
    return outcome, project_sharded(state, q, outcome)


def _fold_in(seed: int, position: int) -> int:
    """A seed for position ``position``'s draws (the reference's
    ``fold_in`` of its key)."""
    import numpy as np

    return int(np.random.SeedSequence([seed, position]).generate_state(
        1, np.uint64)[0] >> 1)


def sample_bits_sharded(state, shots: int, seed: int = 0) -> torch.Tensor:
    """Bitstring samples from a sharded state; (shots, n) int8 on the
    host, column q = qubit q.

    Hierarchical, as the reference: each position's total probability
    (``comm.all_gather`` of D scalars) picks the owning shard of each
    shot, from one host generator seeded by ``seed`` on every rank (so
    every rank makes the same picks); then each position draws its shots
    from its own 2^k amplitudes by the hierarchical inverse CDF
    (``_sample_planar``), from a generator seeded by (seed, position).
    The ranks' rows are summed (each row is filled by one rank).  No
    position sees more than its own shard."""
    from ..parallel import comm

    mesh, k = state.mesh, state.k
    totals = comm.all_gather(mesh, {s: norm2_planar(*pl)
                                    for s, pl in state.shards.items()})
    pick = torch.Generator().manual_seed(seed)
    choice = torch.multinomial(torch.tensor(totals, dtype=torch.float64),
                               shots, replacement=True, generator=pick)
    idx = torch.zeros(shots, dtype=torch.int64)
    for s, (re, im) in state.shards.items():
        rows = (choice == s).nonzero().flatten()
        if rows.numel():
            gen = torch.Generator(device=re.device).manual_seed(
                _fold_in(seed, s))
            local = _sample_planar(re, im, gen, rows.numel(), k)
            idx[rows] = local.cpu() | (s << k)
    comm.all_sum_(mesh, idx)
    return index_bits(idx, state.n)
