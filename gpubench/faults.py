"""Faults planted underneath the port's timed path, which the check has to
find: each is a context manager that patches the port's own functions
for as long as it is open.

* ``unchanged_pass``: every other pass returns its state unchanged;
* ``half_of_the_state``: half of the batch left out, the mean taken over
  the rest: the readout and the sampler over the even amplitudes alone
  (bit 0 clear), renormalised; ``maxcut_energy`` over the first half of
  its edges, scaled to all of them (a half fixed by one index bit leaves
  the QAOA state's <Z_i Z_j> as they are, by its symmetry under flipping
  every bit, so the energy's own sum is halved as well);
* ``altered_answer``: each <Z_S> 1e-3 off, each energy 1e-2 off, bit 0
  of every shot 0.

A cell on one card has no exchange between cards to leave out.
``tests/test_gpubench_faults.py`` plants each on the CPU; ``control.py
--fault`` on the card, at the cell's own size.
"""
import contextlib


@contextlib.contextmanager
def patched(obj, name, wrap):
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def unchanged_pass():
    from quantum_simulations_tpu_torch.runtime import simulator

    calls = [0]

    def wrap(orig):
        def step(re, im, *args, **kwargs):
            calls[0] += 1
            if calls[0] % 2:
                return re, im
            return orig(re, im, *args, **kwargs)
        return step

    stack = contextlib.ExitStack()
    stack.enter_context(patched(simulator, "apply_window_op", wrap))
    stack.enter_context(patched(simulator, "apply_panel_op", wrap))
    return stack


def half_of_the_state():
    from quantum_simulations_tpu_torch.ops import observables, sampling

    def z_wrap(orig):
        def z(re, im, qubits):
            re, im = re[0::2].contiguous(), im[0::2].contiguous()
            norm = float((re.double() ** 2 + im.double() ** 2).sum())
            return orig(re, im, [q - 1 for q in qubits if q]) / norm
        return z

    def s_wrap(orig):
        def s(re, im, gen, shots, n):
            re, im = re[0::2].contiguous(), im[0::2].contiguous()
            return 2 * orig(re, im, gen, shots, n - 1)
        return s

    def e_wrap(orig):
        def e(psi, edges, weights=None):
            half = edges[: len(edges) // 2]
            return orig(psi, half) * len(edges) / len(half)
        return e

    stack = contextlib.ExitStack()
    stack.enter_context(patched(sampling, "expectation_z_planar", z_wrap))
    stack.enter_context(patched(sampling, "_sample_planar", s_wrap))
    stack.enter_context(patched(observables, "maxcut_energy", e_wrap))
    return stack


def altered_answer():
    from quantum_simulations_tpu_torch.ops import observables, sampling

    def z_wrap(orig):
        def z(*args):
            return orig(*args) + 1e-3
        return z

    def e_wrap(orig):
        def e(*args):
            return orig(*args) + 1e-2
        return e

    def bits_wrap(orig):
        def bits(idx, n):
            out = orig(idx, n)
            out[:, 0] = 0
            return out
        return bits

    stack = contextlib.ExitStack()
    stack.enter_context(patched(sampling, "expectation_z_planar", z_wrap))
    stack.enter_context(patched(observables, "maxcut_energy", e_wrap))
    stack.enter_context(patched(sampling, "index_bits", bits_wrap))
    return stack


FAULTS = {"unchanged_pass": unchanged_pass,
          "half_of_the_state": half_of_the_state,
          "altered_answer": altered_answer}
