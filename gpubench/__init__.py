"""The benchmark of ``quantum_simulations_tpu_torch`` on one NVIDIA H100.

``python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
check or per-layer metric is a file of its own, found by name:

* ``configs/<config>.json``: the circuit family, its sizes and source,
  and the reference it is held to (``"reference": {"kind": "cut", ...}``
  for a state too large to hold twice; the full state without it);
* ``traffic/<traffic>.json``: the parameters that ``stream.py`` (the one
  request generator) reads, among them the request's ``kind``;
* ``kinds/<kind>.py``: how one request of that kind calls the port, how
  the control answers it, and how its answer is held to the reference;
* ``checks/<workload>.json``: the limit of each number compared with
  the plain reference (``reference/``);
* ``metrics/<metric>.py``: the reader of one metric, end-to-end or
  per-layer, over the run's record and the port's counters it names; a
  metric split by cells, ``<metric>.<cells>``, is read by its base's.

Nothing here imports JAX or the JAX package; ``reference/`` imports
nothing of the port either.
"""
