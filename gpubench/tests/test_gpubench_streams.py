"""The frozen circuit makers against the port's library, and the request
streams as functions of the seed."""
import json
from pathlib import Path

import pytest

from gpubench import circuits
from gpubench import stream as st

HERE = Path(__file__).resolve().parent.parent
CONFIGS = {p.stem: json.loads(p.read_text()) for p in (HERE / "configs").glob("*.json")}
TRAFFIC = {p.stem: json.loads(p.read_text()) for p in (HERE / "traffic").glob("*.json")}


@pytest.mark.parametrize("n, kw", [(5, {}), (12, {"depth": 3, "seed": 2}),
                                   (28, {})])
def test_non_stabilizer_is_the_library_s(n, kw):
    from quantum_simulations_tpu_torch.circuit import library

    assert circuits.non_stabilizer(n, **kw) == library.non_stabilizer(n, **kw)


@pytest.mark.parametrize("n, kw", [(6, {}), (14, {"p": 3, "seed": 5}), (28, {})])
def test_qaoa_maxcut_is_the_library_s(n, kw):
    from quantum_simulations_tpu_torch.circuit import library

    assert circuits.qaoa_maxcut(n, **kw) == library.qaoa_maxcut(n, **kw)


def test_config_sizes():
    nonstab = CONFIGS["nonstab28"]
    assert len(circuits.maker(nonstab["maker"])(**nonstab["params"])["gates"]) == nonstab["gates"] == 223
    qaoa = CONFIGS["qaoa28"]
    cd = circuits.maker(qaoa["maker"])(**qaoa["params"])
    assert len(cd["gates"]) == qaoa["gates"] == 184
    assert len(st.edges(qaoa)) == 50
    rzz = sorted({tuple(g["qubits"]) for g in cd["gates"] if g["gate"] == "RZZ"})
    assert rzz == st.edges(qaoa)


def _requests(config, traffic, seed, count, warm=False):
    s = (st.Stream.warm if warm else st.Stream)(config, traffic, seed)
    return [s.next() for _ in range(count)]


def _same(a, b):
    return [(r.circuit, r.args) for r in a] == [(r.circuit, r.args) for r in b]


@pytest.mark.parametrize("cell", [("nonstab28", "zsweep.window"),
                                  ("qaoa28", "energy.window"),
                                  ("nonstab28", "zsweep.fused"),
                                  ("qaoa28", "shots.window"),
                                  ("nonstab28", "fresh.window")])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 17, 2 ** 40 + 3, -5])
def test_streams_are_fixed_by_the_seed(cell, seed):
    config, traffic = CONFIGS[cell[0]], TRAFFIC[cell[1]]
    a = _requests(config, traffic, seed, 6)
    assert _same(a, _requests(config, traffic, seed, 6))
    assert not _same(a, _requests(config, traffic, seed + 1, 6))
    assert not _same(a, _requests(config, traffic, seed, 6, warm=True))
    assert [r.index for r in a] == list(range(6))
    for r in a:
        if traffic["kind"] == "expectation_z":
            lo, hi = traffic["z_weight"]
            qs = r.args["qubits"]
            assert lo <= len(qs) <= hi and len(set(qs)) == len(qs)
            assert all(0 <= q < config["params"]["n"] for q in qs)
        if not traffic.get("new_instance"):
            assert r.circuit is a[0].circuit
        elif "angles" in config["fresh"]:
            assert len(r.circuit["gates"]) == config["gates"]
    if traffic.get("new_instance"):
        assert len({json.dumps(r.circuit) for r in a}) == len(a)
    if "angles" in config.get("fresh", {}) and traffic.get("new_instance"):
        thetas = [tuple(g["params"]["theta"] for g in r.circuit["gates"]
                        if g["gate"] == "RZZ")[::50] for r in a]
        assert len(set(thetas)) == len(a)
        assert all(0 <= t < 3.1416 for th in thetas for t in th)


def test_a_fresh_request_is_the_library_s_circuit_for_its_seed():
    from quantum_simulations_tpu_torch.circuit import library

    config, traffic = CONFIGS["nonstab28"], TRAFFIC["fresh.window"]
    s = st.Stream(config, traffic, 2 ** 33 + 21)
    seeds, make = [], s.make

    def spy(**params):
        seeds.append(params["seed"])
        return make(**params)

    s.make = spy
    reqs = [s.next() for _ in range(4)]
    assert len(set(seeds)) == 4
    assert all(isinstance(x, int) and 0 <= x < 2 ** 31 for x in seeds)
    for r, seed in zip(reqs, seeds):
        assert r.circuit == library.non_stabilizer(28, 4, seed)
    assert reqs[0].circuit != reqs[1].circuit


def test_every_kind_is_found_by_name():
    from gpubench import kinds

    names = {t["kind"] for t in TRAFFIC.values()}
    assert names == {p.stem for p in (HERE / "kinds").glob("*.py")} - {"__init__"}
    for name in names:
        mod = kinds.load(name)
        assert all(callable(getattr(mod, k)) for k in kinds.REQUIRED[1:])
        assert isinstance(mod.NUMBER, str)
    for bad in ("no_such_kind", "../run", "stream"):
        with pytest.raises(ValueError):
            kinds.load(bad)
