"""BENCHMARK.json against the contract's shape, and every piece of every
cell found by its name."""
import json
import re

import pytest

from port_bench import harness, traffic

SPEC = harness.load_spec()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"[^\t\n\r]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["port_bench"]
    assert SPEC["command"][1] == "port_bench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len(harness.ROOT.joinpath("BENCHMARK.json").read_bytes()) < 65536


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    cell = harness.resolve(w["name"], SPEC)
    assert cell.chips == 1
    harness.load_plugin("systems", cell.config["system"])
    harness.load_plugin("drivers", cell.traffic["driver"])
    assert cell.per_layer, "every cell reports a per-layer metric"
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in cell.per_layer:
        assert callable(harness.load_plugin("metrics", m["name"]).read)
        assert m["moves"] in e2e
    assert set(cell.limits) >= {"tokens_mismatched", "wave_rel_err",
                                "denoise_rel_err"}


def test_names_units_and_lines():
    entries = (SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"]
               + SPEC["per_layer"])
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in SPEC["configs"]:
        assert c["file"].startswith("port_bench/")
        json.loads(harness.ROOT.joinpath(c["file"]).read_text())
        for key in c["reduced"]:
            assert NAME.match(key)


@pytest.mark.parametrize("mix", sorted(
    p.stem for p in (harness.HERE / "traffic").glob("*.json")))
def test_traffic_is_deterministic_per_seed(mix):
    params = json.loads((harness.HERE / "traffic" / f"{mix}.json")
                        .read_text())
    seed = 2 ** 31 + 12345
    a, b = (traffic.batch_calls(params, seed) for _ in range(2))
    other = traffic.batch_calls(params, seed + 1)
    assert a == b and a != other
    assert sorted(map(sorted, a)) == sorted(map(sorted, other))
    for call in a:
        assert len(set(call)) == len(call) == params["prompts_per_call"]
