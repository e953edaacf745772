"""The harness finds every configuration, traffic mix, limits file and
per-layer reader that BENCHMARK.json names, by name alone."""

import dataclasses
import json
import os

import pytest

from vobench import program, spec
from vobench.reference import config as ref_config
from vobench.reference import vo

BENCH = spec.benchmark()


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert cfg["file"] == f"vobench/configs/{cfg['name']}.json"
    c = spec.config(cfg["name"])
    assert c["name"] == cfg["name"] and c["source"] == cfg["source"]
    assert c["reduced"] == cfg["reduced"]
    assert os.path.exists(os.path.join(spec.ROOT, c["weights"]))
    port = program.vo_config(c["vo_config"])
    ref = ref_config.VOConfig(**{
        k: (getattr(ref_config, type(getattr(port, k)).__name__)(v)
            if hasattr(getattr(port, k), "value") else v)
        for k, v in c["vo_config"].items()})
    plain = lambda x: getattr(x, "value", x)  # noqa: E731
    assert {f.name: plain(getattr(ref, f.name))
            for f in dataclasses.fields(ref)} == {
        f.name: plain(getattr(port, f.name))
        for f in dataclasses.fields(port)}
    vo.covered(ref)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    mix = spec.mix(cell["traffic"])
    assert spec.driver(mix["driver"]).setup
    limits = spec.limits(cell["name"])
    assert limits["numbers"]
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"] for m in spec.end_to_end(BENCH, cell["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer(BENCH, cell["name"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers(metric):
    mod = spec.reader(metric["name"])
    assert callable(mod.read)
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
        metric["unit"], metric["layer"], metric["moves"])


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], m["layer"])
    for m in BENCH["end_to_end"]:
        assert m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                      "device_trace")
