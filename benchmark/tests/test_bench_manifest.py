"""BENCHMARK.json against the contract's shape, and discovery by name:
configurations, traffic mixes and per-layer metrics are files found by
the names the manifest gives them."""

import importlib
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from harness import cell as cell_mod
from harness import scenes

ROOT = cell_mod.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_keys_and_names():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "benchmark/run.py"]
    assert m["paths"] == ["benchmark"]
    assert 1 <= m["run_seconds"] <= 51
    names = [c["name"] for c in m["configs"]] + [w["name"] for w in m["workloads"]]
    names += [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    assert all(0.0 < x["bound"] <= 0.25 for x in m["end_to_end"])
    cells = {w["name"] for w in m["workloads"]}
    for metric in m["per_layer"]:
        assert metric["moves"] in e2e
        assert set(metric["workloads"]) <= cells


@pytest.mark.parametrize("w", manifest()["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_files(w):
    c = cell_mod.Cell(w["name"])
    assert c.cfg["name"] == w["config"]
    assert c.mix["streams"] >= 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "stream_fps"}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(importlib.import_module("metrics." + m["name"]).read)


def test_mix_and_metric_added_as_files_only(tmp_path):
    """A later change adds a traffic mix, a cell and a per-layer metric
    by adding files and entries; no harness file changes."""
    (tmp_path / "benchmark" / "traffic").mkdir(parents=True)
    m = manifest()
    shutil.copytree(os.path.join(ROOT, "benchmark", "configs"),
                    tmp_path / "benchmark" / "configs")
    mix = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                      "s32_fixed_dense.json")))
    mix.update(streams=3, candidates=40)
    (tmp_path / "benchmark" / "traffic" / "s3_quiet.json").write_text(json.dumps(mix))
    m["workloads"].append({"name": "v7ss.s3.quiet", "config": m["configs"][0]["name"],
                           "traffic": "s3_quiet", "chips": 1, "why": "a test cell"})
    m["per_layer"].append({"name": "dummy_count", "unit": "n", "better": "higher",
                           "source": "program_counter", "layer": "host I/O",
                           "moves": "stream_fps", "workloads": ["v7ss.s3.quiet"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    extra = tmp_path / "metrics"
    extra.mkdir()
    (extra / "dummy_count.py").write_text(
        "def read(ctx):\n    return ctx.window.completed * 2.0\n")
    metrics_pkg = importlib.import_module("metrics")
    metrics_pkg.__path__.append(str(extra))
    try:
        c = cell_mod.Cell("v7ss.s3.quiet", str(tmp_path))
        assert c.mix["streams"] == 3 and c.mix["candidates"] == 40
        assert [x["name"] for x in c.per_layer] == ["dummy_count"]

        class Win:
            completed = 7

        got = cell_mod.per_layer_metrics(c, cell_mod.Context(window=Win()))
        assert got == {"dummy_count": {"value": 14.0, "unit": "n"}}
    finally:
        metrics_pkg.__path__.remove(str(extra))


def small_mix(name="s64_pan_dense"):
    mix = json.load(open(os.path.join(ROOT, "benchmark", "traffic", name + ".json")))
    mix.update(streams=3, frame_hw=[96, 160], ring=3)
    mix["objects"]["sizes_hw"] = [[20, 16], [12, 10]]
    return mix


@pytest.mark.parametrize("name", ["s64_pan_dense", "s32_fixed_dense"])
def test_traffic_is_the_seed_s(name):
    mix = small_mix(name)
    a = scenes.render(mix, 2**31 + 12345, "cpu")
    b = scenes.render(mix, 2**31 + 12345, "cpu")
    c = scenes.render(mix, 7, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert [x.shape for x in a] == [x.shape for x in c] == [(3, 96, 160, 3)] * 3


def test_ring_walks_forwards_then_back():
    assert [scenes.order(k, 4) for k in range(9)] == [0, 1, 2, 3, 2, 1, 0, 1, 2]
    assert [scenes.order(k, 1) for k in range(3)] == [0, 0, 0]


def test_pan_is_an_exact_roll():
    """A panning camera's frames are rolls of its background (objects
    aside): the reference's LK follows an exact motion."""
    mix = small_mix()
    mix["objects"]["per_frame"] = 0
    mix["pans_px_per_tick"] = [[2.0, -1.0]]
    t = scenes.render(mix, 3, "cpu")
    assert np.array_equal(t[1][0], np.roll(t[0][0], (-1, 2), (0, 1)))
    assert torch.is_tensor(torch.from_numpy(t[2]))
