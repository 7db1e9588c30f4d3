"""Every cell, configuration, traffic mix, driver and metric is a file the
harness finds by its name in BENCHMARK.json, and one dropped in is picked
up without an edit."""
import importlib.util
import json
import re
import shutil
import sys

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_has_its_file():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        cell, conf, mix = harness.load(w["name"], bench)
        assert cell["name"] == w["name"] and conf["name"] == w["config"]
        assert (harness.HERE / "drivers" / f"{cell['driver']}.py").exists()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(harness.metric_reader(m["name"]), "read"), m["name"]
    for c in bench["configs"]:
        assert (harness.ROOT / c["file"]).exists()
        assert harness.config(c["name"])["reduced"] == c["reduced"]


def test_contract_shape():
    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    # a full check at 24 cells fits in 43200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    for w in bench["workloads"]:
        got = {m["name"] for m in harness.cell_metrics(bench, w["name"],
                                                       False)}
        assert "setup_s" in got and len(got) >= 2, w["name"]
        per = harness.cell_metrics(bench, w["name"], True)
        assert per and all(m["moves"] in got for m in per), w["name"]
    assert len(json.dumps(bench)) < 64 * 1024


def _copy(tmp_path, monkeypatch):
    """A copy of the benchmark (and BENCHMARK.json) to drop files into."""
    dst = tmp_path / "portbench"
    shutil.copytree(harness.HERE, dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    spec = importlib.util.spec_from_file_location("copied_harness",
                                                  dst / "harness.py")
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "copied_harness", mod)
    spec.loader.exec_module(mod)
    return mod


def test_new_files_are_found_without_an_edit(tmp_path, monkeypatch):
    h = _copy(tmp_path, monkeypatch)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    (h.HERE / "mixes" / "chat-short.json").write_text(json.dumps(
        dict(h.mix("chat-open"), rate=1.0)))
    cell = dict(h.cell("deepseek-moe-16b.chat-open"),
                name="deepseek-moe-16b.chat-short", traffic="chat-short")
    (h.HERE / "workloads" / "deepseek-moe-16b.chat-short.json").write_text(
        json.dumps(cell))
    (h.HERE / "metrics" / "answered_share.chat.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench["workloads"].append({k: cell[k] for k in ("name", "config",
                                                     "traffic", "chips",
                                                     "why")})
    bench["per_layer"].append({
        "name": "answered_share.chat", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "serving/scheduler.py",
        "moves": "ttft_p90_ms", "workloads": ["deepseek-moe-16b.chat-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = h.benchmark()
    c, conf, mix = h.load("deepseek-moe-16b.chat-short", bench)
    assert mix["rate"] == 1.0 and conf["name"] == "deepseek-moe-16b"
    names = {m["name"] for m in h.cell_metrics(
        bench, "deepseek-moe-16b.chat-short", True)}
    assert names == {"answered_share.chat"}
    assert h.metric_reader("answered_share.chat").read(None) == 42.0
    # a metric with no file of its own is read by its stem's reader
    (h.HERE / "metrics" / "answered_share.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    assert h.metric_reader("answered_share.score").read(None) == 7.0
    assert h.metric_reader("answered_share.chat").read(None) == 42.0
    names = {m["name"] for m in h.cell_metrics(
        bench, "deepseek-moe-16b.chat-short", False)}
    assert names == {"setup_s"}


def test_a_cell_file_must_agree_with_benchmark_json():
    bench = harness.benchmark()
    bad = json.loads(json.dumps(bench))
    bad["workloads"][0]["traffic"] = "nope"
    with pytest.raises(ValueError):
        harness.load(bad["workloads"][0]["name"], bad)


def test_config_files_match_the_registry():
    for c in harness.benchmark()["configs"]:
        conf = harness.config(c["name"])
        cfg = harness.model_config(conf)
        assert cfg.num_layers == conf["num_hidden_layers"]
        wrong = dict(conf, hidden_size=conf["hidden_size"] // 2)
        with pytest.raises(ValueError):
            harness.model_config(wrong)
