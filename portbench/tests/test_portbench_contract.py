"""BENCHMARK.json against the benchmark's contract, and every name in it
found where the harness looks for it."""

import json
import re

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|per_tok")


def metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_size():
    assert set(BENCH) == TOP_KEYS
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name


def test_metric_fields():
    allowed = {"name", "unit", "better", "bound", "source", "workloads",
               "layer", "moves"}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in metrics():
        assert set(m) <= allowed, m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert "bound" not in m
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs_exist_and_are_used():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key)
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text


def test_every_cell_has_its_files():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
        cell = harness.load_cell(w["name"])
        assert cell["name"] == w["name"] and cell["config"] == w["config"]
        assert cell["traffic"]["name"] == w["traffic"]
        assert cell["chips"] == w["chips"] and cell["why"] == w["why"]
        assert (harness.HERE / "entries" / f"{cell['entry']}.py").exists()
        assert (harness.HERE / "configs" / f"{w['config']}.json").exists()
        assert cell["limits"]
        cuts = {k: v for k, v in cell.get("reduced", {}).items()
                if k != "from"}
        for key, was in cuts.items():
            assert cell["traffic"][key] < was, (w["name"], key)
    assert len(pairs) == len(BENCH["workloads"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_every_cell_reports_setup_an_e2e_and_a_layer_metric():
    for w in BENCH["workloads"]:
        e2e = harness.cell_metrics(w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(w["name"], "per_layer")


def test_layer_metrics_list_exactly_the_cells_that_report_them():
    for m in BENCH["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        moves = next(e for e in BENCH["end_to_end"]
                     if e["name"] == m["moves"])
        reporting = set(moves.get("workloads",
                                  [w["name"] for w in BENCH["workloads"]]))
        assert set(m["workloads"]) <= reporting, m["name"]


def test_one_layer_name_per_module():
    """Metrics of one layer give the same ``layer``, letter for letter."""
    by_prefix = {}
    for m in BENCH["per_layer"]:
        prefix = m["name"].split(".")[0].split("_roofline")[0]
        by_prefix.setdefault(prefix, set()).add(m["layer"])
    for prefix, layers in by_prefix.items():
        if prefix in ("lu", "solve"):
            continue
        assert len(layers) == 1, prefix


def test_each_entry_rate_is_an_end_to_end_metric():
    names = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        mod = harness.load_module(
            harness.HERE / "entries" / f"{cell['entry']}.py", "entry")
        rate = cell.get("rate_metric", mod.Entry.rate_metric)
        assert rate in names
        assert rate in harness.cell_metrics(w["name"], "end_to_end")


def test_files_under_paths_are_named_from_name_characters():
    for path in harness.HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert PATH.match(rel), rel
        for part in path.relative_to(harness.ROOT).parts:
            assert NAME.match(part), rel
