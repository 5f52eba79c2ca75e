"""BENCHMARK.json: its shape, its names and units, and every file a cell
names found under ``portbench/`` by that name."""
import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
PKG = REPO / "portbench"
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_are_the_contracts():
    assert set(BENCH) == KEYS["top"]
    for kind in ("configs", "workloads", "end_to_end"):
        for entry in BENCH[kind]:
            assert set(entry) - {"workloads"} == KEYS[kind], entry
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["per_layer"], m
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = [e["name"] for kind in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[kind]]
    for w in BENCH["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in BENCH["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        unique = [e["name"] for e in BENCH[kind]]
        assert len(unique) == len(set(unique)), kind
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
    texts = [e["why"] for e in BENCH["workloads"] + BENCH["configs"]]
    texts += [m["layer"] for m in BENCH["per_layer"]] + [c["source"] for c in BENCH["configs"]]
    texts += BENCH["command"]
    assert all(_line(t) for t in texts)


def test_paths_command_and_bounds():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    # A full check of 24 cells fits in 43,200 seconds.
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_cells_and_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    configs = {c["name"] for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells)
    assert all(w["chips"] in (1, 4) and w["config"] in configs for w in BENCH["workloads"])
    assert configs == {w["config"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
    for cell in cells:
        per = [m for m in BENCH["per_layer"] if cell in m.get("workloads", cells)]
        assert per, cell
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"client", "prefill", "server", "served step", "model", "kernels", "device"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    cfg = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    conf = json.loads((REPO / cfg["file"]).read_text())
    assert cfg["file"] == f"portbench/configs/{w['config']}.json"
    assert conf["name"] == w["config"] and conf["reduced"] == cfg["reduced"]
    assert (PKG / "reference" / f"{conf['reference']}.py").is_file()
    assert (PKG / "arch" / f"{conf['arch']}.py").is_file()
    traffic = json.loads((PKG / "traffic" / f"{w['traffic']}.json").read_text())
    assert traffic["clients"] >= 1 and traffic["output_tokens"] >= 1
    limits = json.loads((PKG / "cells" / f"{cell}.json").read_text())
    assert "min_tokens_compared" in limits
    assert {"max_logit_gap", "mean_logit_gap"} & set(limits)
    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert (PKG / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_widths_never_reduced():
    for c in BENCH["configs"]:
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank", "_size")), key
            assert key not in ("d_model", "d_ff", "num_heads", "num_kv_heads", "head_dim")
