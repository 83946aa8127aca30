"""Every cell, mix and metric is found by name from files of its own, and
a new one is new files plus new entries: no file that is there changes."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import check, harness

from .conftest import CELLS, ROOT, tiny_cell


def test_every_cell_loads_from_its_own_files():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"], spec)
        assert cell.config["name"] == w["config"]
        assert cell.mix["checks"], w["name"]
        assert cell.limits, w["name"]
        for name in cell.mix["checks"]:
            assert name in check.CHECKS or callable(
                check.load_check(name).numbers), (w["name"], name)
        for m in cell.metrics_e2e + cell.metrics_layer:
            reader = harness.load_reader(m["name"])
            assert reader.UNIT == m["unit"]
            assert callable(reader.read)


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reports_what_the_contract_asks(name):
    spec = harness.load_spec()
    cell = harness.load_cell(name, spec)
    e2e = {m["name"] for m in cell.metrics_e2e}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.metrics_layer
    for m in cell.metrics_layer:
        assert m["moves"] in e2e


def test_tiny_cell_refuses_an_unknown_generator(monkeypatch):
    real = harness.load_cell

    def elsewhere(*args, **kwargs):
        cell = real(*args, **kwargs)
        cell.config["generator"] = "sponza_glb"
        return cell

    monkeypatch.setattr(harness, "load_cell", elsewhere)
    with pytest.raises(ValueError, match="no scene generator 'sponza_glb'"):
        tiny_cell(CELLS[0])


NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")


def _line(text):
    """1 to 200 characters on one line, with no tab."""
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and not any(c in text for c in "\t\n\r"))


def _names_unique(entries):
    names = [e["name"] for e in entries]
    assert all(NAME.fullmatch(n) for n in names), names
    assert len(names) == len(set(names)), names


def test_benchmark_json_keeps_the_contract():
    """Every key and limit of BENCHMARK.json's form, entry by entry."""
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    spec = harness.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}

    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/"), p
        assert ".." not in p.split("/"), p
    assert 1 <= len(spec["command"]) <= 32
    assert all(_line(word) for word in spec["command"])
    for word in spec["command"][1:]:
        if (ROOT / word).exists():
            assert word.startswith(tuple(p + "/" for p in spec["paths"]))

    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200

    configs = spec["configs"]
    assert 1 <= len(configs) <= 24
    _names_unique(configs)
    for c in configs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}, c
        assert _line(c["source"]) and _line(c["why"]), c["name"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in spec["paths"]))
    assert len({c["file"] for c in configs}) == len(configs)

    cells = spec["workloads"]
    assert 1 <= len(cells) <= 24
    _names_unique(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}, w
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert w["config"] in {c["name"] for c in configs}
        assert _line(w["why"]), w["name"]
        assert w["chips"] == 1, w["name"]
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in configs} == {w["config"] for w in cells}

    e2e, layer = spec["end_to_end"], spec["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    _names_unique(e2e + layer)
    cell_names = {w["name"] for w in cells}
    for m in e2e + layer:
        assert UNIT.fullmatch(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher"), m["name"]
        assert set(m.get("workloads", [])) <= cell_names, m["name"]
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in e2e}
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}, m["name"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]), m["name"]
        moved = [e for e in e2e if e["name"] == m["moves"]]
        assert moved, m["name"]
        assert set(m.get("workloads", cell_names)) <= set(
            moved[0].get("workloads", cell_names)), m["name"]


# a check that check.py does not hold: the window's closest-hit calls, seen
# through an observed call, and the last frame's depth at a few pixels
PROBE = '''"""probe: closest-hit calls in the window and a finite depth."""

import torch


def install(sampler, spec):
    sampler.run.observe("probe", "tracers:closest_hit",
                        lambda args, kwargs, out: int(args[0].shape[0]))


def evidence(sampler, state, prior, img, g_const, pose, frame, spec):
    depth = state.gbuffer.depth.flatten()[:spec["pixels"]].clone()
    return {"calls": len(sampler.run.observed["probe"]), "depth": depth}


def numbers(ev, scene, spec, seed, control):
    p = ev["probe"]
    return {"probe_calls": p["calls"],
            "probe_nonfinite": int((~torch.isfinite(p["depth"])).sum())}
'''


def test_a_new_cell_mix_and_metric_need_no_edit(tmp_path):
    """Copy the benchmark, add a configuration, a mix whose check is a new
    file, that check, a limits file and a metric reader as new files and
    new entries; see the copy's harness find them, run the new cell on the
    CPU and come out correct, and the copy's own tests of its files pass,
    while every file that was there stays byte for byte."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "pytest.ini", root / "pytest.ini")
    (root / "raytracer2_tpu_torch").symlink_to(ROOT / "raytracer2_tpu_torch")
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    spec = harness.load_spec()
    bench = root / "portbench"
    conf = json.loads((bench / "configs" / "ladder-1080p.json").read_text())
    conf.update(name="ladder-720p", width=1280, height=720)
    (bench / "configs" / "ladder-720p.json").write_text(json.dumps(conf))
    mix = json.loads((bench / "traffic" / "restir.json").read_text())
    mix["camera_velocity"] = [0.0, 0.0, 0.0]
    mix["checks"]["probe"] = {"pixels": 64}
    (bench / "traffic" / "restir-static.json").write_text(json.dumps(mix))
    (bench / "checks" / "probe.py").write_text(PROBE)
    limits = json.loads((bench / "limits" / "ladder-1080p.restir.json")
                        .read_text())
    limits.update(probe_calls={"min": 1}, probe_nonfinite={"max": 0})
    (bench / "limits" / "ladder-720p.restir-static.json").write_text(
        json.dumps(limits))
    (bench / "metrics" / "frames_per_s.py").write_text(
        'UNIT = "frames/s"\n\n\ndef read(run):\n'
        '    return run.frames / run.window_s\n')
    spec["configs"].append({"name": "ladder-720p", "source": "x",
                            "file": "portbench/configs/ladder-720p.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "ladder-720p.restir-static",
                              "config": "ladder-720p",
                              "traffic": "restir-static", "chips": 1,
                              "why": "x"})
    spec["end_to_end"].append({"name": "frames_per_s", "unit": "frames/s",
                               "better": "higher", "bound": 0.03,
                               "source": "host_clock",
                               "workloads": ["ladder-720p.restir-static"]})
    post = [m for m in spec["per_layer"] if m["name"] == "pass_ms.post"][0]
    post["workloads"].append("ladder-720p.restir-static")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell("ladder-720p.restir-static",
                             harness.load_spec(root), root)
    assert (cell.config["width"], cell.mix["camera_velocity"]) == (
        1280, [0.0, 0.0, 0.0])
    assert "frames_per_s" in {m["name"] for m in cell.metrics_e2e}
    assert "pass_ms.post" in {m["name"] for m in cell.metrics_layer}
    reader = harness.load_reader("frames_per_s", root)

    class Done:
        frames, window_s = 30, 10.0

    assert reader.read(Done) == pytest.approx(3.0)

    # the copy's own code, in processes that find nothing of this checkout
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONDONTWRITEBYTECODE"] = "1"
    run = (
        "import json, sys\n"
        "sys.path.insert(0, 'portbench/tests')\n"
        "import conftest\n"
        "assert 'ladder-720p.restir-static' in conftest.CELLS\n"
        "out = conftest.run_tiny(conftest.tiny_cell("
        "'ladder-720p.restir-static'))\n"
        "print(json.dumps({'correct': out['correct'], 'metrics': "
        "sorted(out['metrics']), 'checks': out['checks']}))\n")
    res = subprocess.run([sys.executable, "-c", run], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["checks"]["probe_calls"]["value"] >= 1
    assert out["checks"]["probe_nonfinite"]["value"] == 0
    assert "frames_per_s" in out["metrics"]
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "portbench/tests/test_portbench_files.py", "-k",
         "not need_no_edit"], cwd=root, env=env, capture_output=True,
        text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:]
    assert ("test_each_cell_reports_what_the_contract_asks["
            "ladder-720p.restir-static] PASSED") in res.stdout

    for p, data in before.items():
        assert p.read_bytes() == data, p
