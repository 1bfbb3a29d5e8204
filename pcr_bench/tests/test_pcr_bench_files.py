"""BENCHMARK.json and the files it names: the contract's rules on names,
units and sizes, discovery of new files without an edit, and no JAX."""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from pcr_bench import run, spec
from pcr_bench.tests import small

BENCH = json.load(open(os.path.join(small.REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def rule_breaks(bench: dict) -> list:
    """What in ``bench`` (a parsed BENCHMARK.json) breaks the rules on
    names and units; empty when nothing does."""
    bad = []
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        names += c.get("reduced", [])
    for w in bench["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    bad += [f"name {n!r}" for n in names if not NAME.match(n)]
    bad += [f"unit {m['unit']!r}" for m in metrics if not UNIT.match(m["unit"])]
    for kind in ("configs", "workloads"):
        seen = [x["name"] for x in bench[kind]]
        bad += [f"{kind} {n!r} twice" for n in set(seen) if seen.count(n) > 1]
    seen = [m["name"] for m in metrics]
    bad += [f"metric {n!r} twice" for n in set(seen) if seen.count(n) > 1]
    return bad

KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_names_and_units_keep_the_rules():
    assert rule_breaks(BENCH) == []
    spaced = {**BENCH["configs"][0], "name": "has space"}
    assert rule_breaks({**BENCH, "configs": BENCH["configs"] + [spaced]}) == [
        "name 'has space'"]
    twice = {**BENCH, "workloads": BENCH["workloads"] + BENCH["workloads"][:1]}
    assert rule_breaks(twice) == [f"workloads {BENCH['workloads'][0]['name']!r} twice"]
    bad_unit = {**BENCH["end_to_end"][0], "name": "x", "unit": "tokens per second"}
    assert rule_breaks({**BENCH, "end_to_end": [bad_unit]}) == [
        "unit 'tokens per second'"]


def test_benchmark_keeps_the_contract():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "pcr_bench/run.py"]
    assert BENCH["paths"] == ["pcr_bench"] and 1 <= BENCH["run_seconds"] <= 51
    texts = [c["source"] for c in BENCH["configs"]] + [x["why"] for x in
                                                     BENCH["configs"] + BENCH["workloads"]]
    texts += [m["layer"] for m in BENCH["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        # no workloads key: the metric applies to every cell, later ones too
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.load(open(os.path.join(small.REPO, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        cell = spec.Cell(small.REPO, w["name"])
        assert {m["name"] for m in cell.end_to_end} == e2e
        assert cell.per_layer == BENCH["per_layer"] and cell.traffic["searches"]
        assert cell.loop().drive
        for kind in cell.traffic["plants"]:
            assert spec.load(cell.dir, "plants", kind).add
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.exists(os.path.join(spec.BENCH_DIR, "metrics", f"{m['name']}.py"))
    assert os.path.getsize(os.path.join(small.REPO, "BENCHMARK.json")) < 64 * 1024


def test_new_files_are_found_without_an_edit(tmp_path, capsys, monkeypatch):
    """A configuration, a traffic mix, a plant kind, a loop and a per-layer
    metric added as files and entries run with no code changed."""
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")
    root = small.make_root(str(tmp_path))
    bench_dir = os.path.join(root, "pcr_bench")
    small.write(os.path.join(bench_dir, "configs", "tiny.json"),
                {**small.CHR, "name": "tiny", "records": [["chrT", 300_000]], "sts_count": 150})
    small.write(os.path.join(bench_dir, "traffic", "loose2.json"),
                {"loop": "fresh_engine", "searches": [{"mismatches": 2}],
                 "plants": {"exact": 8, "mismatch": {"2": 3}, "twice": 4},
                 "control": {"mismatches": 1}, "trace_searches": 1})
    with open(os.path.join(bench_dir, "plants", "twice.py"), "w") as fh:
        fh.write(textwrap.dedent("""
            def add(plan, count):
                for j in range(count):  # one STS planted twice
                    i = plan.fresh()
                    plan.wanted += [(i, "+", "twice", 0, 0), (i, "-", "twice", 0, 0)]
        """))
    with open(os.path.join(bench_dir, "loops", "fresh_engine.py"), "w") as fh:
        fh.write(textwrap.dedent("""
            import importlib.util, os

            path = os.path.join(os.path.dirname(__file__), "warm_engine.py")
            spec = importlib.util.spec_from_file_location("warm", path)
            warm = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(warm)
            CALLS = []

            def drive(ctx):
                CALLS.append(ctx.cell.name)
                return warm.drive(ctx)
        """))
    with open(os.path.join(bench_dir, "metrics", "lines_per_search.py"), "w") as fh:
        fh.write(textwrap.dedent("""
            def read(run):
                return sum(s.text.count("\\n") for s in run.window) / len(run.window)
        """))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "pcr_bench/configs/tiny.json", "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "tiny.loose2", "config": "tiny", "traffic": "loose2",
                               "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "lines_per_search", "unit": "lines", "better": "higher",
                               "source": "program_counter", "layer": "engine",
                               "moves": "scan_mbp_s"})
    small.write(os.path.join(root, "BENCHMARK.json"), bench)
    argv = ["--workload", "tiny.loose2", "--seed", "8", "--seconds", "0.3", "--trace", "1"]
    assert run.main(argv, device="cpu", root=root) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["lines_per_search"]["value"] >= 8 + 3 + 2 * 4
    # every per-layer metric of the real file applies to the new cell too
    assert {m["name"] for m in BENCH["per_layer"]} - {
        "kernel_busy_ms", "kernels_roofline", "device_idle_pct"} <= set(res["metrics"])
    assert spec.load(bench_dir, "loops", "fresh_engine").CALLS == ["tiny.loose2"]


def test_unknown_workload_is_refused(tmp_path):
    root = small.make_root(str(tmp_path))
    with pytest.raises(SystemExit):
        spec.Cell(root, "no.such_cell")


def test_no_jax_loaded_by_a_whole_run(tmp_path):
    """Every module of the benchmark imported, then a whole run in a fresh
    process: no top-level module name jax, jaxlib, flax or merpcr_tpu
    (compared whole: merpcr_tpu_torch is the program) is loaded, and the run
    prints its result (it refuses to, with one loaded)."""
    root = small.make_root(str(tmp_path))
    code = textwrap.dedent(f"""
        import glob, importlib, importlib.util, json, os, sys
        sys.path.insert(0, {small.REPO!r})
        for path in glob.glob(os.path.join({spec.BENCH_DIR!r}, "**", "*.py"), recursive=True):
            rel = os.path.relpath(path, {small.REPO!r})[:-3]
            if os.path.basename(os.path.dirname(path)) in ("metrics", "plants", "loops"):
                spec = importlib.util.spec_from_file_location("m", path)
                spec.loader.exec_module(importlib.util.module_from_spec(spec))
            else:
                importlib.import_module(rel.replace(os.sep, "."))
        from pcr_bench import run
        rc = run.main(["--workload", "chr_small.sparse", "--seed", "3", "--seconds", "0.3"],
                      device="cpu", root={root!r})
        bad = sorted(m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN)
        print(json.dumps({{"rc": rc, "bad": bad, "program": "merpcr_tpu_torch" in sys.modules}}))
    """)
    env = {**os.environ, "MERPCR_TPU_HOST_MAX": "0"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    got = json.loads(lines[-1])
    assert got == {"rc": 0, "bad": [], "program": True}
    assert json.loads(lines[-2])["correct"]
