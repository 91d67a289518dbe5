"""The benchmark is driven by data: every cell, configuration and metric
that BENCHMARK.json names has its file, every traffic file and reader is
named there,
the names keep to the contract's characters, and a new cell is a new
traffic file plus an entry, with no edit to a file that is there."""

import json
import re
import subprocess
import sys

import pytest

import torch

from helpers import CELLS, DATA, TINY_BENCH, session

ROOT = DATA.parents[2]
HB = ROOT / "h100bench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    # 2 + 14 x 24 runs of run_seconds + 60 s, 180 s of compiles a cell, 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_has_its_files(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    traffic = json.loads((HB / "workloads" / f"{cell}.json").read_text())
    assert (HB / "entries" / f"{traffic['entry']}.py").exists()
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    doc = json.loads((ROOT / cfg["file"]).read_text())
    assert set(cfg["reduced"]) == set(doc["reduced"]) == set(doc["published"])
    for k in cfg["reduced"]:
        assert NAME.match(k)
    reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
    assert {"setup_s"} < {m["name"] for m in reported}
    assert any(cell in m.get("workloads", [cell]) for m in BENCH["per_layer"])
    assert set(traffic["limits"]) == {"match_gap", "mconf_err", "inlier_recount", "solver_gap",
                                      "gate_err", "rt_err", "t_max"}


def test_every_file_is_named_in_the_benchmark():
    cells = {w["name"] for w in BENCH["workloads"]}
    assert {p.stem for p in (HB / "workloads").glob("*.json")} == cells
    assert {p.stem for p in (HB / "e2e").glob("*.py")} == {m["name"] for m in BENCH["end_to_end"]}
    assert {p.name[:-3] for p in (HB / "metrics").glob("*.py")} \
        == {m["name"] for m in BENCH["per_layer"]}
    # a configuration file may wait for its cell (PERF.md, Open questions)
    assert {c["file"] for c in BENCH["configs"]} \
        <= {f"h100bench/configs/{p.name}" for p in (HB / "configs").glob("*.json")}
    for m in BENCH["per_layer"]:
        for c in m["workloads"]:
            assert c in cells


def test_a_new_cell_needs_no_edit(tmp_path, capsys):
    """A traffic file and an entry of its own, no other change: the
    harness finds and runs the cell by its name."""
    from h100bench import run

    traffic = json.loads((DATA / "far_tiny.b2.json").read_text())
    traffic.update(batch=1, pool_pairs=3)
    (tmp_path / "far_tiny.b1.json").write_text(json.dumps(traffic))
    bench = dict(TINY_BENCH, workloads=[{"name": "far_tiny.b1", "config": "far_tiny",
                                         "traffic": "b1", "chips": 1}])
    rc = run.main(["--workload", "far_tiny.b1", "--seed", "3", "--seconds", "0.5"],
                  bench=bench, device="cpu", workloads=tmp_path)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] and res["attempted"] >= 1


def test_no_card_no_result(capfd):
    """Without a card the command exits non-zero and prints no result."""
    r = subprocess.run([sys.executable, "h100bench/run.py", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                                                      "PATH": "/usr/bin:/bin"})
    assert r.returncode != 0 and "{" not in r.stdout


@pytest.mark.parametrize("cell", CELLS)
def test_the_seed_makes_the_inputs_and_weights(cell):
    """The same seed (a large one) gives the same pool, draws and weights;
    another seed gives others."""
    a, b, c = (session(cell, s) for s in (2 ** 33 + 1, 2 ** 33 + 1, 2 ** 33 + 2))
    for x, y, z in zip(a.pool + a.uniforms, b.pool + b.uniforms, c.pool + c.uniforms):
        assert torch.equal(x, y)
    assert not torch.equal(a.uniforms[0], c.uniforms[0]) and not torch.equal(a.pool[0], c.pool[0])
    wa, wb, wc = (s._reference().state_dict() for s in (a, b, c))
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    assert any(not torch.equal(wa[k], wc[k]) for k in wa if wa[k].dtype.is_floating_point)


def test_the_run_keeps_only_the_sample_it_checks():
    """Of every request answered, only ``check_requests`` outputs stay, drawn
    from the seed (the same seed keeps the same), from the whole window."""
    a, b = (session(CELLS[0], 2 ** 33 + 5) for _ in range(2))
    k = a.ctx.workload["check_requests"]
    for s in (a, b):
        for i in range(500):
            s.keep(i, object())
    kept = sorted(i for i, _ in a.outputs)
    assert len(kept) == k and kept == sorted(i for i, _ in b.outputs)
    assert max(kept) >= k
