"""Every configuration, mix and per-layer metric is found by its name,
and a new one is added with new files and entries alone."""
import json
import os
import shutil

import pytest

from portbench import run


def _bench():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_cell_files_found_by_name(cell):
    spec = run.load_spec(cell)
    assert spec.cfg["name"] == spec.cell["config"]
    assert spec.mix["loop"] in ("open", "closed")
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s"}
    assert len(spec.end_to_end) >= 2 and spec.per_layer
    for m in spec.per_layer:
        assert callable(run.reader(m["name"]).read)


def test_every_metric_has_a_reader():
    for m in _bench()["per_layer"]:
        assert callable(run.reader(m["name"]).read)


def test_configs_keep_their_sources_and_cuts():
    for c in _bench()["configs"]:
        with open(os.path.join(run.ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])


def test_new_entries_need_no_edit(tmp_path):
    """A throwaway configuration, mix and metric: files and entries
    only, found by the same code."""
    root, here = tmp_path / "root", tmp_path / "pkg"
    shutil.copytree(os.path.join(run.HERE, "traffic"), here / "traffic")
    shutil.copytree(os.path.join(run.HERE, "metrics"), here / "metrics")
    (root / "portbench" / "configs").mkdir(parents=True)
    bench = _bench()
    with open(os.path.join(run.ROOT, bench["configs"][0]["file"])) as fh:
        cfg = json.load(fh)
    cfg["name"] = "ont-tiny"
    cfg["contigs"] = 1
    (root / "portbench" / "configs" / "ont-tiny.json").write_text(
        json.dumps(cfg))
    for c in bench["configs"]:
        (root / c["file"]).write_text(
            open(os.path.join(run.ROOT, c["file"])).read())
    mix = json.loads((here / "traffic" / "readfish.json").read_text())
    mix["reads_per_s"] = 123.0
    (here / "traffic" / "burst.json").write_text(json.dumps(mix))
    (here / "metrics" / "reads_seen.py").write_text(
        "def read(m):\n    return m.counters.get('reads')\n")
    bench["configs"].append({"name": "ont-tiny", "source": "a test",
                             "file": "portbench/configs/ont-tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "ont-tiny.burst", "config": "ont-tiny",
                               "traffic": "burst", "chips": 1, "why": "a test"})
    bench["end_to_end"][0].setdefault("workloads", []).append("ont-tiny.burst")
    bench["per_layer"].append({"name": "reads_seen.x", "unit": "reads",
                               "better": "higher", "source": "program_counter",
                               "layer": "test", "moves": "setup_s",
                               "workloads": ["ont-tiny.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = run.load_spec("ont-tiny.burst", root=str(root), here=str(here))
    assert spec.cfg["contigs"] == 1 and spec.mix["reads_per_s"] == 123.0
    assert [m["name"] for m in spec.per_layer] == ["reads_seen.x"]
    assert run.reader("reads_seen.x", here=str(here)).read(
        run.Measured("c", {}, {}, None, 0.0, {"reads": 7}, {})) == 7
