"""The result line's schema, from tiny runs of each cell on the CPU
(the chip check skipped, the rest of the run as it is)."""
import json
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests.tiny import cell_spec, tiny_run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CARD_ONLY = {"device_memory_peak_mib"}


@pytest.mark.parametrize("cell,trace", [("ont-hg38.readfish", False),
                                        ("ont-hg38.readfish", True),
                                        ("ont-ecoli.wgs-8k", False)])
def test_result_line(cell, trace):
    res = tiny_run(cell, seconds=20.0 if cell.startswith("ont-ecoli") else 3.0,
                   trace=trace)
    json.loads(json.dumps(res))
    assert list(res)[-1] == "checks"
    assert all(k in res for k in KEYS)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    spec = cell_spec(cell)
    want = spec.per_layer if trace else spec.end_to_end
    units = {m["name"]: m["unit"] for m in want}
    assert set(res["metrics"]) <= set(units)
    for name, v in res["metrics"].items():
        assert v["unit"] == units[name] and v["value"] > 0
    if not trace:
        # the card's memory peak is read only where there is a card
        assert set(res["metrics"]) == set(units) - CARD_ONLY
    assert res["device"]["count"] == 1


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                          "ont-ecoli.wgs-8k", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
