"""No module that a run loads has the top-level name jax, jaxlib, flax
or mappy_rs_tpu (the port, mappy_rs_tpu_torch, passes: names compare
whole), and the reference loads nothing of the port."""
import json
import os
import subprocess
import sys

from portbench import run

_PROBE = """
import json, sys
import portbench.run, portbench.trace, portbench.preflight, portbench.loops
import portbench.reference
ref_only = sorted(m for m in sys.modules if m.split('.')[0] == 'mappy_rs_tpu_torch')
import mappy_rs_tpu_torch.api, mappy_rs_tpu_torch.index.build
for name in %r:
    portbench.run.reader(name)
print(json.dumps({"ref_only": ref_only,
                  "forbidden": portbench.run.forbidden_modules(),
                  "port": 'mappy_rs_tpu_torch' in sys.modules}))
"""


def test_no_jax_and_reference_apart():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as fh:
        names = [m["name"] for m in json.load(fh)["per_layer"]]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE % names],
                         cwd=run.ROOT, env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"ref_only": [], "forbidden": [], "port": True}


def test_forbidden_names_compare_whole():
    mods = ["jax", "jax.numpy", "jaxlib", "flax.linen", "mappy_rs_tpu",
            "mappy_rs_tpu.ops", "mappy_rs_tpu_torch", "mappy_rs_tpu_torch.api",
            "jaxtyping", "flaxen"]
    bad = [m for m in mods if m.split(".", 1)[0] in run.FORBIDDEN]
    assert bad == ["jax", "jax.numpy", "jaxlib", "flax.linen",
                   "mappy_rs_tpu", "mappy_rs_tpu.ops"]
