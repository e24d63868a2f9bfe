"""Entry: python -m portbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1> (see portbench/run.py)."""
import time

T_START = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed place inside the checkout (the
# port's own nvcc and host C++ builds go to mappy_rs_tpu_torch/_build)
_CACHE = os.path.join(_ROOT, ".portbench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# the port's tuning knobs stay at the configuration's values
for _k in [k for k in os.environ if k.startswith("MAPPY_RS_TPU_")]:
    del os.environ[_k]

from portbench.run import main  # noqa: E402

sys.exit(main(sys.argv[1:], T_START))
