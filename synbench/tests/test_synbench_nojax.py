"""Nothing a benchmark run imports is JAX or the JAX package: the
harness, the worker and the port's CLI, checked by whole top-level
module names in a fresh process."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "ntsynt_tpu"}

PROBE = """
import json, sys
import synbench.run, synbench.job, synbench.reference, synbench.judge, synbench.control
import ntsynt_tpu_torch.cli
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def test_no_jax_in_a_run():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True).stdout
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert "ntsynt_tpu_torch" in top and "synbench" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_the_name_check_is_whole():
    from synbench.job import forbidden_loaded

    sys.modules.setdefault("ntsynt_tpu_torch", __import__("ntsynt_tpu_torch"))
    assert "ntsynt_tpu_torch" not in forbidden_loaded()
