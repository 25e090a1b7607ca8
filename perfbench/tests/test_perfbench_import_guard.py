"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's); the references load nothing of the program either."""

import json
import os
import subprocess
import sys

from perfbench import common

LOAD_ALL = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench import calibrate, common, run, trace
from perfbench.drivers import trainer, w2v
from perfbench.configs import decoder_ref, sgns_ref
bench = run.benchmark()
for m in bench["per_layer"]:
    run.load_reader(m["name"])
import multiverso_tpu_torch
from multiverso_tpu_torch.models.transformer import TransformerTrainer
from multiverso_tpu_torch.apps.word2vec import SkipGram
from multiverso_tpu_torch.ops import flash_attention
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFS = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench.configs import decoder_ref, sgns_ref
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _tops(code: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code.format(
        root=common.ROOT)], capture_output=True, text=True, timeout=300,
        env=env, cwd=common.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_drivers_metrics_and_program_load_no_jax():
    tops = _tops(LOAD_ALL)
    assert "multiverso_tpu_torch" in tops and "perfbench" in tops
    assert common.forbidden_loaded(tops) == []


def test_references_load_nothing_of_the_program():
    tops = _tops(LOAD_REFS)
    assert common.forbidden_loaded(tops) == []
    assert "multiverso_tpu_torch" not in tops


def test_names_compare_whole():
    assert common.forbidden_loaded(["multiverso_tpu_torch.ops", "jaxtyping",
                                    "flaxen"]) == []
    assert common.forbidden_loaded(["multiverso_tpu.ops", "jax.numpy",
                                    "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "multiverso_tpu"]
