"""The result line: its keys and their shape, and the exits without it."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import common, run

TINY_TRAIN = {
    "model": {"hidden_size": 64, "num_attention_heads": 4,
              "num_key_value_heads": 4, "head_dim": 16,
              "intermediate_size": 128, "vocab_size": 512,
              "num_hidden_layers": 2, "max_position_embeddings": 128},
    "traffic": {"batch": 2, "seq": 32, "ids": "zipf", "exponent": 1.0,
                "pool_steps": 4},
    "trace_steps": 2}


def _tiny_w2v(ids="zipf"):
    m = common.load_workload("w2v-3m-d300.zipf")["model"]
    return {"model": {"vocab_size": 5000, "dim": 16,
                      "assumed": {**m["assumed"], "pairs_per_step": 1024,
                                  "learning_rate": 0.025 * 1024}},
            "traffic": {"ids": ids, "exponent": 1.0, "pool_steps": 4,
                        "corpus_block": 4096},
            "trace_steps": 5}


def _shape(out, trace):
    assert list(out)[-1] == "check"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in out
    assert isinstance(out["correct"], bool)
    assert out["attempted"] > 0 and out["failed"] == 0
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"}
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in out["device"]
    for name, v in out["check"].items():
        assert set(v) == {"value", "limit"}
    if trace:
        assert "busy_s" in out["device"] and "window_s" in out["device"]
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(out)


@pytest.mark.parametrize("trace", [False, True])
def test_trainer_line(trace):
    out = run.run("ouro-2.6b-l16.seq2k", 2 ** 31 + 5, 0.3, trace, "cpu",
                  overrides=TINY_TRAIN)
    _shape(out, trace)
    if not trace:
        assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("trace", [False, True])
def test_w2v_line(trace):
    out = run.run("w2v-3m-d300.zipf", 11, 0.3, trace, "cpu",
                  overrides=_tiny_w2v())
    _shape(out, trace)
    # float32 on both sides: the program follows the reference closely
    assert out["correct"] is True


def _main(cwd, *args):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "ouro-2.6b-l16.seq2k", "--seed", "3", "--seconds", "1",
         "--trace", "0", *args], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_line():
    out = _main(common.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_alone_in_a_directory_no_line(tmp_path):
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(common.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _main(str(tmp_path))
    assert out.returncode != 0 and out.stdout == ""
