"""The control comes out as not correct under every cell's limits.

The control is the plain reference in the program's place, computed in
the precision below the configuration's: fp8 e4m3 operands of every
product for the bf16 trainer, TF32-rounded operands for the float32
word2vec step.  Here at a size a test run holds, on the CPU; on the card
``perfbench/calibrate.py`` reads it at each cell's own size.
"""

import pytest

from perfbench import common
from perfbench.configs import decoder_ref, sgns_ref
from perfbench.drivers import trainer, w2v

CELLS = [w["name"] for w in common.load_json("..", "BENCHMARK.json")
         ["workloads"]]

SMALL_MODEL = {"hidden_size": 128, "num_attention_heads": 4,
               "head_dim": 32, "intermediate_size": 256, "vocab_size": 2048,
               "num_hidden_layers": 2}


def _trainer_readings(wl, precision):
    model = {**wl["model"], **SMALL_MODEL}
    traffic = {**wl["traffic"], "batch": 2, "seq": 64, "pool_steps": 3}
    batches = trainer.make_tokens(model, traffic, 2 ** 31 + 3, "cpu")
    a = model["assumed"]
    flat = trainer.make_weights(model, 2 ** 31 + 3, "cpu")
    return decoder_ref.train(flat, model, batches, a["learning_rate"],
                             a["momentum"], precision, block=32)


def _w2v_readings(wl, precision):
    m = wl["model"]
    model = {**m, "vocab_size": 20000,
             "assumed": {**m["assumed"], "pairs_per_step": 4096,
                         "learning_rate": m["alpha"] * 4096}}
    traffic = {**wl["traffic"], "pool_steps": 3, "corpus_block": 8192}
    batches = w2v.make_batches(model, traffic, 2 ** 31 + 5, "cpu")
    w_in, w_out = w2v.make_tables(model, 2 ** 31 + 5, "cpu")
    return sgns_ref.train(w_in.clone(), w_out.clone(), batches,
                          model["assumed"]["learning_rate"], precision)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    wl = common.load_workload(cell)
    readings = _trainer_readings if wl["driver"] == "trainer" \
        else _w2v_readings
    ref = readings(wl, "fp32")
    control = readings(wl, wl["control"])
    numbers = common.training_numbers(control, ref)
    assert not common.judge(numbers, wl["limits"]), numbers
    # and the reference against itself passes
    assert common.judge(common.training_numbers(ref, ref), wl["limits"])
