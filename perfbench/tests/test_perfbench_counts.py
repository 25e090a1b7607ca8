"""The operation and byte counts against figures worked by hand."""

import pytest
import torch

from perfbench import common
from perfbench.drivers import w2v

OURO = common.load_json("configs", "ouro-2.6b-l16.json")


def test_flash_work_by_hand():
    # One head, two rows, D 1: the causal mask keeps three (q, k) pairs.
    w = common.flash_work(1, 2, 1)
    assert w["flash_fwd"] == (2 * 2 * 3, (2 + 2) * 2 * 2 * 1 + 2 * 4)
    assert w["flash_dq"] == (3 * 2 * 3, (3 * 2 + 2 * 2) * 2 + 2 * 2 * 4)
    assert w["flash_dkv"] == (4 * 2 * 3, (2 * 2 + 4 * 2) * 2 + 2 * 2 * 4)
    full = common.flash_work(1, 2, 1, causal=False)
    assert full["flash_fwd"][0] == 2 * 2 * 4


def test_flash_work_at_the_trainer_shape():
    # [8, 16, 2048, 128] bf16: 2 * 2 * 128 * 2048 * 2049 / 2 * 128 flops.
    flops, nbytes = common.flash_work(8 * 16, 2048, 128)["flash_fwd"]
    assert flops == 4 * 128 * (2048 * 2049 // 2) * 128
    assert nbytes == 4 * 2048 * 128 * 128 * 2 + 128 * 2048 * 4


def test_matmul_params_of_ouro_l16():
    assert common.matmul_params(OURO) == 922_746_880


@pytest.mark.parametrize("seq,gflop", [(2048, 5.939), (16384, 8.758)])
def test_train_flops_per_token(seq, gflop):
    assert common.train_flops_per_token(OURO, seq) / 1e9 == \
        pytest.approx(gflop, abs=5e-4)


def test_least_bytes_by_hand():
    # 10 + 20 distinct rows of 300 floats, read and written; 100 pairs of
    # 2 + 5 int64 ids.
    assert common.w2v_least_bytes(10, 20, 300, 100, 5) == \
        30 * 300 * 4 * 2 + 100 * 7 * 8


def test_distinct_rows_of_a_batch():
    c = torch.tensor([1, 1, 2])
    o = torch.tensor([3, 4, 3])
    neg = torch.tensor([[4, 5], [6, 6], [1, 3]])
    assert w2v.distinct_rows((c, o, neg)) == (2, 5)


def test_percentile_is_nearest_rank():
    vals = [float(x) for x in range(100, 0, -1)]
    assert w2v.percentile(vals, 99) == 99.0
    assert w2v.percentile(vals, 50) == 50.0
    assert w2v.percentile([3.0], 99) == 3.0


def test_norm_gap_takes_the_median_leaf_as_floor():
    ref = {"a": 10.0, "b": 10.0, "c": 0.001}
    prog = {"a": 10.1, "b": 10.0, "c": 0.002}
    # c's gap (0.001) is measured against the median leaf (10), not 0.001.
    assert common.norm_gap(prog, ref) == pytest.approx(0.01)


def test_moved_leaves_rule():
    grad = {"a": 1.0, "b": 2.0, "c": 3.0, "bias": 1e-5}
    assert common.moved_leaves(grad) == ["a", "b", "c"]


def test_training_numbers_and_judge():
    ref = {"loss": [2.0, 1.0], "grad": {"a": 1.0, "b": 1.0},
           "change": {"a": 1.0, "b": 2.0}}
    prog = {"loss": [2.02, 1.0], "grad": {"a": 1.0, "b": 1.1},
            "change": {"a": 1.0, "b": 2.0}}
    n = common.training_numbers(prog, ref)
    assert n == pytest.approx({"loss_gap": 0.01, "grad_gap": 0.1,
                               "change_gap": 0.0})
    assert common.judge(n, {"loss_gap": 0.02, "grad_gap": 0.2,
                            "change_gap": 0.1})
    assert not common.judge(n, {"loss_gap": 0.005, "grad_gap": 0.2,
                                "change_gap": 0.1})
    assert not common.judge({**n, "grad_gap": float("nan")},
                            {"grad_gap": 1.0})


def test_peaks_table():
    assert common.peaks_for("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    assert common.peaks_for("cpu") is None


def test_trace_reduction_by_hand():
    from perfbench import trace

    def x(name, cat, ts, dur, tid=1, **args):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "tid": tid, "args": args}

    events = [
        x("bench.window", "user_annotation", 0, 100),
        x("_Flash", "cpu_op", 10, 5),
        x("cudaLaunchKernel", "cuda_runtime", 11, 1, correlation=1),
        x("cudaLaunchKernel", "cuda_runtime", 30, 1, correlation=2),
        x("aten::mm", "cpu_op", 29, 3),
        # two kernels that overlap count once; a third after a gap
        x("flash_fwd_hopper<128>", "kernel", 20, 20, tid=7, correlation=1),
        x("gemm", "kernel", 30, 20, tid=7, correlation=2),
        x("copy", "gpu_memcpy", 70, 10, tid=7),
    ]
    tr = trace.reduce(events)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(40e-6)          # [20, 50] + [70, 80]
    assert tr.attention_s == pytest.approx(20e-6)     # launched in _Flash
    assert tr.n_kernels == 2
    assert tr.count(lambda n: "flash_fwd_hopper" in n) == 1
    assert [round(s * 1e6) for _, s in tr.gaps] == [20, 20, 20]
    assert tr.top_ops[0] == ("flash_fwd_hopper<128>", pytest.approx(20e-6))
