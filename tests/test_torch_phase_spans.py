"""The port's phase spans and the benchmark's reading of them.

``tracing.span`` opens ``torch.profiler.record_function`` while a
profiler capture runs, so the trainer step's and the word2vec step's
phases land in the capture on the kernels' clock; with nothing armed it
enters nothing.  ``trainer.update_bytes`` counts the least bytes of the
dense update.  ``perfbench/spans.py`` attributes device time to the
spans; here on synthetic Chrome events, and end to end on the CPU.
"""

import json
from collections import defaultdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import run, spans, trace

TRAIN_PHASES = ("Transformer::forward", "Transformer::backward",
                "Transformer::update")
W2V_PHASES = ("SkipGram::gather", "SkipGram::sgns", "SkipGram::scatter")


@pytest.fixture()
def tmv():
    import multiverso_tpu_torch as tmv

    def clean():
        if tmv.initialized():
            tmv.shutdown()
        tmv.config.reset()

    clean()
    tmv.init(device="cpu")
    yield tmv
    clean()


def _trainer(updater="momentum"):
    from multiverso_tpu_torch.models import (TransformerConfig,
                                             TransformerTrainer)

    cfg = TransformerConfig(vocab_size=64, dim=32, n_layers=2, n_heads=2,
                            hidden=64, max_seq=16)
    tr = TransformerTrainer(cfg, device="cpu", updater_type=updater)
    tokens = torch.randint(0, 64, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    return lambda: tr.train_step_async(tokens), tr


def _skipgram():
    from multiverso_tpu_torch.apps import SkipGram

    sg = SkipGram(50, 4, negatives=2, seed=3)
    step, place = sg.make_fused_step()
    rng = np.random.RandomState(0)
    c, o = (place(rng.randint(0, 50, 8)) for _ in range(2))
    neg = place(rng.randint(0, 50, (8, 2)))
    tables = [*sg.table_in.raw_value(), *sg.table_out.raw_value()]

    def one():
        tables[:] = step(*tables, c, o, neg)[:4]

    return one


def _steps(which):
    if which == "trainer":
        return _trainer()[0], "Transformer::train_step_async", TRAIN_PHASES
    return _skipgram(), "SkipGram::step", W2V_PHASES


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            out[e["name"]].append((float(e["ts"]),
                                   float(e["ts"]) + float(e["dur"])))
    return out


@pytest.mark.parametrize("which", ["trainer", "skipgram"])
def test_phase_spans_nest_in_one_step_span(which, tmv, tmp_path):
    one, step, phases = _steps(which)
    one()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        one()
    spans_ = _annotations(prof, tmp_path)
    assert len(spans_[step]) == 1
    a, b = spans_[step][0]
    for name in phases:
        assert len(spans_[name]) == 1, name
        s, e = spans_[name][0]
        assert a <= s <= e <= b, name
    starts = [spans_[n][0][0] for n in phases]
    assert starts == sorted(starts)
    # The names ``attn_*`` attribute attention by stay the kernels' own.
    assert not any(trace.attention_op(n) for n in spans_)


class _Counting:
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("which", ["trainer", "skipgram"])
def test_no_record_function_without_a_profiler(which, tmv, monkeypatch):
    from multiverso_tpu_torch import tracing

    one, _, phases = _steps(which)
    monkeypatch.setattr(_Counting, "entered", 0)
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    assert not tracing.enabled()
    one()
    one()
    assert _Counting.entered == 0
    with profile(activities=[ProfilerActivity.CPU]):
        one()
    assert _Counting.entered == 1 + len(phases)


@pytest.mark.parametrize("which", ["trainer", "skipgram"])
def test_ring_buffer_holds_a_step_under_one_trace_id(which, tmv):
    from multiverso_tpu_torch import tracing

    one, step, phases = _steps(which)
    tracing.clear()
    tracing.enable()
    try:
        one()
        one()
    finally:
        tracing.disable()
    by_id = defaultdict(set)
    for e in tracing.events():
        by_id[e.trace_id].add(e.name)
    tracing.clear()
    assert len(by_id) == 2 and 0 not in by_id
    assert all(names == {step, *phases} for names in by_id.values())


@pytest.mark.parametrize("updater, per_elem", [("momentum", 4 * 5),
                                               ("sgd", 4 * 3)])
def test_update_bytes_counts_each_leaf(updater, per_elem):
    from multiverso_tpu_torch import metrics
    from multiverso_tpu_torch.models.transformer import _leaves

    one, tr = _trainer(updater)
    counter = metrics.counter(spans.UPDATE_BYTES)
    want = sum(p.numel() for p in _leaves(tr.params)) * per_elem
    before = counter.value
    one()
    assert counter.value - before == want
    one()
    assert counter.value - before == 2 * want


# ------------------------------------------------ synthetic Chrome events
def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _launch(ts, corr, tid=1):
    return _x("cudaLaunchKernel", "cuda_runtime", ts, 2, tid=tid,
              correlation=corr)


def _kernel(name, ts, dur, corr):
    return _x(name, "kernel", ts, dur, tid=7, correlation=corr)


def _step_events():
    """One word2vec-like step in a window of 0-1000 µs: a kernel from
    each phase, the sgns one launched from another thread, and a kernel
    before the window."""
    return [
        _x(trace.WINDOW, "user_annotation", 0, 1000),
        _x("SkipGram::step", "user_annotation", 10, 600),
        _x("SkipGram::gather", "user_annotation", 10, 100),
        _x("SkipGram::sgns", "user_annotation", 110, 200),
        _x("SkipGram::scatter", "user_annotation", 310, 300),
        _launch(20, 1), _kernel("gather", 100, 50, 1),
        _launch(150, 2, tid=2), _kernel("gemm", 160, 100, 2),
        _launch(400, 3), _kernel("index_add", 450, 200, 3),
        _launch(-300, 4), _kernel("before", -200, 50, 4),
    ]


def test_kernel_from_another_thread_goes_to_the_span_open_then():
    got = spans.span_device_s(_step_events())
    assert got["SkipGram::sgns"] == pytest.approx(100e-6)
    assert got["SkipGram::gather"] == pytest.approx(50e-6)
    assert got["SkipGram::scatter"] == pytest.approx(200e-6)
    assert got["SkipGram::step"] == pytest.approx(350e-6)
    assert trace.WINDOW not in got


def test_device_time_outside_the_window_is_not_counted():
    events = _step_events() + [_launch(500, 5),
                               _kernel("late", 990, 40, 5)]
    got = spans.span_device_s(events)
    assert got["SkipGram::scatter"] == pytest.approx(210e-6)
    assert got["SkipGram::step"] == pytest.approx(360e-6)
    assert spans.span_check(events, W2V_PHASES) == pytest.approx(100.0)


def test_span_check_and_gaps():
    events = _step_events() + [_launch(700, 6),
                               _kernel("after", 800, 100, 6)]
    assert spans.span_check(events, W2V_PHASES) == pytest.approx(
        100 * 350 / 450)
    gaps = spans.span_gaps(events, W2V_PHASES, "SkipGram::step", top=3)
    assert [g["ms"] for g in gaps] == pytest.approx([0.19, 0.15, 0.1])
    # 260-450: the host in scatter before its kernel; 650-800: after the
    # step; 0-100: in gather, before any kernel.
    assert [(g["phase"], g["step"]) for g in gaps] == [
        ("SkipGram::scatter", 1), ("none", 1), ("SkipGram::gather", 1)]


def _attention_events():
    """A window with an attention op's kernel (launched under ``_Flash``)
    and another kernel, no program spans."""
    return [
        _x(trace.WINDOW, "user_annotation", 0, 1000),
        _x("autograd::_Flash", "cpu_op", 100, 50),
        _launch(110, 1), _kernel("flash_fwd_hopper<128>", 200, 100, 1),
        _x("aten::mm", "cpu_op", 300, 20),
        _launch(305, 2), _kernel("gemm", 400, 300, 2),
    ]


def test_program_spans_leave_the_existing_reduction_as_it_was():
    base = _attention_events()
    with_spans = base + [
        _x("Transformer::train_step_async", "user_annotation", 50, 800),
        _x("Transformer::forward", "user_annotation", 60, 700)]
    a, b = trace.reduce(base), trace.reduce(with_spans)
    for field in ("window_s", "busy_s", "top_ops", "kernels"):
        assert getattr(a, field) == getattr(b, field), field
    assert a.attention_s == b.attention_s == pytest.approx(100e-6)
    assert [s for _, s in a.gaps] == [s for _, s in b.gaps]
    assert spans.span_device_s(base) == {}
    assert spans.span_device_s(with_spans)["Transformer::forward"] == \
        pytest.approx(400e-6)


READERS = [(name, kind) for kind, names in spans.READERS.items()
           for name in names]
SPAN_OF = {"train_forward_ms": "Transformer::forward",
           "train_backward_ms": "Transformer::backward",
           "train_update_ms": "Transformer::update",
           "train_update_hbm": "Transformer::update",
           "w2v_gather_ms": "SkipGram::gather",
           "w2v_sgns_ms": "SkipGram::sgns",
           "w2v_scatter_ms": "SkipGram::scatter",
           "w2v_scatter_hbm": "SkipGram::scatter"}


def _ctx(kind, span_s):
    return run.Context(kind=kind, steps=4, span_s=span_s,
                       peaks={"hbm_bytes_per_s": 3.35e12},
                       update_bytes=8e10, scatter_bytes_per_step=1e9)


@pytest.mark.parametrize("name, kind", READERS)
def test_reader_is_none_without_its_span(name, kind):
    read = run.load_reader(name)
    span = SPAN_OF[name]
    assert read(run.Context(kind=kind, steps=4)) is None
    assert read(_ctx(kind, {})) is None
    assert read(_ctx(kind, {span: 0.0})) is None
    others = {s: 1.0 for s in SPAN_OF.values() if s != span}
    assert read(_ctx(kind, others)) is None
    value = read(_ctx(kind, {span: 0.05}))
    assert value is not None and value > 0
    assert read(_ctx("w2v" if kind == "train" else "train",
                     {span: 0.05})) is None


def test_reader_values():
    ctx = _ctx("train", {"Transformer::update": 0.05})
    assert run.load_reader("train_update_ms")(ctx) == pytest.approx(12.5)
    assert run.load_reader("train_update_hbm")(ctx) == pytest.approx(
        100 * 8e10 / 0.05 / 3.35e12)
    ctx = _ctx("w2v", {"SkipGram::scatter": 0.4})
    assert run.load_reader("w2v_scatter_hbm")(ctx) == pytest.approx(
        100 * 1e9 * 4 / 0.4 / 3.35e12)


def test_measure_finds_the_trainer_phases_on_the_cpu():
    tiny = {"model": {"hidden_size": 64, "num_attention_heads": 4,
                      "num_key_value_heads": 4, "head_dim": 16,
                      "intermediate_size": 128, "vocab_size": 512,
                      "num_hidden_layers": 2,
                      "max_position_embeddings": 128},
            "traffic": {"batch": 2, "seq": 32, "ids": "zipf",
                        "exponent": 1.0, "pool_steps": 4},
            "trace_steps": 2}
    out = spans.measure("ouro-2.6b-l16.seq2k", 2 ** 31 + 9, "cpu",
                        overrides=tiny)
    assert set(TRAIN_PHASES) | {spans.STEP["train"]} <= \
        set(out["span_ms_per_step"])
    # The masters' float32 leaves, momentum: 4 B x 5 an element a step.
    m = tiny["model"]
    d, f, v = m["hidden_size"], m["intermediate_size"], m["vocab_size"]
    leaves = 2 * v * d + d + 2 * (4 * d * d + 3 * d * f + 2 * d)
    assert out["update_bytes"] == 2 * leaves * 20
    assert out["metrics"] == {}       # no device time on the CPU
    json.dumps(out)
