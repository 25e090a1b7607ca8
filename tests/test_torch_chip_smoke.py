"""The build report and the judges of ``chip_smoke.py``, on the CPU.

The chip smoke test reads each built library's ``-Xptxas -v`` log and its
``cuobjdump -sass`` listing, and fails the run when a library holds no
bf16 Hopper kernel, or one holds no wgmma (HGMMA) or no TMA load
(UTMALDG).  Those parsers and that
rule are plain Python; here they run on listings in the formats the CUDA
toolkit prints, with a stand-in ``cuobjdump``.  The tables, lr, rows
and w2v phases' judges (numpy against the card, card against the CPU,
the memory of one row add) run on stand-in results, each with cases it
must reject; the rows phase's numpy reference is held against the
port's own MatrixTable on the CPU, and its row-apply checks against
a row apply that ignores its mask or skips the segment-sum.  The w2v
judge holds real fused runs of a small SkipGram on the CPU: it passes
push-pull against fused and a reordered batch, and rejects each planted
fault of the step (a skipped scatter, half the batch, twice the step, a
stale batch).  The rows phase's ``assign`` case with duplicate ids is
held against numpy's last write, and rejects an apply where the first
write wins.  The lda phase's judges (the share of tokens whose topic
differs, exact count conservation, the MH bound's bytes) run on real
sweeps of a small LightLDA, and conservation rejects one planted
off-by-one count in each of its three arrays.  The sgmix phase's
helpers run real small mixtures: push-pull against fused and a reordered
batch pass ``judge_changes``, a doubled step fails it, and the padding
and homonym verdicts reject what they must.  The resnet phase's protocol
judge runs on real steps of a small ResNet-20 and rejects a sync that
drops the 1/N scale or skips the write-back; its change judge and the
convergence floor are held at their edges; the planes judge passes a
real armed CPU lifecycle and rejects its trace without the profiler's
events, its metrics without the evaluator's series, and a short rule
pack.  The native phase's judges run on real tiny trainers on the CPU
(in memory, the local store, the native store): they pass the three
arms and reject a bridge that drops a push; the ``init`` probe rejects
the non-assign runtimes; its sizes are bench.py's, its launcher runs
the port's LR worker on 2 ranks, and its ratios are checked by hand.
"""

import dataclasses
import functools
import importlib.util
import json
import math
import os
import stat
import time
import types

import numpy as np
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

FWD = "_ZN3mvt16flash_fwd_hopperILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiii"
OLD = "_ZN3mvt16flash_fwd_kernelIfLi32ELi64ELi64EEEvPKT_S3_S3_PS1_Pfiii"

PTXAS_LOG = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{FWD}' for 'sm_90a'
ptxas info    : Function properties for {FWD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 182 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '{OLD}' for 'sm_90a'
ptxas info    : Function properties for {OLD}
    8 bytes stack frame, 36 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 8 bytes cumulative stack size
"""


def _sass(hopper_ops, hopper=FWD):
    lines = ["\tcode for sm_90a", f"\t\tFunction : {hopper}",
             '\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"',
             "        /*0000*/                   LDC R1, c[0x0][0x28] ;"]
    for i, op in enumerate(hopper_ops):
        lines.append(f"        /*{0x10 * (i + 1):04x}*/              @!UP0 {op} ;")
    lines += [f"\t\tFunction : {OLD}",
              "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
              "        /*0010*/               @P0 LDL.64 R2, [R1] ;",
              "        /*0020*/                   STL [R1], R3 ;",
              "        /*0030*/                   STL.64 [R1+0x8], R4 ;"]
    return "\n".join(lines) + "\n"


def test_ptxas_report_reads_registers_and_spills():
    got = chip_smoke.ptxas_report(PTXAS_LOG)
    assert got == {FWD: {"spill_bytes": 0, "registers": 182},
                   OLD: {"spill_bytes": 76, "registers": 40}}


def test_sass_counts_per_kernel_and_predicated():
    ops = ["HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT",
           "HGMMA.64x128x16.F32.BF16 R88, R24, gdesc[UR8].tnspB, R88, gsb0",
           "UTMALDG.3D [UR8], [UR4]"]
    got = chip_smoke.sass_counts(_sass(ops))
    assert got[FWD] == {"HGMMA": 2, "UTMALDG": 1, "LDL": 0, "STL": 0}
    assert got[OLD] == {"HGMMA": 0, "UTMALDG": 0, "LDL": 1, "STL": 2}


def _fake_build(tmp_path, listings):
    """A stand-in for ``ops._build``: logs in BUILD_DIR, and an nvcc whose
    directory holds a ``cuobjdump`` that prints ``listings[name]`` for
    ``lib<name>.so``."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    build_dir = tmp_path / "build"
    build_dir.mkdir()
    paths = {}
    for name in chip_smoke.KERNELS:
        hop = _hopper_name(name)
        (build_dir / f"{name}.log").write_text(PTXAS_LOG.replace(
            FWD, hop if hop in listings[name] else NOT_HOPPER))
        (build_dir / f"lib{name}.sass").write_text(listings[name])
        paths[name] = str(build_dir / f"lib{name}.so")
    tool = bindir / "cuobjdump"
    tool.write_text('#!/bin/sh\ncat "${2%.so}.sass"\n')
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    fake = types.SimpleNamespace(BUILD_DIR=str(build_dir),
                                 nvcc_path=lambda: str(bindir / "nvcc"))
    return fake, paths


def _hopper_name(lib):
    """The mangled name of library ``lib``'s D=128 Hopper kernel, as FWD
    is flash_fwd's."""
    return FWD.replace("16flash_fwd_hopper", f"{len(lib) + 7}{lib}_hopper")


NOT_HOPPER = "_ZN3mvt15flash_dq_kernelIfLi64ELi64ELi64EEEvPKT_S3_S3_S3_PKfS5_PS1_iiif"
GOOD_OPS = ["HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0",
            "UTMALDG.3D [UR8], [UR4]"]


def _listings(bad=None, bad_ops=None):
    """A listing per library, each with its own Hopper kernel holding
    GOOD_OPS, except library ``bad``, whose Hopper kernel holds
    ``bad_ops`` (None: it has no Hopper kernel at all)."""
    out = {}
    for name in chip_smoke.KERNELS:
        hop = _hopper_name(name)
        if name != bad:
            out[name] = _sass(GOOD_OPS, hop)
        elif bad_ops is None:
            out[name] = _sass(GOOD_OPS, NOT_HOPPER)
        else:
            out[name] = _sass(bad_ops, hop)
    return out


def test_build_phase_passes_with_wgmma_and_tma(tmp_path, capsys):
    fake, paths = _fake_build(tmp_path, _listings())
    chip_smoke.phase_build(fake, paths, 1.0)
    assert '"phase": "build", "ok": true' in capsys.readouterr().out


@pytest.mark.parametrize("lib", list(chip_smoke.KERNELS))
@pytest.mark.parametrize("ops", [["UTMALDG.3D [UR8], [UR4]"],
                                 ["HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], "
                                  "RZ, !UPT, gsb0"]])
def test_build_phase_fails_without_wgmma_or_tma(tmp_path, ops, lib):
    fake, paths = _fake_build(tmp_path, _listings(lib, ops))
    with pytest.raises(AssertionError, match="HGMMA or no UTMALDG"):
        chip_smoke.phase_build(fake, paths, 1.0)


@pytest.mark.parametrize("lib", list(chip_smoke.KERNELS))
def test_build_phase_fails_without_a_hopper_kernel(tmp_path, lib):
    fake, paths = _fake_build(tmp_path, _listings(lib))
    with pytest.raises(AssertionError, match="no Hopper kernel"):
        chip_smoke.phase_build(fake, paths, 1.0)


# ------------------------------------------------ tables and lr phase judges

def test_new_phases_run_by_default():
    assert chip_smoke.PHASES[-9:] == ("tables", "lr", "rows", "w2v", "lda",
                                      "sgmix", "resnet", "planes",
                                      "native")
    assert chip_smoke.TABLE_SIZE == 16 * 1024 * 1024
    assert (chip_smoke.W2V_VOCAB, chip_smoke.W2V_DIM,
            chip_smoke.W2V_BATCH) == (100_000, 128, 8192)
    assert (chip_smoke.LDA_DOCS, chip_smoke.LDA_LEN, chip_smoke.LDA_VOCAB,
            chip_smoke.LDA_TOPICS, chip_smoke.LDA_MH_TOPICS) == (
                2048, 64, 10000, 64, (1024, 8192))
    assert (chip_smoke.SGMIX_VOCAB, chip_smoke.SGMIX_DIM,
            chip_smoke.SGMIX_BATCH) == (100_000, 128, 1024)
    assert (chip_smoke.RESNET_TRAIN, chip_smoke.RESNET_HELD,
            chip_smoke.RESNET_CLASSES, chip_smoke.RESNET_WORKERS,
            chip_smoke.RESNET_LR, chip_smoke.RESNET_BATCH,
            chip_smoke.RESNET_PARAMS) == (50_000, 10_000, 10, 2, 0.1, 64,
                                          272_474)


def test_rel_to_peak():
    want = np.array([1.0, -4.0, 2.0])
    assert chip_smoke.rel_to_peak(want, want) == 0.0
    assert chip_smoke.rel_to_peak(want + [0, 0, 0.4], want) == pytest.approx(
        0.1)
    assert chip_smoke.rel_to_peak(want[:2], want) == math.inf
    assert chip_smoke.rel_to_peak([1.0, np.nan, 2.0], want) == math.inf


def test_judge_tables_passes_and_rejects():
    rng = np.random.RandomState(0)
    want = rng.randn(1000).astype(np.float32)
    errs, ok = chip_smoke.judge_tables({"a": (want.copy(), want),
                                        "b": (want + 1e-7, want)})
    assert ok and errs["a"] == 0.0
    flipped = want.copy()
    flipped[:8] = -flipped[:8]          # one byte of signs decoded backwards
    errs, ok = chip_smoke.judge_tables({"a": (want, want),
                                        "one_bit": (flipped, want)})
    assert not ok and errs["one_bit"] > 1e-6
    assert not chip_smoke.judge_tables({})[1]


def _losses(n=20, start=2.0):
    return list(start * 0.9 ** np.arange(n))


def test_judge_lr_passes():
    card = _losses()
    cpu = [v * (1 + 1e-6) for v in card]
    w = np.linspace(-1, 1, 50)
    out, ok = chip_smoke.judge_lr(card, cpu, w, w + 1e-6)
    assert ok and out["loss_falls"] and out["step_within_tol"]
    assert out["trajectory_max_rel_diff"] < 1e-5


@pytest.mark.parametrize("fault", ["trajectory", "flat", "step", "nan",
                                   "length"])
def test_judge_lr_rejects(fault):
    card, cpu = _losses(), _losses()
    w = np.linspace(-1, 1, 50)
    fused = w.copy()
    if fault == "trajectory":
        card[10] *= 1 + 1e-3
    elif fault == "flat":
        card = cpu = [1.0] * 20
    elif fault == "step":
        fused[3] += 1e-3
    elif fault == "nan":
        card[5] = cpu[5] = float("nan")
    else:
        card = card[:19]
    _, ok = chip_smoke.judge_lr(card, cpu, w, fused)
    assert not ok


# ----------------------------------------------------- rows and w2v judges

@pytest.fixture()
def cpu_runtime():
    import multiverso_tpu_torch as mv

    if mv.initialized():
        mv.shutdown()
    mv.init(device="cpu")
    yield mv
    mv.shutdown()
    mv.config.reset()


# ------------------------------------------------------- moe_mesh phase


def test_moe_mesh_layout_and_spec():
    """Two gloo ranks share one card, NCCL ranks take two or four cards;
    each layout's meshes split the tokens (dp) and the experts (ep), and
    each planted fault runs where it can show."""
    assert chip_smoke.moe_layout(1) == ("gloo", 2)
    assert chip_smoke.moe_layout(2) == ("nccl", 2)
    assert chip_smoke.moe_layout(8) == ("nccl", 4)
    for world in (2, 4):
        meshes, faults = chip_smoke.moe_meshes(world)
        assert all(int(np.prod(sizes)) == world for _, sizes, _ in meshes)
        names = {key: n for key, _, n in meshes}
        assert {f for f, _, _ in faults} == {"local_slots", "local_aux",
                                             "router_over_ep"}
        for fault, key, _ in faults:
            assert ("ep" if fault == "router_over_ep" else "dp") in \
                names[key]
    spec = chip_smoke.moe_mesh_spec("gloo", 2)
    assert spec["cfg"]["dim"] == 1024 and spec["cfg"]["n_layers"] == 2
    assert spec["cfg"]["capacity_factor"] == chip_smoke.MOE_MESH_CF
    assert (spec["batch"], spec["seq"]) == (chip_smoke.MOE_CHECK_BATCH,
                                            chip_smoke.MOE_CHECK_SEQ)


def test_judge_moe_mesh_edges():
    rng = np.random.RandomState(0)
    want = ({"losses": [3.0, 2.5]}, [rng.randn(20), rng.randn(5) + 4])
    same = ({"losses": [3.0, 2.5]}, [a.copy() for a in want[1]])
    errs, ok = chip_smoke.judge_moe_mesh(same, want)
    assert ok and errs == {"losses": 0.0, "tree": 0.0}
    # One entry off by just under / just over the floor of rtol times
    # twice the tensor's largest entry.
    top = np.abs(want[1][0]).max()
    for factor, verdict in ((0.99, True), (1.01, False)):
        arrays = [a.copy() for a in want[1]]
        i = int(np.argmax(np.abs(arrays[0])))
        arrays[0][i] += factor * 1e-5 * 2 * top
        assert chip_smoke.judge_moe_mesh(({"losses": [3.0, 2.5]}, arrays),
                                         want)[1] is verdict
    assert not chip_smoke.judge_moe_mesh(({"losses": [3.0, 2.6]}, same[1]),
                                         want)[1]
    assert not chip_smoke.judge_moe_mesh(({"losses": [3.0]}, same[1]),
                                         want)[1]
    assert not chip_smoke.judge_moe_mesh(
        ({"losses": [3.0, 2.5]}, [same[1][0][:10], same[1][1]]), want)[1]
    nan = [a.copy() for a in want[1]]
    nan[1][0] = np.nan
    assert not chip_smoke.judge_moe_mesh(({"losses": [3.0, 2.5]}, nan),
                                         want)[1]


def test_moe_mesh_ranks_on_the_cpu(tmp_path):
    """The phase's ranks at a small width on two gloo ranks on the CPU
    (the phase itself runs bench_moe's width on the card): every mesh run
    holds the one-process run, the capacity runs drop routes, and all
    three planted faults are rejected."""
    spec = chip_smoke.moe_mesh_spec("gloo", 2, device="cpu", vocab_size=64,
                                    dim=32, n_heads=4, hidden=64,
                                    max_seq=32)
    spec["batch"] = 4
    ranks, _ = chip_smoke.launch_moe_ranks(spec, str(tmp_path), timeout=240)
    verdicts, ok = chip_smoke.judge_moe_ranks(ranks[0])
    assert ok, verdicts
    assert len(verdicts) == 9
    assert [r["fault"] for r in ranks[0]["faults"]] == [
        "router_over_ep", "local_slots", "local_aux"]
    assert ranks[1]["runs"] and "errors" not in ranks[1]["runs"][0]


def test_planted_moe_fault_restores():
    from multiverso_tpu_torch.models import moe
    from multiverso_tpu_torch.models.transformer import TransformerTrainer

    keep = (moe._global_plan, moe._global_stats,
            TransformerTrainer._sum_grads)
    for fault in ("local_slots", "local_aux", "router_over_ep"):
        with chip_smoke.planted_moe_fault(fault):
            now = (moe._global_plan, moe._global_stats,
                   TransformerTrainer._sum_grads)
            assert sum(a is not b for a, b in zip(now, keep)) == 1
        assert (moe._global_plan, moe._global_stats,
                TransformerTrainer._sum_grads) == keep
    with chip_smoke.planted_moe_fault(None):
        pass


# ---------------------------------------------------------- shard phase


def test_shard_phase_runs_after_mesh_at_its_sizes():
    i = chip_smoke.PHASES.index("shard")
    assert chip_smoke.PHASES[i - 2:i + 2] == ("mesh", "moe_mesh", "shard",
                                              "tables")
    assert (chip_smoke.SHARD_BIG_ROWS, chip_smoke.SHARD_IDS) == (1 << 20,
                                                                 8192)
    assert chip_smoke.shard_layout(1) == ("gloo", 2)
    assert {chip_smoke.shard_device("gloo", r) for r in range(2)} == {
        "cuda:0"}
    assert chip_smoke.shard_layout(4) == ("nccl", 4)
    assert [chip_smoke.shard_device("nccl", r) for r in range(4)] == [
        f"cuda:{r}" for r in range(4)]


@pytest.mark.parametrize("updater", ["sgd", "adagrad"])
def test_shard_dense_reference_matches_the_port(cpu_runtime, updater):
    import torch

    rng = np.random.RandomState(0)
    start, g = rng.randn(2, 1000).astype(np.float32)
    t = cpu_runtime.ArrayTable(1000, init=start, updater_type=updater,
                               default_option=cpu_runtime.AddOption(
                                   learning_rate=chip_smoke.SHARD_LR))
    t.add(torch.from_numpy(g))
    want = chip_smoke.np_dense_apply(start, g, updater, chip_smoke.SHARD_LR)
    assert chip_smoke.rel_change(t.get(), want, start) <= 1e-6


def test_shard_block_checks_and_planted_shift(cpu_runtime):
    from multiverso_tpu_torch.parallel.sharding import TableShard

    m = cpu_runtime.MatrixTable(10, 3, updater_type="adagrad")
    nbytes = chip_smoke.block_bytes(m)
    assert nbytes == 2 * 10 * 3 * 4
    assert chip_smoke.block_checks(m, nbytes, 1)["ok"]
    # Each of the two tensors may round up to 512 bytes, no more.
    assert chip_smoke.block_checks(m, nbytes + 1024, 1)["ok"]
    assert not chip_smoke.block_checks(m, nbytes + 1025, 1)["ok"]
    assert not chip_smoke.block_checks(m, nbytes - 1, 1)["ok"]
    assert not chip_smoke.block_checks(m, nbytes, 2)["ok"]   # a replica
    shard = TableShard("cpu", 10, world=2, rank=1)
    shifted = chip_smoke.shifted_shard(shard)
    assert (shifted.offset, shifted.size, shifted.padded) == (6, 5, 10)
    ids = np.arange(12)
    np.testing.assert_array_equal(shifted.owned(ids),
                                  (ids >= 6) & (ids < 10))
    np.testing.assert_array_equal(shard.owned(ids), (ids >= 5) & (ids < 10))


def _shard_rank(r, ok=True, fault_ok=False):
    return {"rank": r, "arrays": {"array_sgd_asp": {"ok": ok}},
            "w2v_table": {"ok": True}, "big_table": {"ok": True},
            "fault": {"ok": fault_ok}, "device_get_refused": True}


def test_judge_shard_ranks_edges():
    verdicts, ok, rejected = chip_smoke.judge_shard_ranks(
        [_shard_rank(0), _shard_rank(1)])
    assert ok and rejected and len(verdicts) == 8
    assert not chip_smoke.judge_shard_ranks(
        [_shard_rank(0), _shard_rank(1, ok=False)])[1]
    # A planted fault that passed on every rank fails the phase.
    assert not chip_smoke.judge_shard_ranks(
        [_shard_rank(0, fault_ok=True), _shard_rank(1, fault_ok=True)])[1]


def test_judge_shard_apps_edges():
    rng = np.random.RandomState(0)
    start = {"in": rng.randn(50), "out": rng.randn(50)}
    end = {k: v + rng.randn(50) for k, v in start.items()}
    one = {"w2v_sgd": (start, end, [3.0, 2.0])}
    sharded = {"w2v_sgd.end.in": end["in"], "w2v_sgd.end.out": end["out"],
               "w2v_sgd.losses": [3.0, 2.0]}
    out, ok = chip_smoke.judge_shard_apps(sharded, one)
    assert ok and out["change_rel_errors"] == {"w2v_sgd.in": 0.0,
                                               "w2v_sgd.out": 0.0}
    moved = np.abs(end["out"] - start["out"]).max()
    for factor, want in ((0.9, True), (1.1, False)):
        bad = dict(sharded)
        bad["w2v_sgd.end.out"] = end["out"] + np.eye(50)[3] * (
            chip_smoke.W2V_RTOL * factor * moved)
        assert chip_smoke.judge_shard_apps(bad, one)[1] is want
    assert not chip_smoke.judge_shard_apps(
        {**sharded, "w2v_sgd.losses": [3.0]}, one)[1]
    assert not chip_smoke.judge_shard_apps(
        {k: v for k, v in sharded.items() if k != "w2v_sgd.end.in"},
        one)[1]


@pytest.mark.parametrize("updater", ["default", "sgd", "adagrad"])
def test_rows_reference_matches_the_port(cpu_runtime, updater):
    """The rows phase's numpy reference (duplicates summed, ids past the
    table dropped and read as zeros) is what the port computes; a
    reference that skipped the duplicate sum is rejected."""
    mv = cpu_runtime
    rng = np.random.RandomState(1)
    w0 = rng.randn(50, 8).astype(np.float32)
    ids = np.array([3, 7, 3, 49, 50, 80, 3, 0])
    g = rng.randn(8, 8).astype(np.float32)
    lr, eps = np.float32(0.1), np.float32(1e-8)
    t = mv.MatrixTable(50, 8, name=updater, updater_type=updater, init=w0)
    t.add_rows(ids, g, option=mv.AddOption(learning_rate=float(lr)))
    w, h = w0.copy(), np.zeros_like(w0)
    chip_smoke._np_row_apply(w, h, ids, g, lr, eps, updater)
    errs, ok = chip_smoke.judge_tables({
        "table": (t.get(), w),
        "rows": (t.get_rows(ids), chip_smoke._np_rows(w, ids))})
    assert ok, errs
    if updater == "adagrad":
        seq, hs = w0.copy(), np.zeros_like(w0)
        for i in range(len(ids)):     # each duplicate applied on its own
            chip_smoke._np_row_apply(seq, hs, ids[i:i + 1], g[i:i + 1], lr,
                                     eps, updater)
        assert not chip_smoke.judge_tables({"table": (t.get(), seq)})[1]


def test_rows_judge_rejects_clamped_reads():
    """An id past the table must read zeros; the last row (a clamped
    gather) is rejected."""
    w = np.random.RandomState(2).randn(10, 4).astype(np.float32)
    ids = np.array([1, 10, 30])
    clamped = w[np.minimum(ids, 9)]
    _, ok = chip_smoke.judge_tables({"rows": (clamped,
                                              chip_smoke._np_rows(w, ids))})
    assert not ok


def test_judge_row_add_memory():
    table = 100_000 * 128 * 4
    assert chip_smoke.judge_row_add_memory(12 * 2 ** 20, table)
    assert not chip_smoke.judge_row_add_memory(table, table)
    assert not chip_smoke.judge_row_add_memory(table + 12 * 2 ** 20, table)


def test_row_apply_checks_hold_on_the_cpu():
    """The rows phase's on-device row-apply checks, run on the CPU: every
    updater against itself and sgd/adagrad against numpy, with a mask,
    duplicates and ids past the table."""
    import torch

    rng = np.random.RandomState(4)
    w0 = rng.randn(50, 8).astype(np.float32)
    ids = np.array([3, 7, 3, 49, 50, 80, 3, 0, 12, 7])
    g = rng.randn(len(ids), 8).astype(np.float32)
    mask = np.array([True, False, True, True, True, False, True])
    checks = chip_smoke.row_apply_checks(torch, w0, ids, g, mask,
                                         np.float32(0.1), np.float32(1e-8),
                                         "cpu")
    # [w, *state] of six updaters in two calls each against the CPU
    # (state: adagrad, momentum, smooth_gradient), and sgd's [w] and
    # adagrad's [w, h] in two calls each against numpy.
    assert len(checks) == 2 * (1 + 1 + 2 + 2 + 2 + 1) + 2 * (1 + 2)
    errs, ok = chip_smoke.judge_tables(checks)
    assert ok, errs


@pytest.mark.parametrize("fault", ["mask_ignored", "no_segment_sum"])
def test_row_apply_checks_reject(monkeypatch, fault):
    """A row apply that ignores its mask, or a non-linear updater that
    gets duplicates unsummed, fails against numpy (the CPU comparison
    alone cannot see a fault both devices share)."""
    import torch

    from multiverso_tpu_torch.updaters import base, sgd

    if fault == "mask_ignored":
        real = base._kept_rows
        monkeypatch.setattr(sgd, "_kept_rows",
                            lambda rows, mask, n, anchored=False:
                            real(rows, None, n, anchored))
    else:
        monkeypatch.setattr(
            base, "aggregate_rows",
            lambda rows, delta: (rows, delta,
                                 torch.ones(rows.shape, dtype=torch.bool)))
    rng = np.random.RandomState(4)
    w0 = rng.randn(50, 8).astype(np.float32)
    ids = np.array([3, 7, 3, 49, 50, 80, 3, 0, 12, 7])
    g = rng.randn(len(ids), 8).astype(np.float32)
    mask = np.array([True, False, True, True, True, False, True])
    errs, ok = chip_smoke.judge_tables(chip_smoke.row_apply_checks(
        torch, w0, ids, g, mask, np.float32(0.1), np.float32(1e-8), "cpu"))
    assert not ok
    bad = {k for k, e in errs.items() if e > chip_smoke.TABLE_TOL}
    assert bad and all(k.endswith("_vs_numpy") for k in bad)


def test_rel_change():
    start = np.zeros(4)
    want = np.array([0.0, 1.0, -2.0, 0.0])
    assert chip_smoke.rel_change(want, want, start) == 0.0
    assert chip_smoke.rel_change(want + [0, 0, 0, 0.02], want,
                                 start) == pytest.approx(0.01)
    assert chip_smoke.rel_change(start, want, start) == pytest.approx(1.0)
    assert chip_smoke.rel_change(want, start, start) == math.inf
    assert chip_smoke.rel_change(want[:3], want, start) == math.inf
    assert chip_smoke.rel_change(None, want, start) == math.inf


def _w2v_inputs():
    rng = np.random.RandomState(3)
    start = {"in": rng.randn(8, 8), "out": rng.randn(8, 8)}
    end = {k: v + 0.01 * rng.randn(8, 8) for k, v in start.items()}
    got = {k: v + 1e-7 for k, v in end.items()}
    card = [4.158883 - 1e-3 * i for i in range(20)]
    cpu = [v * (1 + 1e-6) for v in card]
    return ({"sgd_card_vs_cpu": (got, end, start)},
            {"sgd": (card, cpu, True),
             "dlrm": (card[::-1], cpu[::-1], False)},
            {"sgd": True, "adagrad": True})


def test_judge_w2v_passes():
    changes, traj, sync = _w2v_inputs()
    out, ok = chip_smoke.judge_w2v(changes, traj, sync)
    assert ok and out["trajectories"]["sgd"]["falls"]
    assert max(out["change_rel_errors"].values()) < 1e-4


@pytest.mark.parametrize("fault", ["trajectory", "flat", "step", "sync",
                                   "nan", "length", "no_sync_runs",
                                   "unmoved", "missing", "no_changes"])
def test_judge_w2v_rejects(fault):
    changes, traj, sync = _w2v_inputs()
    got, want, start = changes["sgd_card_vs_cpu"]
    card, cpu, _ = traj["sgd"]
    if fault == "trajectory":
        card[7] *= 1 + 1e-3
    elif fault == "flat":
        traj["sgd"] = ([1.0] * 20, [1.0] * 20, True)
    elif fault == "step":
        got["out"][2, 3] += 1e-4
    elif fault == "sync":
        sync["adagrad"] = False
    elif fault == "nan":
        card[3] = cpu[3] = float("nan")
    elif fault == "length":
        traj["sgd"] = (card[:19], cpu, True)
    elif fault == "no_sync_runs":
        sync = {}
    elif fault == "unmoved":
        changes["sgd_card_vs_cpu"] = (start, start, start)
    elif fault == "missing":
        del got["out"]
    else:
        changes = {}
    _, ok = chip_smoke.judge_w2v(changes, traj, sync)
    assert not ok


# A small SkipGram through the phase's own helpers: the judge must pass
# two correct runs and reject each planted fault of the fused step.
SV, SD, SB = 1000, 16, 64


def _small_batches(n):
    rng = np.random.RandomState(6)
    return [(rng.randint(SV, size=SB).astype(np.int32),
             rng.randint(SV, size=SB).astype(np.int32),
             rng.randint(SV, size=(SB, chip_smoke.W2V_NEG)).astype(np.int32))
            for _ in range(n)]


def _small_model(updater, name):
    from multiverso_tpu_torch.apps import SkipGram

    return chip_smoke.w2v_model(SkipGram, SV, SD, SB, updater, name)


@pytest.mark.parametrize("updater", ["sgd", "adagrad"])
def test_w2v_judge_passes_real_runs(cpu_runtime, updater):
    """Push-pull against fused, and a run whose batches list their pairs
    in another order, from one start: within W2V_RTOL of the change."""
    import torch

    batches = _small_batches(3)
    ref, alt = _small_model(updater, "ref"), _small_model(updater, "alt")
    a, b = _small_model(updater, "pp"), _small_model(updater, "fu")
    start = chip_smoke.w2v_snapshot(ref)
    losses, free = chip_smoke.w2v_fused(torch, ref, batches)
    assert free is None and len(losses) == 3
    perm = np.random.RandomState(0).permutation(SB)
    chip_smoke.w2v_fused(torch, alt, [tuple(x[perm] for x in bt)
                                      for bt in batches])
    a.train_batch(*batches[0])
    chip_smoke.w2v_fused(torch, b, batches[:1])
    snap = chip_smoke.w2v_snapshot
    errs, ok = chip_smoke.judge_changes({
        "reordered": (snap(alt), snap(ref), start),
        "pushpull_vs_fused": (snap(a), snap(b), start)})
    assert ok, errs
    assert len(errs) == 2 * (2 if updater == "sgd" else 4)


@pytest.mark.parametrize("updater", ["sgd", "adagrad"])
@pytest.mark.parametrize("fault", ["out_scatter_skipped", "half_batch",
                                   "double_step", "stale_batch"])
def test_w2v_judge_rejects_a_wrong_fused_step(cpu_runtime, monkeypatch,
                                              updater, fault):
    import torch

    from multiverso_tpu_torch.updaters import base

    batches = _small_batches(3)
    ref = _small_model(updater, "ref")
    start = chip_smoke.w2v_snapshot(ref)
    chip_smoke.w2v_fused(torch, ref, batches)
    if fault == "out_scatter_skipped":
        real = base.scatter_apply

        def skip_out(upd, data, state, rows, delta, opt):
            if rows.shape[0] > SB:       # the output table's scatter
                return data, state
            return real(upd, data, state, rows, delta, opt)

        monkeypatch.setattr(base, "scatter_apply", skip_out)
    bad = _small_model(updater, "bad")
    if fault == "half_batch":
        batches = [tuple(x[:SB // 2] for x in bt) for bt in batches]
    elif fault == "double_step":
        bad.option = dataclasses.replace(
            bad.option, learning_rate=2 * bad.option.learning_rate)
    elif fault == "stale_batch":
        batches = [batches[0], batches[0], batches[2]]
    chip_smoke.w2v_fused(torch, bad, batches)
    errs, ok = chip_smoke.judge_changes({
        fault: (chip_smoke.w2v_snapshot(bad), chip_smoke.w2v_snapshot(ref),
                start)})
    assert not ok, errs


# ----------------------------------------------- rows: assign duplicates

def test_assign_duplicates_case_shape():
    rng = np.random.RandomState(3)
    for n in (8192, 8193, 8194, 300):
        ids, values, mask = chip_smoke.assign_duplicates_case(rng, n, 5000)
        _, counts = np.unique(ids, return_counts=True)
        assert ids.size == values.shape[0] == mask.size == n
        assert counts.min() == 2 and counts.max() == 4
        assert 0 < (ids >= 5000).sum() and 0.8 < mask.mean() < 0.95


def test_assign_duplicates_hold_last_write(monkeypatch):
    """The port's assign on the CPU (four threads, where a plain
    ``index_put_`` orders no writes to one row) equals numpy's last
    write; an apply where the first write wins does not."""
    import torch

    rng = np.random.RandomState(4)
    w0 = rng.randn(3000, chip_smoke.W2V_DIM).astype(np.float32)
    ids, values, mask = chip_smoke.assign_duplicates_case(rng, 4096, 3000)
    want = chip_smoke.last_write(w0, ids, values, mask)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        got, _ = chip_smoke.assign_duplicates(torch, "cpu", w0, ids, values,
                                              mask)
        assert np.array_equal(got, want)
        first, _ = chip_smoke.assign_duplicates(
            torch, "cpu", w0, *(np.ascontiguousarray(a[::-1])
                                for a in (ids, values, mask)))
        assert not np.array_equal(first, want)
    finally:
        torch.set_num_threads(threads)


# ------------------------------------------------------------- lda judges

def test_z_disagreement():
    docs = np.array([[1, 2, -1], [3, -1, -1]])
    z = np.array([[0, 1, -1], [2, -1, -1]])
    assert chip_smoke.z_disagreement(z, z, docs) == 0.0
    other = z.copy()
    other[0, 1] = 3
    other[1, 2] = 5                          # a PAD slot: not a token
    assert chip_smoke.z_disagreement(other, z, docs) == pytest.approx(1 / 3)
    assert chip_smoke.z_disagreement(z[:1], z, docs) == 1.0


def test_mh_bound_bytes():
    assert chip_smoke.mh_bound_bytes(10, 4) == 4 * 10 * 4 * 7
    ms = chip_smoke.mh_bound_bytes(10_000, 8192) / chip_smoke.PEAK_HBM_BYTES
    assert ms * 1e3 == pytest.approx(0.6847, abs=1e-4)


def _small_lda_state(sweep, draws_seed=1):
    import torch

    from multiverso_tpu_torch.apps import LightLDA, synthetic_documents

    docs, _ = synthetic_documents(24, 60, 6, doc_len=16, seed=0)
    docs[::5, 11:] = -1
    gumbel, mh = chip_smoke.lda_host_draws(torch, docs.shape, 8,
                                           chip_smoke.LDA_MH_STEPS,
                                           seed=draws_seed)
    return docs, chip_smoke.lda_sweep(LightLDA, docs, sweep,
                                      gumbel if sweep == "fused" else mh,
                                      vocab=60, topics=8)


@pytest.mark.parametrize("sweep", ["fused", "mh", "sample"])
def test_lda_judges_on_real_sweeps(cpu_runtime, sweep):
    """One sweep of each kind twice from the same draws: no token differs
    and the counts are conserved; other draws move some tokens."""
    docs, a = _small_lda_state(sweep)
    _, b = _small_lda_state(sweep)
    assert chip_smoke.z_disagreement(a[0], b[0], docs) == 0.0
    checks, ok = chip_smoke.lda_counts_conserved(docs, *a[1:])
    assert ok, checks
    if sweep != "sample":
        _, c = _small_lda_state(sweep, draws_seed=2)
        assert chip_smoke.z_disagreement(c[0], a[0], docs) > 0.01


@pytest.mark.parametrize("where", ["doc_topic", "word_topic", "topic_sum"])
def test_lda_conservation_rejects_one_count_off(cpu_runtime, where):
    docs, (_, dt, wt, ts) = _small_lda_state("mh")
    arrays = {"doc_topic": dt.copy(), "word_topic": wt.copy(),
              "topic_sum": ts.copy()}
    arrays[where].reshape(-1)[3] += 1
    checks, ok = chip_smoke.lda_counts_conserved(
        docs, arrays["doc_topic"], arrays["word_topic"], arrays["topic_sum"])
    assert not ok, checks


# ----------------------------------------------------------- sgmix judges

def _small_sgmix(name, updater="sgd", lr=0.05 * 64):
    from multiverso_tpu_torch.apps import SkipGramMixture

    return SkipGramMixture(300, 8, senses=2, learning_rate=lr, negatives=3,
                           window=3, updater_type=updater, name=name)


def _sgmix_batches(sg, n=3):
    import itertools

    from multiverso_tpu_torch.apps import synthetic_corpus

    corpus = synthetic_corpus(64 * n, 300, seed=0)
    return list(itertools.islice(sg.batches(corpus, 64, seed=0), n))


def test_sgmix_judge_passes_and_rejects_real_runs(cpu_runtime):
    import torch

    ref, alt, bad = (_small_sgmix(n) for n in ("ref", "alt", "bad"))
    a, b = _small_sgmix("pp"), _small_sgmix("fu")
    batches = _sgmix_batches(ref)
    start = chip_smoke.sgmix_snapshot(ref)
    losses, free = chip_smoke.sgmix_fused(torch, ref, batches)
    assert free is None and len(losses) == 3 and np.isfinite(losses).all()
    perm = np.random.RandomState(0).permutation(64)
    chip_smoke.sgmix_fused(torch, alt, [tuple(x[perm] for x in bt)
                                        for bt in batches])
    a.train_batch(*batches[0])
    chip_smoke.sgmix_fused(torch, b, batches[:1])
    snap = chip_smoke.sgmix_snapshot
    errs, ok = chip_smoke.judge_changes({
        "reordered": (snap(alt), snap(ref), start),
        "pushpull_vs_fused": (snap(a), snap(b), start)})
    assert ok, errs
    assert len(errs) == 6
    bad.option = dataclasses.replace(bad.option,
                                     learning_rate=2 * bad.option.learning_rate)
    chip_smoke.sgmix_fused(torch, bad, batches)
    _, ok = chip_smoke.judge_changes({"double": (snap(bad), snap(ref),
                                                 start)})
    assert not ok


def test_sgmix_padding_check(cpu_runtime, monkeypatch):
    """The padding batches: the first puts word V-1 in, the second keeps
    it out.  Under momentum the port leaves V-1 alone; a step that
    clamps the scatter ids onto V-1 (the fault the check exists for)
    changes its state."""
    import torch

    from multiverso_tpu_torch.updaters import base

    V = 300
    m = _small_sgmix("m", "momentum", lr=0.05)
    first, second = chip_smoke.padding_batches(_sgmix_batches(m, 2), V)
    assert (first[0] == V - 1).any() and (first[1] == V - 1).any()
    assert not any((x == V - 1).any() for x in (second[0], second[1],
                                                second[3]))
    assert (second[1] == V).any()
    chip_smoke.sgmix_fused(torch, m, [first])
    before = chip_smoke.sgmix_snapshot(m)
    chip_smoke.sgmix_fused(torch, m, [second])
    same = chip_smoke.rows_unchanged(before, chip_smoke.sgmix_snapshot(m),
                                     V, 2)
    assert all(same.values()) and len(same) == 5, same

    real = base.scatter_apply

    def clamped(upd, data, state, rows, delta, opt):
        return real(upd, data, state, rows.clamp(max=data.shape[0] - 1),
                    delta, opt)

    monkeypatch.setattr(base, "scatter_apply", clamped)
    bad = _small_sgmix("bad", "momentum", lr=0.05)
    chip_smoke.sgmix_fused(torch, bad, [first])
    before = chip_smoke.sgmix_snapshot(bad)
    chip_smoke.sgmix_fused(torch, bad, [second])
    same = chip_smoke.rows_unchanged(before, chip_smoke.sgmix_snapshot(bad),
                                     V, 2)
    assert not same["out_state0"], same


def test_senses_separate_verdict():
    a, b, prior = [0.9, 0.1], [0.05, 0.95], [0.5, 0.5]
    assert chip_smoke.senses_separate(a, b, prior, 0.3)
    assert not chip_smoke.senses_separate(a, [0.9, 0.1], prior, 0.3)
    assert not chip_smoke.senses_separate([0.6, 0.4], b, prior, 0.3)
    assert not chip_smoke.senses_separate(a, b, [0.9, 0.1], 0.3)
    assert not chip_smoke.senses_separate(a, b, prior, 0.95)


# ------------------------------------- trainer, small, moe, longctx judges

def test_transformer_phases_at_bench_shapes():
    assert chip_smoke.PHASES[5:8] == ("small", "moe", "longctx")
    assert chip_smoke.SMALL == dict(vocab_size=8192, dim=512, n_layers=4,
                                    n_heads=8, hidden=1408)
    assert (chip_smoke.SMALL_BATCH, chip_smoke.SMALL_SEQ) == (8, 2048)
    assert chip_smoke.MOE == dict(vocab_size=16384, dim=1024, n_layers=8,
                                  n_heads=8, hidden=2816, num_experts=8,
                                  top_k=2, capacity_factor=1.25, remat=True)
    assert (chip_smoke.MOE_BATCH, chip_smoke.MOE_SEQ) == (8, 1024)
    assert chip_smoke.LONG == dict(vocab_size=8192, dim=1024, n_layers=4,
                                   n_heads=8, hidden=2816, remat=True)
    assert (chip_smoke.LONG_BATCH, chip_smoke.LONG_SEQ) == (1, 16384)


def test_mesh_phase_and_long_context_shapes():
    """The mesh phase runs after longctx, at the trainer's config and the
    ring's bf16 check at bench_long_context's attention shape; the seq
    65,536 run is bench.py's longctx64k config."""
    assert chip_smoke.PHASES[8] == "mesh"
    assert (chip_smoke.LONG64K_SEQ, chip_smoke.LONG64K_BLOCK) == (65536,
                                                                  4096)
    assert chip_smoke.RING_SP == 4
    assert chip_smoke.RING_BF16 == (1, 8, 16384, 128)
    assert chip_smoke.RING_F32 == (2, 4, 2048, 64)
    assert chip_smoke.MESH_STEPS == 3


def test_flash_work_counts_cross_length_pieces():
    """A square causal piece keeps the counts it always had; a full
    piece counts every (q, k) pair and reads tk rows of k and v."""
    assert chip_smoke.flash_work(8, 2048, 128) == chip_smoke.flash_work(
        8, 2048, 128, 2048, True)
    work = chip_smoke.flash_work(2, 64, 32, tk=128, causal=False)
    assert work["flash_fwd"] == (2 * 2 * 32 * 64 * 128 * 2,
                                 (2 * 64 + 2 * 128) * 2 * 32 * 2
                                 + 2 * 64 * 4)
    assert work["flash_dkv"][0] == 4 * 2 * 32 * 64 * 128 * 2


def _attn_case(t, d, seed, tk=None):
    import torch

    g = torch.Generator().manual_seed(seed)
    tk = tk or t

    def r(*shape):
        return torch.randn(*shape, generator=g)

    return dict(q=r(2, t, d), k=r(2, tk, d), v=r(2, tk, d), do=r(2, t, d),
                dlse=r(2, t))


@pytest.mark.parametrize("causal", [True, False])
def test_blocked_plain_equals_the_plain_versions(causal):
    """The seq 65,536 check's plain side, in blocks of rows or columns,
    is the kernels' plain versions (float32 on the CPU)."""
    from multiverso_tpu_torch.ops import flash_attention as fa

    x = _attn_case(200, 32, 3)
    want = chip_smoke.blocked_plain(fa, x, causal, 64)
    o, lse = fa.flash_fwd_ref(x["q"], x["k"], x["v"], 32 ** -0.5, causal)
    np.testing.assert_allclose(want["o"], o, atol=1e-6)
    np.testing.assert_allclose(want["lse"], lse, atol=1e-5)
    saved = (lse, (x["do"] * o).sum(-1) - x["dlse"])
    got = chip_smoke.blocked_plain(fa, x, causal, 64, saved)
    ref = chip_smoke.run_three(fa, x, causal, True, saved)
    for key in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[key], ref[key], atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_launch_rule_holds_the_schedule(monkeypatch, layout):
    """The mesh phase's expected launches per virtual rank and its piece
    tally are what the port's ring schedule runs, forward and backward,
    piece shape by piece shape."""
    import torch
    from multiverso_tpu_torch.parallel import (InProcessRing,
                                               ring_attention_shard,
                                               sequence_positions)

    sp, T = 4, 64
    zigzag = layout == "zigzag"
    x = _attn_case(T, 32, 4)
    blocks = {n: [x[n][None].index_select(
        2, sequence_positions(T, sp, r, zigzag)).requires_grad_()
        for r in range(sp)] for n in ("q", "k", "v")}
    shapes = {}
    counts = _counted_kernels(monkeypatch, shapes)
    ring = InProcessRing(blocks["k"], blocks["v"])
    per_rank, outs = [], []
    for r in range(sp):
        before = counts["flash_fwd"]
        outs.append(ring_attention_shard(
            blocks["q"][r], blocks["k"][r], blocks["v"][r], r, sp,
            ring.rotate_for(r), True, None, zigzag))
        per_rank.append(counts["flash_fwd"] - before)
    assert per_rank == chip_smoke.ring_launches(sp, layout)
    torch.autograd.backward([a for o in outs for a in o],
                            [torch.ones_like(a) for o in outs for a in o])
    pieces = chip_smoke.ring_pieces(T, sp, layout)
    assert shapes == {(name, tq, tk, causal): n
                      for tq, tk, causal, n in pieces
                      for name in chip_smoke.KERNELS}
    assert sum(n for *_, n in pieces) == sum(per_rank)


def test_expected_launches_per_remat_policy():
    assert chip_smoke.expected_launches(False, 16, 5) == {
        "flash_fwd": 80, "flash_dq": 80, "flash_dkv": 80}
    assert chip_smoke.expected_launches("dots", 16, 5) == {
        "flash_fwd": 80, "flash_dq": 80, "flash_dkv": 80}
    assert chip_smoke.expected_launches("full", 16, 5) == {
        "flash_fwd": 160, "flash_dq": 80, "flash_dkv": 80}
    ok = {"flash_fwd": 160, "flash_dq": 80, "flash_dkv": 80}
    assert chip_smoke.judge_launches(ok, "full", 16, 5)
    assert not chip_smoke.judge_launches(ok, "dots", 16, 5)
    assert not chip_smoke.judge_launches({**ok, "flash_dq": 0}, "full",
                                         16, 5)


def _counted_kernels(monkeypatch, shapes=None):
    """Count each kernel's runs as the card's wrappers count launches
    (on the CPU the wrappers run the plain versions and count nothing);
    into ``shapes`` too by (kernel, Tq, Tk, causal), as
    ``launch_shapes`` counts them."""
    from multiverso_tpu_torch.ops import flash_attention as fa

    counts = {k: 0 for k in chip_smoke.KERNELS}
    for name, attr in (("flash_fwd", "_fwd"), ("flash_dq", "_dq"),
                       ("flash_dkv", "_dkv")):
        plain = getattr(fa, attr)

        def counted(*args, _plain=plain, _name=name):
            counts[_name] += 1
            if shapes is not None:
                key = (_name, args[0].shape[1], args[1].shape[1],
                       bool(args[-1]))
                shapes[key] = shapes.get(key, 0) + 1
            return _plain(*args)

        monkeypatch.setattr(fa, attr, counted)
    return counts


def _remat_run(policy, steps=2):
    import torch
    from multiverso_tpu_torch.models import transformer as pt

    cfg = pt.TransformerConfig(vocab_size=512, dim=64, n_layers=2,
                               n_heads=2, hidden=128, max_seq=32,
                               compute_dtype=torch.float32,
                               remat=policy is not None,
                               remat_policy=policy or "full")
    tr = pt.TransformerTrainer(cfg, device="cpu", seed=0)
    tokens = np.random.RandomState(0).randint(0, 512, size=(2, 32))
    return [float(tr.train_step_async(tokens)) for _ in range(steps)]


@pytest.mark.parametrize("policy", [None, "dots", "full"])
def test_launch_rule_holds_real_remat_runs(monkeypatch, policy):
    counts = _counted_kernels(monkeypatch)
    _remat_run(policy)
    assert chip_smoke.judge_launches(counts, policy or False, 2, 2), counts


def test_launch_rule_rejects_dots_that_relaunches_the_forward(monkeypatch):
    """A "dots" policy that does not keep the flash forward's output
    replays the kernel in the backward, as a forward outside the
    dispatcher would: the launch rule must reject that run."""
    import torch
    from torch.utils.checkpoint import CheckpointPolicy
    from multiverso_tpu_torch.models import transformer as pt

    def mm_only(ctx, op, *args, **kwargs):
        if op == torch.ops.aten.mm.default:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    monkeypatch.setattr(pt, "_dots_policy", mm_only)
    counts = _counted_kernels(monkeypatch)
    _remat_run("dots")
    assert counts["flash_fwd"] == 2 * 2 * 2
    assert not chip_smoke.judge_launches(counts, "dots", 2, 2)


def test_judge_remat_losses():
    base = [10.9, 10.2, 9.8, 9.6, 9.5]
    rel, ok = chip_smoke.judge_remat_losses([x * 1.0005 for x in base],
                                            base)
    assert ok and rel == pytest.approx(5e-4)
    assert not chip_smoke.judge_remat_losses([x * 1.003 for x in base],
                                             base)[1]
    assert not chip_smoke.judge_remat_losses(base[:4], base)[1]
    assert not chip_smoke.judge_remat_losses(base[:4] + [math.nan],
                                             base)[1]


def _remat_params(policy, steps=2):
    """(start, after) snapshots of a small trainer's parameters around
    ``steps`` steps under ``policy`` (None: no remat)."""
    import torch
    from multiverso_tpu_torch.models import transformer as pt

    cfg = pt.TransformerConfig(vocab_size=512, dim=64, n_layers=2,
                               n_heads=2, hidden=128, max_seq=32,
                               compute_dtype=torch.float32,
                               remat=policy is not None,
                               remat_policy=policy or "full")
    tr = pt.TransformerTrainer(cfg, device="cpu", seed=0)
    start = chip_smoke.snapshot(tr.params)
    tokens = np.random.RandomState(0).randint(0, 512, size=(2, 32))
    for _ in range(steps):
        assert math.isfinite(float(tr.train_step_async(tokens)))
    return start, chip_smoke.snapshot(tr.params)


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_remat_change_judge_on_real_runs(policy):
    """The trainer phase's change judge: a remat run's parameter change
    equals the no-remat run's; one whose update of a layer weight was
    lost is rejected."""
    start, want = _remat_params(None)
    _, got = _remat_params(policy)
    change = max(chip_smoke.rel_change(g, w, s0)
                 for g, w, s0 in zip(got, want, start))
    assert change == 0.0
    got[3] = start[3]
    lost = max(chip_smoke.rel_change(g, w, s0)
               for g, w, s0 in zip(got, want, start))
    assert lost > chip_smoke.REMAT_TOL


def test_judge_remat_losses_on_real_runs(monkeypatch):
    base = _remat_run(None, steps=3)
    for policy in ("dots", "full"):
        rel, ok = chip_smoke.judge_remat_losses(_remat_run(policy, 3), base)
        assert ok and rel == 0.0


_MOE_KW = dict(vocab_size=16384, dim=64, n_layers=2, n_heads=2, hidden=128,
               num_experts=8, top_k=2, capacity_factor=1.25, remat=True,
               max_seq=64)


def _moe_sides():
    import torch
    from multiverso_tpu_torch.models import TransformerConfig, init_params

    host = init_params(TransformerConfig(**_MOE_KW), seed=0)
    tokens = torch.as_tensor(np.random.RandomState(1).randint(
        0, 16384, size=(2, 64)))
    return [chip_smoke.moe_check_run(torch, _MOE_KW, host, tokens, "cpu")
            for _ in range(2)]


def test_judge_moe_passes_real_runs():
    card, cpu = _moe_sides()
    checks, ok = chip_smoke.judge_moe(card, cpu)
    assert ok, checks
    assert checks["ample_dropped"] == 0
    assert sum(checks["dropped_cpu"]["cf0.5"]) > 0
    assert len(checks["dropped_cpu"]["cf1.25"]) == 2    # one per layer


@pytest.mark.parametrize("fault", ["ample_drops", "other_drops", "aux",
                                   "logits", "nothing_drops"])
def test_judge_moe_rejects(fault):
    card, cpu = _moe_sides()
    if fault == "ample_drops":
        card["ample"]["dropped"] = [1, 0]
    elif fault == "other_drops":
        card["cf1.25"]["dropped"] = [d + 1 for d in
                                     card["cf1.25"]["dropped"]]
    elif fault == "aux":
        card["dense"]["aux"] *= 1 + 1e-4
    elif fault == "logits":
        card["cf0.5"]["logits"] = card["cf0.5"]["logits"] * (1 + 1e-3)
    else:
        for side in (card, cpu):
            side["cf0.5"]["dropped"] = [0, 0]
    assert not chip_smoke.judge_moe(card, cpu)[1]


def test_judge_moe_rejects_a_capacity_path_that_drops(monkeypatch):
    """At room for every route, a capacity dispatch whose buckets are too
    small drops routes and parts from the dense dispatch."""
    from multiverso_tpu_torch.models import moe

    card, cpu = _moe_sides()
    monkeypatch.setattr(moe, "moe_capacity", lambda *a: 8)
    bad, _ = _moe_sides()
    card["ample"] = bad["ample"]
    checks, ok = chip_smoke.judge_moe(card, cpu)
    assert not ok
    assert checks["ample_dropped"] > 0
    assert checks["ample_vs_dense_card"] > chip_smoke.MOE_TOL


@pytest.mark.parametrize("planted", [False, True])
def test_moe_layer_syncs_reports_where_the_host_waited(monkeypatch, planted):
    """The moe phase's sync check: an op inside the layer that raises
    "called a synchronizing CUDA operation" (what the card's "error"
    debug mode does) makes the layer not sync-free; any other error
    propagates."""
    import torch
    from multiverso_tpu_torch.models import moe

    modes = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    routing = moe._routing

    def noisy(*args):
        if planted:
            raise RuntimeError("called a synchronizing CUDA operation")
        return routing(*args)

    monkeypatch.setattr(moe, "_routing", noisy)
    params = moe.init_moe_params(64, 128, 8, seed=0)
    x = torch.randn(2, 16, 64)
    for dispatch in ("dense", "capacity"):
        modes.clear()
        free = chip_smoke.moe_layer_sync_free(torch, params, x, dispatch)
        assert free is not planted
        assert modes == ["error", 0]

    def broken(*args):
        raise RuntimeError("an unrelated failure")

    monkeypatch.setattr(moe, "_routing", broken)
    with pytest.raises(RuntimeError, match="unrelated"):
        chip_smoke.moe_layer_sync_free(torch, params, x, "dense")


# ------------------------------------------------- resnet and planes judges

def _small_resnet(seed=0):
    from multiverso_tpu_torch.apps.resnet import (ResNet20DataParallel,
                                                  synthetic_cifar)

    app = ResNet20DataParallel(lr=0.05, num_classes=4, seed=seed,
                               device="cpu")
    x, y = synthetic_cifar(32, num_classes=4, seed=seed)
    return app, app.place(x, y)


@pytest.mark.parametrize("fault", [None, "scale_dropped",
                                   "write_back_skipped"])
def test_protocol_judge_rejects_planted_faults(cpu_runtime, monkeypatch,
                                               fault):
    """The resnet phase's protocol check on a real step: the true sync
    passes bit for bit; a sync that drops the 1/N scale, or one that
    skips the write-back into the net, fails it."""
    import torch

    app, (xb, yb) = _small_resnet()
    if fault == "scale_dropped":
        for m in app.mgrs:
            m._average = False
    elif fault == "write_back_skipped":
        for m in app.mgrs:
            monkeypatch.setattr(m, "_write_back", lambda flat: None)
    records = chip_smoke.resnet_sync_records(torch, app, xb, yb)
    checks, ok = chip_smoke.judge_protocol(torch, records, 2)
    assert ok is (fault is None), checks
    if fault == "scale_dropped":
        assert not checks["sync0"]["table_exact"]
    if fault == "write_back_skipped":
        assert checks["sync0"]["table_exact"]
        assert not checks["sync0"]["params_exact"]


def test_resnet_check_run_and_change_judge_edges(cpu_runtime):
    """Two CPU runs from one start agree exactly; the change judge passes
    at its tolerance and fails just past it, and on a run that did not
    move."""
    import torch
    from multiverso_tpu_torch.apps.resnet import synthetic_cifar

    x, y = synthetic_cifar(128, num_classes=4, seed=0)
    runs = []
    for name in ("a", "b"):
        app, _ = _small_resnet()
        runs.append(chip_smoke.resnet_check_run(torch, app, x, y, 2))
        chip_smoke.close_app(app)
    (start, ends, losses), (start_b, ends_b, losses_b) = runs
    assert all(np.array_equal(p, q) for p, q in zip(start, start_b))
    assert losses == losses_b and np.isfinite(losses).all()
    assert len(ends) == 2
    end, end_b = ends[-1], ends_b[-1]
    rels, ok = chip_smoke.judge_resnet_changes(end_b, end, start)
    assert ok and set(rels) == {"worker0", "worker1"}
    assert all(r == 0.0 for r in rels.values())
    end64 = [e.astype(np.float64) for e in end]
    start64 = [s.astype(np.float64) for s in start]
    for w, tol in enumerate(chip_smoke.RESNET_TOL):
        moved = end64[w] - start64[w]
        k = int(np.abs(moved).argmax())
        for factor, want in ((0.999, True), (1.001, False)):
            got = [e.copy() for e in end64]
            got[w][k] += tol * factor * abs(moved[k])
            assert chip_smoke.judge_resnet_changes(got, end64,
                                                   start64)[1] is want
    assert not chip_smoke.judge_resnet_changes(end, start, start)[1]


def test_resnet_l2_judge_and_held_step_edges():
    """The L2 measure passes at its tolerance and fails just past it; an
    error spread over every entry (as TF32's) that the largest-entry
    judge passes fails the held step, while one chaotic entry as large
    as that judge allows passes it."""
    rng = np.random.RandomState(0)
    start = [rng.randn(4000) for _ in range(2)]
    moved = [rng.randn(4000) * 1e-2 for _ in range(2)]
    want = [s + m for s, m in zip(start, moved)]
    rels, ok = chip_smoke.resnet_l2_changes(want, want, start)
    assert ok and all(r == 0.0 for r in rels.values())
    for w, tol in enumerate(chip_smoke.RESNET_L2_TOL):
        unit = moved[w] / np.linalg.norm(moved[w])
        for factor, ok_want in ((0.999, True), (1.001, False)):
            got = [x.copy() for x in want]
            got[w] = got[w] + unit * tol * factor * np.linalg.norm(moved[w])
            assert chip_smoke.resnet_l2_changes(got, want,
                                                start)[1] is ok_want
    # Worker 1: an error of half its largest-entry limit in every entry,
    # and the same in one entry.
    w, tol = 1, chip_smoke.RESNET_TOL[1]
    peak = np.abs(moved[w]).max()
    spread = [x.copy() for x in want]
    spread[w] = spread[w] + 0.5 * tol * peak * np.sign(rng.randn(4000))
    assert chip_smoke.judge_resnet_changes(spread, want, start)[1]
    held, ok = chip_smoke.resnet_step_held(spread, want, start)
    assert not ok and held == {"worker0": True, "worker1": False}
    single = [x.copy() for x in want]
    single[w][7] += 0.5 * tol * peak
    assert chip_smoke.resnet_step_held(single, want, start)[1]
    assert chip_smoke.rel_l2_change(want[0], want[0], want[0]) == math.inf


def test_convergence_threshold_edges():
    floor = chip_smoke.RESNET_ACC_MIN
    assert chip_smoke.converged(floor + 1e-4)
    assert not chip_smoke.converged(floor)
    assert not chip_smoke.converged(0.1)


def test_cudnn_flags_restore_what_they_found():
    import torch

    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32, cudnn.deterministic
    with chip_smoke.cudnn_flags(torch, allow_tf32=not before[0],
                                deterministic=not before[1]):
        assert (cudnn.allow_tf32, cudnn.deterministic) == (
            not before[0], not before[1])
        read = chip_smoke.torch_float_settings(torch)
        assert (read["cudnn.allow_tf32"], read["cudnn.deterministic"]) == (
            not before[0], not before[1])
    assert (cudnn.allow_tf32, cudnn.deterministic) == before


def _armed_run(tmp_path):
    """A CPU lifecycle with the planes phase's flags: (trace, metrics
    text, rules loaded)."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import health, profiler

    mv.init(device="cpu", args=[*chip_smoke.PLANES_FLAGS,
                                f"-trace_dir={tmp_path}"])
    try:
        rules = len(health.evaluator().snapshot())
        prof = profiler.active()
        t = mv.ArrayTable(16, name="planes")
        deadline = time.time() + 5
        while time.time() < deadline and (
                prof.samples == 0
                or not any(s.name == "health.alerts.firing"
                           for s in mv.metrics.REGISTRY.series())):
            t.add(np.ones(16, np.float32))
    finally:
        mv.shutdown()
        mv.config.reset()
        mv.tracing.disable()
    with open(tmp_path / "trace_rank0.json") as f:
        trace = json.load(f)
    with open(tmp_path / "metrics_rank0.prom") as f:
        prom = f.read()
    return trace, prom, rules


def test_planes_judge_passes_and_rejects(tmp_path):
    """The planes phase's judge on a real armed CPU lifecycle passes, and
    fails on the same trace without the profiler's events, on a metrics
    file without the evaluator's series, and on a short rule pack."""
    from multiverso_tpu_torch import health

    trace, prom, rules = _armed_run(tmp_path)
    n = len(health.default_rules())
    checks, ok = chip_smoke.judge_planes(trace, prom, rules, n)
    assert ok, checks
    assert checks["profile_events"] > 0 and checks["spans"] > 0
    stripped = {"traceEvents": [e for e in trace["traceEvents"]
                                if not e["name"].startswith("profile:")]}
    assert not chip_smoke.judge_planes(stripped, prom, rules, n)[1]
    no_health = "\n".join(ln for ln in prom.splitlines()
                          if "health_alerts" not in ln)
    assert not chip_smoke.judge_planes(trace, no_health, rules, n)[1]
    assert not chip_smoke.judge_planes(trace, prom, rules - 1, n)[1]
    assert not chip_smoke.judge_planes(None, "", 0, n)[1]


# --------------------------------------------------------- native phase

def _bench_defaults(name):
    """The keyword defaults of one of bench.py's functions, read from its
    source (bench.py imports JAX at the top)."""
    import ast

    with open(os.path.join(_ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    args = fn.args.args[-len(fn.args.defaults):]
    return {a.arg: ast.literal_eval(d)
            for a, d in zip(args, fn.args.defaults)}


def test_native_phase_runs_last_at_bench_sizes():
    assert chip_smoke.PHASES[-1] == "native"
    assert chip_smoke.NATIVE_LR == _bench_defaults("bench_lr_native8")
    assert chip_smoke.NATIVE_W2V == _bench_defaults("bench_w2v_native8")
    assert chip_smoke.NATIVE_SERVE_PROCS == 2


TINY = dict(vocab_size=64, dim=64, n_layers=2, n_heads=2, hidden=64)


def test_native_offload_judges_on_cpu(monkeypatch):
    """The phase's judges on real tiny runs on the CPU: the local and the
    native store equal the in-memory trainer bit for bit; the native
    arm runs each kernel's path the launch rule's count of times; a
    bridge that drops the first step's push fails the comparison; the
    ``init`` probe rejects runtimes under ``default`` and ``sgd`` and
    passes ``assign``."""
    import torch

    from multiverso_tpu_torch import native as nat
    from multiverso_tpu_torch.parallel import OffloadedState

    cfg, host, tokens = chip_smoke.small_offload_setup(
        torch, TINY, 16, 4, "float32")
    arm = functools.partial(chip_smoke.offload_arm, torch, cfg, host,
                            tokens, device="cpu")
    counts = _counted_kernels(monkeypatch)
    mem = arm()
    rt = nat.NativeRuntime(args=["-updater_type=assign", "-log_level=error"])
    try:
        arms = {"local": arm("local")}
        counts.update(dict.fromkeys(counts, 0))
        arms["native"] = arm("native", rt)
        native_counts = dict(counts)
        dropped = arm("native", rt,
                      bridge_hook=chip_smoke.dropping_push(3))
    finally:
        rt.shutdown()
    verdict, ok = chip_smoke.judge_offload_arms(mem, arms)
    assert ok and verdict == {"local": True, "native": True}
    assert set(arms["native"][5]) == {"push_s", "wait_s"}
    assert chip_smoke.judge_launches(native_counts, None, TINY["n_layers"],
                                     chip_smoke.MOE_MESH_STEPS)
    assert not chip_smoke.judge_launches(
        {**native_counts, "flash_dkv": native_counts["flash_dkv"] - 1},
        None, TINY["n_layers"], chip_smoke.MOE_MESH_STEPS)
    assert not chip_smoke.judge_offload_arms(mem, {"d": dropped})[1]
    assert dropped[0][0] == mem[0][0] and dropped[0][2] != mem[0][2]
    # A run one step short, or of other state, fails too.
    short = (mem[0][:2], *mem[1:])
    assert not chip_smoke.judge_offload_arms(mem, {"s": short})[1]
    other = (*mem[:3], [a + 1 for a in mem[3]], *mem[4:])
    assert not chip_smoke.judge_offload_arms(mem, {"o": other})[1]
    for upd in ("default", "sgd"):
        assert chip_smoke.native_probe_rejects(nat, OffloadedState, upd)
    assert not chip_smoke.native_probe_rejects(nat, OffloadedState,
                                               "assign")


def test_native_ratio_arithmetic():
    assert chip_smoke.native_ratios(None, None, 10.0, 20.0) == {}
    assert chip_smoke.native_ratios(30.0, None, 10.0, 20.0) == {
        "lr_fused_vs_native8": 3.0}
    assert chip_smoke.native_ratios(30.0, 50.0, 10.0, 20.0) == {
        "lr_fused_vs_native8": 3.0, "w2v_fused_vs_native8": 2.5}
    outs = ["NATIVE_LR_OK rank=0 dt=1.500000 steps=60",
            "NATIVE_LR_OK rank=1 dt=2.250000 steps=60"]
    assert chip_smoke.native_wall(outs) == 2.25
    got = chip_smoke.serve_numbers(
        "SERVE_BENCH_OK rank=0 cold_p50_ms=0.400000 cached_p50_ms=0.010000")
    assert got["serve_cold_p50_ms"] == 0.4
    assert got["serve_cached_vs_cold_p50"] == pytest.approx(40.0)
    assert "serve_rank" not in got
    cpus = os.cpu_count() or 1
    assert chip_smoke.blas_threads(8) == max(1, cpus // 8)
    assert chip_smoke.blas_threads(10 * cpus) == 1


def test_spawn_native_workers_runs_the_ports_workers():
    """The phase's launcher at 2 ranks and a small LR job: every rank's
    marker and a barrier-to-barrier window; a marker no rank prints
    fails the launch, naming a rank."""
    outs = chip_smoke.spawn_native_workers("lr_native_worker.py", 2,
                                           "NATIVE_LR_OK", (3, 32),
                                           timeout=240)
    assert all(f"NATIVE_LR_OK rank={r}" in o for r, o in enumerate(outs))
    assert chip_smoke.native_wall(outs) > 0
    with pytest.raises(RuntimeError, match="rank 0"):
        chip_smoke.spawn_native_workers("lr_native_worker.py", 2,
                                        "NO_SUCH_MARKER", (1, 8),
                                        timeout=240)


def test_native_build_thread_reports_its_build():
    """The phase's build runs in a thread started beside the kernels'
    builds; joined, it has the library and its seconds, and no error."""
    from multiverso_tpu_torch import native as nat

    thread, out = chip_smoke.start_native_build()
    thread.join(timeout=900)
    assert not thread.is_alive()
    assert "error" not in out and out["build_s"] >= 0
    assert isinstance(out["prebuilt"], bool)
    assert os.path.exists(nat.lib_path())
