"""The build report and the judges of ``chip_smoke.py``, on the CPU.

The chip smoke test reads each built library's ``-Xptxas -v`` log and its
``cuobjdump -sass`` listing, and fails the run when a library lacks one
of its bf16 Hopper kernels (the forward, dq and dk/dv at D 32, 64, 128
and 256), or one holds no wgmma (HGMMA) or no TMA load (UTMALDG), or
spills.  Those parsers and that
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
The serve phase's judges pass a good reading and reject each planted
fault (a lost acked add, a failover without a promotion, an alert that
never fired, byte books 20% off, a missed hot key, ...); its key parser,
its sizes (bench.py's), the launcher's exempt victim and the
interactive fleet's deadlines are checked on small stand-ins (the
workers themselves run in ``test_torch_serve_tier.py`` and
``test_torch_failover_audit.py``).  The judges of the port's CLI steps
reject each planted fault: a ``--strict`` that exits 0 while the page is
live, a top finding naming rank 0, a doctor fleet whose shutdown took
45 s, ``mvaudit`` reporting one lost acked add, ``mvtop`` missing a
rank, a latdoctor table without a stage; their text parsers read what
the CLIs print, and the scrape replay answers the port's ops client.
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
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

FWD = "_ZN3mvt16flash_fwd_hopperILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiii"
SPLIT = "_ZN3mvt12flash_split3EPK6float4P5uint2m"

PTXAS_LOG = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{FWD}' for 'sm_90a'
ptxas info    : Function properties for {FWD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 182 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '{SPLIT}' for 'sm_90a'
ptxas info    : Function properties for {SPLIT}
    8 bytes stack frame, 36 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 8 bytes cumulative stack size
"""


def _sass(hopper_ops, hopper=FWD):
    """A listing with the Hopper kernel(s) ``hopper`` (a name or a list),
    each holding ``hopper_ops``, and a kernel of another design (the
    split, SPLIT) with local-memory traffic."""
    lines = ["\tcode for sm_90a"]
    for name in [hopper] if isinstance(hopper, str) else hopper:
        lines += [f"\t\tFunction : {name}",
                  '\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"',
                  "        /*0000*/                   LDC R1, c[0x0][0x28] ;"]
        for i, op in enumerate(hopper_ops):
            lines.append(f"        /*{0x10 * (i + 1):04x}*/              @!UP0 {op} ;")
    lines += [f"\t\tFunction : {SPLIT}",
              "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
              "        /*0010*/               @P0 LDL.64 R2, [R1] ;",
              "        /*0020*/                   STL [R1], R3 ;",
              "        /*0030*/                   STL.64 [R1+0x8], R4 ;"]
    return "\n".join(lines) + "\n"


def test_ptxas_report_reads_registers_and_spills():
    got = chip_smoke.ptxas_report(PTXAS_LOG)
    assert got == {FWD: {"spill_bytes": 0, "registers": 182},
                   SPLIT: {"spill_bytes": 76, "registers": 40}}


def test_sass_counts_per_kernel_and_predicated():
    ops = ["HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT",
           "HGMMA.64x128x16.F32.BF16 R88, R24, gdesc[UR8].tnspB, R88, gsb0",
           "UTMALDG.3D [UR8], [UR4]"]
    got = chip_smoke.sass_counts(_sass(ops))
    assert got[FWD] == {"HGMMA": 2, "UTMALDG": 1, "LDL": 0, "STL": 0}
    assert got[SPLIT] == {"HGMMA": 0, "UTMALDG": 0, "LDL": 1, "STL": 2}


def _fake_build(tmp_path, listings, spills=None):
    """A stand-in for ``ops._build``: logs in BUILD_DIR, and an nvcc whose
    directory holds a ``cuobjdump`` that prints ``listings[name]`` for
    ``lib<name>.so``.  Each log reports every Hopper kernel of its
    listing with no spills, but kernel ``spills`` with 48 bytes."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    build_dir = tmp_path / "build"
    build_dir.mkdir()
    paths = {}
    for name in chip_smoke.KERNELS:
        log = PTXAS_LOG.replace(FWD, NOT_HOPPER)
        for hop in _hopper_names(name):
            if hop in listings[name]:
                spill = 48 if hop == spills else 0
                log += PTXAS_LOG.split(f"ptxas info    : Compiling entry "
                                       f"function '{SPLIT}'")[0].replace(
                    "ptxas info    : 0 bytes gmem\n", "").replace(
                    FWD, hop).replace("0 bytes spill stores",
                                      f"{spill} bytes spill stores")
        (build_dir / f"{name}.log").write_text(log)
        (build_dir / f"lib{name}.sass").write_text(listings[name])
        paths[name] = str(build_dir / f"lib{name}.so")
    tool = bindir / "cuobjdump"
    tool.write_text('#!/bin/sh\ncat "${2%.so}.sass"\n')
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    fake = types.SimpleNamespace(BUILD_DIR=str(build_dir),
                                 nvcc_path=lambda: str(bindir / "nvcc"))
    return fake, paths


def _hopper_name(lib, d=128):
    """The mangled name of library ``lib``'s D=d Hopper kernel, as the
    compiler names it."""
    return FWD.replace("16flash_fwd_hopperILi128EE",
                       f"{len(lib) + 7}{lib}_hopperILi{d}EE")


def _hopper_f32_name(lib, d=128):
    """The mangled name of library ``lib``'s D=d float32 plane kernel."""
    return FWD.replace("16flash_fwd_hopperILi128EE",
                       f"{len(lib) + 11}{lib}_hopper_f32ILi{d}EE")


def _hopper_names(lib, drop=None, drop_f32=None):
    """Library ``lib``'s Hopper kernels, one per head dim it must hold,
    but ``drop``, and its float32 plane kernels but ``drop_f32``."""
    return ([_hopper_name(lib, d) for d in chip_smoke.HOPPER_DIMS[lib]
             if d != drop]
            + [_hopper_f32_name(lib, d)
               for d in chip_smoke.HOPPER_F32_DIMS[lib] if d != drop_f32])


NOT_HOPPER = "_ZN3mvt15flash_dq_kernelIfLi64ELi64ELi64EEEvPKT_S3_S3_S3_PKfS5_PS1_iiif"
GOOD_OPS = ["HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0",
            "UTMALDG.3D [UR8], [UR4]"]


def _listings(bad=None, bad_ops=None, drop=None, drop_f32=None):
    """A listing per library, each with its Hopper kernels holding
    GOOD_OPS, except library ``bad``: its D=128 Hopper kernel holds
    ``bad_ops`` (with ``bad_ops`` None it has no Hopper kernel at all,
    with ``drop`` or ``drop_f32`` a head dim it lacks that dim's bf16 or
    float32 plane kernel)."""
    out = {}
    for name in chip_smoke.KERNELS:
        if name != bad:
            out[name] = _sass(GOOD_OPS, _hopper_names(name))
        elif drop is not None or drop_f32 is not None:
            out[name] = _sass(GOOD_OPS, _hopper_names(name, drop, drop_f32))
        elif bad_ops is None:
            out[name] = _sass(GOOD_OPS, NOT_HOPPER)
        else:
            out[name] = (_sass(GOOD_OPS, _hopper_names(name, 128))
                         + _sass(bad_ops, _hopper_name(name)))
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


@pytest.mark.parametrize("lib", ["flash_fwd", "flash_dkv", "flash_dq"])
@pytest.mark.parametrize("d", [32, 256])
def test_build_phase_fails_without_the_d32_or_d256_design(tmp_path, lib, d):
    """The forward, dk/dv and dq must each hold their Hopper kernel at D
    32 and D 256 (with wgmma and TMA): a library that lacks one fails."""
    fake, paths = _fake_build(tmp_path, _listings(lib, drop=d))
    with pytest.raises(AssertionError, match=rf"{lib}: no Hopper kernel "
                                             rf"at D \[{d}\]"):
        chip_smoke.phase_build(fake, paths, 1.0)


@pytest.mark.parametrize("lib", ["flash_fwd", "flash_dkv", "flash_dq"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_build_phase_fails_without_the_float32_plane_design(tmp_path, lib,
                                                            d):
    """The forward, dq and dk/dv must each hold their float32 plane kernel
    at D 64, 128 and 256: a library that lacks one fails."""
    fake, paths = _fake_build(tmp_path, _listings(lib, drop_f32=d))
    with pytest.raises(AssertionError, match=rf"{lib}: no Hopper_f32 "
                                             rf"kernel at D \[{d}\]"):
        chip_smoke.phase_build(fake, paths, 1.0)


@pytest.mark.parametrize("lib", ["flash_dkv", "flash_dq", "flash_fwd"])
def test_build_phase_fails_without_the_d32_float32_plane_design(tmp_path,
                                                                lib):
    """The forward, dq and dk/dv must hold their float32 plane kernel at D
    32 too: a library that lacks it fails."""
    fake, paths = _fake_build(tmp_path, _listings(lib, drop_f32=32))
    with pytest.raises(AssertionError, match=rf"{lib}: no Hopper_f32 "
                                             rf"kernel at D \[32\]"):
        chip_smoke.phase_build(fake, paths, 1.0)


@pytest.mark.parametrize("lib,d", [("flash_dq", 128), ("flash_dkv", 64),
                                   ("flash_fwd", 256), ("flash_dkv", 32),
                                   ("flash_dq", 32)])
def test_build_phase_fails_on_a_spilling_float32_plane_kernel(tmp_path, lib,
                                                              d):
    fake, paths = _fake_build(tmp_path, _listings(),
                              spills=_hopper_f32_name(lib, d))
    with pytest.raises(AssertionError, match="48 bytes spilled"):
        chip_smoke.phase_build(fake, paths, 1.0)


def test_hopper_dim_tells_the_float32_plane_kernels_apart():
    f32 = "void mvt::flash_dq_hopper_f32<128>"
    assert chip_smoke.hopper_dim("flash_dq", f32, "_f32") == 128
    assert chip_smoke.hopper_dim("flash_dq", f32) is None
    assert chip_smoke.hopper_dim(
        "flash_dkv", _hopper_f32_name("flash_dkv", 64), "_f32") == 64
    assert chip_smoke.hopper_dim(
        "flash_dkv", "void mvt::flash_dkv_hopper<64>", "_f32") is None


@pytest.mark.parametrize("lib,d", [("flash_fwd", 256), ("flash_dkv", 32),
                                   ("flash_dq", 256), ("flash_dq", 32)])
def test_build_phase_fails_on_a_spilling_hopper_kernel(tmp_path, lib, d):
    fake, paths = _fake_build(tmp_path, _listings(),
                              spills=_hopper_name(lib, d))
    with pytest.raises(AssertionError, match="48 bytes spilled"):
        chip_smoke.phase_build(fake, paths, 1.0)


def test_hopper_dim_reads_demangled_and_mangled_names():
    assert chip_smoke.hopper_dim(
        "flash_fwd", "void mvt::flash_fwd_hopper<256>") == 256
    assert chip_smoke.hopper_dim(
        "flash_dkv", "void mvt::flash_dkv_hopper<32>") == 32
    assert chip_smoke.hopper_dim("flash_fwd", _hopper_name("flash_fwd",
                                                           32)) == 32
    assert chip_smoke.hopper_dim(
        "flash_dq", "void mvt::flash_dkv_hopper<64>") is None


# ------------------------------------------------ tables and lr phase judges

def test_new_phases_run_by_default():
    assert chip_smoke.PHASES[-10:] == ("tables", "lr", "rows", "w2v", "lda",
                                       "sgmix", "resnet", "planes",
                                       "native", "serve")
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
    assert chip_smoke.PHASES[5:9] == ("small", "headdims", "moe", "longctx")
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


def test_headdims_phase_shapes():
    """The headdims phase trains transformer_large's widths in 8 heads of
    256, bench_transformer's in 16 heads of 32, and transformer_large in
    float32 at the trainer's attention shape (16 heads of 128)."""
    assert chip_smoke.large_config(torch, heads=chip_smoke.WIDE_HEADS
                                   ).head_dim == 256
    assert chip_smoke.large_config(torch).head_dim == 128
    assert chip_smoke.NARROW == dict(chip_smoke.SMALL, n_heads=16)
    assert chip_smoke.NARROW["dim"] // chip_smoke.NARROW["n_heads"] == 32
    f32 = chip_smoke.large_config(torch, dtype=torch.float32)
    assert (f32.compute_dtype, f32.n_heads, f32.head_dim, f32.n_layers) == (
        torch.float32, 16, 128, 16)
    wide = chip_smoke.large_config(torch, heads=chip_smoke.WIDE_HEADS,
                                   dtype=torch.float32)
    assert (wide.compute_dtype, wide.n_heads, wide.head_dim) == (
        torch.float32, 8, 256)
    assert chip_smoke.large_config(torch).compute_dtype == torch.bfloat16


@pytest.mark.parametrize("name,dtype,d,rate", [
    ("flash_dq", torch.float32, 128, "bf16x6"),
    ("flash_dkv", torch.float32, 64, "bf16x6"),
    ("flash_dq", torch.float32, 48, "bf16x6"),
    ("flash_fwd", torch.float32, 128, "bf16x6"),
    ("flash_dkv", torch.float32, 32, "bf16x6"),
    ("flash_dq", torch.float32, 256, "bf16x6"),
    ("flash_dkv", torch.float32, 256, "bf16x6"),
    ("flash_dkv", torch.float32, 200, "bf16x6"),
    ("flash_dq", torch.bfloat16, 128, "bf16"),
    ("flash_fwd", torch.float32, 96, "bf16x6"),
    ("flash_fwd", torch.float32, 32, "bf16x6"),
    ("flash_fwd", torch.float32, 256, "bf16x6"),
    ("flash_dq", torch.float32, 32, "bf16x6"),
    ("flash_dkv", torch.float32, 16, "bf16x6")])
def test_bound_rate_follows_the_design(name, dtype, d, rate):
    """Every float32 kernel runs the plane design at every padded D, so
    each is bound at six bf16 products a product; bf16 at the bf16
    rate."""
    from multiverso_tpu_torch.ops import flash_attention as fa

    assert name in chip_smoke.KERNELS
    assert chip_smoke.bound_rate(fa, name, dtype, d) == rate


def test_bound_rate_reads_an_older_trees_table():
    """``--kernel-times --root`` of a tree whose float32 forward at D 32
    ran the first port's FMA kernel (its ``_F32_PLANE_DIMS`` lacks 32)
    bounds that launch at the card's FP32 rate, and the rest as before."""
    from multiverso_tpu_torch.ops import flash_attention as fa

    old = types.SimpleNamespace(
        torch=torch, _kernel_dim=fa._kernel_dim,
        _F32_PLANE_DIMS={"flash_fwd": (64, 128, 256),
                         "flash_dq": (32, 64, 128, 256),
                         "flash_dkv": (32, 64, 128, 256)})
    assert chip_smoke.bound_rate(old, "flash_fwd", torch.float32, 32) \
        == "fp32"
    assert chip_smoke.bound_rate(old, "flash_fwd", torch.float32, 16) \
        == "fp32"
    assert chip_smoke.bound_rate(old, "flash_dq", torch.float32, 32) \
        == "bf16x6"
    assert chip_smoke.RATES["fp32"] == chip_smoke.PEAK_FP32_FLOPS


def test_six_product_bound_at_the_trainer_shape():
    """dq and dk/dv's six-product bounds at [4, 16, 2048, 128]: 6 x flops
    at 989 TFLOP/s."""
    work = chip_smoke.flash_work(64, 2048, 128, elem=4)
    for name, ms in (("flash_dq", 0.6257), ("flash_dkv", 0.8342)):
        flops = work[name][0]
        assert flops / chip_smoke.RATES["bf16x6"] * 1e3 == pytest.approx(
            ms, rel=1e-3)


def test_split_share_times_the_split_beside_the_call():
    """The split's ms is the timer's reading of the split alone (CUDA
    events on the card), and its share is that over the call's ms."""
    timed = []

    def timer(fn):
        timed.append(fn)
        return 0.5
    split = object()
    got = chip_smoke.split_share(split, 2.0, timer=timer)
    assert got == {"split_ms": 0.5, "split_share": 0.25}
    assert timed == [split]


def test_split_share_times_with_cuda_events_by_default(monkeypatch):
    """Without a timer the split is timed as the call is, by ``cuda_ms``
    (CUDA events), not by a profiler, which lost kernels on the card's
    host."""
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn: 0.09)
    got = chip_smoke.split_share(lambda: None, 0.45)
    assert got["split_ms"] == 0.09
    assert got["split_share"] == pytest.approx(0.2)


def test_f64_errors_hold_the_kernel_within_the_ratio():
    ref = {"dq": torch.zeros(4, dtype=torch.float64)}
    plain = {"dq": torch.tensor([1e-6, 0, 0, 0])}
    within = {"dq": torch.tensor([0, -7.9e-6, 0, 0])}
    past = {"dq": torch.tensor([0, 0, 9e-6, 0])}
    errs, ok = chip_smoke.f64_errors(within, plain, ref)
    assert ok and errs["dq"]["ratio"] == pytest.approx(7.9, rel=1e-3)
    assert not chip_smoke.f64_errors(past, plain, ref)[1]


def test_f64_forward_matches_softmax_attention():
    """The float64 reference of the forward's gate is softmax attention
    and its logsumexp on the pre-scaled float32 q, a head at a time or
    all at once."""
    rng = np.random.RandomState(4)
    x = {n: torch.tensor(rng.randn(3, 24, 16).astype(np.float32))
         for n in ("q", "k", "v")}
    qs = (x["q"] * 16 ** -0.5).double()
    for causal in (True, False):
        s = qs @ x["k"].double().transpose(1, 2)
        if causal:
            s = s.masked_fill(~torch.ones(24, 24, dtype=torch.bool).tril(),
                              -math.inf)
        want = {"o": torch.softmax(s, -1) @ x["v"].double(),
                "lse": torch.logsumexp(s, -1)}
        for heads in (1, 8):
            got = chip_smoke.f64_forward(torch, x, causal, heads=heads)
            for name in want:
                assert got[name].dtype == torch.float64
                np.testing.assert_allclose(got[name].numpy(),
                                           want[name].numpy(), atol=1e-13,
                                           err_msg=name)


def test_f64_backward_matches_autograd():
    """The float64 reference of the parity gate is the backward of
    softmax attention from the saved lse and delta."""
    rng = np.random.RandomState(3)
    x = {n: torch.tensor(rng.randn(2, 24, 16).astype(np.float32))
         for n in ("q", "k", "v", "do")}
    scale = 16 ** -0.5
    q, k, v = (x[n].double().requires_grad_() for n in ("q", "k", "v"))
    s = ((q * scale) @ k.transpose(1, 2)).masked_fill(
        ~torch.ones(24, 24, dtype=torch.bool).tril(), -math.inf)
    o = torch.softmax(s, -1) @ v
    lse = torch.logsumexp(s, -1)
    grads = torch.autograd.grad(o, (q, k, v), x["do"].double())
    delta = (x["do"].double() * o).sum(-1)
    ref = chip_smoke.f64_backward(torch, x, (lse.detach().float(),
                                             delta.detach().float()),
                                  True, heads=1)
    for name, want in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(ref[name].numpy(), want.numpy(),
                                   atol=1e-5, err_msg=name)


def test_parity_float32_cases_cover_the_plane_tiles():
    cases = chip_smoke.f32_cases(torch)
    assert all(dt == torch.float32 for *_, dt, _, _ in cases)
    tags = {(d, t, tk, tag) for _, t, tk, d, _, _, tag in cases}
    assert (128, 2048, 2048, "full_width_f32") in tags
    assert (128, 8192, 8192, "long_f32") in tags
    assert {tag for *_, tag in cases} >= set(chip_smoke.F64_CASES)
    for d in (64, 128):
        assert (d, 2080, 2080, "half_tile") in tags
        assert (d, 2112, 2112, "half_tile") in tags
        assert (d, 66, 66, "two_row_tile") in tags
        assert (d, 130, 130, "two_row_tile") in tags
        assert (d, 40, 136, "cross_length") in tags
        assert (d, 136, 40, "cross_length") in tags
    assert (128, 2064, 2064, "half_block") in tags
    assert [bh for bh, *_, tag in cases if tag == "one_head"] == [1]
    # All three at D 256: T 8,192 under the float64 gate, the 64-row
    # tiles' edges, the forward's 128-row tile's last tile of 2 rows and
    # Tq≠Tk both ways.
    assert (256, 8192, 8192, "long_f32_d256") in tags
    assert "long_f32_d256" in chip_smoke.F64_CASES
    for t, tk, tag in ((2080, 2080, "half_tile"), (66, 66, "two_row_tile"),
                       (130, 130, "two_row_tile"),
                       (40, 136, "cross_length"), (136, 40, "cross_length")):
        assert (256, t, tk, tag) in tags
    for t in (66, 130, 40, 136):
        assert {c for _, tq, _, d, _, c, _ in cases
                if d == 256 and tq == t} == {True, False}
    # dq and dk/dv at D 32: T 8,192 under the float64 gate, the 64-row
    # tiles' edges and Tq≠Tk both ways, causal and not.
    assert (32, 8192, 8192, "long_f32_d32") in tags
    assert "long_f32_d32" in chip_smoke.F64_CASES
    for t, tk, tag in ((2080, 2080, "half_tile"), (2112, 2112, "half_tile"),
                       (66, 66, "two_row_tile"), (130, 130, "two_row_tile"),
                       (40, 136, "cross_length"), (136, 40, "cross_length")):
        assert (32, t, tk, tag) in tags
    for t in (66, 130, 40, 136):
        assert {c for _, tq, _, d, _, c, _ in cases
                if d == 32 and tq == t} == {True, False}


def test_exp_bound_rate_and_float32_bytes():
    """The exp unit's rate is 16 a clock an SM against the tensor cores'
    4,096 bf16 flops: a 256th of the bf16 peak; a float32 call moves
    twice the bytes of a bf16 one (lse and delta are float32 in both)."""
    assert chip_smoke.PEAK_EX2_PER_S == pytest.approx(989e12 / 256)
    pairs = 2048 * 2049 // 2
    assert pairs * 128 / chip_smoke.PEAK_EX2_PER_S * 1e3 == pytest.approx(
        0.06952, rel=1e-4)
    b16 = chip_smoke.flash_work(64, 2048, 128)["flash_fwd"][1]
    b32 = chip_smoke.flash_work(64, 2048, 128, elem=4)["flash_fwd"][1]
    assert b32 - 64 * 2048 * 4 == 2 * (b16 - 64 * 2048 * 4)


def test_sgns_bytes_bound_and_cases():
    """The SGNS kernel's bound at the word2vec cell's shape: 131,072
    centres and 786,432 output rows of 300 floats read and written once,
    2.202 GB, 0.657 ms at 3.35 TB/s; the card cases take that shape,
    bench_w2v's and a ragged one with scalar loads."""
    nbytes = chip_smoke.sgns_bytes(131_072, 300, 5)
    assert nbytes == 2 * (131_072 + 786_432) * 300 * 4
    assert nbytes / chip_smoke.PEAK_HBM_BYTES * 1e3 == pytest.approx(
        0.6573, rel=1e-3)
    assert chip_smoke.SGNS_CASES[0] == (131_072, 300, 5)
    assert chip_smoke.SGNS_CASES[1] == (chip_smoke.W2V_BATCH,
                                        chip_smoke.W2V_DIM,
                                        chip_smoke.W2V_NEG)
    assert chip_smoke.SGNS_CASES[2][1] % 4


def test_sgns_close_rejects_a_planted_error():
    """The card check's judge: the plain version against itself passes;
    the largest entry off by 1e-4 of its value fails, and so does a
    NaN."""
    from multiverso_tpu_torch.ops import sgns

    g = torch.Generator().manual_seed(0)
    vc = torch.randn(33, 7, generator=g)
    out = torch.randn(33 * 4, 7, generator=g)
    _, _, want = sgns.sgns_plain(vc, out, 3)
    assert chip_smoke.sgns_close(want.clone(), want) == (0.0, True)
    bad = want.clone().view(-1)
    top = int(want.abs().argmax())
    bad[top] *= 1 + 1e-4
    assert not chip_smoke.sgns_close(bad.view_as(want), want)[1]
    bad[top] = float("nan")
    bad = bad.view_as(want)
    assert not chip_smoke.sgns_close(bad, want)[1]


def test_parity_edge_cases_cover_new_tiles_and_grid():
    cases = chip_smoke.edge_cases(torch)
    dims = {(d, t, tag) for _, t, _, d, _, _, tag in cases}
    for d in (32, 256):
        assert (d, 2112, "half_tile") in dims and (d, 130, "two_row_tile") \
            in dims
    assert (256, 2080, "half_tile") in dims and (256, 66, "two_row_tile") \
        in dims
    big = [(bh, d, dt, causal) for bh, _, _, d, dt, causal, tag in cases
           if tag == "bh_past_grid_y"]
    assert big == [(65_600, 32, torch.bfloat16, True),
                   (65_600, 32, torch.float32, True)]


def test_mesh_phase_and_long_context_shapes():
    """The mesh phase runs after longctx, at the trainer's config and the
    ring's bf16 check at bench_long_context's attention shape; the seq
    65,536 run is bench.py's longctx64k config."""
    assert chip_smoke.PHASES[9] == "mesh"
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
    assert chip_smoke.PHASES[-2:] == ("native", "serve")
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


# ---------------------------------------------------------- serve phase

def test_serve_phase_runs_at_bench_sizes():
    serve = chip_smoke.SERVE
    assert serve["tail"] == _bench_defaults("bench_tail")["nclients"]
    for mode in ("latency", "audit", "health"):
        assert serve[mode] == _bench_defaults(f"bench_{mode}")["nclients"]
    assert serve["skew"] == tuple(_bench_defaults("bench_skew").values())
    assert serve["capacity"] == tuple(
        _bench_defaults("bench_capacity").values())
    assert serve["fanin"] == serve["ops"] == 1000
    assert chip_smoke.SERVE_INFLIGHT == 8
    assert set(chip_smoke.SERVE_BARS) >= {
        "ops_overhead_pct", "audit_overhead_pct", "health_overhead_pct",
        "hotkey_track_overhead_pct", "capacity_overhead_pct",
        "repl_overhead_pct"}


def test_worker_keys_read_report_lines_only():
    outs = ["fd_limit: RLIMIT_NOFILE soft=1024 hard=4096 cannot cover\n"
            "FANIN_BENCH_OK rank=0 accepted=64.000000 adds_ok=1.000000\n",
            "rank=1 p50_ms=0.250000 shed_rate=0.5\n"
            "rank=2 accepted=7 ep=127.0.0.1:5 detect=-1.0\n"]
    keys = chip_smoke.worker_keys(outs)
    assert keys == {"accepted": 64.0, "adds_ok": 1.0, "p50_ms": 0.25,
                    "shed_rate": 0.5, "detect": -1.0}
    assert chip_smoke.bench_names({"a": 1, "ops_b": 2}, "ops_",
                                  ("ops_",)) == {"ops_a": 1, "ops_b": 2}
    assert chip_smoke.bench_names({"a": 1}, "fanin_") == {"fanin_a": 1}


_GOOD = {
    "fanin": {"accepted": 64.0, "clients": 64.0, "shed_rate": 0.5,
              "adds_ok": 1.0},
    "failover": {"failover_lost_acked_adds": 0.0, "promotions": 1.0,
                 "failover_promote_ms": 1500.0},
    "skew": {"hot_hits": 5.0, "hot_expected": 5.0, "skew_ratio_zipf": 12.0,
             "skew_ratio_uniform": 1.6, "staleness_count": 4.0,
             "nan_table": 3.0},
    "capacity": {"capacity_bytes_accuracy": 1.0, "capacity_kv_accuracy": 1.0,
                 "mvplan_spread_after": 1.01, "demo_bytes_skew": 3.0,
                 "demo_load_skew": 11.0, "demo_rss_delta": 7e6,
                 "demo_arena_delta": 4194304.0},
}
_BOX = {"reason": "nan_update: table 3 (2 NaN element(s) in one add)"}


def _judge(name, keys):
    return {
        "fanin": lambda: chip_smoke.judge_fanin(keys, 64, demo=True),
        "failover": lambda: chip_smoke.judge_failover(keys),
        "skew": lambda: chip_smoke.judge_skew(keys, _BOX, nan=True),
        "capacity": lambda: chip_smoke.judge_capacity(keys, demo=True),
    }[name]()


@pytest.mark.parametrize("name,planted", [
    ("fanin", {"accepted": 63.0}), ("fanin", {"shed_rate": 0.0}),
    ("fanin", {"adds_ok": 0.0}),
    ("failover", {"failover_lost_acked_adds": 1.0}),
    ("failover", {"promotions": 0.0}),
    ("failover", {"failover_promote_ms": math.inf}),
    ("failover", {"failover_promote_ms": 12000.0}),
    ("skew", {"hot_hits": 4.0}), ("skew", {"skew_ratio_zipf": 4.0}),
    ("skew", {"nan_table": 2.0}), ("skew", {"staleness_count": 0.0}),
    ("capacity", {"capacity_bytes_accuracy": 0.8}),
    ("capacity", {"capacity_kv_accuracy": 1.2}),
    ("capacity", {"mvplan_spread_after": 2.5}),
    ("capacity", {"demo_load_skew": 1.5}),
    ("capacity", {"demo_rss_delta": 0.0}),
])
def test_serve_judges_reject_planted_faults(name, planted):
    assert _judge(name, dict(_GOOD[name]))[1]
    checks, ok = _judge(name, {**_GOOD[name], **planted})
    assert not ok and list(checks.values()).count(False) == 1, checks


def test_fanin_judge_gates_the_shed_in_the_demo_run_only():
    keys = {**_GOOD["fanin"], "shed_rate": 0.0}
    assert chip_smoke.judge_fanin(keys, 64)[1]
    assert not chip_smoke.judge_fanin(keys, 64, demo=True)[1]
    assert not chip_smoke.judge_fanin({**keys, "accepted": 63.0}, 64)[1]
    assert not chip_smoke.judge_fanin({**keys, "clients": 65.0}, 64)[1]


def test_serve_judges_reject_a_missing_key_and_a_missing_box():
    for name, keys in _GOOD.items():
        assert not _judge(name, {})[1], name
    assert not chip_smoke.judge_skew(_GOOD["skew"], None, nan=True)[1]
    assert chip_smoke.judge_skew(_GOOD["skew"], None)[1]


@pytest.mark.parametrize("mode,good,bad", [
    ("health", {"health_alert_fired": 1.0}, {"health_alert_fired": 0.0}),
    ("audit", {"audit_detect_ms": 12.5}, {"audit_detect_ms": -1.0}),
    ("latency", {"stage_sum_ratio": 0.97}, {"stage_sum_ratio": 0.8}),
    ("ops", {"ops_scrapes": 40.0}, {}),
    ("tail", {"clients": 10000.0}, {}),
])
def test_plane_judges(mode, good, bad):
    assert chip_smoke.judge_serve_plane(mode, good)[1]
    assert not chip_smoke.judge_serve_plane(mode, bad)[1]


def _finding(kind, count=None):
    return {"kind": kind, "count": count}


@pytest.mark.parametrize("mode,findings,outs,box,ok", [
    ("chaos", [_finding("dup", 2)], ["", "CHAOS_ADDS_OK"], None, True),
    ("chaos", [_finding("dup", 2), _finding("lost")],
     ["", "CHAOS_ADDS_OK"], None, False),
    ("chaos", [_finding("dup", 1)], ["", "CHAOS_ADDS_OK"], None, False),
    ("chaos", [_finding("dup", 2), _finding("unacked")],
     ["", "CHAOS_ADDS_OK"], None, False),
    ("chaos", [_finding("dup", 2)], ["", ""], None, False),
    ("loss", [_finding("gap"), _finding("unacked")], ["", ""],
     {"reason": "audit_gap: table 0 origin 1"}, True),
    ("loss", [_finding("gap"), _finding("unacked"), _finding("lost")],
     ["", ""], {"reason": "audit_gap: table 0 origin 1"}, False),
    ("loss", [_finding("gap"), _finding("unacked")], ["", ""], None, False),
    ("loss", [_finding("unacked")], ["", ""],
     {"reason": "audit_gap: table 0 origin 1"}, False),
    ("plain", [], ["", "PLAIN_OK"], None, True),
    ("plain", [], ["", ""], None, False),
])
def test_audit_judge(mode, findings, outs, box, ok):
    assert chip_smoke.judge_audit(mode, findings, outs, box)[1] == ok


_DEMO_FACTS = {
    "ops": ({"ranks": ["0", "1"], "silent": [], "rank_up": [1.0, 1.0],
             "labeled_series": [500, 500], "exemplar_ids": 20,
             "blackbox_reason": "barrier_timeout: waiting for rank(s) 1",
             "blackbox_spans": 70, "shared_trace_ids": 40,
             "resolved_exemplars": 20},
            [{"rank_up": [1.0, None]}, {"silent": ["1"]},
             {"exemplar_ids": 0}, {"blackbox_reason": ""},
             {"resolved_exemplars": 0}]),
    "latency": ({"stage_sum_ratio": 1.0, "stages_populated": True,
                 "dominant_stage": "apply", "exemplar_in_trace": True},
                [{"dominant_stage": "wire_out"}, {"stage_sum_ratio": 0.8},
                 {"stages_populated": False},
                 {"exemplar_in_trace": False}]),
    "doctor": ({"healthy_armed": True, "healthy_firing": 0,
                "fault_state": "firing", "cleared_state": "ok",
                "resolved": 1},
               [{"healthy_firing": 1}, {"fault_state": "ok"},
                {"fault_state": None}, {"cleared_state": "firing"},
                {"resolved": 0}]),
}


@pytest.mark.parametrize("demo", sorted(_DEMO_FACTS))
def test_demo_judges_reject_planted_faults(demo):
    judge = getattr(chip_smoke, f"judge_{demo}_demo")
    good, planted = _DEMO_FACTS[demo]
    assert judge(good)[1]
    for bad in planted:
        assert not judge({**good, **bad})[1], bad


_VICTIM = """
import os, signal, sys
if int(sys.argv[2]) == 1:
    os.kill(os.getpid(), signal.SIGKILL)
print("VICTIM_OK rank=" + sys.argv[2], flush=True)
"""


def test_spawn_native_workers_exempts_the_victim(tmp_path):
    script = tmp_path / "victim.py"
    script.write_text(_VICTIM)
    outs = chip_smoke.spawn_native_workers(str(script), 2, "VICTIM_OK",
                                           timeout=60, exempt_ranks=(1,))
    assert "VICTIM_OK rank=0" in outs[0] and "VICTIM_OK" not in outs[1]
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        chip_smoke.spawn_native_workers(str(script), 2, "VICTIM_OK",
                                        timeout=60)


_SLEEPER = """
import os, sys, time
rank = sys.argv[2]
with open(os.path.join(os.path.dirname(__file__), "pid" + rank), "w") as f:
    f.write(str(os.getpid()))
if rank == "1":
    print("SLEEPER rank=1 waiting on its peer", flush=True)
    time.sleep(120)
print("SLEEPER_OK rank=" + rank, flush=True)
"""


def test_spawn_native_workers_names_the_rank_past_its_deadline(tmp_path):
    """A rank still running at the deadline is killed, named in the error
    with what it wrote, and no rank is left behind."""
    script = tmp_path / "sleeper.py"
    script.write_text(_SLEEPER)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[1\] still running") \
            as err:
        chip_smoke.spawn_native_workers(str(script), 2, "SLEEPER_OK",
                                        timeout=3)
    assert time.monotonic() - t0 < 60
    assert "rank 1:\nSLEEPER rank=1 waiting on its peer" in str(err.value)
    for r in range(2):
        pid = int((tmp_path / f"pid{r}").read_text())
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


_HOLDER = """
import sys
print("HELD", flush=True)
for line in sys.stdin:
    if line.strip() == "ping":
        print("PONG " + sys.argv[2], flush=True)
    elif line.strip() == "quit":
        break
print("BYE " + sys.argv[2], flush=True)
"""


def test_fleet_commands_deadlines_and_exits(tmp_path):
    script = tmp_path / "holder.py"
    script.write_text(_HOLDER)
    with chip_smoke.Fleet(str(script), 2, "HELD", timeout=60) as fleet:
        assert len(fleet.eps) == 2
        assert fleet.command(1, "ping", "PONG").strip() == "PONG 1"
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rank 0 timed out"):
            fleet.expect(0, "NEVER", timeout=0.5)
        assert time.monotonic() - t0 < 5
        for r in range(2):
            fleet.send(r, "quit")
        outs = fleet.finish(lambda r: f"BYE {r}", timeout=60)
        assert "BYE 0" in outs[0] and "PONG 1" in outs[1]
    with chip_smoke.Fleet(str(script), 1, "HELD", timeout=60) as fleet:
        fleet.send(0, "quit")
        with pytest.raises(RuntimeError, match="rank 0 ended"):
            fleet.expect(0, "PONG", timeout=30)
    with pytest.raises(RuntimeError, match="timed out before 'NOT_PRINT"):
        chip_smoke.Fleet(str(script), 1, "NOT_PRINTED", timeout=2)


def test_raise_fd_limit_stays_within_the_hard_limit():
    import resource

    soft, hard, now = chip_smoke.raise_fd_limit(256)
    assert now >= min(256, soft if hard == resource.RLIM_INFINITY else hard)
    assert resource.getrlimit(resource.RLIMIT_NOFILE)[1] == hard


# ------------------------------------------------- the port's CLIs

def _run(out, rc=0):
    return {"tool": "t", "args": [], "rc": rc, "out": out, "err": ""}


_DOCTOR_TOP = ("1. [critical] rank 1: latency SLO burn — dominant p99 stage "
               "is 'apply'\n     - alert 'lat-slo-burn' firing (value 80, "
               "firing 3s)\n")
_ALERTS_VIEW = ("mvtop --alerts @ 22:34:47 — 2 alert(s), 1 firing\n"
                "rank          rule  severity   state  value  age_s\n"
                "   1  lat-slo-burn  critical  firing     60      3\n"
                "   0  lat-slo-burn  critical      ok      -      7\n")
_QUIET = "no findings — every scraped plane is quiet\n"


def _doctor_facts(**planted):
    cli = {"quiet_strict": _run(_QUIET), "fault": _run(_DOCTOR_TOP),
           "mvtop_alerts": _run(_ALERTS_VIEW),
           "fault_strict": _run(_DOCTOR_TOP, 1),
           "cleared_strict": _run(_QUIET)}
    facts = {"cli": cli, "shutdown_s": 1.18, "seconds": 20.5}
    for key, value in planted.items():
        (cli if key in cli else facts)[key] = value
    return facts


@pytest.mark.parametrize("planted", [
    {"fault_strict": _run(_DOCTOR_TOP, 0)},     # strict 0 with a live page
    {"fault": _run(_DOCTOR_TOP.replace("rank 1", "rank 0"))},
    {"fault": _run(_DOCTOR_TOP.replace("[critical]", "[warning]"))},
    {"fault": _run(_DOCTOR_TOP.replace("latency SLO burn", "RSS growing"))},
    {"fault": _run(_DOCTOR_TOP, 2)},
    {"quiet_strict": _run(_DOCTOR_TOP, 1)},
    {"cleared_strict": _run(_DOCTOR_TOP, 1)},
    {"shutdown_s": 45.9},                       # the stalled shutdown
    {"mvtop_alerts": _run(_ALERTS_VIEW.replace("firing     60", "ok  60"))},
    {"mvtop_alerts": _run(_ALERTS_VIEW, 1)},
], ids=["strict-0-while-paged", "top-rank-0", "top-not-critical",
        "top-not-burn", "doctor-crashed", "quiet-strict-1",
        "cleared-strict-1", "shutdown-45s", "alerts-not-firing",
        "alerts-exit-1"])
def test_doctor_cli_judge_rejects_planted_faults(planted):
    assert chip_smoke.judge_doctor_cli(_doctor_facts())[1]
    checks, ok = chip_smoke.judge_doctor_cli(_doctor_facts(**planted))
    assert not ok, checks


def test_doctor_and_latdoctor_gate_apply_only_when_asked():
    wire = _run(_DOCTOR_TOP.replace("'apply'", "'wire_out'"))
    for gate in (False, True):
        assert chip_smoke.judge_doctor_cli(_doctor_facts(),
                                           gate_apply=gate)[1]
        assert chip_smoke.judge_doctor_cli(_doctor_facts(fault=wire),
                                           gate_apply=gate)[1] != gate
        text = _latdoctor_text(dominant="wire_out")
        assert chip_smoke.judge_latdoctor(_run(text),
                                          gate_apply=gate)[1] != gate
        assert chip_smoke.judge_latdoctor(_run(_latdoctor_text()),
                                          gate_apply=gate)[1]


def test_doctor_shutdown_bound_is_well_below_the_stall():
    # The stall is the reconnect budget's 15 s on each of 3 attempts.
    assert chip_smoke.DOCTOR_SHUTDOWN_S <= 45.0 / 4


_CHAOS_OUT = ("mvaudit @ 22:35:51 — 2 stream(s), 1 finding(s)\n"
              "rank  table  origin  applied  acked  lag  dups  reorders  "
              "pending  gap\n"
              "   0      0       1       12     12    0     2         0  "
              "      0    -\n"
              "DUP table 0 origin 1 shard 0 x2 seqs [4,4],[5,5]\n")
_CHAOS_DIFF = [{"table": 0, "origin": 1, "shard": 0, "kind": "dup",
                "count": 2, "seqs": [(4, 4), (5, 5)]}]
_LOSS_OUT = ("mvaudit @ 22:36:13 — 2 stream(s), 4 finding(s)\n"
             "GAP table 0 origin 1 shard 0 seqs [1,1] — pending "
             "out-of-order range outlived -audit_grace_ms\n"
             "REORDER table 0 origin 1 shard 0 x3\n"
             "UNACKED table 0 origin 1 shard 0 seqs [1,4] — sent but "
             "never acked\n")
_SETTLE_OUT = ("mvaudit @ 22:35:28 — 12 stream(s), 1 finding(s)\n"
               "SILENT rank 1 — rank never answered the audit scrape "
               "(fleet deadline)\n")
_SILENT = [{"kind": "silent", "rank": 1, "detail": "never answered"}]
_LOST_LINE = ("LOST table 0 origin 2 shard 1 seqs [7,7] — ACKED but never "
              "applied — lost acked add(s)\n")


@pytest.mark.parametrize("mode,run,findings,ok", [
    ("chaos", _run(_CHAOS_OUT), _CHAOS_DIFF, True),
    ("chaos", _run(_CHAOS_OUT + _LOST_LINE, 1), _CHAOS_DIFF, False),
    ("chaos", _run(_CHAOS_OUT.replace("x2", "x1")), _CHAOS_DIFF, False),
    ("chaos", _run(_CHAOS_OUT.replace("origin 1 shard 0 x2",
                                      "origin 0 shard 0 x2")),
     _CHAOS_DIFF, False),
    ("chaos", _run(_CHAOS_OUT, 1), _CHAOS_DIFF, False),
    ("loss", _run(_LOSS_OUT, 1), [], True),
    ("loss", _run(_LOSS_OUT, 0), [], False),
    ("loss", _run(_LOSS_OUT.replace("GAP", "REORDER"), 1), [], False),
    ("loss", _run(_LOSS_OUT + _LOST_LINE, 1), [], False),
    ("settle", _run(_SETTLE_OUT), _SILENT, True),
    ("settle", _run(_SETTLE_OUT + _LOST_LINE, 1), _SILENT, False),
    ("settle", _run(_SETTLE_OUT + _LOST_LINE, 0), _SILENT, False),
    ("settle", _run(_SETTLE_OUT), _SILENT + [
        {"kind": "lost", "table": 0, "origin": 2, "shard": 1}], False),
    ("settle", _run("", 0), _SILENT, False),
], ids=["chaos", "chaos-one-lost", "chaos-one-dup", "chaos-other-origin",
        "chaos-exit-1", "loss", "loss-exit-0", "loss-no-gap", "loss-lost",
        "settle", "settle-one-lost", "settle-lost-exit-0",
        "settle-diff-disagrees", "settle-printed-nothing"])
def test_mvaudit_judge(mode, run, findings, ok):
    assert chip_smoke.judge_mvaudit(mode, run, findings)[1] == ok


def test_audit_named_reads_what_render_findings_writes():
    from multiverso_tpu_torch.ops.audit import render_findings

    findings = _CHAOS_DIFF + _SILENT + [
        {"kind": "gap", "table": 0, "origin": 1, "shard": 0, "seq_lo": 1,
         "seq_hi": 1, "detail": "x"},
        {"kind": "lost", "table": 2, "origin": 3, "shard": 1, "seq_lo": 5,
         "seq_hi": 9, "detail": "y"}]
    assert (chip_smoke.audit_named(render_findings(findings))
            == chip_smoke.findings_named(findings))
    assert chip_smoke.audit_named(render_findings([])) == []


_VIEW_OUT = {
    "metrics": 'mv_ops_rank_up{rank="0"} 1\nmv_ops_rank_up{rank="1"} 1\n',
    "health": ("mvtop @ 22:33:55 — 2 rank(s)\n"
               "rank   up  healthy  engine  queue  max\n"
               "   0  yes      yes   epoll      0   64\n"
               "   1  yes      yes   epoll      0   64\n"),
    "hotkeys": ("mvtop --hotkeys @ 22:33:56 — 2 table row(s)\n"
                "rank  table  gets  adds  skew  top keys\n"
                "   0      0    10    10  9.00  3:100 5:40\n"
                "   1      0    10    10  0.00         -\n"),
    "alerts": ("mvtop --alerts @ 22:33:55 — 0 alert(s), 0 firing\n"
               "rank  rule  severity  state  value  age_s\n"),
}


@pytest.mark.parametrize("kind,planted", [
    ("health", _VIEW_OUT["health"].replace("   1  yes", "   0  yes")),
    ("hotkeys", _VIEW_OUT["hotkeys"].splitlines()[0]),
    ("metrics", 'mv_ops_rank_up{rank="0"} 1\n'),
    ("alerts", _VIEW_OUT["alerts"] + "   1     -         -  unknown      -"
     "      -\n"),
    ("alerts", ""),
], ids=["health-missing-rank", "hotkeys-no-rows", "metrics-missing-rank",
        "alerts-silent-rank", "alerts-empty"])
def test_mvtop_views_judge_rejects_a_missing_rank(kind, planted):
    runs = {k: _run(v) for k, v in _VIEW_OUT.items()}
    checks, ok = chip_smoke.judge_mvtop_views(runs)
    assert ok, checks
    checks, ok = chip_smoke.judge_mvtop_views({**runs, kind: _run(planted)})
    assert not ok and not checks[kind]
    assert not chip_smoke.judge_mvtop_views({**runs, kind: _run(
        _VIEW_OUT[kind], 1)})[1]
    assert not chip_smoke.judge_mvtop_views({})[1]


@pytest.mark.parametrize("checks,names", [
    ({"ranks_up": True, "exemplars": False}, ["exemplars"]),
    ({"ranks_up": True, "cli": {"metrics": True, "hotkeys": False,
                                "audit": False}},
     ["cli.hotkeys", "cli.audit"]),
    ({"a": True, "cli": {"health": True}}, []),
    (None, []),
], ids=["flat", "nested", "all-pass", "none"])
def test_falsy_checks_names_each_failed_check(checks, names):
    """The serve phase's error names each failed check by its path."""
    assert chip_smoke.falsy_checks(checks) == names


_REPL_VIEW = ("mvtop --replication @ 22:35:34 — 4 rank(s)\n"
              "rank   armed  sync  epoch  owners   backups  backs  promoted"
              "  fwd\n"
              "   0     yes   yes   2048   0,2,0  -1,-1,-1      2         2"
              "    6\n"
              "   1    DEAD     -      -       -         -      -         -"
              "    -\n"
              "   2     yes   yes   2048   0,2,0  -1,-1,-1      1         1"
              "   10\n")


@pytest.mark.parametrize("planted", [
    _REPL_VIEW.replace("      1         1   10", "      1         -   10"),
    _REPL_VIEW.replace("   2     yes   yes   2048", "   2     yes   yes      0"),
    "\n".join(_REPL_VIEW.splitlines()[:-1]),
], ids=["not-promoted", "epoch-not-raised", "rank-2-missing"])
def test_mvtop_replication_judge(planted):
    assert chip_smoke.judge_mvtop_replication(_run(_REPL_VIEW))[1]
    assert not chip_smoke.judge_mvtop_replication(_run(_REPL_VIEW, 1))[1]
    assert not chip_smoke.judge_mvtop_replication(_run(planted))[1]


def _latdoctor_text(stages=chip_smoke.LATENCY_STAGES, dominant="apply"):
    out = []
    for r in ("0", "1"):
        out += [f"rank {r} (timing armed)",
                "  stage            p50       p95       p99   count"]
        out += [f"  {s:<9}    0.012ms   0.032ms   0.073ms      40"
                for s in stages]
        out += ["  total        0.071ms   0.171ms   0.239ms      40",
                f"  dominant p99 stage = {dominant} (25.570 ms)"]
    return "\n".join(out) + "\n"


def test_latdoctor_judge_and_parser():
    text = _latdoctor_text()
    ranks = chip_smoke.latdoctor_ranks(text)
    assert ranks["1"] == {"stages": list(chip_smoke.LATENCY_STAGES),
                          "dominant_p99": "apply"}
    assert chip_smoke.judge_latdoctor(_run(text))[1]
    # The named stage is reported, not gated.
    assert chip_smoke.judge_latdoctor(_run(_latdoctor_text(
        dominant="wire_out")))[1]
    for bad in (_run(text, 1),
                _run(_latdoctor_text(chip_smoke.LATENCY_STAGES[:-1])),
                _run(text.split("rank 1 (timing")[0]),
                _run(text.replace("  dominant p99 stage = apply", "")),
                _run("")):
        assert not chip_smoke.judge_latdoctor(bad)[1]


def _failover_facts(**planted):
    facts = {"dead_peers": 1, "detect_s": 0.3, "promote_s": 0.4,
             "owner_seen": ["1=2", "1=2"], "beacons_match": True,
             "barriers": ["BARRIER ok", "BARRIER ok"], "array": [5.0] * 12,
             "herd_reads": 35359, "diff": _SILENT,
             "cli": {"mvaudit": _run(_SETTLE_OUT),
                     "mvtop": _run(_REPL_VIEW)}}
    facts.update(planted)
    return facts


@pytest.mark.parametrize("planted", [
    {"dead_peers": 0}, {"owner_seen": ["1=2", "1=1"]}, {"promote_s": 11.0},
    {"beacons_match": False}, {"barriers": ["BARRIER ok", "BARRIER failed"]},
    {"array": [5.0] * 11 + [4.0]}, {"herd_reads": 0}])
def test_failover_demo_judge_rejects_planted_faults(planted):
    assert chip_smoke.judge_failover_demo(_failover_facts())[1]
    assert not chip_smoke.judge_failover_demo(_failover_facts(**planted))[1]


@pytest.mark.parametrize("cli", [
    {"mvaudit": _run(_SETTLE_OUT + _LOST_LINE, 1), "mvtop": _run(_REPL_VIEW)},
    {"mvaudit": _run(_SETTLE_OUT),
     "mvtop": _run("\n".join(_REPL_VIEW.splitlines()[:-1]))},
], ids=["one-lost-acked-add", "mvtop-missing-rank-2"])
def test_failover_cli_judge_rejects_planted_faults(cli):
    checks, ok = chip_smoke.judge_failover_cli(_failover_facts())
    assert ok, checks
    assert not chip_smoke.judge_failover_cli(_failover_facts(cli=cli))[1]


def test_table_rows_and_tool_records():
    rows = chip_smoke.table_rows(_VIEW_OUT["hotkeys"])
    assert [r["rank"] for r in rows] == ["0", "1"]
    assert rows[0]["top"] == "3:100" and rows[1]["skew"] == "0.00"
    assert chip_smoke.table_rows("no table here") == []
    long = _run("x" * 5000)
    rec = chip_smoke.tool_records({"a": long, "b": {"c": long}})
    assert len(rec["a"]["out"]) == 1500 and rec["b"]["c"]["rc"] == 0


def test_apply_counts():
    doctors = [{"doctor_top_names_apply": v} for v in (True, False, True)]
    lats = [{"latdoctor_dominant_p99": {"1": s}, "dominant_stage": "apply"}
            for s in ("apply", "wire_out")]
    assert chip_smoke.apply_counts(doctors, lats) == {
        "doctor_top_names_apply": [2, 3],
        "latdoctor_dominant_p99_apply": [1, 2],
        "latency_mean_stage_apply": [2, 2]}


def test_scrape_replay_answers_the_ports_ops_client():
    from multiverso_tpu_torch.ops.introspect import OpsClient

    doc = {"ranks": {"0": {"rank": 0}}, "silent": []}
    with chip_smoke.ScrapeReplay({"audit": json.dumps(doc),
                                  "metrics": "m 1\n"}) as replay:
        with OpsClient(replay.endpoint, timeout=10) as c:
            assert c.audit(fleet=True) == doc
            assert c.metrics_text(fleet=True) == "m 1\n"
            assert c.report("capacity", fleet=True) == "{}"
        t0 = time.monotonic()
    assert time.monotonic() - t0 < 5
