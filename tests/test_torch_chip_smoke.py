"""The build report and the judges of ``chip_smoke.py``, on the CPU.

The chip smoke test reads each built library's ``-Xptxas -v`` log and its
``cuobjdump -sass`` listing, and fails the run when a library holds no
bf16 Hopper kernel, or one holds no wgmma (HGMMA) or no TMA load
(UTMALDG).  Those parsers and that
rule are plain Python; here they run on listings in the formats the CUDA
toolkit prints, with a stand-in ``cuobjdump``.  The tables and lr
phases' judges (numpy against the card, card against the CPU) run on
stand-in results, each with cases it must reject.
"""

import importlib.util
import math
import os
import stat
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
    assert chip_smoke.PHASES[-2:] == ("tables", "lr")
    assert chip_smoke.TABLE_SIZE == 16 * 1024 * 1024


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
