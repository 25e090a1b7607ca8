"""Tables sharded across ranks: the port over gloo at 2 and 4 processes
against the JAX package in one process.

Two launches of ``torch_ranks`` (4 ranks, then 2), each under its own
hard timeout, run every case of ``shard_cases``: dense adds under SGD,
AdaGrad and momentum, BSP and SSP flushes, 1-bit adds, ``add_rows`` and
``get_rows`` with overlapping, duplicate and empty per-rank id sets, the
sparse table's host mirror, a checkpoint chain (the JAX package writes,
4 ranks restore and write, 2 ranks restore and write; the port in one
process and the JAX package restore the 4 ranks' file), LR's and
word2vec's fused epochs, and the param managers' delta sync.  Each
rank's reads are held against the JAX package's table after the same
adds stacked (or summed) in one process, at rtol and atol 1e-6, as the
row tests hold them; and every rank's ``_data`` and each state tensor
must hold ``ceil(rows / world)`` rows, which a full replica fails.
Rows and sizes divide 2 or 4 unevenly (41, 10) as well as evenly (8).
"""

import math
import os
from types import SimpleNamespace

import numpy as np
import pytest

import shard_cases as C
import torch_ranks as R

TOL = 1e-6
WORLDS = (4, 2)       # in launch order: 2 ranks restore 4 ranks' file
CASES = ("dense", "clock", "onebit", "rows", "apps", "mixture",
         "managers", "refusals")
# The mixture is held as its own parity test holds it against the JAX
# package in one process (tests/test_torch_skipgram_mixture.py).
MIXTURE_TOL = dict(rtol=1e-5, atol=1e-8)


def _jax_pkg():
    import multiverso_tpu as jmv
    from multiverso_tpu import apps
    from multiverso_tpu.ext import jax_ext, torch_ext

    return SimpleNamespace(mv=jmv, init=jmv.init, device="cpu", apps=apps,
                           torch_ext=torch_ext, shared=jax_ext)


def _jax(fn, *args, **kw):
    """``fn(jax_pkg, *args, **kw)`` in a fresh JAX runtime."""
    pkg = _jax_pkg()
    pkg.mv.config.reset()
    if pkg.mv.initialized():
        pkg.mv.shutdown()
    try:
        return fn(pkg, *args, **kw)
    finally:
        if pkg.mv.initialized():
            pkg.mv.shutdown()
        pkg.mv.config.reset()


def write_jax_checkpoint(pkg, path):
    """The checkpoint the 4-rank run starts from: one round of adds
    into the checkpoint tables, at step 1."""
    pkg.init()
    a, m = C.checkpoint_tables(pkg)
    a.add(C.delta(1, (C.N_ARRAY,)))
    m.add(C.delta(2, C.SMALL))
    pkg.mv.checkpoint.save(path, extra={"step": 1})
    pkg.mv.shutdown()


def _plan(world, ckpt):
    cases = [[c, "shards", dict(case=c)] for c in CASES]
    cases.append(["checkpoint", "shards",
                  dict(case="checkpoint", restore=ckpt[f"in{world}"],
                       save=ckpt[f"out{world}"], seed=800 + world)])
    return [dict(sizes=[world], names=["shard"], cases=cases)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shard_ranks"))
    ckpt = {"in4": os.path.join(root, "jax.ckpt"),
            "out4": os.path.join(root, "ranks4.ckpt"),
            "out2": os.path.join(root, "ranks2.ckpt")}
    ckpt["in2"] = ckpt["out4"]
    _jax(write_jax_checkpoint, ckpt["in4"])
    out = {}
    for world in WORLDS:
        d = os.path.join(root, f"w{world}")
        R.launch(_plan(world, ckpt), d, world)
        out[world] = d

    def read(world, name):
        res = R.results(out[world], name, world)
        for r in res:
            assert "error" not in r, f"{name} at {world}: {r['error']}"
        return res

    return read, ckpt


def _hold(res, want, world, tol=None):
    """Every rank's reads against the one-process side's: shared keys on
    every rank, ``_r<k>`` keys on rank k; at ``tol`` (rtol and atol,
    default TOL each)."""
    tol = tol or dict(rtol=TOL, atol=TOL)
    for r, got in enumerate(res):
        keys = [k for k in got if not k.startswith("sizes_")]
        assert keys, "a rank returned nothing"
        for k in keys:
            assert k in want, k
            np.testing.assert_allclose(got[k], want[k], **tol,
                                       err_msg=f"rank {r}: {k}")
        own = {k for k in want if k.endswith(f"_r{r}")}
        shared = {k for k in want if not _rank_key(k)}
        assert own | shared == set(keys), (r, set(keys) ^ (own | shared))


def _rank_key(k):
    head, _, tail = k.rpartition("_r")
    return bool(head) and tail.isdigit()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["dense", "clock", "onebit", "rows"])
def test_table_ops_match_jax(runs, world, case):
    read, _ = runs
    want = _jax(C.CASES[case], world)
    _hold(read(world, case), want, world)


@pytest.mark.parametrize("world", WORLDS)
def test_bsp_and_ssp_hold_adds_until_their_barrier(runs, world):
    read, _ = runs
    for got in read(world, "clock"):
        for k in ("bsp_before", "ssp_before", "rows_before", "ssp_after1"):
            np.testing.assert_array_equal(got[k], 0.0, err_msg=k)
        assert np.abs(got["ssp_after2"]).max() > 0
        assert np.abs(got["bsp_after"]).max() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_fused_apps_match_jax(runs, world):
    """LR's and word2vec's fused epochs on sharded tables, every rank
    passing the global batches, against the JAX package's in one process
    (which equal its own run across two processes)."""
    read, _ = runs
    _hold(read(world, "apps"), _jax(C.case_apps, world), world)


@pytest.mark.parametrize("world", WORLDS)
def test_mixture_fused_epoch_matches_jax(runs, world):
    """The skip-gram mixture's fused epoch on three sharded tables against
    the JAX package's in one process (which equals its own run across
    two processes)."""
    read, _ = runs
    _hold(read(world, "mixture"), _jax(C.case_mixture, world), world,
          MIXTURE_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_param_managers_sync_across_ranks(runs, world):
    """``TorchParamManager`` and ``mv_shared`` under several processes
    pull with the collective ``get()``; held against the JAX package's
    managers in one process with the ranks' stacked deltas."""
    read, _ = runs
    _hold(read(world, "managers"), _jax(C.case_managers, world), world)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_tables_refuse_device_get_and_whole_assign(runs, world):
    """And LightLDA's device sweeps, which the JAX package cannot run
    across processes, refuse with the ROADMAP item's name."""
    read, _ = runs
    for got in read(world, "refusals"):
        assert "several processes" in str(got["device_get"])
        assert "several processes" in str(got["raw_assign"])
        for sweep in ("make_fused_pass", "make_mh_pass"):
            assert '"Several processes"' in str(got[sweep]), got[sweep]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES[:-1] + ("checkpoint",))
def test_every_rank_holds_one_block(runs, world, case):
    """Each rank's ``_data`` and every state tensor of every table hold
    ``ceil(rows / world)`` rows (a full replica holds ``rows``)."""
    read, _ = runs
    seen = 0
    for got in read(world, case):
        for k, sizes in got.items():
            if k.startswith("sizes_"):
                rows, blocks = int(sizes[0]), sizes[1:]
                assert rows >= world, k
                np.testing.assert_array_equal(
                    blocks, math.ceil(rows / world), err_msg=k)
                seen += 1
    assert seen or case == "refusals"


def _checkpoint_want(world_chain):
    """The JAX package's tables along the chain: its own write, then each
    world's round of adds in turn."""
    def run(pkg):
        pkg.init()
        tables = C.checkpoint_tables(pkg)
        a, m = tables
        a.add(C.delta(1, (C.N_ARRAY,)))
        m.add(C.delta(2, C.SMALL))
        wants = []
        for world in world_chain:
            restored = {}
            C._snap(restored, "restored", tables)
            C._push(a, world, None, 800 + world, (C.N_ARRAY,), add="stack")
            C._push(m, world, None, 850 + world, C.SMALL)
            after = {}
            C._snap(after, "after", tables)
            wants.append({**restored, **after})
        pkg.mv.shutdown()
        return wants
    return _jax(run)


def test_checkpoint_crosses_world_sizes_and_packages(runs):
    """JAX → 4 ranks → 2 ranks, each restoring what the one before wrote,
    updater state included; each step equals the JAX package's own
    tables along the same adds."""
    read, _ = runs
    wants = _checkpoint_want(WORLDS)
    for world, want in zip(WORLDS, wants):
        res = read(world, "checkpoint")
        for got in res:
            assert int(got["extra_step"]) == (1 if world == 4 else 2)
        _hold(res, {**want, "extra_step": res[0]["extra_step"]}, world)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_four_rank_checkpoint_restores_in_one_process(runs, side, tmv):
    """The 4 ranks' file restores into one process of either package
    (and, above, into 2 ranks) as the tables the 4 ranks held."""
    read, ckpt = runs
    want = read(4, "checkpoint")[0]

    def restore(pkg):
        pkg.init()
        tables = C.checkpoint_tables(pkg)
        assert pkg.mv.checkpoint.restore(ckpt["out4"]) == {"step": 2}
        got = {}
        C._snap(got, "after", tables)
        pkg.mv.shutdown()
        return got

    if side == "jax":
        got = _jax(restore)
    else:
        from functools import partial

        got = restore(SimpleNamespace(mv=tmv,
                                      init=partial(tmv.init, device="cpu")))
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


@pytest.fixture()
def tmv():
    import multiverso_tpu_torch as tmv

    def clean():
        if tmv.initialized():
            tmv.shutdown()
        tmv.config.reset()

    clean()
    yield tmv
    clean()
