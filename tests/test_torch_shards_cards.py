"""Tables sharded across ranks over NCCL, one rank per card on four cards.

Marked ``card``: it needs four CUDA devices and skips without them (the
CPU tests hold the same cases over gloo against the JAX package:
``test_torch_shards.py``).  On a machine with four cards, from the
repository root::

    python -m pytest --noconftest tests/test_torch_shards_cards.py -q

(``--noconftest``: the repository's conftest imports JAX, which such a
machine need not have; this file imports none of it.)

Two launches of ``torch_ranks`` over NCCL (4 ranks on ``cuda:0-3``, then
2 on ``cuda:0-1``) run every case of ``shard_cases``, the tables on the
ranks' cards; each is held against the same adds made by the port in
one process on ``cuda:0``, at rtol and atol 1e-6, with every rank's
blocks at ``ceil(rows / world)`` rows.  The checkpoint chain starts from
a file the port writes in one process, goes through 4 ranks and then 2,
and the 4 ranks' file restores in one process.  The fused apps: LR under
AdaGrad and SGD at 1e-6; word2vec under SGD and the skip-gram mixture at
1e-5 of each table's largest entry.  word2vec under AdaGrad is not held
here: its row scatter sums duplicate ids with CUDA atomics in no fixed
order, and AdaGrad's step turns those last-bit differences into step
differences (ROADMAP.md, Queue 3), in one process as well as across
ranks.
"""

import math
import os
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import shard_cases as C
import torch_ranks as R

pytestmark = pytest.mark.card

WORLDS = (4, 2)
CASES = ("dense", "clock", "onebit", "rows", "apps", "mixture",
         "managers", "refusals")
TOL = 1e-6
W2V_TOL = 1e-5


def _port_pkg():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import apps
    from multiverso_tpu_torch.ext import shared, torch_ext

    return SimpleNamespace(mv=mv, init=partial(mv.init, device="cuda:0"),
                           device="cuda:0", apps=apps, torch_ext=torch_ext,
                           shared=shared)


def _one(fn, *args, **kw):
    """``fn(port_pkg, *args, **kw)`` in a fresh runtime on ``cuda:0``."""
    pkg = _port_pkg()
    pkg.mv.config.reset()
    try:
        return fn(pkg, *args, **kw)
    finally:
        if pkg.mv.initialized():
            pkg.mv.shutdown()
        pkg.mv.config.reset()


def _write_checkpoint(pkg, path):
    pkg.init()
    a, m = C.checkpoint_tables(pkg)
    a.add(C.delta(1, (C.N_ARRAY,)))
    m.add(C.delta(2, C.SMALL))
    pkg.mv.checkpoint.save(path, extra={"step": 1})
    pkg.mv.shutdown()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if torch.cuda.device_count() < max(WORLDS):
        pytest.skip(f"needs {max(WORLDS)} CUDA devices, has "
                    f"{torch.cuda.device_count()}")
    root = str(tmp_path_factory.mktemp("shard_cards"))
    ckpt = {"in4": os.path.join(root, "one.ckpt"),
            "out4": os.path.join(root, "ranks4.ckpt"),
            "out2": os.path.join(root, "ranks2.ckpt")}
    ckpt["in2"] = ckpt["out4"]
    _one(_write_checkpoint, ckpt["in4"])
    out = {}
    for world in WORLDS:
        cases = [[c, "shards", dict(case=c)] for c in CASES]
        cases.append(["checkpoint", "shards",
                      dict(case="checkpoint", restore=ckpt[f"in{world}"],
                           save=ckpt[f"out{world}"], seed=800 + world)])
        out[world] = os.path.join(root, f"w{world}")
        R.launch([dict(sizes=[world], names=["shard"], cases=cases)],
                 out[world], world, backend="nccl")

    def read(world, name):
        res = R.results(out[world], name, world)
        for r in res:
            assert "error" not in r, f"{name} at {world}: {r['error']}"
        return res

    return read, ckpt


def _hold(res, want, skip=()):
    for r, got in enumerate(res):
        for k, v in got.items():
            if k.startswith("sizes_"):
                rows, blocks = int(v[0]), v[1:]
                np.testing.assert_array_equal(
                    blocks, math.ceil(rows / len(res)), err_msg=k)
                continue
            if any(k.startswith(s) for s in skip):
                continue
            if k.startswith(("w2v_", "sgm_")):
                scale = float(np.max(np.abs(want[k])) or 1.0)
                np.testing.assert_allclose(v, want[k], rtol=W2V_TOL,
                                           atol=W2V_TOL * scale,
                                           err_msg=f"rank {r}: {k}")
            else:
                np.testing.assert_allclose(v, want[k], rtol=TOL, atol=TOL,
                                           err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["dense", "clock", "onebit", "rows",
                                  "mixture", "managers"])
def test_table_ops_over_nccl_match_one_card(runs, world, case):
    read, _ = runs
    _hold(read(world, case), _one(C.CASES[case], world))


@pytest.mark.parametrize("world", WORLDS)
def test_fused_apps_over_nccl_match_one_card(runs, world):
    read, _ = runs
    _hold(read(world, "apps"), _one(C.case_apps, world),
          skip=("w2v_adagrad",))


@pytest.mark.parametrize("world", WORLDS)
def test_refusals_over_nccl(runs, world):
    read, _ = runs
    for got in read(world, "refusals"):
        assert "several processes" in str(got["device_get"])
        assert "several processes" in str(got["raw_assign"])
        for sweep in ("make_fused_pass", "make_mh_pass"):
            assert '"Several processes"' in str(got[sweep]), got[sweep]


def test_checkpoint_chain_over_nccl(runs):
    """One process → 4 ranks → 2 ranks, and the 4 ranks' file back into
    one process."""
    read, ckpt = runs

    def chain(pkg):
        pkg.init()
        tables = C.checkpoint_tables(pkg)
        tables[0].add(C.delta(1, (C.N_ARRAY,)))
        tables[1].add(C.delta(2, C.SMALL))
        wants = []
        for world in WORLDS:
            want = {}
            C._snap(want, "restored", tables)
            C._push(tables[0], world, None, 800 + world, (C.N_ARRAY,),
                    add="stack")
            C._push(tables[1], world, None, 850 + world, C.SMALL)
            C._snap(want, "after", tables)
            wants.append(want)
        pkg.mv.shutdown()
        return wants

    for world, want in zip(WORLDS, _one(chain)):
        res = read(world, "checkpoint")
        _hold(res, {**want, "extra_step": res[0]["extra_step"]})

    def restore(pkg):
        pkg.init()
        tables = C.checkpoint_tables(pkg)
        assert pkg.mv.checkpoint.restore(ckpt["out4"]) == {"step": 2}
        got = {}
        C._snap(got, "after", tables)
        pkg.mv.shutdown()
        return got

    four = read(4, "checkpoint")[0]
    for k, v in _one(restore).items():
        np.testing.assert_allclose(v, four[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
