"""Cases of the sharded-table tests, each written once for both sides.

A case is ``fn(pkg, world, rank=None, **kw) -> {name: array}``.  With a
``rank`` it runs on that rank of a ``torch.distributed`` group of
``world`` processes (the port, whose tables then shard) and each rank
adds its own deltas; with ``rank=None`` it runs in one process and makes
the same adds stacked, or summed where a table takes no stack: what the
sharded tables must hold.  ``pkg`` names the package a side runs:
``mv`` (the package), ``init`` (its ``init`` with the side's device),
``device`` (where a torch module lives: ``"cpu"``, or a rank's card),
``apps``, ``torch_ext`` and ``shared`` (the delta-sync managers), so one
case runs on the JAX package, the port in one process, or a rank.

Keys ending in ``_r<k>`` are rank k's own reads; a rank returns only
its own, the one-process side every rank's.  ``sizes_*`` keys (ranks
only) hold, per table, its live rows and then the leading length of
``_data`` and of each state tensor on the rank: ``ceil(rows / world)``
each when the table is sharded.  Every input comes from numpy seeds.
"""

from __future__ import annotations

import numpy as np

N_ARRAY = 41             # divides neither 2 nor 4
MATRIX = (8, 4)          # divides both
SMALL = (10, 3)          # divides 2, not 4
ROWS = (41, 4)
# Per-rank row batches (rank k of a group takes entry k): overlapping,
# with a duplicate, and one empty set at 4 ranks; the reads ask for an
# empty set at 2 ranks and for one id past the table (41), which reads
# zeros.
ADD_IDS = [[0, 3, 5, 5, 40], [5, 7, 3, 39, 20], [], [40, 0, 21]]
GET_IDS = [[3, 5, 7, 1, 40], [], [12, 0, 39], [40, 41, 2]]
SPARSE_ADD = [[0, 3, 3], [9, 3], [], [1]]
SPARSE_GET = [[3, 1, 9], [0, 3], [2], [9, 8, 3]]
UPDATERS = ("sgd", "adagrad", "momentum")


def delta(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _sizes(*tables):
    """Per table: its live rows, then the leading length of ``_data`` and
    of each state slot on this rank."""
    return {t.name: np.asarray([getattr(t, "num_rows", None) or t.size,
                                t._data.shape[0]]
                               + [s.shape[0] for s in t._state])
            for t in tables}


def _push(t, world, rank, seed, shape, add=None):
    """Rank ``rank`` adds its delta; one process adds every rank's
    (``add`` stacked, or their sum for a table that takes no stack)."""
    ds = [delta(seed + r, shape) for r in range(world)]
    if rank is not None:
        t.add(ds[rank])
    elif add == "stack":
        t.add(np.stack(ds))
    else:
        t.add(np.sum(ds, axis=0, dtype=np.float32))


def _rows_push(t, world, rank, seed, ids):
    """Rank ``rank``'s ``add_rows`` of ``ids[rank]``; one process adds
    every rank's batch as one."""
    batches = [(np.asarray(ids[r], np.int64),
                delta(seed + r, (len(ids[r]), t.num_cols)))
               for r in range(world)]
    if rank is not None:
        t.add_rows(*batches[rank])
    else:
        t.add_rows(np.concatenate([b[0] for b in batches]),
                   np.concatenate([b[1] for b in batches]))


def _reads(out, key, t, world, rank, ids):
    """``get_rows`` of each rank's ``ids`` (a rank: its own)."""
    for r in range(world) if rank is None else [rank]:
        want = np.asarray(ids[r], np.int64)
        if rank is None:
            # One process: the live rows of the whole table, zeros past
            # it (the port's contract for ids past a table).
            full = t.get()
            got = np.zeros((len(want), t.num_cols), np.float32)
            live = want < full.shape[0]
            got[live] = full[want[live]]
        else:
            got = t.get_rows(want)
        out[f"{key}_r{r}"] = np.asarray(got, np.float32).reshape(
            len(want), t.num_cols)


def case_dense(pkg, world, rank=None):
    """Dense adds, two rounds, under SGD, AdaGrad and momentum: an
    ArrayTable of 41, MatrixTables of 8 x 4 and 10 x 3."""
    mv, out = pkg.mv, {}
    for upd in UPDATERS:
        pkg.init(updater_type=upd)
        a = mv.ArrayTable(N_ARRAY, name=f"a_{upd}")
        m = mv.MatrixTable(*MATRIX, name=f"m_{upd}")
        s = mv.MatrixTable(*SMALL, name=f"s_{upd}")
        for rnd in range(2):
            _push(a, world, rank, 10 * rnd, (N_ARRAY,), add="stack")
            _push(m, world, rank, 100 + 10 * rnd, MATRIX)
            _push(s, world, rank, 200 + 10 * rnd, SMALL)
            for t in (a, m, s):
                out[f"{t.name}_{rnd}"] = t.get()
        if rank is not None:
            out.update({f"sizes_{k}": v for k, v in _sizes(a, m, s).items()})
        mv.shutdown()
    return out


def case_clock(pkg, world, rank=None):
    """BSP (adds invisible before the barrier, one merged apply at it),
    SSP with staleness 1 (visible one barrier later), and BSP row adds."""
    mv, out = pkg.mv, {}
    pkg.init(sync=True, updater_type="adagrad")
    bsp = mv.ArrayTable(SMALL[0], name="bsp")
    ssp = mv.ArrayTable(N_ARRAY, name="ssp", staleness=1)
    rows = mv.MatrixTable(*ROWS, name="bsp_rows")
    _push(bsp, world, rank, 300, (SMALL[0],), add="stack")
    _push(ssp, world, rank, 310, (N_ARRAY,), add="stack")
    _rows_push(rows, world, rank, 320, ADD_IDS)
    out["bsp_before"], out["ssp_before"] = bsp.get(), ssp.get()
    out["rows_before"] = rows.get()
    mv.barrier()
    out["bsp_after"], out["ssp_after1"] = bsp.get(), ssp.get()
    out["rows_after"] = rows.get()
    _reads(out, "rows_read", rows, world, rank, GET_IDS)
    mv.barrier()
    out["ssp_after2"] = ssp.get()
    if rank is not None:
        out.update({f"sizes_{k}": v
                    for k, v in _sizes(bsp, ssp, rows).items()})
    mv.shutdown()
    return out


def onebit_payloads(world, rounds, shape, seed):
    """Each round's sum over ranks of each rank's decoded 1-bit payload,
    every rank carrying its own error-feedback residual."""
    from multiverso_tpu_torch.util.quantization import (OneBitCompressor,
                                                        dequantize_1bit)

    comps = [OneBitCompressor() for _ in range(world)]
    n = int(np.prod(shape))
    sums = []
    for rnd in range(rounds):
        total = np.zeros(n, np.float32)
        for r in range(world):
            packed, p, m = comps[r].compress(
                delta(seed + 10 * rnd + r, shape))
            total += dequantize_1bit(packed, p, m, n)
        sums.append(total.reshape(shape))
    return sums


def case_onebit(pkg, world, rank=None):
    """Two rounds of 1-bit adds into an ArrayTable of 41 and a
    MatrixTable of 10 x 3 (plain-add updater)."""
    mv, out = pkg.mv, {}
    pkg.init(updater_type="default")
    tables = [(mv.ArrayTable(N_ARRAY, name="q_a"), (N_ARRAY,), 400),
              (mv.MatrixTable(*SMALL, name="q_m"), SMALL, 500)]
    for t, shape, seed in tables:
        sums = (onebit_payloads(world, 2, shape, seed) if rank is None
                else None)
        for rnd in range(2):
            if rank is None:
                t.add(sums[rnd])
            else:
                t.add(delta(seed + 10 * rnd + rank, shape), compress="1bit")
            out[f"{t.name}_{rnd}"] = t.get()
    if rank is not None:
        out.update({f"sizes_{k}": v for k, v in
                    _sizes(*(t for t, _, _ in tables)).items()})
    mv.shutdown()
    return out


def case_rows(pkg, world, rank=None):
    """``add_rows`` (two rounds) and ``get_rows`` with overlapping,
    duplicate and empty per-rank id sets, on a MatrixTable of 41 x 4
    under each updater; then a SparseMatrixTable of 10 x 3 whose host
    mirror held rows before a peer's adds."""
    mv, out = pkg.mv, {}
    for upd in UPDATERS:
        pkg.init(updater_type=upd)
        m = mv.MatrixTable(*ROWS, name=f"rows_{upd}")
        for rnd in range(2):
            _rows_push(m, world, rank, 600 + 10 * rnd, ADD_IDS)
            _reads(out, f"{m.name}_{rnd}", m, world, rank, GET_IDS)
        out[m.name] = m.get()
        tables = [m]
        if upd == "adagrad":
            sp = mv.SparseMatrixTable(*SMALL, name="sparse")
            if rank is not None:
                sp.get_rows(SPARSE_GET[rank])      # warms the host mirror
            _rows_push(sp, world, rank, 700, SPARSE_ADD)
            _reads(out, "sparse", sp, world, rank, SPARSE_GET)
            _rows_push(sp, world, rank, 710, SPARSE_ADD)
            _reads(out, "sparse2", sp, world, rank, SPARSE_ADD)
            out["sparse"] = sp.get()
            tables.append(sp)
        if rank is not None:
            out.update({f"sizes_{k}": v for k, v in _sizes(*tables).items()})
        mv.shutdown()
    return out


def checkpoint_tables(pkg):
    mv = pkg.mv
    return (mv.ArrayTable(N_ARRAY, name="ck_a", updater_type="adagrad"),
            mv.MatrixTable(*SMALL, name="ck_m", updater_type="momentum"))


def _snap(out, key, tables):
    for t in tables:
        snap = t.store_state()
        out[f"{key}_{t.name}"] = np.asarray(snap["data"])
        for i, s in enumerate(snap["state"]):
            out[f"{key}_{t.name}_s{i}"] = np.asarray(s)


def case_checkpoint(pkg, world, rank=None, restore=None, save=None,
                    seed=800):
    """Restore ``restore`` (written by any package at any world size),
    report the tables with their updater state, add one round, report
    again, and save to ``save``."""
    out = {}
    pkg.init()
    tables = checkpoint_tables(pkg)
    extra = pkg.mv.checkpoint.restore(restore)
    out["extra_step"] = np.asarray(extra["step"])
    _snap(out, "restored", tables)
    _push(tables[0], world, rank, seed, (N_ARRAY,), add="stack")
    _push(tables[1], world, rank, seed + 50, SMALL)
    _snap(out, "after", tables)
    if save:
        pkg.mv.checkpoint.save(save, extra={"step": int(extra["step"]) + 1})
    if rank is not None:
        out.update({f"sizes_{k}": v for k, v in _sizes(*tables).items()})
    pkg.mv.shutdown()
    return out


def lr_data():
    from multiverso_tpu_torch.apps import synthetic_classification

    return synthetic_classification(64, 10, 3, seed=1)


def w2v_corpus():
    return make_corpus(200, 41, 2)


def case_apps(pkg, world, rank=None):
    """The fused steps as the JAX package runs them across processes:
    every rank passes the same global batches.  An LR epoch (10 features,
    3 classes, batch 16) and a word2vec epoch (vocabulary 41, dim 8,
    batch 32), under AdaGrad and SGD."""
    out = {}
    x, y = lr_data()
    corpus = w2v_corpus()
    for upd in ("adagrad", "sgd"):
        pkg.init()
        lr = pkg.apps.LogisticRegression(10, 3, learning_rate=0.5,
                                         updater_type=upd)
        out[f"lr_{upd}_loss"] = np.asarray(lr.train_epoch_fused(x, y, 16))
        out[f"lr_{upd}"] = lr.table.get()
        sg = pkg.apps.SkipGram(41, 8, learning_rate=0.5, updater_type=upd)
        steps, loss = sg.train_epoch_fused(corpus, 32)
        out[f"w2v_{upd}_loss"] = np.asarray(loss)
        out[f"w2v_{upd}_in"] = sg.table_in.get()
        out[f"w2v_{upd}_out"] = sg.table_out.get()
        if rank is not None:
            out.update({f"sizes_{upd}_{k}": v for k, v in _sizes(
                lr.table, sg.table_in, sg.table_out).items()})
        pkg.mv.shutdown()
    return out


def case_mixture(pkg, world, rank=None):
    """The skip-gram mixture's fused epoch (vocabulary 21, dim 8, two
    senses, batch 32) on its sense, out and prior tables, every rank
    passing the global batches."""
    pkg.init()
    sg = pkg.apps.SkipGramMixture(21, 8, senses=2, learning_rate=0.5,
                                  name="sgm")
    _, loss = sg.train_epoch_fused(make_corpus(300, 21, 3), 32)
    out = {"sgm_loss": np.asarray(loss), "sgm_sense": sg.table_sense.get(),
           "sgm_out": sg.table_out.get(), "sgm_prior": sg.table_prior.get()}
    if rank is not None:
        out.update({f"sizes_{k}": v for k, v in _sizes(
            sg.table_sense, sg.table_out, sg.table_prior).items()})
    pkg.mv.shutdown()
    return out


def make_corpus(tokens, vocab, seed):
    from multiverso_tpu_torch.apps import synthetic_corpus

    return synthetic_corpus(tokens, vocab, seed=seed)


def _net():
    import torch

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return torch.nn.Sequential(torch.nn.Linear(5, 3), torch.nn.Tanh(),
                                   torch.nn.Linear(3, 2))


def _flat(net):
    return np.concatenate([p.detach().cpu().numpy().ravel()
                           for p in net.parameters()])


def case_managers(pkg, world, rank=None):
    """``TorchParamManager`` and a shared variable, two rounds of local
    drift and sync.  One process: the managers' tables take every rank's
    ``(local - synced) / world`` as one stacked add."""
    import torch

    out, device = {}, pkg.device
    pkg.init()
    net = _net().to(device)
    mgr = pkg.torch_ext.TorchParamManager(net, name="pm")
    shared = pkg.shared.mv_shared(np.zeros(6, np.float32), name="sv")
    synced, sv_synced = _flat(net), np.zeros(6, np.float32)
    for rnd in range(2):
        drift = [delta(900 + 10 * rnd + r, synced.shape) * 0.1
                 for r in range(world)]
        sv_drift = [delta(950 + 10 * rnd + r, (6,)) for r in range(world)]
        if rank is not None:
            with torch.no_grad():
                local = torch.as_tensor(synced + drift[rank])
                torch.nn.utils.vector_to_parameters(
                    local.to(device), list(net.parameters()))
            mgr.sync_all_param()
            shared.set_value(sv_synced + sv_drift[rank])
            value = shared.mv_sync()
        else:
            mgr.table.add(np.stack([d / world for d in drift]))
            shared.table.add(np.stack([d / world for d in sv_drift]))
            value = shared.table.get()
        synced = (_flat(net) if rank is not None
                  else np.asarray(mgr.table.get(), np.float32))
        sv_synced = np.asarray(
            value.cpu() if isinstance(value, torch.Tensor) else value,
            np.float32)
        out[f"pm_{rnd}"], out[f"sv_{rnd}"] = synced, sv_synced
    if rank is not None:
        out.update({f"sizes_{k}": v
                    for k, v in _sizes(mgr.table, shared.table).items()})
    pkg.mv.shutdown()
    return out


def case_refusals(pkg, world, rank):
    """What a sharded table refuses: the one-process device get, and a
    ``raw_assign`` of the whole table in place of this rank's block."""
    import torch

    out = {}
    pkg.init()
    t = pkg.mv.ArrayTable(N_ARRAY, name="refuse")
    try:
        t.get(device=True)
        out["device_get"] = "served"
    except RuntimeError as exc:
        out["device_get"] = str(exc)
    try:
        t.raw_assign(torch.zeros(N_ARRAY))
        out["raw_assign"] = "assigned"
    except ValueError as exc:
        out["raw_assign"] = str(exc)
    lda = pkg.apps.LightLDA(40, 4)
    for sweep in ("make_fused_pass", "make_mh_pass"):
        try:
            getattr(lda, sweep)(8)
            out[sweep] = "built"
        except NotImplementedError as exc:
            out[sweep] = str(exc)
    pkg.mv.shutdown()
    return out


CASES = {n[5:]: f for n, f in dict(globals()).items()
         if n.startswith("case_")}
