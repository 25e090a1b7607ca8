"""Word2vec cells: the port's ``SkipGram.make_fused_step`` over two
``MatrixTable``s on one card.

Set-up makes the traffic on the card from the seed: a synthetic corpus
whose ids follow the traffic's distribution, sub-sampled as word2vec
does, cut into skip-gram pairs with a random window, and negatives from
the unigram distribution to the 3/4 power; ``pool_steps`` batches of it,
cycled.  It builds the ``SkipGram`` app, puts tables drawn from the seed
in place of its own (``raw_assign``), and drives the fused step through
the checked steps and one more.  The window dispatches steps ahead and
records a CUDA event at every step boundary, so each step's time is the
interval between two events.  The check replays the checked steps in the
plain reference (``configs/sgns_ref.py``).
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Tuple

import torch

from .. import common
from ..configs import sgns_ref

KIND = "w2v"
Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def make_tables(model: dict, seed: int, device) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Both tables uniform in [-0.5/dim, 0.5/dim), drawn on ``device``
    from the seed in one call."""
    V, D = model["vocab_size"], model["dim"]
    g = common.generator(seed, "tables", device)
    both = torch.rand(2, V, D, generator=g, device=device)
    both.sub_(0.5).div_(D)
    return both[0], both[1]


def make_batches(model: dict, traffic: dict, seed: int, device
                 ) -> List[Batch]:
    """``pool_steps`` batches of ``pairs_per_step`` (center, context) pairs
    and ``negative`` negatives each, int64 on ``device``."""
    V = model["vocab_size"]
    S, P = model["assumed"]["pairs_per_step"], traffic["pool_steps"]
    K, W = model["negative"], model["window"]
    probs = common.rank_probs(V, traffic["ids"],
                              traffic.get("exponent", 1.0), device)
    keep = common.keep_probs(probs, model["sample"])
    g = common.generator(seed, "corpus", device)
    need, got = S * P, 0
    centers, contexts = [], []
    while got < need:
        ids = common.sample_ids(probs, traffic["corpus_block"], g)
        kept = ids[torch.rand(ids.numel(), generator=g, device=device,
                              dtype=torch.float64) < keep[ids]]
        c, o = common.skipgram_pairs(kept, W, g)
        centers.append(c)
        contexts.append(o)
        got += c.numel()
    c = torch.cat(centers)[:need].view(P, S)
    o = torch.cat(contexts)[:need].view(P, S)
    noise = probs.pow(model["negative_power"])
    neg = common.sample_ids(noise / noise.sum(), need * K,
                            common.generator(seed, "negatives", device))
    neg = neg.view(P, S, K)
    return [(c[i], o[i], neg[i]) for i in range(P)]


def distinct_rows(batch: Batch) -> Tuple[int, int]:
    """Distinct rows of the input table (centers) and of the output
    table (contexts and negatives) a batch touches."""
    c, o, neg = batch
    return (int(torch.unique(c).numel()),
            int(torch.unique(torch.cat([o, neg.reshape(-1)])).numel()))


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank ``q`` percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


class Cell:
    kind = KIND

    def __init__(self, wl: dict, seed: int, device):
        import multiverso_tpu_torch as mv
        from multiverso_tpu_torch.apps.word2vec import SkipGram

        self.wl, self.seed, self.device = wl, seed, torch.device(device)
        self.model, self.traffic = wl["model"], wl["traffic"]
        m = self.model
        self.lr = m["assumed"]["learning_rate"]
        self.pairs = m["assumed"]["pairs_per_step"]
        self.phases = common.Phases()
        self.batches = make_batches(m, self.traffic, seed, self.device)
        self.rows = [distinct_rows(b) for b in self.batches]
        self.phases.mark("traffic")
        mv.init(device=self.device)
        self._mv = mv
        app = SkipGram(m["vocab_size"], m["dim"], learning_rate=self.lr,
                       negatives=m["negative"], window=m["window"],
                       updater_type=m["assumed"]["updater"],
                       seed=seed % 2 ** 32)
        self.phases.mark("skipgram_init")
        w_in, w_out = make_tables(m, seed, self.device)
        app.table_in.raw_assign(w_in)
        app.table_out.raw_assign(w_out)
        del w_in, w_out
        self.app = app
        self.step_fn, place = app.make_fused_step()
        self.batches = [tuple(place(t) for t in b) for b in self.batches]
        self.din, self.sin = app.table_in.raw_value()
        self.dout, self.sout = app.table_out.raw_value()
        self.phases.mark("tables")
        self.step_no = 0
        self.readings = self._checked_steps(wl["checked_steps"])
        self.phases.mark("checked_steps")
        for _ in range(wl["warm_steps"]):
            self._step()
        self._sync()
        self.phases.mark("warm_steps")

    # ------------------------------------------------------------ steps
    def _step(self) -> torch.Tensor:
        c, o, neg = self.batches[self.step_no % len(self.batches)]
        self.step_no += 1
        self.din, self.sin, self.dout, self.sout, loss = self.step_fn(
            self.din, self.sin, self.dout, self.sout, c, o, neg)
        return loss

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _checked_steps(self, n: int) -> dict:
        """The first ``n`` steps, through the window's own call: each
        step's loss, each table's first gradient as the updater got it
        ((w0 - w1) / lr) and each table's change after the last."""
        start = {"in": self.din.clone(), "out": self.dout.clone()}
        losses, grad = [], {}
        for i in range(n):
            losses.append(self._step())
            if i == 0:
                grad = {"in": common.norm64(start["in"] - self.din) / self.lr,
                        "out": common.norm64(start["out"] - self.dout)
                        / self.lr}
        change = {"in": common.norm64(self.din - start["in"]),
                  "out": common.norm64(self.dout - start["out"])}
        del start
        return {"loss": [float(x) for x in losses], "grad": grad,
                "change": change}

    # ----------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        cuda = self.device.type == "cuda"
        self._sync()
        marks = []
        n = 0
        t0 = time.perf_counter()
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        while time.perf_counter() - t0 < seconds:
            loss = self._step()
            n += 1
            if cuda:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
        self._sync()
        elapsed = time.perf_counter() - t0
        self.last_loss = float(loss)
        out = {"steps": n, "seconds": elapsed,
               "w2v_pairs_per_s": n * self.pairs / elapsed}
        if cuda:
            ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
            out["w2v_step_ms_p99"] = percentile(ms, 99)
            out["step_ms_p50"] = percentile(ms, 50)
        return out

    def traced(self, profile) -> dict:
        steps = self.wl["trace_steps"]
        first = self.step_no
        self._sync()
        with profile():
            for _ in range(steps):
                loss = self._step()
            self._sync()
        self.last_loss = float(loss)
        m = self.model
        total = 0
        for i in range(first, first + steps):
            uin, uout = self.rows[i % len(self.rows)]
            total += common.w2v_least_bytes(uin, uout, m["dim"], self.pairs,
                                            m["negative"])
        return {"steps": steps, "least_bytes_per_step": total / steps}

    # ------------------------------------------------------------ check
    def release(self) -> None:
        self.batches = self.batches[:self.wl["checked_steps"]]
        del self.app, self.step_fn, self.din, self.sin, self.dout, self.sout
        self._mv.shutdown()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "fp32",
                  fault: Optional[str] = None) -> dict:
        """The plain reference over the checked steps' batches, from the
        same tables, drawn again from the seed.  ``fault="half_batch"``
        drops the second half of each batch's pairs (the loss is then the
        mean over the rest)."""
        batches = self.batches[:self.wl["checked_steps"]]
        if fault == "half_batch":
            batches = [tuple(t[:max(1, t.shape[0] // 2)] for t in b)
                       for b in batches]
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        w_in, w_out = make_tables(self.model, self.seed, self.device)
        out = sgns_ref.train(w_in, w_out, batches, self.lr, precision)
        del w_in, w_out
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out


def setup(wl: dict, seed: int, device) -> Cell:
    return Cell(wl, seed, device)
