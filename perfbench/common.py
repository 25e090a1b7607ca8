"""What every driver, reader and reference of the benchmark shares.

Seeds, the traffic samplers, the operation counts (``flash_work``, the
trainer's FLOPs a token, the word2vec step's least bytes), the table of
peaks, the training check's numbers and the look for JAX.  Nothing here
imports the program under test.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import statistics
import sys
import time
from typing import Dict, Iterable, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# Module names whose presence in ``sys.modules`` makes a run void: the
# JAX stack and the JAX package the port was made from.  Compared by the
# whole top-level name, since the port's own name begins with the last.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "multiverso_tpu")


def forbidden_loaded(modules: Optional[Iterable[str]] = None) -> List[str]:
    """Top-level names of loaded modules that no run may hold."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".")[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


class Phases:
    """Seconds spent in each named part of a set-up, in order."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self._last = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self._last
        self._last = now


def load_json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_workload(name: str) -> dict:
    """A cell's file, ``workloads/<name>.json``, with its configuration's
    file (``configs/<config>.json``) under ``"model"``."""
    wl = load_json("workloads", f"{name}.json")
    wl["model"] = load_json("configs", f"{wl['config']}.json")
    wl["name"] = name
    return wl


def derive_seed(seed: int, purpose: str) -> int:
    """A 63-bit generator seed for one use of the run's ``--seed``: the
    same pair gives the same stream in every process, and any whole
    number (past 32 bits too) is a seed."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, purpose: str, device):
    import torch

    return torch.Generator(device=device).manual_seed(
        derive_seed(seed, purpose))


# ------------------------------------------------------------ traffic
def rank_probs(vocab: int, dist: str, exponent: float = 1.0, device="cpu"):
    """float64 probabilities of ids 0..vocab-1: ``"zipf"`` gives id r-1
    the weight r^-exponent (ids ordered by frequency, as word2vec orders
    its vocabulary), ``"uniform"`` the same weight to every id."""
    import torch

    if dist == "uniform":
        return torch.full((vocab,), 1.0 / vocab, dtype=torch.float64,
                          device=device)
    if dist != "zipf":
        raise ValueError(f"unknown id distribution {dist!r}")
    r = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    w = r.pow(-float(exponent))
    return w / w.sum()


def sample_ids(probs, n: int, gen):
    """``n`` ids drawn from ``probs`` by the inverse of its cumulative sum
    (one uniform draw an id, on the generator's device)."""
    import torch

    cdf = torch.cumsum(probs, 0)
    cdf = cdf / cdf[-1]
    u = torch.rand(n, generator=gen, dtype=torch.float64,
                   device=probs.device)
    return torch.searchsorted(cdf, u).clamp_(max=probs.numel() - 1)


def keep_probs(probs, sample: float):
    """word2vec's sub-sampling: a word of frequency f is kept with
    probability (sqrt(f / t) + 1) · t / f, at most 1."""
    ratio = probs / sample
    return ((ratio.sqrt() + 1) / ratio).clamp_(max=1.0)


def skipgram_pairs(tokens, window: int, gen):
    """word2vec's skip-gram pairs of a token stream: each position draws
    a window b in 1..window and pairs with every position within b of
    it, left to right.  Returns (centers, contexts), int64."""
    import torch

    n = tokens.numel()
    b = torch.randint(1, window + 1, (n,), generator=gen,
                      device=tokens.device)
    pos = torch.arange(n, device=tokens.device)
    offs = [d for d in range(-window, window + 1) if d != 0]
    off = torch.tensor(offs, device=tokens.device)
    ctx = pos[:, None] + off[None, :]
    ok = (off.abs()[None, :] <= b[:, None]) & (ctx >= 0) & (ctx < n)
    centers = tokens[:, None].expand(n, len(offs))[ok]
    contexts = tokens[ctx.clamp(0, n - 1)][ok]
    return centers, contexts


# ------------------------------------------------------- operation counts
def flash_work(bh, t, d, tk=None, causal=True, elem=2):
    """{kernel: (flops, bytes)} of attention of [bh, t, d] queries over
    [bh, tk, d] keys (tk = t by default) in a type of ``elem`` bytes (bf16
    by default): 2 flops per multiply-add over the (q, k) pairs the causal
    mask keeps (all of them without it), each input read once and each
    output written once (q, o, do and dq have t rows; k, v, dk and dv tk;
    lse and delta are float32)."""
    tk = tk or t
    pairs = t * (t + 1) // 2 if causal else t * tk
    e, f4 = elem, 4
    return {
        "flash_fwd": (2 * 2 * d * pairs * bh,
                      (2 * t + 2 * tk) * bh * d * e + bh * t * f4),
        "flash_dq": (3 * 2 * d * pairs * bh,
                     (3 * t + 2 * tk) * bh * d * e + 2 * bh * t * f4),
        "flash_dkv": (4 * 2 * d * pairs * bh,
                      (2 * t + 4 * tk) * bh * d * e + 2 * bh * t * f4),
    }


def matmul_params(model: dict) -> int:
    """Parameters of the decoder's matrix products, the head included
    (the embedding is a lookup): per layer q, k, v, o and the SwiGLU's
    three matrices."""
    d, f = model["hidden_size"], model["intermediate_size"]
    per_layer = 4 * d * d + 3 * d * f
    return model["num_hidden_layers"] * per_layer + d * model["vocab_size"]


def train_flops_per_token(model: dict, seq: int) -> int:
    """6 · (matmul parameters) + 6 · L · d · T: the forward and backward
    of every product and of causal attention; recomputation and the
    embedding lookup are not counted."""
    L, d = model["num_hidden_layers"], model["hidden_size"]
    return 6 * matmul_params(model) + 6 * L * d * seq


def w2v_least_bytes(uniq_in: int, uniq_out: int, dim: int, pairs: int,
                    negatives: int, elem: int = 4, id_bytes: int = 8) -> int:
    """The bytes a skip-gram step must move at the least: each table's
    distinct rows of the batch read once and written once, and the ids
    (centers, contexts and negatives) read once."""
    rows = (uniq_in + uniq_out) * dim * elem * 2
    return rows + pairs * (2 + negatives) * id_bytes


def peaks_for(kind: str) -> Optional[dict]:
    """The published peaks of the card named ``kind``
    (``torch.cuda.get_device_name()``), or None for a card not in
    ``peaks.json``."""
    table = load_json("peaks.json")["cards"]
    for name, peaks in table.items():
        if kind == name or kind.startswith(name):
            return peaks
    return None


# ------------------------------------------------------ training check
def norm64(x) -> float:
    """The 2-norm summed in float64 (a float32 sum's own rounding would
    hide gaps below about 1e-7 of the norm)."""
    import torch

    return float(torch.linalg.vector_norm(x, dtype=torch.float64))


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    names = list(ref) if leaves is None else list(leaves)
    med = statistics.median(ref[n] for n in names)
    worst = 0.0
    for n in names:
        p = prog.get(n, float("nan"))
        gap = abs(p - ref[n]) / max(ref[n], med)
        if not math.isfinite(gap):
            return float("inf")
        worst = max(worst, gap)
    return worst


def moved_leaves(ref_grad: Dict[str, float], share: float = 1e-3
                 ) -> List[str]:
    """Leaves whose first gradient in the reference is at least ``share``
    of the median leaf's: the others move by round-off alone."""
    med = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= share * med]


def training_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers that decide a training cell's ``correct``: each step's
    loss (the widest relative gap), the first gradient's norm and the
    norm of the parameters' change after the checked steps, each by the
    worst leaf (``norm_gap``)."""
    loss = 0.0
    for p, r in zip(prog["loss"], ref["loss"]):
        gap = abs(p - r) / abs(r)
        loss = max(loss, gap if math.isfinite(gap) else float("inf"))
    if len(prog["loss"]) != len(ref["loss"]):
        loss = float("inf")
    moved = moved_leaves(ref["grad"])
    return {
        "loss_gap": loss,
        "grad_gap": norm_gap(prog["grad"], ref["grad"]),
        "change_gap": norm_gap(prog["change"], ref["change"], moved),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number finite and within its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)
