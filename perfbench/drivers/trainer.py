"""Trainer cells: the port's ``TransformerTrainer`` on one card.

Set-up draws the float32 masters and the token pool from the seed on the
card, builds one trainer (momentum updater, bf16 compute) and drives it
through the checked steps and one more, each by ``train_step_async`` on
a batch of its own.  The window dispatches steps ahead, as a training
loop does, and ends in one ``synchronize``.  The check replays the
checked steps in the plain reference (``configs/decoder_ref.py``) from
the same masters and batches.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import torch

from .. import common
from ..configs import decoder_ref

KIND = "train"
FLASH = ("flash_fwd", "flash_dq", "flash_dkv")


def make_weights(model: dict, seed: int, device) -> torch.Tensor:
    """Every leaf of ``decoder_ref.leaf_shapes`` in one float32 buffer,
    drawn on ``device`` from the seed in one call: matrices N(0, 1/fan
    in), the embedding N(0, 0.02²), norm gains 1."""
    shapes = decoder_ref.leaf_shapes(model)
    total = sum(math.prod(s) for _, s in shapes)
    g = common.generator(seed, "weights", device)
    flat = torch.randn(total, generator=g, device=device)
    at = 0
    for name, shape in shapes:
        n = math.prod(shape)
        leaf = flat[at:at + n]
        if len(shape) == 1:
            leaf.fill_(1.0)
        else:
            leaf.mul_(0.02 if name == "embed" else shape[0] ** -0.5)
        at += n
    return flat


def make_tokens(model: dict, traffic: dict, seed: int, device
                ) -> List[torch.Tensor]:
    """``pool_steps`` batches [batch, seq] of ids drawn from the traffic's
    distribution over the vocabulary."""
    B, T, P = traffic["batch"], traffic["seq"], traffic["pool_steps"]
    probs = common.rank_probs(model["vocab_size"], traffic["ids"],
                              traffic.get("exponent", 1.0), device)
    g = common.generator(seed, "tokens", device)
    ids = common.sample_ids(probs, P * B * T, g)
    return list(ids.view(P, B, T).unbind(0))


def program_config(model: dict):
    from multiverso_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(
        vocab_size=model["vocab_size"], dim=model["hidden_size"],
        n_layers=model["num_hidden_layers"],
        n_heads=model["num_attention_heads"],
        hidden=model["intermediate_size"],
        max_seq=model["max_position_embeddings"],
        rope_theta=float(model["rope_theta"]),
        norm_eps=model["rms_norm_eps"], compute_dtype=torch.bfloat16,
        remat=False)
    if cfg.head_dim != model["head_dim"]:
        raise ValueError(f"head_dim {model['head_dim']} is not hidden_size"
                         f" / num_attention_heads ({cfg.head_dim})")
    return cfg


def host_tree(flat: torch.Tensor, model: dict) -> dict:
    """The masters as the program takes them: host tensors, names and
    [in, out] layouts of ``params_from_jax``."""
    views = decoder_ref.views(flat.cpu(), decoder_ref.leaf_shapes(model))
    layers = [{k: views[f"layers.{i}.{k}"] for k in decoder_ref.LAYER_KEYS}
              for i in range(model["num_hidden_layers"])]
    return {"embed": views["embed"], "out_norm": views["out_norm"],
            "head": views["head"], "layers": layers}


def program_leaves(params: dict) -> Dict[str, torch.Tensor]:
    out = {"embed": params["embed"], "out_norm": params["out_norm"],
           "head": params["head"]}
    for i, lyr in enumerate(params["layers"]):
        for k in decoder_ref.LAYER_KEYS:
            out[f"layers.{i}.{k}"] = lyr[k]
    return out


def _diff_norms(now: Dict[str, torch.Tensor], start: Dict[str, torch.Tensor],
                scale: float = 1.0) -> Dict[str, float]:
    return {n: common.norm64(start[n] - now[n]) / scale for n in start}


class Cell:
    kind = KIND

    def __init__(self, wl: dict, seed: int, device):
        from multiverso_tpu_torch.models.transformer import TransformerTrainer
        from multiverso_tpu_torch.updaters import AddOption

        self.wl, self.seed, self.device = wl, seed, torch.device(device)
        self.model = wl["model"]
        self.traffic = wl["traffic"]
        train = self.model["assumed"]
        self.lr, self.momentum = train["learning_rate"], train["momentum"]
        self.phases = common.Phases()
        self.batches = make_tokens(self.model, self.traffic, seed,
                                   self.device)
        flat = make_weights(self.model, seed, self.device)
        self.phases.mark("traffic_and_weights")
        tree = host_tree(flat, self.model)
        del flat
        self.phases.mark("weights_to_host")
        self.trainer = TransformerTrainer(
            program_config(self.model), device=self.device,
            updater_type=train["updater"],
            option=AddOption(learning_rate=self.lr,
                             momentum=self.momentum),
            params=tree)
        del tree
        self.phases.mark("trainer")
        self.step_no = 0
        self.readings = self._checked_steps(wl["checked_steps"])
        self.phases.mark("checked_steps")
        for _ in range(wl["warm_steps"]):
            self._step()
        self._sync()
        self.phases.mark("warm_steps")

    # ------------------------------------------------------------ steps
    def _step(self) -> torch.Tensor:
        batch = self.batches[self.step_no % len(self.batches)]
        self.step_no += 1
        return self.trainer.train_step_async(batch)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _checked_steps(self, n: int) -> dict:
        """The first ``n`` steps, through the window's own call: each
        step's loss, each leaf's first gradient as the updater got it
        ((w0 - w1) / lr: the momentum starts at zero) and each leaf's
        change after the last."""
        start = {k: v.detach().clone() for k, v in
                 program_leaves(self.trainer.params).items()}
        losses, grad = [], None
        for i in range(n):
            losses.append(self._step())
            if i == 0:
                grad = _diff_norms(program_leaves(self.trainer.params),
                                   start, self.lr)
        change = _diff_norms(program_leaves(self.trainer.params), start)
        del start
        return {"loss": [float(x) for x in losses], "grad": grad,
                "change": change}

    @property
    def tokens_per_step(self) -> int:
        return self.traffic["batch"] * self.traffic["seq"]

    # ----------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        self._sync()
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            loss = self._step()
            n += 1
        self._sync()
        elapsed = time.perf_counter() - t0
        self.last_loss = float(loss)
        return {"steps": n, "seconds": elapsed,
                "train_tokens_per_s": n * self.tokens_per_step / elapsed}

    def traced(self, profile) -> dict:
        """``trace_steps`` steps under ``profile`` (a context manager
        that records them); what the readers need besides the trace."""
        from multiverso_tpu_torch.ops import flash_attention as fa

        steps = self.wl["trace_steps"]
        self._sync()
        fa.reset_launch_counts()
        with profile():
            for _ in range(steps):
                loss = self._step()
            self._sync()
        self.last_loss = float(loss)
        launches = fa.launch_counts()
        m, t = self.model, self.traffic
        work = common.flash_work(t["batch"] * m["num_attention_heads"],
                                 t["seq"], m["head_dim"], elem=2)
        return {
            "steps": steps,
            "launches": launches,
            "flops_per_step": common.train_flops_per_token(m, t["seq"])
            * self.tokens_per_step,
            "attention_work": [(k, launches[k] / steps, *work[k])
                               for k in FLASH],
        }

    # ------------------------------------------------------------ check
    def release(self) -> None:
        self.batches = self.batches[:self.wl["checked_steps"]]
        del self.trainer
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "fp32",
                  fault: Optional[str] = None) -> dict:
        """The plain reference over the checked steps' batches, from the
        same masters, drawn again from the seed.  ``fault="half_batch"``
        drops the second half of each batch's rows, or of its one row's
        positions (the loss is then the mean over the rest)."""
        batches = self.batches[:self.wl["checked_steps"]]
        if fault == "half_batch":
            batches = [b[:b.shape[0] // 2] if b.shape[0] > 1
                       else b[:, :b.shape[1] // 2] for b in batches]
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        flat = make_weights(self.model, self.seed, self.device)
        out = decoder_ref.train(flat, self.model, batches, self.lr,
                                self.momentum, precision)
        del flat
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out


def setup(wl: dict, seed: int, device) -> Cell:
    return Cell(wl, seed, device)

