"""Data-parallel ResNet-20 / CIFAR-10 — the port of
``multiverso_tpu/apps/resnet.py``.

Reference (SURVEY.md §2.33, ``binding/lua/`` docs): the Lua/Torch binding's
documented example is ``fb.resnet.torch`` ResNet-20 on CIFAR-10 made
data-parallel by syncing parameters through an ArrayTable each iteration.

PyTorch: N in-process workers train on disjoint shards of each batch and
delta-sync through one table per step (``ext.torch_ext``), with the
nets, the table, the epoch's data and the losses on the device; the last
loss is read once, at the end of an epoch.  ``synthetic_cifar`` and
``build_resnet20`` are the JAX package's functions: the same seed gives
the same arrays and the same initial weights.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ext.torch_ext import TorchParamManager

__all__ = ["ResNet20DataParallel", "build_resnet20", "synthetic_cifar"]


def synthetic_cifar(num_samples: int, num_classes: int = 10, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-shaped [N,3,32,32] data with class-dependent channel structure."""
    rng = np.random.RandomState(seed)
    y = rng.randint(num_classes, size=num_samples).astype(np.int64)
    x = rng.randn(num_samples, 3, 32, 32).astype(np.float32)
    # plant a per-class mean pattern so a small net can separate classes
    patterns = rng.randn(num_classes, 3, 8, 8).astype(np.float32)
    up = np.kron(patterns, np.ones((1, 1, 4, 4), np.float32))
    x += 2.0 * up[y]
    return x, y


def build_resnet20(num_classes: int = 10):
    """ResNet-20 (CIFAR variant: 3 stages x 3 basic blocks, 16/32/64)."""
    import torch.nn as nn

    class BasicBlock(nn.Module):
        def __init__(self, cin, cout, stride=1):
            super().__init__()
            self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(cout)
            self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(cout)
            self.short = (nn.Sequential() if stride == 1 and cin == cout else
                          nn.Sequential(
                              nn.Conv2d(cin, cout, 1, stride, bias=False),
                              nn.BatchNorm2d(cout)))
            self.relu = nn.ReLU(inplace=True)

        def forward(self, x):
            out = self.relu(self.bn1(self.conv1(x)))
            out = self.bn2(self.conv2(out))
            return self.relu(out + self.short(x))

    def stage(cin, cout, n, stride):
        blocks: List[nn.Module] = [BasicBlock(cin, cout, stride)]
        blocks += [BasicBlock(cout, cout) for _ in range(n - 1)]
        return nn.Sequential(*blocks)

    return nn.Sequential(
        nn.Conv2d(3, 16, 3, 1, 1, bias=False), nn.BatchNorm2d(16),
        nn.ReLU(inplace=True),
        stage(16, 16, 3, 1), stage(16, 32, 3, 2), stage(32, 64, 3, 2),
        nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(64, num_classes))


class ResNet20DataParallel:
    """N simulated torch workers sharing one parameter table.

    The reference's multi-process layout collapses to in-process workers
    for the degenerate test mode (SURVEY.md §4).  ``device`` is where the
    nets train: ``None`` is ``cuda:0`` (raising without a card), and it
    must be the runtime's device, where the table lives.  BatchNorm's
    running statistics are buffers, so they stay per worker, unsynced.
    """

    def __init__(self, num_workers: int = 2, lr: float = 0.1,
                 num_classes: int = 10, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.num_workers = num_workers
        self.nets = []
        self.opts = []
        # The JAX app's draws (manual_seed before each build, on the CPU
        # generator), without clobbering the caller's RNG.
        with torch.random.fork_rng(devices=[]):
            for _ in range(num_workers):
                torch.manual_seed(seed)  # identical init across workers
                self.nets.append(build_resnet20(num_classes))
        for net in self.nets:
            net.to(self.device)
            self.opts.append(torch.optim.SGD(net.parameters(), lr=lr,
                                             momentum=0.9))
        self.mgrs = [TorchParamManager(self.nets[0], name="resnet20",
                                       peers=num_workers)]
        for net in self.nets[1:]:
            self.mgrs.append(
                TorchParamManager(net, table=self.mgrs[0].table,
                                  peers=num_workers))
        self.loss_fn = torch.nn.CrossEntropyLoss()

    def place(self, x, y) -> Tuple[torch.Tensor, torch.Tensor]:
        """Images and labels as tensors on the device (one copy each)."""
        return (torch.as_tensor(x, device=self.device),
                torch.as_tensor(y, device=self.device))

    def local_steps(self, xb: torch.Tensor, yb: torch.Tensor
                    ) -> torch.Tensor:
        """Each worker's forward, backward and SGD step on its shard
        ``[wid::N]`` of the batch, in turn; the last worker's loss, as a
        tensor on the device."""
        loss = None
        for wid in range(self.num_workers):
            self.opts[wid].zero_grad()
            loss = self.loss_fn(
                self.nets[wid](xb[wid::self.num_workers]),
                yb[wid::self.num_workers])
            loss.backward()
            self.opts[wid].step()
        return loss.detach()

    def train_step(self, xb: torch.Tensor, yb: torch.Tensor
                   ) -> torch.Tensor:
        """``local_steps``, then every manager's sync in turn — so worker
        0 holds the table as it was before worker 1's push until the next
        step, the JAX package's ASP order."""
        loss = self.local_steps(xb, yb)
        for m in self.mgrs:
            m.sync_all_param()
        return loss

    def train_epoch(self, x, y, batch_size: int = 64) -> float:
        """One pass over ``x``/``y`` (numpy or tensors) in batches of
        ``batch_size``; the last worker's loss of the last step."""
        x, y = self.place(x, y)
        last = None
        for i in range(0, x.shape[0] - batch_size + 1, batch_size):
            last = self.train_step(x[i:i + batch_size], y[i:i + batch_size])
        return 0.0 if last is None else float(last)

    def accuracy(self, x, y) -> float:
        net = self.nets[0]
        x, y = self.place(x, y)
        net.eval()  # BatchNorm must use running stats, not the eval batch
        try:
            with torch.no_grad():
                hits = int((net(x).argmax(1) == y).sum())
            return hits / y.shape[0]
        finally:
            net.train()
