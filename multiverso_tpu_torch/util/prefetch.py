"""Device prefetch — keep host-to-device copies behind compute.

Port of ``multiverso_tpu/util/prefetch.py``.  The reference's
``AsyncBuffer`` (SURVEY.md §2.24) hides parameter-pull latency behind
the training step; the analogous host-side bottleneck here is the input
pipeline: a copy issued only when the step needs its batch serializes
transfer and compute.

On a CUDA device each array leaf is staged in pinned host memory and
copied with ``non_blocking=True`` on a side stream, up to ``size``
batches ahead of the consumer.  The consumer's stream waits on that
copy's event before it is handed the batch, and the result is recorded
on the consumer's stream so the caching allocator never reuses its
memory early.  No thread is needed: the copies run while the previous
steps compute.  On the CPU the leaves are placed with no stream.  A
placer callable takes the place of the device: it is applied to every
array leaf when the batch is queued, as in the JAX package.
"""

from __future__ import annotations

import collections
import itertools
from typing import Any, Iterable, Iterator, Optional

__all__ = ["prefetch_to_device"]


def prefetch_to_device(iterator: Iterable[Any], size: int = 2,
                       sharding: Optional[Any] = None) -> Iterator[Any]:
    """Yield elements of ``iterator`` with their arrays already on device.

    Each element (a tree of dicts, lists and tuples whose array leaves are
    numpy arrays or tensors) is copied up to ``size`` elements ahead of
    the consumer.  Non-array leaves (step counters, ids, strings) ride
    along untouched.

    ``sharding`` is where the arrays land: a device (``None`` is
    ``cuda:0``, raising without a card, as every entry point of the
    port), whose copies go through pinned memory and a side stream on a
    card; or a *callable* ``array -> placed tensor`` — e.g. the closure
    ``parallel.sharding.batch_placer`` returns — applied to every array
    leaf as the batch is queued, on the current stream.

    ``size=2`` is the sweet spot for steady-state training (one batch
    computing, one in flight); larger only helps jittery producers.
    """
    if size < 1:  # validate HERE, not at first next() inside the loop
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    return _prefetch_gen(iter(iterator), size, sharding)


def _prefetch_gen(it: Iterator[Any], size: int,
                  sharding: Optional[Any]) -> Iterator[Any]:
    import numpy as np
    import torch

    from ..device import resolve_device
    from .tree import tree_map

    def is_array(x) -> bool:
        return isinstance(x, (np.ndarray, torch.Tensor))

    if callable(sharding):
        def put(batch):
            return tree_map(lambda x: sharding(x) if is_array(x) else x,
                            batch)

        def hand_over(staged):
            return staged
    else:
        device = resolve_device(sharding)
        cuda = device.type == "cuda"
        copy_stream = torch.cuda.Stream(device) if cuda else None

        def put_leaf(x):
            if not is_array(x):
                return x
            t = torch.as_tensor(x)
            if not cuda:
                return t.to(device)
            if t.device.type == "cpu":
                t = t.pin_memory()
            return t.to(device, non_blocking=True)

        def put(batch):
            if not cuda:
                return tree_map(put_leaf, batch)
            # The copies run on the side stream; the event marks their end.
            with torch.cuda.stream(copy_stream):
                out = tree_map(put_leaf, batch)
                done = torch.cuda.Event()
                done.record(copy_stream)
            return out, done

        def hand_over(staged):
            if not cuda:
                return staged
            batch, done = staged
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)

            def adopt(x):
                if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                    x.record_stream(consumer)
                return x

            return tree_map(adopt, batch)

    queue: collections.deque = collections.deque()

    def enqueue(n: int) -> None:
        for batch in itertools.islice(it, n):
            queue.append(put(batch))

    enqueue(size)
    while queue:
        batch = hand_over(queue.popleft())
        enqueue(1)
        yield batch
