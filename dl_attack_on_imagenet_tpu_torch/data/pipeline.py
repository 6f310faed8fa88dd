"""Host-to-device input pipeline: a double-buffered prefetch.

Port of ``dl_attack_on_imagenet_tpu/data/pipeline.py``. On a CUDA device
each batch is pinned and copied with ``non_blocking=True`` on a side stream,
so that batch i+1 crosses PCIe while the compute stream works on batch i;
the compute stream waits on an event per batch, and each tensor is recorded
on the compute stream so that its memory is not handed out again before the
compute stream is done with it. On the CPU the batch passes straight
through, unpinned.
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator, Tuple

import torch

from .. import DeviceLike, resolve_device


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device: DeviceLike = None) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Wrap an iterator of host batches (tuples of arrays) with a transfer
    lookahead of ``size`` batches; yields tuples of tensors on ``device``.

    ``device`` defaults to CUDA and raises where there is none.
    """
    device = resolve_device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield tuple(torch.as_tensor(a, device=device) for a in batch)
        return

    copy_stream = torch.cuda.Stream(device)

    def put(batch):
        with torch.cuda.stream(copy_stream):
            out = tuple(torch.as_tensor(a).pin_memory().to(device, non_blocking=True)
                        for a in batch)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return out, ready

    queue = collections.deque()
    it = iter(iterator)
    for batch in itertools.islice(it, size):
        queue.append(put(batch))
    while queue:
        out, ready = queue.popleft()
        compute = torch.cuda.current_stream(device)
        compute.wait_event(ready)
        for t in out:
            t.record_stream(compute)
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
        yield out
