"""Async frame prefetcher: overlap host→device transfers with compute.

The reference overlaps IO and compute with its two-thread pipeline
(SURVEY.md §2.3); here the same overlap comes from JAX's async
`jax.device_put` — frame i+1's host→device copy is in flight while frame
i's kernels run, which takes the transfer off the critical path.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Tuple

import jax


def prefetch_frames(frames: Iterable[Tuple], depth_first: bool = True,
                    keep_host: bool = False) -> Iterator[Tuple]:
    """Wrap a (timestamp, depth[, rgb]) iterable; yields the same tuples
    with array elements already on device, one transfer ahead.

    keep_host=True appends the ORIGINAL (host) tuple as a final element:
    consumers that need host bytes later (keyframe rgb for atlas blits)
    read them from RAM instead of downloading back what was uploaded."""
    it = iter(frames)

    def upload(item):
        dev = tuple(jax.device_put(x) if hasattr(x, "shape") else x
                    for x in item)
        return dev + (item,) if keep_host else dev

    try:
        pending = upload(next(it))
    except StopIteration:
        return
    for item in it:
        nxt = upload(item)   # async: in flight while caller computes
        yield pending
        pending = nxt
    yield pending
