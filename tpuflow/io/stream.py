"""High-level frame streaming: native prefetcher -> device arrays.

The host input pipeline (SURVEY.md §2.6 "host-device streaming" row):
a background C++ thread reads and widens frames while the device
computes the previous pair, so host-to-device transfers overlap disk IO.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Sequence

import numpy as np


class FrameStream:
    """Iterate (H, W) float32 frames from .bin files with readahead.

    Uses the native prefetcher when built; otherwise plain reads.
    """

    def __init__(
        self,
        paths: Sequence[str | Path],
        width: int = 320,
        height: int = 240,
        depth: int = 3,
    ):
        self.paths = [str(p) for p in paths]
        self.width = width
        self.height = height
        self.depth = depth

    def __iter__(self) -> Iterator[np.ndarray]:
        try:
            from tpuflow import _fastio
        except ImportError:
            _fastio = None

        if _fastio is not None:
            pf = _fastio.FramePrefetcher(self.paths, depth=self.depth)
            try:
                while True:
                    payload = pf.next_frame()
                    if payload is None:
                        return
                    yield np.frombuffer(payload, dtype=np.float32).reshape(
                        self.height, self.width
                    )
            finally:
                pf.close()
        else:
            from tpuflow.io.frames import load_frame_bin

            for p in self.paths:
                yield load_frame_bin(p, self.width, self.height)

    def pairs(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Consecutive (prev, curr) frame pairs."""
        prev = None
        for frame in self:
            if prev is not None:
                yield prev, frame
            prev = frame

    def device_pairs(self, lookahead: int = 2):
        """Consecutive (prev, curr) pairs as DEVICE arrays, H2D
        double-buffered (see :func:`device_pairs`)."""
        return device_pairs(self, lookahead=lookahead)


def prefetch_to_device(frames, lookahead: int = 2):
    """Stream frames to the device ``lookahead`` ahead of consumption.

    ``jax.device_put`` is asynchronous: it *initiates* the H2D copy and
    returns immediately, so holding a small deque of in-flight transfers
    overlaps each upload with the compute consuming the previous frames —
    the analog of the reference's frame buffer streaming pixels while
    the pipeline computes
    (rtl/common/frame_buffer_simple.sv:60-94). Each frame is uploaded
    exactly once (the naive per-pair ``jnp.asarray(prev), jnp.asarray
    (curr)`` uploads every frame twice)."""
    import collections

    import jax

    q: collections.deque = collections.deque()
    for frame in frames:
        q.append(jax.device_put(frame))
        while len(q) > lookahead:
            yield q.popleft()
    while q:
        yield q.popleft()


def device_pairs(frames, lookahead: int = 2):
    """Consecutive (prev, curr) DEVICE-array pairs from a host frame
    iterable, with ``lookahead`` H2D transfers in flight."""
    prev = None
    for frame in prefetch_to_device(frames, lookahead=lookahead):
        if prev is not None:
            yield prev, frame
        prev = frame
