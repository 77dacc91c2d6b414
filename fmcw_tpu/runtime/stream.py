"""Streaming multi-frame runtime: double-buffered ingest + overlapped dispatch.

The reference overlaps everything in hardware: while the corner turner's
write bank fills with frame N, the read bank drains frame N-1, and an
``overflow_error`` fires if the consumer lags (rtl/src/corner_turner.vhd:
31-36,94-96).  The device-side equivalent (SURVEY.md §2d "double buffering"):

* host->device copies of frame N+1 are issued while frame N computes —
  ``jax.device_put`` and jitted dispatch are both asynchronous, so keeping a
  small in-flight window pipelines the PCIe transfer under compute;
* a bounded in-flight window provides backpressure; in ``drop`` mode an
  overloaded pipeline skips input frames and counts them (the overflow_error
  analog) instead of stalling the source.

Use ``stream()`` for a simple generator pipeline or ``StreamStats`` for the
accounting.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Iterable, Iterator

import jax
import numpy as np


@dataclasses.dataclass
class StreamStats:
    frames_in: int = 0
    frames_processed: int = 0
    frames_dropped: int = 0   # overflow_error analog


def stream(proc: Callable, frames: Iterable[np.ndarray], depth: int = 2,
           policy: str = "block", stats: StreamStats | None = None,
           **proc_kw) -> Iterator[dict]:
    """Pipeline ``frames`` (int16 iq arrays) through ``proc``.

    Yields output dicts in order.  At most ``depth`` frames are in flight:
    transfers and compute for later frames overlap the consumer's use of
    earlier results.  ``policy``:

    * ``"block"`` — backpressure the source (the AXI-Stream ready/valid
      analog): wait for the oldest result before admitting a new frame.
    * ``"drop"`` — if the window is full and the oldest result is not ready,
      drop the incoming frame and count it (frame-drop accounting under
      overload, cf. corner_turner.vhd:94-96).
    """
    if policy not in ("block", "drop"):
        raise ValueError(policy)
    st = stats if stats is not None else StreamStats()
    inflight: deque = deque()

    def ready(out) -> bool:
        try:
            return bool(out["n_dets"].is_ready())
        except AttributeError:
            return True

    for f in frames:
        st.frames_in += 1
        if len(inflight) >= depth:
            if policy == "drop" and not ready(inflight[0]):
                st.frames_dropped += 1
                continue
            out = inflight.popleft()
            jax.block_until_ready(out)
            st.frames_processed += 1
            yield out
        dev = jax.device_put(f)            # async H2D
        inflight.append(proc(dev, **proc_kw))  # async dispatch
    while inflight:
        out = inflight.popleft()
        jax.block_until_ready(out)
        st.frames_processed += 1
        yield out


class FrameAssembler:
    """Assemble whole CPI frames from arbitrarily-chunked sample streams.

    The reference ingests one sample per clock with tvalid gaps and
    backpressure (every TB exercises this — SURVEY.md §4); the framework
    ingests whole frames, so this adapter reassembles them: feed int16 I/Q
    sample chunks of any length (the AXI-Stream analog), get complete
    (n_doppler, n_range, 2) frames out.  Chunk boundaries never affect the
    result (property-tested in tests/test_runtime.py).
    """

    def __init__(self, n_doppler: int, n_range: int):
        self.shape = (n_doppler, n_range, 2)
        self._frame_samples = n_doppler * n_range
        self._buf = np.zeros((self._frame_samples, 2), dtype=np.int16)
        self._fill = 0

    def push(self, chunk: np.ndarray) -> list[np.ndarray]:
        """``chunk``: (k, 2) int16 I/Q samples.  Returns the list of frames
        completed by this chunk (usually empty or one)."""
        chunk = np.asarray(chunk, dtype=np.int16).reshape(-1, 2)
        done = []
        pos = 0
        while pos < len(chunk):
            take = min(len(chunk) - pos, self._frame_samples - self._fill)
            self._buf[self._fill: self._fill + take] = chunk[pos: pos + take]
            self._fill += take
            pos += take
            if self._fill == self._frame_samples:
                done.append(self._buf.reshape(self.shape).copy())
                self._fill = 0
        return done

    @property
    def pending_samples(self) -> int:
        return self._fill


def stream_batched(proc: Callable, frames: Iterable[np.ndarray],
                   batch_size: int, depth: int = 2,
                   stats: StreamStats | None = None, **proc_kw
                   ) -> Iterator[dict]:
    """Accumulate frames into device batches for a batch processor — the
    throughput configuration (amortizes dispatch overhead over batch_size
    frames).  The final partial batch is zero-padded and its pad results
    masked off via the "batch_valid" key added to each yielded dict."""
    st = stats if stats is not None else StreamStats()
    buf: list = []

    def batches():
        nonlocal buf
        for f in frames:
            st.frames_in += 1
            buf.append(f)
            if len(buf) == batch_size:
                yield np.stack(buf), batch_size
                buf = []
        if buf:
            pad = [np.zeros_like(buf[0])] * (batch_size - len(buf))
            yield np.stack(buf + pad), len(buf)

    inflight: deque = deque()
    for arr, n_valid in batches():
        dev = jax.device_put(arr)
        out = proc(dev, **proc_kw)
        out["batch_valid"] = n_valid
        inflight.append(out)
        if len(inflight) >= depth:
            o = inflight.popleft()
            jax.block_until_ready({k: v for k, v in o.items()
                                   if k != "batch_valid"})
            st.frames_processed += o["batch_valid"]
            yield o
    while inflight:
        o = inflight.popleft()
        jax.block_until_ready({k: v for k, v in o.items()
                               if k != "batch_valid"})
        st.frames_processed += o["batch_valid"]
        yield o
