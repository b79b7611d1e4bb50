"""Stream residency: host-resident panels reach the card in double-buffered
chunks (`factorvae_tpu/data/stream.py`).

Under `PanelDataset(residency="stream")` the panel stays in host memory. An
epoch or a scoring pass takes its days in chunks, and each chunk travels as
a relocatable mini-panel (`windows.chunk_mini_panel`): the unchanged device
gather over it gives bitwise the batches the whole panel gives. One worker
thread produces chunk k+1 while the consumer computes on chunk k:

- the worker gathers the chunk on the host straight into one of two pinned
  staging buffers (`torch.empty(..., pin_memory=True)`, grown to the
  largest chunk; `np.take(..., out=)` writes the panel rows in place), then
  copies it with `.to(device, non_blocking=True)` on a side CUDA stream and
  records an event;
- before it gathers into a staging buffer again, it synchronizes the event
  of the copy that last read that buffer (else it would overwrite bytes the
  DMA is still reading);
- the consumer's stream waits for the event, and every device tensor of the
  chunk gets `record_stream` on the consumer's stream (a tensor allocated on
  the side stream otherwise returns to that stream's pool when its last
  reference drops, and a later chunk's copy could reuse it while this
  chunk's kernels are still queued);
- a chunk is released (its tensors dropped) when the consumer asks for the
  next one, and the worker copies a chunk only while fewer than two are
  alive, so device memory holds two chunks however long the history is.

Chunks are consumed strictly in order: chunk order is the step order, part
of the bitwise contract with the "hbm" residency. A CPU dataset (the tests)
takes the same path with the copy as the identity and nothing pinned.

`ChunkStream` keeps the transfer ledger: `bytes_put`, `produce_seconds`
(host gather and copy enqueue, on the worker), `wait_seconds` (the consumer
waiting for an unfinished chunk), both also per chunk, `copy_seconds` (the
copies' device time, CUDA events), `retries`, `staging_waits` (staging
buffers found still being read by their copy) and `overlap_frac`. A failed produce retries
`MAX_RETRIES` times with backoff, then raises; the chaos kinds
`stream_fail` and `stream_stall` inject there. With a timeline installed
(`utils/logging.py`) each produce is a `chunk_produce` span on the "stream"
lane, each wait a `chunk_wait` span on "stream_wait", and each retry a
`stream_retry` mark.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from factorvae_tpu_torch.chaos import fault as chaos_fault
from factorvae_tpu_torch.data.windows import gather_days, mini_panel_maps
from factorvae_tpu_torch.utils.logging import timeline_event, timeline_span_at

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.int64): torch.int64}


def overlap_frac(wait_seconds: float, produce_seconds: float) -> float:
    """The share of the produce time hidden behind the consumer's compute,
    1 - wait / produce clamped to [0, 1]; 0 when nothing was produced."""
    if produce_seconds <= 0.0:
        return 0.0
    return max(0.0, min(1.0, 1.0 - wait_seconds / produce_seconds))


class MiniPanel:
    """One chunk's mini-panel on the device, in the place of the dataset for
    `train/loop.batch_for` and `lane_batch`: values (n_max, rows, C+1),
    fill maps (rows, n_max) int64."""

    def __init__(self, values: torch.Tensor, last_valid: torch.Tensor,
                 next_valid: torch.Tensor, seq_len: int):
        self.values, self.last_valid, self.next_valid = values, last_valid, next_valid
        self.seq_len = seq_len

    def gather(self, days: torch.Tensor):
        return gather_days(self.values, self.last_valid, self.next_valid, days,
                           self.seq_len)

    def release(self) -> None:
        self.values = self.last_valid = self.next_valid = None


class ChunkStream:
    """Iterate `n_chunks` chunks on `device`, produced one chunk ahead.

    `make_chunk(i, alloc)` builds chunk i on the host as a tuple of numpy
    arrays, each made by `alloc(name, shape, dtype)` (a view of the pinned
    staging buffer on CUDA, a fresh array on the CPU) and filled in place.
    The stream yields `wrap(tensors)` of their device copies; an item, or an
    element of a tuple item, with a `release` method is released when the
    consumer asks for the next chunk. One pass per stream."""

    #: a failed produce (the host gather, the pin or the copy) retries this
    #: many times with exponential backoff, then raises; a retry is
    #: deterministic, so bitwise the first attempt
    MAX_RETRIES = 2
    RETRY_BACKOFF_S = 0.05
    ALIVE = 2       # chunks on the device at most

    def __init__(self, make_chunk: Callable, n_chunks: int, device,
                 wrap: Callable = tuple):
        self._make_chunk = make_chunk
        self._wrap = wrap
        self.n_chunks = int(n_chunks)
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        # the ledger is written by the worker and read by the consumer
        self._lock = threading.Lock()
        self.bytes_put = 0
        self.produce_seconds = 0.0
        self.wait_seconds = 0.0
        self.copy_seconds = 0.0
        self.retries = 0
        self.staging_waits = 0
        self.chunk_produce_seconds = [0.0] * self.n_chunks
        self.chunk_wait_seconds = [0.0] * self.n_chunks
        self._staging = [{}, {}]        # per buffer: name -> pinned uint8 tensor
        self._copied = [None, None]     # per buffer: (start, end) events of its last copy
        self._slots = threading.Semaphore(self.ALIVE)
        self._closed = False
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None

    # ---- worker side -----------------------------------------------------

    def _produce(self, i: int):
        last = None
        for attempt in range(self.MAX_RETRIES + 1):
            if self._closed:
                return None
            try:
                stall = chaos_fault("stream_stall", chunk=i)
                if stall is not None:
                    time.sleep(stall.delay_s)
                if chaos_fault("stream_fail", chunk=i) is not None:
                    raise RuntimeError(f"chaos: injected stream transfer failure (chunk {i})")
                return self._produce_once(i)
            except Exception as e:      # noqa: BLE001 - retried, then raised
                last = e
                if attempt == self.MAX_RETRIES:
                    raise
                with self._lock:
                    self.retries += 1
                timeline_event("stream_retry", cat="recovery", resource="stream", chunk=i,
                               attempt=attempt + 1, error=str(e))
                time.sleep(self.RETRY_BACKOFF_S * (2 ** attempt))
        raise last      # unreachable

    def _settle(self, buf: int) -> None:
        """Wait for the copy that last read staging buffer `buf` and book its
        device time."""
        with self._lock:
            done = self._copied[buf]
        if done is None:
            return
        start, end = done
        if not end.query():
            with self._lock:
                self.staging_waits += 1
        end.synchronize()
        with self._lock:
            self.copy_seconds += start.elapsed_time(end) / 1e3
            self._copied[buf] = None

    def _alloc_for(self, buf: int, views: list):
        bufs = self._staging[buf]

        def alloc(name, shape, dtype):
            dtype = np.dtype(dtype)
            if not self._cuda:
                return np.empty(shape, dtype)
            n = int(np.prod(shape)) * dtype.itemsize
            if name not in bufs or bufs[name].numel() < n:
                bufs[name] = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            t = bufs[name][:n].view(_TORCH_DTYPES[dtype]).view(tuple(shape))
            arr = t.numpy()
            views.append((arr, t))
            return arr

        return alloc

    def _produce_once(self, i: int):
        t0 = time.perf_counter()
        buf = i % 2
        views: list = []
        if self._cuda:
            self._settle(buf)
        arrays = self._make_chunk(i, self._alloc_for(buf, views))
        nbytes = sum(int(a.nbytes) for a in arrays)
        if self._cuda:
            sources = [next(t for a, t in views if a is arr) for arr in arrays]
            out = self._copy(buf, sources)
            if out is None:
                return None
        else:
            out = (tuple(torch.from_numpy(a) for a in arrays), None)
        t1 = time.perf_counter()
        seconds = t1 - t0
        with self._lock:
            self.bytes_put += nbytes
            self.produce_seconds += seconds
            self.chunk_produce_seconds[i] = seconds
        timeline_span_at("chunk_produce", t0, t1, cat="stream", resource="stream", chunk=i,
                         bytes=nbytes)
        return out

    def _copy(self, buf: int, sources: list):
        """The chunk's pinned sources to the device on the side stream, once
        fewer than ALIVE chunks are alive: (tensors, the copy's end event)."""
        self._slots.acquire()
        if self._closed:
            self._slots.release()
            return None
        try:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.device(self.device), torch.cuda.stream(self._copy_stream):
                start.record()
                tensors = tuple(s.to(self.device, non_blocking=True) for s in sources)
                end.record()
            with self._lock:
                self._copied[buf] = (start, end)
            return tensors, end
        except BaseException:
            # no copy may still read the buffer that a retry gathers into
            self._copy_stream.synchronize()
            self._slots.release()
            raise

    # ---- consumer side ---------------------------------------------------

    def __iter__(self) -> Iterator:
        if self.n_chunks <= 0:
            return
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(self._produce, 0)
            try:
                for i in range(self.n_chunks):
                    nxt = ex.submit(self._produce, i + 1) if i + 1 < self.n_chunks else None
                    t0 = time.perf_counter()
                    tensors, ready = fut.result()
                    fut = nxt
                    t1 = time.perf_counter()
                    waited = t1 - t0
                    with self._lock:
                        self.wait_seconds += waited
                        self.chunk_wait_seconds[i] = waited
                    timeline_span_at("chunk_wait", t0, t1, cat="stream",
                                     resource="stream_wait", chunk=i)
                    if ready is not None:
                        stream = torch.cuda.current_stream(self.device)
                        stream.wait_event(ready)
                        for t in tensors:
                            t.record_stream(stream)
                    item = self._wrap(tensors)
                    del tensors
                    yield item
                    for part in (item if isinstance(item, tuple) else (item,)):
                        if hasattr(part, "release"):
                            part.release()
                    del item
                    if self._cuda:
                        self._slots.release()
                if self._cuda:
                    for buf in (0, 1):
                        self._settle(buf)
            finally:
                self._closed = True
                for _ in range(self.ALIVE):     # a worker waiting for a slot ends
                    self._slots.release()

    @property
    def overlap_frac(self) -> float:
        with self._lock:
            return overlap_frac(self.wait_seconds, self.produce_seconds)

    def stats(self) -> dict:
        """The ledger as a dict, with the copies' rate in GB/s (None on the
        CPU or before any copy was timed)."""
        with self._lock:
            out = {"chunks": self.n_chunks, "bytes_put": self.bytes_put,
                   "produce_seconds": self.produce_seconds,
                   "wait_seconds": self.wait_seconds, "copy_seconds": self.copy_seconds,
                   "retries": self.retries, "staging_waits": self.staging_waits,
                   "overlap_frac": overlap_frac(self.wait_seconds, self.produce_seconds),
                   "chunk_produce_seconds": list(self.chunk_produce_seconds),
                   "chunk_wait_seconds": list(self.chunk_wait_seconds)}
        out["h2d_gb_per_s"] = (out["bytes_put"] / out["copy_seconds"] / 1e9
                               if out["copy_seconds"] > 0 else None)
        return out


def chunk_slices(n_steps: int, steps_per_chunk: int) -> list:
    """[(start, stop)] covering range(n_steps) in order. The tail chunk is
    shorter, never padded: padding would add steps."""
    if steps_per_chunk <= 0:
        raise ValueError(f"steps_per_chunk must be >= 1; got {steps_per_chunk}")
    return [(s, min(s + steps_per_chunk, n_steps)) for s in range(0, n_steps, steps_per_chunk)]


def stream_epoch_batches(dataset, order: np.ndarray, steps_per_chunk: int,
                         placement: Optional[Callable] = None) -> ChunkStream:
    """A ChunkStream over a stream-resident dataset's day order, yielding
    (MiniPanel, local order) per chunk of `steps_per_chunk` steps.

    `order` is (steps, B), the serial or shared order, or (S, steps, B), one
    order per lane of a fleet. A fleet chunk stacks its lanes' mini-panels
    along the day axis (lane s's rows, local days and fill maps offset by
    s·m·T), so one gather over it serves every lane. The stream is also kept
    as `dataset.last_stream`, whose ledger a caller may read. `placement`
    (`parallel/sharding.chunk_placement`) maps the host panel's (values,
    last_valid, next_valid) to this rank's stocks of them, so a rank on a
    mesh builds and copies only its rows of every mini-panel."""
    order = np.asarray(order, np.int64)
    lanes = order if order.ndim == 3 else order[None]
    slices = chunk_slices(lanes.shape[1], steps_per_chunk)
    values, lv, nv = dataset.values_np, dataset.last_valid_np, dataset.next_valid_np
    if placement is not None:
        values, lv, nv = placement(values, lv, nv)
    t, n, c1 = dataset.seq_len, values.shape[0], values.shape[-1]

    def make_chunk(i, alloc):
        lo, hi = slices[i]
        rows, clvs, cnvs, local = [], [], [], []
        offset = 0
        for days in lanes[:, lo:hi].reshape(lanes.shape[0], -1):
            ld, r, clv, cnv = mini_panel_maps(lv, nv, days, t)
            local.append(np.where(ld >= 0, ld.astype(np.int64) + offset, -1))
            rows.append(r)
            clvs.append(np.where(clv >= 0, clv.astype(np.int64) + offset, -1))
            cnvs.append(cnv.astype(np.int64) + offset)
            offset += len(r)
        cvalues = alloc("values", (n, offset, c1), np.float32)
        np.take(values, np.concatenate(rows), axis=1, out=cvalues, mode="clip")
        clv = alloc("last_valid", (offset, n), np.int64)
        np.concatenate(clvs, out=clv)
        cnv = alloc("next_valid", (offset, n), np.int64)
        np.concatenate(cnvs, out=cnv)
        local_order = alloc("order", order[..., lo:hi, :].shape, np.int64)
        local_order[...] = np.stack(local).reshape(local_order.shape)
        return cvalues, clv, cnv, local_order

    def wrap(tensors):
        cvalues, clv, cnv, local_order = tensors
        return MiniPanel(cvalues, clv, cnv, t), local_order

    stream = ChunkStream(make_chunk, len(slices), dataset.device, wrap=wrap)
    dataset.last_stream = stream
    return stream


def epoch_chunks(dataset, order: np.ndarray, steps_per_chunk: int,
                 placement: Optional[Callable] = None):
    """The (dataset, order tensor) pairs an epoch's loop walks: one pair of
    the resident panel under "hbm", a ChunkStream of mini-panels under
    "stream" (`placement` as in `stream_epoch_batches`)."""
    if dataset.residency == "stream":
        return stream_epoch_batches(dataset, order, steps_per_chunk, placement)
    return [(dataset, torch.as_tensor(np.asarray(order, np.int64), device=dataset.device))]
