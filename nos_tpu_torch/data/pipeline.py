"""Input pipeline: host-side batching with device prefetch.

Counterpart of ``nos_tpu/data/pipeline.py``:

- batches are assembled on the host (numpy); tokenization and packing
  never touch the device;
- ``prefetch_to_device`` keeps ``depth`` batches in flight on a
  background thread: each batch is copied from pinned host memory with
  ``non_blocking=True`` on a copy stream of its own, so the next batch's
  host-to-device copy overlaps the current step's compute;
- with ``torch.distributed`` initialised, each process feeds only its
  share of the global batch: the loader strides the sample stream by
  rank, the standard per-host data-parallel feed. Under a ``dp`` /
  ``sp`` mesh it strides by the **dp** index instead, so every sp rank
  of one dp group draws the same rows, and ``prefetch_to_device(mesh=)``
  hands each rank its ``S/sp`` columns of them.

Deterministic: one integer seed fixes the sample order; ``skip(n)``
replays the stream past n batches for a resume.
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

from nos_tpu_torch import _resolve_device


def pack_documents(
    documents: Iterable[np.ndarray],
    seq_len: int,
    eos_id: int,
) -> Iterator[np.ndarray]:
    """Greedy sequence packing: concatenate token documents separated by
    ``eos_id`` and emit dense [seq_len] windows — no padding FLOPs, the
    standard pretraining feed."""
    buffer: List[int] = []
    for doc in documents:
        buffer.extend(int(t) for t in doc)
        buffer.append(eos_id)
        while len(buffer) >= seq_len:
            yield np.asarray(buffer[:seq_len], np.int32)
            del buffer[:seq_len]


def _process_grid(mesh=None) -> "tuple[int, int]":
    """The loader's (stride index, stride count): the dp coordinate and
    dp size under a mesh (all sp ranks of a dp group read the same rows),
    else the rank and world size of ``torch.distributed`` when
    initialised, else (0, 1)."""
    if mesh is not None:
        from nos_tpu_torch.parallel.mesh import axis_index, axis_size

        return axis_index(mesh, "dp"), axis_size(mesh, "dp")
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class BatchLoader:
    """Deterministic host-side batch stream over a token corpus.

    ``corpus``: one long int32 token array (memory-mapped files work —
    anything ndarray-like with __getitem__ slicing). Samples are random
    seq_len windows drawn by a seeded generator; ``skip(n)`` fast-forwards
    past n batches for checkpoint-resume replay. ``mesh``: stride by the
    rank's dp index over the dp size (see ``_process_grid``).
    """

    def __init__(
        self,
        corpus,
        batch: int,
        seq_len: int,
        seed: int = 0,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        mesh=None,
    ) -> None:
        if len(corpus) < seq_len + 1:
            raise ValueError(
                f"corpus of {len(corpus)} tokens is shorter than seq_len {seq_len}"
            )
        self.corpus = corpus
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        if process_index is None or process_count is None:
            process_index, process_count = _process_grid(mesh)
        if batch % process_count:
            raise ValueError(
                f"global batch {batch} does not divide {process_count} processes"
            )
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch = batch // process_count
        self._rng = np.random.default_rng(seed)

    def skip(self, n_batches: int) -> None:
        """Fast-forward (checkpoint resume): replays the RNG stream — only
        the start-index draws, never the corpus copies — so batch N after
        a restart equals batch N of the original run at negligible cost."""
        for _ in range(n_batches):
            self._draw_starts()

    def _draw_starts(self) -> np.ndarray:
        # One GLOBAL draw per batch; every process takes its own stride of
        # the same sample list, so the union across processes is exactly
        # the single-process batch.
        return self._rng.integers(0, len(self.corpus) - self.seq_len, size=self.batch)

    def _draw(self) -> np.ndarray:
        starts = self._draw_starts()
        mine = starts[self.process_index::self.process_count]
        return np.stack(
            [np.asarray(self.corpus[s:s + self.seq_len], np.int32) for s in mine]
        )

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self._draw()


def prefetch_to_device(
    host_batches: Iterable[np.ndarray],
    device=None,
    depth: int = 2,
    mesh=None,
) -> Iterator[torch.Tensor]:
    """Wrap a host batch iterator so the copies to ``device`` (``cuda``
    unless the caller names another) run ``depth`` batches ahead on a
    background thread. On the card each batch goes through pinned memory
    on a copy stream; the consumer's stream waits for that copy before
    the batch is handed over, so no host sync is needed. A feeder error
    is raised on the consumer's side; a consumer that stops early
    releases the feeder.

    ``mesh``: each host batch is this rank's dp group's rows [B/dp, S]
    (``BatchLoader(mesh=...)``), and the rank receives its block
    [B/dp, S/sp] of them; only the block is copied."""
    dev = _resolve_device(device)
    done = object()
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    error: collections.deque = collections.deque(maxlen=1)
    stop = threading.Event()
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(item) -> bool:
        # Bounded, abandonment-aware put: an early-stopping consumer sets
        # `stop`, and the feeder must exit rather than block forever on a
        # full queue holding device buffers.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def to_device(host_batch):
        host = torch.from_numpy(np.ascontiguousarray(host_batch))
        if mesh is not None:
            from nos_tpu_torch.parallel.sharding import sequence_block

            host = sequence_block(mesh, host).contiguous()
        if copy_stream is None:
            return host.to(dev, copy=True), None
        with torch.cuda.stream(copy_stream):
            batch = host.pin_memory().to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return batch, ready

    def feeder() -> None:
        try:
            for host_batch in host_batches:
                if not put(to_device(host_batch)):
                    return
        except Exception as e:  # noqa: BLE001 — surfaced on the consumer side
            error.append(e)
        finally:
            put(done)

    thread = threading.Thread(target=feeder, name="data-prefetch", daemon=True)
    thread.start()

    try:
        while True:
            item = q.get()
            if item is done:
                if error:
                    raise error.popleft()
                return
            batch, ready = item
            if ready is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(ready)
                # allocated on the copy stream, used on this one
                batch.record_stream(stream)
            yield batch
    finally:
        # GeneratorExit (consumer stopped early) or normal exhaustion:
        # release the feeder and drop any buffered batches.
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
