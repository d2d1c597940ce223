"""Port input pipeline (nos_tpu_torch.data) against the JAX reference.

The loader and the packer are numpy in both: their batches must be
identical, element for element, for the same seed. ``prefetch_to_device``
runs here with ``device="cpu"``; every test that consumes a stream does
so on a helper thread joined with a timeout, so a feeder that hangs
fails the test instead of the suite.
"""
import threading

import numpy as np
import pytest
import torch

from nos_tpu.data import BatchLoader as JaxBatchLoader
from nos_tpu.data import pack_documents as jax_pack_documents
from nos_tpu_torch.data import BatchLoader, pack_documents, prefetch_to_device
from nos_tpu_torch.data import pipeline

TIMEOUT_S = 30


def within_timeout(fn):
    """Run ``fn`` on a thread; its result, or its exception re-raised.
    Fails if it does not finish within TIMEOUT_S."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(TIMEOUT_S)
    assert not thread.is_alive(), f"did not finish within {TIMEOUT_S} s"
    if "error" in box:
        raise box["error"]
    return box["value"]


CORPUS = np.random.default_rng(0).integers(0, 1000, size=20_000).astype(np.int32)


class TestBatchLoader:
    def test_batches_identical_to_reference(self):
        ours = BatchLoader(CORPUS, batch=8, seq_len=32, seed=7,
                           process_index=0, process_count=1)
        ref = JaxBatchLoader(CORPUS, batch=8, seq_len=32, seed=7,
                             process_index=0, process_count=1)
        for _, a, b in zip(range(4), ours, ref):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)

    def test_skip_replays_the_reference_stream(self):
        ours = BatchLoader(CORPUS, batch=4, seq_len=16, seed=3,
                           process_index=0, process_count=1)
        ref = JaxBatchLoader(CORPUS, batch=4, seq_len=16, seed=3,
                             process_index=0, process_count=1)
        ours.skip(5)
        ref.skip(5)
        resumed = next(iter(ours))
        np.testing.assert_array_equal(resumed, next(iter(ref)))
        # and it is batch 6 of a run that never stopped
        fresh = iter(BatchLoader(CORPUS, batch=4, seq_len=16, seed=3,
                                 process_index=0, process_count=1))
        for _ in range(6):
            sixth = next(fresh)
        np.testing.assert_array_equal(resumed, sixth)

    @pytest.mark.parametrize("rank", [0, 1, 2, 3])
    def test_process_striding_identical_to_reference(self, rank):
        ours = BatchLoader(CORPUS, batch=8, seq_len=16, seed=1,
                           process_index=rank, process_count=4)
        ref = JaxBatchLoader(CORPUS, batch=8, seq_len=16, seed=1,
                             process_index=rank, process_count=4)
        assert ours.local_batch == 2
        for _, a, b in zip(range(3), ours, ref):
            np.testing.assert_array_equal(a, b)

    def test_rank_and_world_come_from_torch_distributed(self, monkeypatch):
        dist = torch.distributed
        monkeypatch.setattr(dist, "is_available", lambda: True)
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_rank", lambda: 1)
        monkeypatch.setattr(dist, "get_world_size", lambda: 2)
        loader = BatchLoader(CORPUS, batch=4, seq_len=16, seed=2)
        assert (loader.process_index, loader.process_count) == (1, 2)
        ref = JaxBatchLoader(CORPUS, batch=4, seq_len=16, seed=2,
                             process_index=1, process_count=2)
        np.testing.assert_array_equal(next(iter(loader)), next(iter(ref)))

    def test_single_process_without_torch_distributed(self):
        assert pipeline._process_grid() == (0, 1)
        loader = BatchLoader(CORPUS, batch=4, seq_len=16)
        assert (loader.process_index, loader.process_count) == (0, 1)

    def test_rejects_tiny_corpus_and_odd_batch(self):
        with pytest.raises(ValueError, match="shorter"):
            BatchLoader(np.arange(10), batch=2, seq_len=16)
        with pytest.raises(ValueError, match="divide"):
            BatchLoader(np.arange(1000), batch=3, seq_len=8,
                        process_index=0, process_count=2)


class TestPackDocuments:
    def test_identical_to_reference(self):
        rng = np.random.default_rng(4)
        docs = [rng.integers(1, 50, size=n).astype(np.int32)
                for n in (3, 17, 1, 40, 9, 25)]
        ours = list(pack_documents(docs, seq_len=8, eos_id=0))
        ref = list(jax_pack_documents(docs, seq_len=8, eos_id=0))
        assert len(ours) == len(ref) > 0
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


class TestPrefetch:
    def test_yields_the_host_batches_as_tensors(self):
        loader = BatchLoader(CORPUS, batch=4, seq_len=16, seed=5,
                             process_index=0, process_count=1)
        want = [b for _, b in zip(range(3), iter(
            BatchLoader(CORPUS, batch=4, seq_len=16, seed=5,
                        process_index=0, process_count=1)))]

        def consume():
            stream = prefetch_to_device(iter(loader), device="cpu")
            return [next(stream) for _ in range(3)]

        got = within_timeout(consume)
        for g, w in zip(got, want):
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w)

    def test_finite_stream_terminates(self):
        batches = [np.full((2, 4), i, np.int32) for i in range(3)]
        got = within_timeout(
            lambda: list(prefetch_to_device(iter(batches), device="cpu", depth=1))
        )
        assert [int(b[0, 0]) for b in got] == [0, 1, 2]

    def test_feeder_error_is_raised_to_the_consumer(self):
        def broken():
            yield np.zeros((2, 4), np.int32)
            raise RuntimeError("corpus IO failed")

        def consume():
            stream = prefetch_to_device(broken(), device="cpu")
            next(stream)
            return list(stream)

        with pytest.raises(RuntimeError, match="corpus IO failed"):
            within_timeout(consume)

    def test_early_stop_releases_the_feeder(self):
        produced = []

        def endless():
            i = 0
            while True:
                produced.append(i)
                yield np.full((1, 2), i, np.int32)
                i += 1

        def consume():
            stream = prefetch_to_device(endless(), device="cpu", depth=2)
            first = next(stream)
            stream.close()  # the consumer stops early
            return first

        assert int(within_timeout(consume)[0, 0]) == 0
        feeders = [t for t in threading.enumerate() if t.name == "data-prefetch"]
        for t in feeders:
            t.join(TIMEOUT_S)
        assert not any(t.is_alive() for t in feeders)
        assert len(produced) <= 5  # bounded by the queue's depth, not endless
