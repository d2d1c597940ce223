"""Host-side batching and device prefetch for training."""

from nos_tpu_torch.data.pipeline import BatchLoader, pack_documents, prefetch_to_device

__all__ = ["BatchLoader", "pack_documents", "prefetch_to_device"]
