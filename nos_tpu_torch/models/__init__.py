"""The Llama-family decoder and its KV-cache generation, in PyTorch."""

from nos_tpu_torch.models.llama import (
    LlamaConfig,
    init_llama_params,
    llama_forward,
    llama_loss,
)

__all__ = ["LlamaConfig", "init_llama_params", "llama_forward", "llama_loss"]
