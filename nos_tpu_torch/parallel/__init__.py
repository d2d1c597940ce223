"""Training in PyTorch: the one-device train step (multi-device is
ROADMAP Queue 1 item 9)."""

from nos_tpu_torch.parallel.train import make_train_step

__all__ = ["make_train_step"]
