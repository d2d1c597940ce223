"""Hand-written Hopper kernels and their plain PyTorch versions.

Import from the kernel's module (``nos_tpu_torch.ops.flash_attention``):
its ``LAUNCHES`` counter lives there, and re-exporting the function here
would shadow the module of the same name.
"""
