"""Data-parallel training over torch.distributed (counterpart of
faststyle_tpu/parallel/)."""
