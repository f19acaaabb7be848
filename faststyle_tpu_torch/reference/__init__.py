"""Plain references of the port's models: float32 PyTorch in NCHW, written
from the published code, importing nothing of the port. The CPU tests hold
the port to them."""
