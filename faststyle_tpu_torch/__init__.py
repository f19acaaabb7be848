"""faststyle_tpu_torch — the PyTorch/CUDA port of faststyle_tpu for NVIDIA Hopper.

The JAX package `faststyle_tpu` is the reference; this package mirrors its
module names so each counterpart is easy to find, keeps its public layouts
(NHWC activations, HWIO weights in files) and imports nothing of it.

Public surface (training, serving, Gatys slow-style, TFRecords, data parallelism,
sharded serving):
    faststyle_tpu_torch.ops.layers           — conv / norm / pool primitives
    faststyle_tpu_torch.ops.cuda.gram        — the Gram kernel (CUDA C++, sm_90a)
    faststyle_tpu_torch.models.transform_net — Johnson-style image transform net
    faststyle_tpu_torch.models.vgg16         — conv-only VGG16 feature tower
    faststyle_tpu_torch.losses               — content / style (Gram) / TV losses
    faststyle_tpu_torch.training             — train step, loop, checkpoints, slow-style
    faststyle_tpu_torch.inference            — params I/O, Stylizer, host pack/unpack
    faststyle_tpu_torch.compat.tf1_checkpoint — TF1 checkpoints without TensorFlow
    faststyle_tpu_torch.data.pipeline        — TFRecord / image-dir batchers + device prefetch
    faststyle_tpu_torch.data.{tfrecord,writer} — TFRecord codec (host C++) and dataset writer
    faststyle_tpu_torch.parallel             — data-parallel training over torch.distributed,
                                               batch- and row-sharded serving over a device
                                               list, the multi-device dry run
    faststyle_tpu_torch.convert              — weights between the npz and torch layouts
    faststyle_tpu_torch.cli.{train,stylize_image,stylize_webcam,slow_style,tfrecords_writer}
                                             — `python -m faststyle_tpu_torch.cli.<name>`

Entry points run on `cuda` unless the caller asks for `device="cpu"`; they
never fall back to the CPU on their own. float32 means float32: every CLI
calls `full_float32()` first, so no convolution or matmul runs in TF32.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def full_float32() -> None:
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls, process-wide.
    PyTorch's default lets cuDNN run float32 convolutions in TF32 (a 10-bit
    mantissa); the port offers float32 and bfloat16, never TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`device` as a torch.device; raises when CUDA is asked for and absent
    instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev
