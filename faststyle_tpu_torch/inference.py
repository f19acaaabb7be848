"""Stylization on the device (counterpart of faststyle_tpu/inference.py).

Transform-net weights on disk: the JAX package's flat `.npz` (keys
`'<block>/<var>'`, conv kernels HWIO, transposed-conv kernels HWOI), so
either package loads what the other saves, and the reference's TF1
checkpoint prefixes through the port's own `compat.tf1_checkpoint`.

`Stylizer` keeps the params resident on its device and runs the naive walk
eagerly (PyTorch has no trace to cache per shape). uint8 frames go to the
device as they are and come back clipped and cast there. The packed-u8
fast path moves the boundary relayouts of the frames to the host:
`pack_u8_host` reflect-pads and packs frames, `unpack_u8_host` unpacks
results, both in C++ (`csrc/depth_to_space.cc`, built at first use by the
host compiler and called through ctypes, which releases the GIL, so one
large frame splits into row slabs across a small thread pool).
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from faststyle_tpu_torch import convert, resolve_device
from faststyle_tpu_torch.models import transform_net
from faststyle_tpu_torch.models.transform_net import Params
from faststyle_tpu_torch.ops.cuda import build

# Worker pool for host-side pack/unpack: the C++ routines release the GIL
# and are independent per packed block-row, so a large frame splits into
# row slabs across cores. Created at first use.
_host_pool: Optional[ThreadPoolExecutor] = None
_host_pool_lock = threading.Lock()
_HOST_WORKERS = min(8, os.cpu_count() or 1)
# below this many packed block-rows a slab's dispatch costs more than it saves
_MIN_ROWS_PER_SLAB = 64
_PAD = 40


def _pool() -> ThreadPoolExecutor:
    global _host_pool
    if _host_pool is None:
        with _host_pool_lock:  # threaded serving hosts race the first call
            if _host_pool is None:
                _host_pool = ThreadPoolExecutor(max_workers=_HOST_WORKERS, thread_name_prefix="fs-host-relayout")
    return _host_pool


def _parallel_rows(fn, hb: int) -> None:
    """Run fn(by0, by1) over [0, hb), sliced across the pool when large."""
    slabs = min(_HOST_WORKERS, max(1, hb // _MIN_ROWS_PER_SLAB))
    if slabs == 1:
        fn(0, hb)
        return
    bounds = [hb * i // slabs for i in range(slabs + 1)]
    futs = [_pool().submit(fn, bounds[i], bounds[i + 1]) for i in range(slabs)]
    for f in futs:
        f.result()


@functools.cache
def _host_lib() -> ctypes.CDLL:
    """csrc/depth_to_space.cc, built on first use; raises if it cannot be."""
    lib = build.load("depth_to_space")
    lng, ptr = ctypes.c_long, ctypes.c_void_p
    lib.fs_unpack_u8_rows.argtypes = [ptr, ptr, lng, lng, lng, lng, lng, lng, lng, lng]
    lib.fs_unpack_u8_rows.restype = None
    lib.fs_pack_u8_rows.argtypes = [ptr, ptr, lng, lng, lng, lng, lng]
    lib.fs_pack_u8_rows.restype = None
    return lib


# ---------------------------------------------------------------------------
# Params on disk
# ---------------------------------------------------------------------------


def load_params_numpy(model_path: str | Path) -> Dict[str, Dict[str, np.ndarray]]:
    """Transform-net params in the file layouts from any supported container:
    a TF1 V2 checkpoint prefix (`<p>.index` and `<p>.data-*` exist), else a
    `.npz` (a `.ckpt` name or a bare stem resolves to the `.npz` beside it)."""
    model_path = Path(model_path)
    if model_path.with_name(model_path.name + ".index").exists():
        from faststyle_tpu_torch.compat import tf1_checkpoint

        return tf1_checkpoint.load_transform_net_params(model_path)
    candidates = [model_path]
    if model_path.suffix == ".ckpt":
        candidates.append(model_path.with_suffix(".npz"))
    elif model_path.suffix != ".npz":
        candidates.append(model_path.with_name(model_path.name + ".npz"))
    for cand in candidates:
        if cand.suffix == ".npz" and cand.exists():
            params: Dict[str, Dict[str, np.ndarray]] = {}
            with np.load(cand) as flat:
                for key in flat.files:
                    blk, var = key.split("/")
                    params.setdefault(blk, {})[var] = flat[key]
            return params
    raise FileNotFoundError(f"no model found at {model_path} (.index / .npz)")


def load_params(model_path: str | Path, *, device: str | torch.device = "cuda") -> Params:
    """`load_params_numpy`'s params as torch params on `device`."""
    return convert.params_from_numpy(load_params_numpy(model_path), device=device)


def save_params(model_path: str | Path, params: Params) -> None:
    """Save torch params as the flat HWIO `.npz` container."""
    flat = {
        f"{blk}/{var}": arr
        for blk, sub in convert.params_to_numpy(params).items()
        for var, arr in sub.items()
    }
    np.savez(model_path, **flat)


# ---------------------------------------------------------------------------
# Host pack / unpack (packed-u8 I/O)
# ---------------------------------------------------------------------------


def _out_array(out: Optional[np.ndarray], shape: tuple) -> np.ndarray:
    if out is None:
        return np.empty(shape, np.uint8)
    if out.shape != shape or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous uint8 array of shape {shape}, got {out.dtype} {out.shape}")
    return out


def unpack_u8_host(
    packed: np.ndarray, height: int, width: int, p: int = 4, c: int = 3, *, out: Optional[np.ndarray] = None
) -> np.ndarray:
    """Host depth-to-space of packed-u8 stylizer output:
    [N, Hb, Wb, p*p*c] uint8 -> [N, height, width, c] uint8 (into `out`
    when given), by the C++ routine, row slabs across the host pool."""
    packed = np.ascontiguousarray(packed)
    if packed.dtype != np.uint8 or packed.ndim != 4:
        raise ValueError(f"expected uint8 NHWC packed array, got {packed.dtype} ndim={packed.ndim}")
    n, hb, wb, cc = packed.shape
    # raises, not asserts: these guard raw-pointer writes, also under python -O
    if cc != p * p * c or height > hb * p or width > wb * p:
        raise ValueError(f"packed shape {packed.shape} inconsistent with p={p}, c={c}, target {height}x{width}")
    lib = _host_lib()
    out = _out_array(out, (n, height, width, c))
    for i in range(n):
        src, dst = packed[i].ctypes.data, out[i].ctypes.data
        _parallel_rows(
            lambda by0, by1, src=src, dst=dst: lib.fs_unpack_u8_rows(src, dst, hb, wb, p, c, height, width, by0, by1),
            hb,
        )
    return out


def unpack_u8_plain(packed: np.ndarray, height: int, width: int, p: int = 4, c: int = 3) -> np.ndarray:
    """unpack_u8_host in numpy: its plain version, for the tests."""
    n, hb, wb, _ = packed.shape
    full = packed.reshape(n, hb, wb, p, p, c).transpose(0, 1, 3, 2, 4, 5).reshape(n, hb * p, wb * p, c)
    return np.ascontiguousarray(full[:, :height, :width, :])


def packed_shape(n: int, h: int, w: int, pad: int = _PAD, p: int = 4) -> tuple[int, int, int, int]:
    """The shape pack_u8_host gives N frames of h x w."""
    return (n, -(-(h + 2 * pad) // p), -(-(w + 2 * pad) // p), p * p * 3)


def _check_frames(imgs: np.ndarray, pad: int) -> None:
    # raises, not asserts (python -O strips asserts; this guards a raw-pointer routine)
    if imgs.dtype != np.uint8 or imgs.ndim != 4 or imgs.shape[-1] != 3:
        raise ValueError(f"pack_u8_host needs uint8 NHWC RGB frames, got {imgs.dtype} shape {imgs.shape}")
    h, w = imgs.shape[1:3]
    if h <= pad or w <= pad:
        raise ValueError(
            f"packed input needs frames larger than the {pad}px reflect pad (got {h}x{w}): "
            "single-reflection padding is undefined below pad+1 px. Use a Stylizer without "
            "packed_input for tiny frames (the plain path multi-reflects)."
        )


def pack_u8_host(imgs: np.ndarray, pad: int = _PAD, p: int = 4, *, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Host reflect-pad + space-to-depth pack of uint8 RGB frames:
    [N, H, W, 3] -> [N, ceil((H+2*pad)/p), ceil((W+2*pad)/p), p*p*3] (into
    `out` when given, e.g. a pinned staging buffer), by the C++ routine."""
    imgs = np.ascontiguousarray(imgs)
    _check_frames(imgs, pad)
    if p != 4:
        raise ValueError(f"the host pack is built for p=4, got {p}")
    n, h, w, _ = imgs.shape
    shape = packed_shape(n, h, w, pad, p)
    lib = _host_lib()
    out = _out_array(out, shape)
    for i in range(n):
        src, dst = imgs[i].ctypes.data, out[i].ctypes.data
        _parallel_rows(lambda by0, by1, src=src, dst=dst: lib.fs_pack_u8_rows(src, dst, h, w, pad, by0, by1), shape[1])
    return out


def pack_u8_plain(imgs: np.ndarray, pad: int = _PAD, p: int = 4) -> np.ndarray:
    """pack_u8_host in numpy: its plain version, for the tests."""
    imgs = np.ascontiguousarray(imgs)
    _check_frames(imgs, pad)
    n, h, w, _ = imgs.shape
    _, hb, wb, _ = packed_shape(n, h, w, pad, p)
    padded = np.pad(imgs, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="reflect")
    full = np.zeros((n, hb * p, wb * p, 3), np.uint8)
    full[:, : h + 2 * pad, : w + 2 * pad] = padded
    return np.ascontiguousarray(full.reshape(n, hb, p, wb, p, 3).transpose(0, 1, 3, 2, 4, 5).reshape(n, hb, wb, p * p * 3))


def quantize_for_packed_input(imgs: np.ndarray, owner) -> np.ndarray:
    """Clip and quantize float frames to uint8 for the host pack stage,
    warning once per `owner` (anything with a `_warned_quantize` attribute):
    packed input serves the camera/decoder contract (uint8 frames), and a
    float frame fed to it loses its fractional intensities. uint8 frames
    pass through untouched."""
    if imgs.dtype == np.uint8:
        return imgs
    if not owner._warned_quantize:
        owner._warned_quantize = True
        warnings.warn(
            "packed_input stylizer received float frames: quantizing to uint8 "
            "(fractional intensities are lost). Use a Stylizer without "
            "packed_input to preserve float input precision.",
            stacklevel=3,
        )
    return np.clip(imgs, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Stylizer
# ---------------------------------------------------------------------------


def make_forward(
    upsample_method: str,
    compute_dtype: torch.dtype | None,
    *,
    output_uint8: bool,
    packed_input: bool,
    packed_output: bool,
):
    """The serving forward contract: fwd(params, x, hw=None). The packed
    flags route through transform_net.apply_packed with uint8 / packed-u8
    layouts; otherwise the plain apply with optional uint8 output."""

    def fwd(p: Params, x: torch.Tensor, hw=None) -> torch.Tensor:
        if packed_input or packed_output:
            return transform_net.apply_packed(
                p,
                x,
                compute_dtype=compute_dtype,
                output_dtype=torch.uint8,
                output_layout="packed_u8" if packed_output else "nhwc",
                input_layout="packed_u8" if packed_input else "nhwc",
                input_hw=hw,
                upsample_method=upsample_method,
            )
        return transform_net.apply(
            p,
            x,
            upsample_method,
            compute_dtype=compute_dtype,
            output_dtype=torch.uint8 if output_uint8 else None,
        )

    return fwd


def _as_torch_params(params: Mapping, device: torch.device) -> Params:
    """Torch params (torch layouts) move to `device`; numpy or other array
    leaves are taken as the file layouts and converted."""
    leaves = [v for sub in params.values() for v in sub.values()]
    if leaves and all(isinstance(v, torch.Tensor) for v in leaves):
        return {blk: {var: t.detach().to(device, torch.float32) for var, t in sub.items()} for blk, sub in params.items()}
    return convert.params_from_numpy(params, device=device)


class Stylizer:
    """Stylization of RGB [0, 255] images with params resident on `device`.

    `compute_dtype=torch.bfloat16` runs the conv stack in bf16; instance-norm
    statistics stay in float32. The default, None, is float32, the
    parity-test precision (the CLIs turn TF32 off, `full_float32`).
    """

    def __init__(
        self,
        model_path: str | Path | None = None,
        params: Optional[Mapping] = None,
        upsample_method: str = "resize",
        compute_dtype: torch.dtype | None = None,
        output_uint8: bool = False,
        packed_output: bool = False,
        packed_input: bool = False,
        device: str | torch.device = "cuda",
    ):
        """`output_uint8` clips and casts on the device, so a fetched frame
        moves a quarter of float32's bytes; uint8 input frames go to the
        device as they are and are cast there.

        `packed_output` (implies output_uint8): stylize_batch returns the
        packed uint8 tensor [N, ceil(OH/4), ceil(OW/4), 48], (OH, OW) =
        transform_net.output_shape(H, W); `unpack_u8_host(out, OH, OW)`
        interleaves it on the host.

        `packed_input` (implies output_uint8): stylize_batch reflect-pads and
        packs uint8 frames on the host (`pack_u8_host`), and the device
        unpacks them with a view. Float frames are quantized to uint8 first,
        with a one-time warning per instance.

        `params`: `{block: {var: array}}`, torch tensors in torch layouts or
        numpy arrays in the file layouts; else `model_path` is loaded."""
        self.device = resolve_device(device)
        if params is None:
            if model_path is None:
                raise ValueError("need model_path or params")
            params = load_params_numpy(model_path)
        if upsample_method not in transform_net.UPSAMPLE_METHODS:
            raise ValueError(f"unknown upsample_method {upsample_method!r}")
        self._params = _as_torch_params(params, self.device)
        self._method = upsample_method
        self._output_uint8 = output_uint8 or packed_output or packed_input
        self._packed_output = packed_output
        self._packed_input = packed_input
        self._warned_quantize = False
        self._fwd = make_forward(
            upsample_method,
            compute_dtype,
            output_uint8=self._output_uint8,
            packed_input=packed_input,
            packed_output=packed_output,
        )

    @property
    def params(self) -> Params:
        return self._params

    @property
    def packed_input(self) -> bool:
        return self._packed_input

    @property
    def packed_output(self) -> bool:
        return self._packed_output

    def stylize_device(self, x: torch.Tensor, hw: tuple[int, int] | None = None) -> torch.Tensor:
        """The forward on a tensor already on the device, in the input
        layout (packed uint8 with `hw` = (h, w) when packed_input), without
        any host conversion: the streaming CLI stages frames itself."""
        with torch.inference_mode():
            return self._fwd(self._params, x, hw)

    def stylize_batch(self, imgs: np.ndarray | torch.Tensor) -> torch.Tensor:
        """NHWC RGB [0, 255] -> stylized NHWC [0, 255] on the device (float32,
        or uint8 with output_uint8). With output_uint8, uint8 inputs go to
        the device as they are; otherwise inputs become float32.

        With packed_input the host pack stage is uint8-only: float frames are
        clipped to [0, 255] and quantized (fractional intensities are lost,
        and a one-time warning says so)."""
        if self._packed_input:
            if isinstance(imgs, torch.Tensor):
                imgs = imgs.cpu().numpy()
            imgs = quantize_for_packed_input(np.asarray(imgs), self)
            packed = torch.from_numpy(pack_u8_host(imgs)).to(self.device)
            return self.stylize_device(packed, tuple(imgs.shape[1:3]))
        x = torch.as_tensor(imgs)
        if x.dtype != torch.float32 and not (self._output_uint8 and x.dtype == torch.uint8):
            x = x.float()
        return self.stylize_device(x.to(self.device))

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """Single HWC image (uint8 or float RGB) -> stylized HWC uint8."""
        img = np.asarray(img)
        if not (self._output_uint8 and img.dtype == np.uint8):
            img = img.astype(np.float32)
        out = self.stylize_batch(img[None]).cpu().numpy()
        if self._packed_output:
            oh, ow = transform_net.output_shape(img.shape[0], img.shape[1])
            return unpack_u8_host(out, oh, ow)[0]
        if out.dtype == np.uint8:
            return out[0]
        return np.clip(out[0], 0, 255).astype(np.uint8)

    def warmup(self, height: int, width: int, dtypes=None) -> None:
        """Run and synchronise one call per dtype signature stylize_batch can
        hit at this shape, so cuDNN's first-call set-up is not billed to the
        first real frame: uint8 and float32 when output_uint8, else float32;
        `dtypes=[np.uint8]` (or float32) for single-dtype traffic. Packed
        input quantizes on the host, so it has the one uint8 signature."""
        if dtypes is None:
            dtypes = [np.uint8, np.float32] if self._output_uint8 else [np.float32]
        if self._packed_input:
            dtypes = [np.uint8]
        for dt in dtypes:
            out = self.stylize_batch(np.zeros((1, height, width, 3), dt))
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
