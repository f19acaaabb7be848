"""Stylization on the device (counterpart of faststyle_tpu/inference.py).

Transform-net weights on disk: the JAX package's flat `.npz` (keys
`'<block>/<var>'`, conv kernels HWIO, transposed-conv kernels HWOI), so
either package loads what the other saves, and the reference's TF1
checkpoint prefixes through the port's own `compat.tf1_checkpoint`.

`Stylizer` keeps the params resident on its device and runs the naive walk
eagerly (PyTorch has no trace to cache per shape). It serves the Johnson
transform net, or AdaIN (`models/adain.py`), which stylizes with any style
image: `encode_style` turns one into a handle that each call carries.
uint8 frames go to the device as they are and come back clipped and cast
there. The packed-u8
fast path moves the boundary relayouts of the frames to the host:
`pack_u8_host` reflect-pads and packs frames, `unpack_u8_host` unpacks
results, both in C++ (`csrc/depth_to_space.cc`, built at first use by the
host compiler and called through ctypes, which releases the GIL, so one
large frame splits into row slabs across a small thread pool).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from faststyle_tpu_torch import convert, resolve_device
from faststyle_tpu_torch.models import adain, transform_net
from faststyle_tpu_torch.models.transform_net import Params
from faststyle_tpu_torch.ops.cuda import build
from faststyle_tpu_torch.ops.cuda import instance_norm
from faststyle_tpu_torch.utils import profiling

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


class _TransformNet:
    """The Johnson transform net as Stylizer serves it: its style is in its
    weights, its packed input carries a reflect border of `_PAD`, and its
    walk runs eagerly (its `norm.fused` spans are recorded per launch)."""

    name, pad, takes_style, graphed = "transform_net", _PAD, False, False
    output_shape = staticmethod(transform_net.output_shape)

    @staticmethod
    def prepare(params: Params, compute_dtype) -> Params:
        return params

    @staticmethod
    def forward(p: Params, x: torch.Tensor, hw, style, *, upsample_method, compute_dtype, output_uint8,
                packed_input, packed_output) -> torch.Tensor:
        if style is not None:
            raise ValueError("a transform net carries its style in its weights: it takes no style")
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

    @staticmethod
    def encode_style(p: Params, x: torch.Tensor, compute_dtype, style_id: int):
        raise ValueError("encode_style is AdaIN's: this Stylizer serves a transform net")

    @staticmethod
    def blank_style(device: torch.device) -> None:
        return None

    @staticmethod
    def float_to_u8(out: np.ndarray) -> np.ndarray:
        return np.clip(out, 0, 255).astype(np.uint8)


class _AdaIN:
    """AdaIN (`models/adain.py`) as Stylizer serves it: each call carries a
    style from `encode_style`, its packed input has no border, its weights
    are cast once (`adain.prepare`), and on the card its forward may replay
    as a CUDA graph (`Stylizer._graphed`)."""

    name, pad, takes_style, graphed = "adain", adain.PAD, True, True
    output_shape = staticmethod(adain.output_shape)
    prepare = staticmethod(adain.prepare)
    encode_style = staticmethod(adain.encode_style)

    @staticmethod
    def forward(p: Params, x: torch.Tensor, hw, style, *, upsample_method, compute_dtype, output_uint8,
                packed_input, packed_output) -> torch.Tensor:
        if style is None:
            raise ValueError("an AdaIN model stylizes with a style: pass style=Stylizer.encode_style(image)")
        if packed_input or packed_output:
            return adain.apply_packed(p, x, style, compute_dtype=compute_dtype, input_hw=hw,
                                      output_layout="packed_u8" if packed_output else "nhwc",
                                      input_layout="packed_u8" if packed_input else "nhwc")
        return adain.apply(p, x, style, compute_dtype=compute_dtype, output_dtype=torch.uint8 if output_uint8 else None)

    @staticmethod
    def blank_style(device: torch.device) -> "adain.Style":
        """Any moments do for a warm-up: a style changes no shape."""
        ones = torch.ones(adain.DECODER[0][2], device=device)
        return adain.Style(0, 0 * ones, ones)

    @staticmethod
    def float_to_u8(out: np.ndarray) -> np.ndarray:
        return np.clip(out + 0.5, 0, 255).astype(np.uint8)  # rounded, as adain.to_u8


_KINDS = {kind.name: kind for kind in (_TransformNet, _AdaIN)}
MODELS = tuple(_KINDS)


def make_forward(
    upsample_method: str,
    compute_dtype: torch.dtype | None,
    *,
    output_uint8: bool,
    packed_input: bool,
    packed_output: bool,
    model: str = "transform_net",
):
    """The serving forward contract: fwd(params, x, hw=None, style=None).
    The packed flags route through the model's apply_packed with uint8 /
    packed-u8 layouts; otherwise the plain apply with optional uint8
    output. `style` (an `adain.Style`) is AdaIN's, and only AdaIN's."""
    if model not in _KINDS:
        raise ValueError(f"model must be one of {MODELS}, got {model!r}")
    forward = functools.partial(_KINDS[model].forward, upsample_method=upsample_method, compute_dtype=compute_dtype,
                                output_uint8=output_uint8, packed_input=packed_input, packed_output=packed_output)

    def fwd(p: Params, x: torch.Tensor, hw=None, style=None) -> torch.Tensor:
        return forward(p, x, hw, style)

    return fwd


def _as_torch_params(params: Mapping, device: torch.device) -> Params:
    """Torch params (torch layouts) move to `device`; numpy or other array
    leaves are taken as the file layouts and converted."""
    leaves = [v for sub in params.values() for v in sub.values()]
    if leaves and all(isinstance(v, torch.Tensor) for v in leaves):
        return {blk: {var: t.detach().to(device, torch.float32) for var, t in sub.items()} for blk, sub in params.items()}
    return convert.params_from_numpy(params, device=device)


def style_args(style) -> tuple:
    """The style as a trailing argument, or none: a transform net's calls
    keep their two-argument form."""
    return () if style is None else (style,)


class _Graph(NamedTuple):
    """One forward captured as a CUDA graph over static inputs and output."""

    key: tuple
    graph: "torch.cuda.CUDAGraph"
    x: torch.Tensor
    style: "adain.Style"
    out: torch.Tensor
    fused: bool  # whether the capture holds the instance-norm kernels


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
        model: str | None = None,
    ):
        """`output_uint8` clips and casts on the device, so a fetched frame
        moves a quarter of float32's bytes; uint8 input frames go to the
        device as they are and are cast there.

        `packed_output` (implies output_uint8): stylize_batch returns the
        packed uint8 tensor [N, ceil(OH/4), ceil(OW/4), 48], (OH, OW) =
        self.output_shape(H, W); `unpack_u8_host(out, OH, OW)` interleaves
        it on the host.

        `packed_input` (implies output_uint8): stylize_batch reflect-pads and
        packs uint8 frames on the host (`pack_u8_host`), and the device
        unpacks them with a view. Float frames are quantized to uint8 first,
        with a one-time warning per instance.

        `params`: `{block: {var: array}}`, torch tensors in torch layouts or
        numpy arrays in the file layouts; else `model_path` is loaded.

        `model`: "transform_net" or "adain"; None reads it from the blocks'
        names (`adain.is_adain`). An AdaIN model stylizes each call with a
        `style` from `encode_style`; its packed input has no border (pad
        0), and its output extent is `adain.output_shape`'s."""
        self.device = resolve_device(device)
        if params is None:
            if model_path is None:
                raise ValueError("need model_path or params")
            params = load_params_numpy(model_path)
        if upsample_method not in transform_net.UPSAMPLE_METHODS:
            raise ValueError(f"unknown upsample_method {upsample_method!r}")
        if model is None:
            model = "adain" if adain.is_adain(params) else "transform_net"
        self._fwd = make_forward(
            upsample_method,
            compute_dtype,
            output_uint8=output_uint8 or packed_output or packed_input,
            packed_input=packed_input,
            packed_output=packed_output,
            model=model,
        )
        self._kind = _KINDS[model]
        self._compute_dtype = compute_dtype
        self._styles = 0
        self._params = _as_torch_params(params, self.device)
        self._walk_params = self._kind.prepare(self._params, compute_dtype)  # what the forward reads
        self._method = upsample_method
        self._output_uint8 = output_uint8 or packed_output or packed_input
        self._packed_output = packed_output
        self._packed_input = packed_input
        self._warned_quantize = False
        self._graph: Optional[_Graph] = None
        self._eager_key: Optional[tuple] = None

    @property
    def params(self) -> Params:
        return self._params

    @property
    def model(self) -> str:
        """"transform_net" or "adain"."""
        return self._kind.name

    @property
    def takes_style(self) -> bool:
        """Whether each call carries a style from `encode_style` (AdaIN)."""
        return self._kind.takes_style

    @property
    def pad(self) -> int:
        """The border `pack_u8_host` gives this model's packed input."""
        return self._kind.pad

    def output_shape(self, h: int, w: int) -> tuple[int, int]:
        """The model's output extent for an h x w frame."""
        return self._kind.output_shape(h, w)

    def encode_style(self, image: np.ndarray | torch.Tensor) -> "adain.Style":
        """An AdaIN style handle from an HxWx3 RGB [0, 255] image (uint8 or
        float), encoded on the device in the compute dtype; its moments stay
        resident there. Each handle gets the next id (its `adain.style`
        span's)."""
        x = torch.as_tensor(image).to(self.device)
        with torch.inference_mode():
            style = self._kind.encode_style(self._walk_params, x, self._compute_dtype, self._styles + 1)
        self._styles += 1
        return style

    @property
    def packed_input(self) -> bool:
        return self._packed_input

    @property
    def packed_output(self) -> bool:
        return self._packed_output

    def stylize_device(self, x: torch.Tensor, hw: tuple[int, int] | None = None, style=None) -> torch.Tensor:
        """The forward on a tensor already on the device, in the input
        layout (packed uint8 with `hw` = (h, w) when packed_input), without
        any host conversion: the streaming CLI stages frames itself.
        `style`: an AdaIN model's handle from `encode_style`. On the card an
        AdaIN forward called again at one shape replays a CUDA graph of
        itself (`_graphed`)."""
        with torch.inference_mode():
            # a missing style raises in the eager forward
            if self._kind.graphed and style is not None and x.is_cuda and not torch.cuda.is_current_stream_capturing():
                return self._graphed(x, hw, style)
            return self._fwd(self._walk_params, x, hw, *style_args(style))

    def _graphed(self, x: torch.Tensor, hw, style: "adain.Style") -> torch.Tensor:
        """An AdaIN forward as one CUDA graph launch: its ~190 launches cost
        the host more than a 4K frame's 22 device ms can hide. A call at a
        new shape runs eagerly (the kernels' builds, cuDNN's plans and every
        cached index are made there); the next call at that same shape
        captures the forward over static copies of x and the style's
        moments, in place of any graph held before, so a Stylizer holds one
        graph and its memory pool. A call at the graph's shape copies its
        inputs in and replays it, inside an `adain.norm` span when the graph
        holds the norm kernels, and returns a copy of its output."""
        key = (tuple(x.shape), x.dtype, hw)
        if self._graph is None or self._graph.key != key:
            if key != self._eager_key:
                self._eager_key = key
                return self._fwd(self._walk_params, x, hw, style)
            self._graph = None  # the old graph's pool goes before the new one is taken
            self._graph = self._capture(key, x, hw, style)
        g = self._graph
        g.x.copy_(x)
        g.style.mean.copy_(style.mean)
        g.style.std.copy_(style.std)
        with profiling.span("adain.norm") if g.fused else contextlib.nullcontext():
            g.graph.replay()
        return g.out.clone()

    def _capture(self, key: tuple, x: torch.Tensor, hw, style: "adain.Style") -> _Graph:
        static_x, static_style = x.clone(), adain.Style(0, style.mean.clone(), style.std.clone())
        graph, launches = torch.cuda.CUDAGraph(), instance_norm.launches
        with torch.cuda.graph(graph):
            out = self._fwd(self._walk_params, static_x, hw, static_style)
        fused = instance_norm.launches > launches
        instance_norm.launches = launches  # a capture launches nothing
        return _Graph(key, graph, static_x, static_style, out, fused)

    def stylize_batch(self, imgs: np.ndarray | torch.Tensor, style=None) -> torch.Tensor:
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
            packed = torch.from_numpy(pack_u8_host(imgs, self.pad)).to(self.device)
            return self.stylize_device(packed, tuple(imgs.shape[1:3]), *style_args(style))
        x = torch.as_tensor(imgs)
        if x.dtype != torch.float32 and not (self._output_uint8 and x.dtype == torch.uint8):
            x = x.float()
        return self.stylize_device(x.to(self.device), None, *style_args(style))

    def __call__(self, img: np.ndarray, style=None) -> np.ndarray:
        """Single HWC image (uint8 or float RGB) -> stylized HWC uint8."""
        img = np.asarray(img)
        if not (self._output_uint8 and img.dtype == np.uint8):
            img = img.astype(np.float32)
        out = self.stylize_batch(img[None], style).cpu().numpy()
        if self._packed_output:
            oh, ow = self.output_shape(img.shape[0], img.shape[1])
            return unpack_u8_host(out, oh, ow)[0]
        if out.dtype == np.uint8:
            return out[0]
        return self._kind.float_to_u8(out[0])

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
        style = self._kind.blank_style(self.device)
        for dt in dtypes:
            out = self.stylize_batch(np.zeros((1, height, width, 3), dt), style)
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
