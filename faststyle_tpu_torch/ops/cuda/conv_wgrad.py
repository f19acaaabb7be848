"""The weight gradient of a 2-D convolution, with its CUDA kernel.

    dW[o, i, kh, kw] = sum over n, y, x of dY[n, y, x, o] * Xpad[n, y*s + kh, x*s + kw, i]

X [n, h, w, ci] and dY [n, oh, ow, co] are NHWC; Xpad is X zero-padded by
(ph, pw) on both sides; dW is [co, ci, kh, kw] (OIHW) float32. The kernels
are csrc/conv_wgrad.cu (CUDA C++ for sm_90a, built on first use by `build`,
bound with ctypes); its header gives the two designs, both an implicit GEMM
over the n*oh*ow output pixels on the tensor cores (bf16 mma.sync; float32
as 3xTF32):
  * "tile": the im2col rows of X gathered on the fly, the pixel rows split
    across blocks as `plan` says;
  * "strip" (float32, wide kernels over few channels: `design`): each block
    walks strips of output pixels, copies the X patch a strip reads into
    shared memory once and reads the im2col in place from it, as
    `strip_plan` and `strip_offsets` lay it out.
The blocks' partial sums are added in a fixed order. No atomics, so two
calls on the same inputs give the same bits: it is what makes the train
step reproducible on the card (ops/conv_grad.py).

No TPU kernel stands behind it (the JAX package's conv gradients are
XLA's). A CUDA tensor goes through the kernel or raises; a CPU tensor goes
through `conv_weight_grad_plain`, the im2col product in plain PyTorch.
`launches` counts calls that launched the kernel, and nothing else;
`relayouts` counts inputs that had to be copied to NHWC first.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from faststyle_tpu_torch.ops.cuda import build

KSTEP = 32  # pixel rows per shared-memory stage in csrc/conv_wgrad.cu
TP = 128  # im2col columns per output tile
TILE_C = (8, 16, 32, 64)  # output-channel tile widths the kernel is built for
RESIDENT = 2  # blocks an SM holds at once
STRIP_ROWS = 8  # output rows of a strip: its patch reads (8 + kh - 1) / 8 ~ 2x the rows at kh = 9
STRIP_MT = (2, 4, 6, 8, 11)  # m16 tiles a warp, as the strip kernel (pixels on K) is built for
STRIP_KN_MT = (2, 4, 6, 9)  # m16 tiles a warp of the kw-on-N strip kernel
KN_NT = 2  # n8 tiles a warp of the kw-on-N strip kernel holds
STRIP_P_MAX = 8 * 16 * STRIP_MT[-1]  # widest im2col (kh*kw*ci) the strip kernel holds in registers
SMEM_MAX = 232448  # dynamic shared memory a block may have on sm_90
SM_SHARED = 233472  # shared memory of one SM, 1024 bytes of it kept per resident block

launches = 0
relayouts = 0


class WgradPlan(NamedTuple):
    """How one call is cut: `splits` slices of `chunk` pixel rows over
    128 x `tile_c` output tiles, `blocks` blocks in all."""

    splits: int
    chunk: int
    tile_c: int
    blocks: int

    @property
    def launches(self) -> int:
        """Kernel launches per call: the tile kernel, plus the reduce when split."""
        return 1 if self.splits == 1 else 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def out_size(n: int, k: int, stride: int, pad: int) -> int:
    """Output extent of a conv over n with kernel k, stride and pad per side."""
    return (n + 2 * pad - k) // stride + 1


@functools.cache
def plan(rows: int, p: int, co: int, in_bytes: int, num_sms: int) -> WgradPlan:
    """The launch plan for `rows` = n*oh*ow output pixels, p = kh*kw*ci
    im2col columns and co output channels, with X and dY together
    `in_bytes` long, on a card with `num_sms` SMs. The split count fills the
    card as evenly as it can, minimising the rows a block walks times the
    waves of blocks, taking the fewest splits on a tie; and the split
    scratch (splits x p x co float32) never outweighs half the input, the
    byte budget of ops/cuda/gram.py's plan."""
    tile_c = next((t for t in TILE_C if co <= t), TILE_C[-1])
    tiles = _cdiv(p, TP) * _cdiv(co, tile_c)
    cap = (in_bytes // 2) // (p * co * 4)
    slots = num_sms * RESIDENT
    most = max(1, min(cap, _cdiv(rows, KSTEP), 65535, 4 * _cdiv(slots, tiles)))
    best = None
    for want in range(1, most + 1):
        chunk = _cdiv(_cdiv(rows, want), KSTEP) * KSTEP
        splits = _cdiv(rows, chunk)
        busiest = _cdiv(tiles * splits, slots) * chunk
        if best is None or busiest < best[0]:
            best = (busiest, splits, chunk)
    _, splits, chunk = best
    return WgradPlan(splits, chunk, tile_c, tiles * splits)


def design(kh: int, kw: int, ci: int, co: int, dtype: torch.dtype) -> str:
    """Which kernel design a weight gradient takes on the card: a fixed rule
    on the shape. "strip" for float32 kernels of 25 taps or more over at
    most 16 input and 16 output channels (the transform net's two 9x9
    convs, whose tile-design gathers read each X value once per tap), as
    far as the strip kernel holds kh*kw*ci in registers; "tile" for the
    rest, and for bfloat16."""
    strip = dtype == torch.float32 and kh * kw >= 25 and ci <= 16 and co <= 16 and kh * kw * ci <= STRIP_P_MAX
    return "strip" if strip else "tile"


def strip_forms(kh: int, kw: int, ci: int, co: int, stride: int) -> list[str]:
    """The forms the strip kernels take at this shape: "pixels" (the
    pixels on K, the im2col columns (kh, kw, i) on M, each landed stage
    split into TF32 hi and lo parts once) and, at stride 1 with kw*co <= 32,
    "kn" (kw on the N side: C[(kh, i), (kw, o)])."""
    kn_ok = stride == 1 and kw * co <= 32 and kh * ci <= 16 * STRIP_KN_MT[-1]
    return ["pixels"] + ["kn"] * kn_ok


def strip_form(kh: int, kw: int, ci: int, co: int, stride: int) -> str:
    """The form a strip shape takes: kw on N where it fits, the faster
    form at the train step's final 9x9 on an H100 (PERF.md section 6)."""
    return strip_forms(kh, kw, ci, co, stride)[-1]


class StripPlan(NamedTuple):
    """How one strip-design call is cut and laid out in shared memory.

    A strip is `r` output rows x `wt` output columns of one image (`sy` x
    `sx` strips an image, `strips` in all); its X patch is `pr` x `pc`
    cells of ci floats, row pitch `rp` floats, and its dY rows `r*wt`
    pixels of pitch `dp` floats. `swz` (8 or 0) swaps a patch column's
    channel halves by bit 1 of the column, `dswz` a dY pixel's by bit 1 of
    the pixel. `blocks` blocks walk `per` consecutive strips each through
    a ring of `smem` bytes: two stages of `raw` floats, and for "pixels" a
    third for the lo parts. Each warp holds `mt` m16 tiles and `nt` n8
    tiles."""

    form: str
    r: int
    wt: int
    pr: int
    pc: int
    rp: int
    dp: int
    swz: int
    dswz: int
    sy: int
    sx: int
    strips: int
    per: int
    blocks: int
    mt: int
    nt: int
    raw: int
    smem: int

    @property
    def launches(self) -> int:
        """Kernel launches per call: the strip kernel, plus the reduce when split."""
        return 1 if self.blocks == 1 else 2


def _strip_layout(form: str, r: int, wt: int, ci: int, co: int, kh: int, kw: int, stride: int):
    pr, pc = (r - 1) * stride + kh, (wt - 1) * stride + kw
    if form == "kn":
        pc = _cdiv(pc, 8) * 8  # k8 steps over whole patch columns
    rp = _cdiv(pc * ci, 4) * 4  # 16-byte rows
    dp = 8 if co <= 8 else 16  # lanes t*dp + g hit 32 banks (with dswz for 16)
    raw = pr * rp + r * wt * dp
    return pr, pc, rp, dp, raw, (2 if form == "kn" else 3) * raw * 4


def _park_floats(form: str, mt: int) -> int:
    """Floats the kw-on-N kernel parks its row groups' sums in (in the ring)."""
    if form != "kn":
        return 0
    nw = 4 // KN_NT
    return (8 // nw - 1) * nw * mt * KN_NT * 128


@functools.cache
def strip_plan(n: int, oh: int, ow: int, ci: int, co: int, kh: int, kw: int, stride: int, in_bytes: int,
               num_sms: int, form: str | None = None) -> StripPlan:
    """The strip design's plan for dY [n, oh, ow, co] of X (ci channels,
    X and dY together `in_bytes` long) and a kh x kw kernel at `stride`, on
    a card with `num_sms` SMs, in `form` (None: `strip_form`'s). Strips are
    STRIP_ROWS rows by the width (a multiple of 8, at most 64) that pads ow
    least, the widest on a tie, of those whose ring lets two blocks share an
    SM (else one). The blocks fill the card's slots, each walking an equal
    run of strips, and their partials (blocks x p x co float32) never
    outweigh half the input, the byte budget of `plan`."""
    p = kh * kw * ci
    if design(kh, kw, ci, co, torch.float32) != "strip":
        raise ValueError(f"conv_weight_grad: no strip design for a {kh}x{kw} kernel, ci {ci}, co {co}")
    form = strip_form(kh, kw, ci, co, stride) if form is None else form
    if form not in strip_forms(kh, kw, ci, co, stride):
        raise ValueError(f"conv_weight_grad: no strip form {form} for a {kh}x{kw} kernel at stride {stride}, "
                         f"ci {ci}, co {co}")
    if form == "kn":
        mt, nt = next(m for m in STRIP_KN_MT if 16 * m >= kh * ci), KN_NT
    else:
        mt, nt = next(m for m in STRIP_MT if 8 * 16 * m >= p), _cdiv(co, 8)
    r = min(STRIP_ROWS, oh)
    best = None
    for resident in (2, 1):
        budget = min(SMEM_MAX, SM_SHARED // resident - 1024)
        for wt in range(8, min(64, _cdiv(ow, 8) * 8) + 1, 8):
            _, _, _, _, raw, smem = _strip_layout(form, r, wt, ci, co, kh, kw, stride)
            fits = smem <= budget and _park_floats(form, mt) <= 2 * raw
            if fits and (best is None or _cdiv(ow, wt) * wt <= _cdiv(ow, best) * best):
                best = wt
        if best is not None:
            break
    if best is None:
        raise ValueError(f"conv_weight_grad: no strip of a {kh}x{kw} kernel at stride {stride} fits shared memory")
    wt = best
    pr, pc, rp, dp, raw, smem = _strip_layout(form, r, wt, ci, co, kh, kw, stride)
    sy, sx = _cdiv(oh, r), _cdiv(ow, wt)
    strips = n * sy * sx
    cap = max(1, (in_bytes // 2) // (p * co * 4))
    per = _cdiv(strips, min(strips, num_sms * resident, cap))
    swz = 8 if ci == 16 and stride == 1 else 0
    dswz = 8 if co > 8 else 0
    return StripPlan(form, r, wt, pr, pc, rp, dp, swz, dswz, sy, sx, strips, per, _cdiv(strips, per), mt, nt,
                     raw, smem)


def patch_index(pl: StripPlan, ci: int, row, col, ch):
    """Where patch cell (row, col, channel) lies in its ring stage, in
    floats (ints or integer tensors): the kernels' layout."""
    return row * pl.rp + col * ci + (ch ^ (((col >> 1) & 1) * pl.swz))


def dy_index(pl: StripPlan, pixel, o):
    """Where output channel o of the strip's pixel (row * wt + column) lies
    in the stage's dY rows, in floats."""
    return pixel * pl.dp + (o ^ (((pixel >> 1) & 1) * pl.dswz))


def strip_offsets(pl: StripPlan, kh: int, kw: int, ci: int, stride: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixels on K: (qoff [r*wt], poff [4, kh*kw*ci]), so that im2col
    element (pixel q of a strip, column p = (kh, kw, i)) is
    patch[qoff[q] + poff[q % 4, p]], as the kernel reads it in place. Lane
    t of a k8 step takes pixels of column t (mod 4), which fixes a cell's
    swizzle (stride 1) by t.
    Kw on N: (qoff [r*pc], poff [4, kh*ci]), so that A[(kh, i), patch
    column x' of row y] is patch[qoff[y*pc + x'] + poff[x' % 4, (kh, i)]]."""
    t = torch.arange(4)[:, None]
    if pl.form == "kn":
        q = torch.arange(pl.r * pl.pc)
        qoff = (q // pl.pc) * pl.rp + (q % pl.pc) * ci
        m = torch.arange(kh * ci)
        poff = m // ci * pl.rp + (m % ci ^ (((t >> 1) & 1) * pl.swz))
        return qoff, poff
    q = torch.arange(pl.r * pl.wt)
    qoff = (q // pl.wt) * stride * pl.rp + (q % pl.wt) * stride * ci
    m = torch.arange(kh * kw * ci)
    ky, kx, ch = m // ci // kw, m // ci % kw, m % ci
    poff = ky * pl.rp + kx * ci + (ch ^ ((((t + kx) >> 1) & 1) * pl.swz))
    return qoff, poff


def _check(x: torch.Tensor, dy: torch.Tensor, kernel_size, stride: int, padding) -> None:
    if x.device != dy.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_weight_grad: x on {x.device}, dy on {dy.device}")
    if x.dim() != 4 or dy.dim() != 4 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"conv_weight_grad: expected NHWC x and dy, got {tuple(x.shape)}, {tuple(dy.shape)}")
    if x.dtype != dy.dtype or x.dtype not in (torch.float32, torch.bfloat16, torch.float64):
        raise TypeError(f"conv_weight_grad: x {x.dtype} and dy {dy.dtype} must be one of float32, bfloat16")
    (kh, kw), (ph, pw) = kernel_size, padding
    _, h, w, _ = x.shape
    want = (out_size(h, kh, stride, ph), out_size(w, kw, stride, pw))
    if tuple(dy.shape[1:3]) != want:
        raise ValueError(f"conv_weight_grad: dy {tuple(dy.shape)} does not match x {tuple(x.shape)}, "
                         f"kernel {kernel_size}, stride {stride}, padding {padding} (want {want})")


def conv_weight_grad_plain(x: torch.Tensor, dy: torch.Tensor, kernel_size, stride: int, padding) -> torch.Tensor:
    """The plain version: im2col of X (unfold) times the rows of dY, summed
    in float32 (float64 for float64 input). Returns [co, ci, kh, kw]."""
    _check(x, dy, kernel_size, stride, padding)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    n, _, _, ci = x.shape
    co = dy.shape[3]
    cols = F.unfold(x.permute(0, 3, 1, 2).to(acc), kernel_size, padding=padding, stride=stride)  # [n, ci*kh*kw, L]
    rows = dy.to(acc).reshape(n, -1, co)  # [n, L, co]
    return torch.einsum("nkl,nlo->ok", cols, rows).reshape(co, ci, *kernel_size)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("conv_wgrad")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fs_conv_wgrad.argtypes = [
        ptr, ptr, ptr, ptr, i32,  # x, dy, partial, out, is_bf16
        i32, i32, i32, i32,  # n, h, w, ci
        i32, i32, i32,  # oh, ow, co
        i32, i32, i32, i32, i32,  # kh, kw, s, ph, pw
        i32, ctypes.c_longlong, i32,  # splits, chunk, tile_c
        i32, i32, i32, i32, i32,  # design, strip_r, strip_w, patch_cols, row_pitch
        i32, i32, i32, i32, i32,  # dy_pitch, swz, dswz, strips_per_block, mt
        ptr,  # stream
    ]
    lib.fs_conv_wgrad.restype = ctypes.c_int
    lib.fs_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fs_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def num_sms(device_index: int) -> int:
    """The card's SM count, read once per device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """t as a contiguous NHWC tensor, counting the copies it takes."""
    global relayouts
    if t.is_contiguous():
        return t
    relayouts += 1
    return t.contiguous()


DESIGNS = ("tile", "strip")
_rule = design


def conv_weight_grad_cuda(x: torch.Tensor, dy: torch.Tensor, kernel_size, stride: int, padding, *,
                          design: str | None = None, form: str | None = None) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors: the design `design` gives
    (the rule, for None) or the one named ("tile" or "strip"; a strip the
    shape does not take raises), a strip in `form` (None: `strip_form`'s)."""
    global launches
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv_weight_grad: the kernel takes float32 or bfloat16, got {x.dtype}")
    (kh, kw), (ph, pw) = kernel_size, padding
    n, h, w, ci = x.shape
    _, oh, ow, co = dy.shape
    chosen = _rule(kh, kw, ci, co, x.dtype) if design is None else design
    if chosen not in DESIGNS or (chosen == "strip" and _rule(kh, kw, ci, co, x.dtype) != "strip"):
        raise ValueError(f"conv_weight_grad: no {chosen!r} design for a {kh}x{kw} kernel, ci {ci}, co {co}, {x.dtype}")
    if form is not None and chosen != "strip":
        raise ValueError(f"conv_weight_grad: form {form!r} names a strip form, but the design is {chosen!r}")
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return conv_weight_grad_cuda(x, dy, kernel_size, stride, padding, design=chosen, form=form)
    x, dy = _nhwc(x), _nhwc(dy)
    p = kh * kw * ci
    in_bytes = (x.numel() + dy.numel()) * x.element_size()
    if chosen == "strip":
        sp = strip_plan(n, oh, ow, ci, co, kh, kw, stride, in_bytes, num_sms(dev.index), form)
        splits, chunk, tile_c = sp.blocks, 0, 0
        strip_args = (2 if sp.form == "kn" else 1, sp.r, sp.wt, sp.pc, sp.rp, sp.dp, sp.swz, sp.dswz, sp.per,
                      sp.mt)
    else:
        pl = plan(n * oh * ow, p, co, in_bytes, num_sms(dev.index))
        splits, chunk, tile_c = pl.splits, pl.chunk, pl.tile_c
        strip_args = (0,) * 10
    out = torch.empty((co, ci, kh, kw), dtype=torch.float32, device=dev)
    partial = torch.empty(splits * p * co, dtype=torch.float32, device=dev) if splits > 1 else None
    lib = _lib()
    err = lib.fs_conv_wgrad(
        x.data_ptr(), dy.data_ptr(), None if partial is None else partial.data_ptr(), out.data_ptr(),
        int(x.dtype == torch.bfloat16), n, h, w, ci, oh, ow, co, kh, kw, stride, ph, pw,
        splits, chunk, tile_c, *strip_args, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.fs_cuda_error_string(err).decode()
        raise RuntimeError(f"conv_wgrad {chosen} kernel launch failed: {msg} (cuda error {err})")
    launches += 1
    return out


def conv_weight_grad(x: torch.Tensor, dy: torch.Tensor, kernel_size, stride: int = 1, padding=(0, 0)) -> torch.Tensor:
    """NHWC x [n,h,w,ci] and dy [n,oh,ow,co] -> dW [co, ci, kh, kw] float32:
    the kernel on a CUDA tensor, the plain version on a CPU one."""
    kernel_size, padding = tuple(kernel_size), tuple(padding)
    _check(x, dy, kernel_size, stride, padding)
    if x.is_cuda:
        return conv_weight_grad_cuda(x, dy, kernel_size, stride, padding)
    return conv_weight_grad_plain(x, dy, kernel_size, stride, padding)
