"""Row-sharded stylization of one large frame over a list of devices
(counterpart of faststyle_tpu/parallel/spatial.py).

`data_parallel.ShardedStylizer` spreads a batch of frames over devices for
throughput; this module spreads one frame's rows over them (4K and up) for
latency and memory. Shard i owns output rows [i*hs, (i+1)*hs). It walks
the net (`transform_net._walk_steps`) over a window of the frame,
reflect-padded once as a whole: its own rows, the 80 padded rows that the
VALID resblock convs consume, and `halo` rows on each side that soak up the
wrong values a window edge injects through the SAME convs and the upsample
taps. It keeps only its own rows. No activation crosses shards.

Instance norm is the one global coupling: its statistics span the whole
frame. At each of the 16 IN calls every shard sums the rows it owns at that
layer, the partial sums are added in shard order on the first device, and
that is the frame's mean; a second pass of squared deviations over the
owned rows gives the variance. Both are float32, and the statistics are the
single-device ones up to summation order. Every window row is normalized
with them, halo rows included, since later convs read those.

One thread drives the shards in lockstep: each shard's walk is a generator
that stops at every IN call; the thread runs every shard up to its next IN,
reduces, and sends each shard its normalized tensor. Launches are
asynchronous, so the devices run their shards together, and no thread
waits on another (a thread per shard meeting at a barrier measured
slower on an H100: `PERF.md`, the findings on sharded serving).

Exactness needs H % (4n) == 0: window starts are then multiples of 4, so
both stride-2 stages see the whole frame's phases and SAME pads.
`SpatialStylizer` shards a frame at the largest such n, down to one device
(the plain forward), rather than approximating: padding the rows to
alignment would change the frame's IN statistics. Inference only.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from faststyle_tpu_torch import inference
from faststyle_tpu_torch.models import transform_net
from faststyle_tpu_torch.ops import layers as L
from faststyle_tpu_torch.parallel.mesh import serving_devices

# one-sided reach of a window edge's wrong values into the output, in
# full-resolution rows: the 9x9 SAME convs (4 + 4), the stride-2 and the
# upsample taps. Halo 16 is exact and 8 leaks (tests/test_torch_spatial.py);
# 24 keeps a margin and is a multiple of 8
DEFAULT_HALO = 24
_PAD = 40  # the net's reflect pad per side
_EPS = 1e-3  # instance norm's, as ops/layers.instance_norm


def _in_layer_schedule(h: int) -> List[Tuple[int, int]]:
    """(global row extent, offset divisor) of each IN call, in walk order:
    the divisor maps a window's padded-row start s0 to the layer's row
    space (1 full resolution, 2 half, 4 quarter)."""
    full = h + 2 * _PAD
    half = full // 2
    q0 = full // 4
    sched = [(full, 1), (half, 2), (q0, 4)]
    for i in range(5):  # resblock INs: each VALID conv crops 2 rows
        sched.append((q0 - (4 * i + 2), 4))
        sched.append((q0 - (4 * i + 4), 4))
    sched.append((2 * (q0 - 20), 2))  # upsample_0
    sched.append((4 * (q0 - 20), 1))  # upsample_1 (== h)
    sched.append((h, 1))  # the final 9x9, IN, tanh
    return sched


class _Done(NamedTuple):
    """A shard's walk after its last IN call: its scaled-tanh output."""

    y: torch.Tensor


def _resume(walk, normed: torch.Tensor):
    """Send a walk its normalized tensor: the walk's next (x, scale, shift),
    or `_Done` once it has run to its output."""
    try:
        return walk.send(normed)
    except StopIteration as done:
        return _Done(done.value[0])


def _sum_in_order(parts: List[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The shards' partial sums added in shard order on `device`."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def _spatial_norms(
    pending: List[tuple], call: int, starts: List[int], crop: int, schedule, first: torch.device
) -> List[torch.Tensor]:
    """IN call `call` of every shard: moments over the rows each shard owns
    at that layer, summed over the shards, applied to every window row.
    `pending[i]` is shard i's (x, scale, shift); `crop` is how many padded
    rows a window is shorter than the frame."""
    global_lh, div = schedule[call]
    n = len(pending)
    owned, xfs = [], []
    for i, (x, _, _) in enumerate(pending):
        # the window's rows at this layer have global ids offset ..
        # offset+lh-1: a VALID conv crops window and frame alike
        offset, lh = starts[i] // div, x.shape[1]
        if lh != global_lh - crop // div:
            raise RuntimeError(f"IN call {call + 1}, shard {i}: {lh} window rows, the schedule's {global_lh - crop // div}")
        g0, g1 = i * global_lh // n, (i + 1) * global_lh // n
        if not offset <= g0 <= g1 <= offset + lh:
            raise RuntimeError(f"IN call {call + 1}, shard {i}: rows [{g0}, {g1}) outside [{offset}, {offset + lh})")
        xf = x.float()
        xfs.append(xf)
        owned.append(xf[:, g0 - offset : g1 - offset])
    count = float(global_lh * pending[0][0].shape[2])  # the width is never split
    mean = _sum_in_order([o.sum(dim=(1, 2), keepdim=True) for o in owned], first) / count
    means = [mean.to(o.device) for o in owned]
    var = _sum_in_order([(o - m).square().sum(dim=(1, 2), keepdim=True) for o, m in zip(owned, means)], first) / count
    outs = []
    for (x, scale, shift), xf, m in zip(pending, xfs, means):
        out = scale.float() * ((xf - m) * torch.rsqrt(var.to(x.device) + _EPS)) + shift.float()
        outs.append(out.to(x.dtype))
    return outs


def windows(h: int, n: int, halo: int = DEFAULT_HALO) -> Tuple[int, int, List[int]]:
    """(rows each shard owns, window height in padded rows, each window's
    first padded row) of an h-row frame over n shards: shard i's window
    starts `halo` rows above its own, clamped to the padded frame."""
    hs = h // n
    win = hs + 2 * _PAD + 2 * halo
    return hs, win, [min(max(i * hs - halo, 0), h + 2 * _PAD - win) for i in range(n)]


def spatial_stylize_fn(
    params: Mapping,
    h: int,
    w: int,
    devices: Sequence[str | torch.device],
    *,
    compute_dtype: torch.dtype | None = None,
    halo: int = DEFAULT_HALO,
    upsample_method: str = "resize",
) -> Callable[[np.ndarray | torch.Tensor], torch.Tensor]:
    """The row-sharded forward of an (h, w) frame, one shard per entry of
    `devices` (entries may repeat). Returns fn(img [h, w, 3] or
    [1, h, w, 3], RGB [0, 255]) -> [h, w', 3] float32 on devices[0], w'
    the net's output width."""
    if upsample_method not in transform_net.UPSAMPLE_METHODS:
        raise ValueError(f"unknown upsample_method {upsample_method!r}")
    devices = serving_devices(devices)
    n = len(devices)
    if h % (4 * n) != 0:
        raise ValueError(
            f"spatial sharding needs H % (4*n) == 0 for stride-phase "
            f"alignment; got H={h}, n={n} "
            "(SpatialStylizer auto-selects an aligned shard count)"
        )
    if halo % 4 != 0:
        raise ValueError("halo must be a multiple of 4")
    hs, win, starts = windows(h, n, halo)
    hp = h + 2 * _PAD
    if win > hp:
        raise ValueError(
            f"image too small to shard {n} ways with halo {halo}: "
            f"window {win} > padded height {hp}"
        )
    # every window must see the whole frame's stride phases: starts and
    # extent multiples of 4, and the same SAME pads at both stride-2 stages
    if win % 4 or any(s % 4 for s in starts):
        raise RuntimeError(f"window {win} or starts {starts} not multiples of 4")
    for part, whole in ((win, hp), (win // 2, hp // 2)):
        if L._same_pads(part, 3, 2) != L._same_pads(whole, 3, 2):
            raise RuntimeError(f"stride-2 SAME pads differ: window extent {part}, frame extent {whole}")
    schedule = _in_layer_schedule(h)
    replicas = {d: inference._as_torch_params(params, d) for d in dict.fromkeys(devices)}
    dtype = compute_dtype if compute_dtype is not None else torch.float32

    def fn(img: np.ndarray | torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            x = torch.as_tensor(img, device=devices[0])
            if x.ndim == 3:
                x = x[None]
            if tuple(x.shape[1:3]) != (h, w):
                raise ValueError(f"built for {h}x{w} frames, got {tuple(x.shape)}")
            padded = L.reflect_pad(x.to(dtype), _PAD)  # the whole frame's pad
            walks = [
                transform_net._walk_steps(replicas[d], padded[:, s0 : s0 + win].to(d), upsample_method)
                for d, s0 in zip(devices, starts)
            ]
            pending = [next(walk) for walk in walks]
            for call in range(len(schedule)):
                if any(isinstance(p, _Done) for p in pending):
                    raise RuntimeError(f"a walk ended after {call} IN calls; the schedule has {len(schedule)}")
                normed = _spatial_norms(pending, call, starts, hp - win, schedule, devices[0])
                pending = [_resume(walk, t) for walk, t in zip(walks, normed)]
            if not all(isinstance(p, _Done) for p in pending):
                raise RuntimeError(f"a walk has more IN calls than the schedule's {len(schedule)}")
            own = [i * hs - s0 for i, s0 in enumerate(starts)]
            return torch.cat([p.y[:, o : o + hs].to(devices[0]) for p, o in zip(pending, own)], dim=1)[0].float()

    return fn


def _single_device(params, compute_dtype, upsample_method, img) -> torch.Tensor:
    with torch.inference_mode():
        x = torch.as_tensor(img, device=params["initconv_0"]["W"].device)
        if x.ndim == 3:
            x = x[None]
        return transform_net.apply(params, x, upsample_method, compute_dtype=compute_dtype)[0].float()


class SpatialStylizer:
    """Row-sharded stylization of single large frames, one forward per
    (h, w) kept.

    A frame of height h is sharded over the largest n <= len(devices) with
    h % (4n) == 0 and a window no taller than the frame (`shards_for`); at
    n = 1 it runs the plain single-device forward. Every answer equals the
    single-device forward up to summation order. 4K (2160 rows) runs 6-way
    over 8 devices, 8K (4320) 8-way.

    `params`: torch tensors in torch layouts, or numpy arrays in the file
    layouts. `devices` defaults to every visible card; entries may repeat
    (["cuda:0"] * 4 walks four windows on one card)."""

    def __init__(
        self,
        params: Mapping,
        devices: Sequence[str | torch.device] | None = None,
        *,
        compute_dtype: torch.dtype | None = None,
        halo: int = DEFAULT_HALO,
        upsample_method: str = "resize",
    ):
        if upsample_method not in transform_net.UPSAMPLE_METHODS:
            raise ValueError(f"unknown upsample_method {upsample_method!r}")
        self.devices = serving_devices(devices)
        self._params = inference._as_torch_params(params, self.devices[0])
        self._dtype = compute_dtype
        self._halo = halo
        self._upsample = upsample_method
        self._fns: dict = {}

    def shards_for(self, h: int) -> int:
        """The largest n <= len(devices) with exact alignment and a valid
        window."""
        for n in range(len(self.devices), 0, -1):
            if h % (4 * n) == 0 and h // n + 2 * self._halo <= h:
                return n
        return 1

    def _fn(self, h: int, w: int):
        if (h, w) not in self._fns:
            n = self.shards_for(h)
            if n == 1:  # misaligned or small frame: the exact single-device forward
                self._fns[(h, w)] = functools.partial(_single_device, self._params, self._dtype, self._upsample)
            else:
                self._fns[(h, w)] = spatial_stylize_fn(
                    self._params,
                    h,
                    w,
                    self.devices[:n],
                    compute_dtype=self._dtype,
                    halo=self._halo,
                    upsample_method=self._upsample,
                )
        return self._fns[(h, w)]

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """HWC (or 1HWC) RGB [0, 255] -> stylized HWC float32 [0, 255]."""
        # float32 before dispatch, whichever n is chosen: uint8 into the
        # single-device forward would come back clipped and rounded, so a
        # pixel would depend on whether its frame's height shards
        img = np.asarray(img, np.float32)
        if img.ndim == 4:
            img = img[0]
        return self._fn(img.shape[0], img.shape[1])(img).cpu().numpy()
