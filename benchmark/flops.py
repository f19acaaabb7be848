"""Operations and bytes from shapes: the benchmark's own count, frozen.

A copy of the port's counts (`transform_net.conv_shapes`,
`utils.profiling.stylize_ops`, `bench.train_step_flops`) that reads the
sizes from a configuration file, so that no change to the program moves the
yardstick. The tests hold these counts to `FlopCounterMode` over the
program at small sizes.

A convolution is counted as the port runs it: the resize-convolutions as
their phase form (one 2x2 VALID conv with 4*co outputs over x padded by one
row and column); in float32 the data gradient as forward convolutions
(stride 1: the flipped kernel over the input's extent; stride 2: the
sub-pixel phase form); in bfloat16 as cuDNN's, counted as its forward.
Bytes: each input (activation and weight) read once and each output
written once, in the compute dtype.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ConvWork:
    """One convolution's work: what it is (`fwd`, `dgrad`, `wgrad`), where
    (`layer`), its operations and the least bytes it moves."""

    kind: str
    layer: str
    flops: int
    bytes: int
    by_kernel: bool = False  # a weight gradient that the port's conv_wgrad kernel runs

    def least_s(self, peak_flops: float, peak_bytes_per_s: float) -> float:
        return max(self.flops / peak_flops, self.bytes / peak_bytes_per_s)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _conv(n: int, oh: int, ow: int, taps: int, ci: int, co: int) -> int:
    return 2 * n * oh * ow * taps * ci * co


def transform_convs(model: dict, h: int, w: int) -> list[tuple[str, tuple[int, ...]]]:
    """The transform net's convolutions as (layer, (in_h, in_w, out_h, out_w,
    k, stride, ci, co)): the input after the reflect pad, SAME padding inside
    the conv; a resize-conv as its phase form."""
    pad = model["reflect_pad"]
    out = []
    hh, ww = h + 2 * pad, w + 2 * pad
    for i, (k, ci, co, s) in enumerate(model["init"]):
        oh, ow = _cdiv(hh, s), _cdiv(ww, s)
        out.append((f"initconv_{i}", (hh, ww, oh, ow, k, s, ci, co)))
        hh, ww = oh, ow
    width = model["resblock_width"]
    for i in range(model["resblocks"]):
        for j in (1, 2):  # 3x3 VALID
            out.append((f"resblock_{i}.{j}", (hh, ww, hh - 2, ww - 2, 3, 1, width, width)))
            hh, ww = hh - 2, ww - 2
    for i, (_k, ci, co) in enumerate(model["upsample"]):
        out.append((f"upsample_{i}", (hh + 1, ww + 1, hh, ww, 2, 1, ci, 4 * co)))
        hh, ww = 2 * hh, 2 * ww
    k, ci, co = model["final"]
    out.append((f"upsample_{len(model['upsample'])}", (hh, ww, hh, ww, k, 1, ci, co)))
    return out


def output_shape(model: dict, h: int, w: int) -> tuple[int, int]:
    """The transform net's output extent for an h x w input."""
    _, (_ih, _iw, oh, ow, *_rest) = transform_convs(model, h, w)[-1]
    return oh, ow


def stylize_convs(model: dict, h: int, w: int, dtype_bytes: int) -> list[ConvWork]:
    """One served frame's convolutions."""
    work = []
    for layer, (ih, iw, oh, ow, k, _s, ci, co) in transform_convs(model, h, w):
        work.append(ConvWork("fwd", layer, _conv(1, oh, ow, k * k, ci, co),
                             dtype_bytes * (ih * iw * ci + k * k * ci * co + oh * ow * co)))
    return work


def stylize_frame_flops(model: dict, h: int, w: int) -> int:
    return sum(c.flops for c in stylize_convs(model, h, w, 2))


def _kernel_wgrad(rule: dict | None, k: int, stride: int, ci: int) -> bool:
    """Whether the port's conv_wgrad kernel runs this weight gradient: the
    configuration's `wgrad_kernel` rule (None: cuDNN runs them all)."""
    if rule is None:
        return False
    unless = rule["unless"]
    return not (k == unless["k"] and stride == unless["stride"] and ci >= unless["min_ci"])


def vgg_convs(vgg: dict, h: int, w: int, last: str) -> list[tuple[str, int, int, int, int]]:
    """(layer, h, w, ci, co) of VGG16's 3x3 SAME convs from conv1_1 to `last`,
    with a 2x2 stride-2 SAME pool after each group."""
    out, ci = [], 3
    for gi, (co, depth) in enumerate(vgg["groups"], start=1):
        for j in range(1, depth + 1):
            name = f"conv{gi}_{j}"
            out.append((name, h, w, ci, co))
            if name == last:
                return out
            ci = co
        h, w = _cdiv(h, 2), _cdiv(w, 2)
    raise ValueError(f"no VGG16 conv {last}")


def vgg_order(vgg: dict) -> list[str]:
    return [f"conv{gi}_{j}" for gi, (_co, depth) in enumerate(vgg["groups"], start=1) for j in range(1, depth + 1)]


def train_convs(config: dict, n: int, h: int, w: int) -> list[ConvWork]:
    """Every convolution of one train step at batch n x h x w as the port
    runs it at the configuration's precision: the transform net's forward,
    weight gradients and data gradients (none for the first conv, whose
    input is the batch); VGG16 to the deepest loss layer on the stylized
    batch, forward and data gradients (VGG is frozen); VGG16 to the deepest
    content layer on the batch, forward only."""
    model, vgg, loss = config["model"], config["vgg16"], config["loss"]
    bf16 = config["precision"] == "bfloat16"
    nb = 2 if bf16 else 4
    rule = None if bf16 else config.get("wgrad_kernel")
    work = []
    for i, (layer, (ih, iw, oh, ow, k, s, ci, co)) in enumerate(transform_convs(model, h, w)):
        x, y, wt = n * ih * iw * ci, n * oh * ow * co, k * k * ci * co
        fwd = _conv(n, oh, ow, k * k, ci, co)
        work.append(ConvWork("fwd", layer, fwd, nb * (x + wt + y)))
        work.append(ConvWork("wgrad", layer, fwd, nb * (x + y + wt), _kernel_wgrad(rule, k, s, ci)))
        if i == 0:
            continue
        if bf16:
            dflops = fwd
        elif s == 1:
            dflops = _conv(n, ih, iw, k * k, co, ci)
        else:
            ph, pw = (oh - 1) * s + k - ih, (ow - 1) * s + k - iw  # SAME's total pads
            dflops = _conv(n, _cdiv(ih + ph, s), _cdiv(iw + pw, s), _cdiv(k, s) ** 2, co, s * s * ci)
        work.append(ConvWork("dgrad", layer, dflops, nb * (y + wt + x)))
    oh, ow = output_shape(model, h, w)
    layers = list(loss["content_layers"]) + list(loss["style_layers"])
    order = vgg_order(vgg)
    deepest = max(layers, key=order.index)
    for name, hh, ww, ci, co in vgg_convs(vgg, oh, ow, deepest):
        a, y, wt = n * hh * ww * ci, n * hh * ww * co, 9 * ci * co
        flops = _conv(n, hh, ww, 9, ci, co)
        work.append(ConvWork("fwd", "vgg." + name, flops, nb * (a + wt + y)))
        work.append(ConvWork("dgrad", "vgg." + name, flops, nb * (y + wt + a)))
    if loss["content_layers"]:
        deepest_content = max(loss["content_layers"], key=order.index)
        for name, hh, ww, ci, co in vgg_convs(vgg, h, w, deepest_content):
            a, y, wt = n * hh * ww * ci, n * hh * ww * co, 9 * ci * co
            work.append(ConvWork("fwd", "vgg_content." + name, _conv(n, hh, ww, 9, ci, co), nb * (a + wt + y)))
    return work


def train_step_flops(config: dict, n: int, h: int, w: int) -> int:
    """All of one train step's convolutions and the style layers' Grams,
    forward and backward (2*n*hw*c*c each). Elementwise work, instance
    norms, pools and Adam are not counted (nor by FlopCounterMode)."""
    total = sum(c.flops for c in train_convs(config, n, h, w))
    oh, ow = output_shape(config["model"], h, w)
    style = config["loss"]["style_layers"]
    deepest = max(style, key=vgg_order(config["vgg16"]).index)
    for name, hh, ww, _ci, co in vgg_convs(config["vgg16"], oh, ow, deepest):
        if name in style:
            total += 2 * 2 * n * hh * ww * co * co
    return total
