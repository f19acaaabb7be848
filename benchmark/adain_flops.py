"""Operations and bytes of the AdaIN configuration from its shapes: the
benchmark's own count (`flops.py` counts the transform net's).

A served frame runs the encoder to relu4_1 on the content (the styles are
encoded in set-up) and the decoder: 19 convolutions, each counted as 2 *
OH * OW * K * K * CI * CO (the bias is not counted, nor by
FlopCounterMode), over its reflect-padded input. Bytes: the padded input
read once, the weights read once and the output written once, in the
compute dtype. As the port runs them, each 3x3 conv over an extent of 2 or
more also has two edge convs (`kind` "edge"), which recompute its first
and last rows and columns from 6-px strips: 4 output rows of the width and
4 columns of the height; `frame_flops` counts the model's 19 alone. The
content's AdaIN is bound by its bytes: the relu4_1 features read twice
(moments, then the apply) and written once.
"""

from __future__ import annotations

from benchmark.flops import ConvWork, _cdiv, _conv


def _work(name: str, hh: int, ww: int, k: int, ci: int, co: int, nb: int) -> list[ConvWork]:
    """A stride-1 conv with a reflect pad of k // 2 over hh x ww, and the
    port's edge convs for a 3x3 over 2 x 2 or more."""
    pad = k // 2
    work = [ConvWork("fwd", name, _conv(1, hh, ww, k * k, ci, co),
                     nb * ((hh + 2 * pad) * (ww + 2 * pad) * ci + k * k * ci * co + hh * ww * co))]
    if k == 3 and hh >= 2 and ww >= 2:
        for n, other in ((ww, hh), (hh, ww)):  # the rows' strip, then the columns'
            work.append(ConvWork("edge", name, _conv(1, 4, n, 9, ci, co),
                                 nb * (6 * (n + 2) * ci + 9 * ci * co + 4 * n * co)))
    return work


def convs(model: dict, h: int, w: int, dtype_bytes: int = 2) -> list[ConvWork]:
    """One served frame's convolutions as the port runs them, encoder then
    decoder, each model conv followed by its edge convs."""
    work = []
    hh, ww = h, w
    for name, k, ci, co in model["encoder"]:
        work += _work(name, hh, ww, k, ci, co, dtype_bytes)
        if name in model["pool_after"]:
            hh, ww = _cdiv(hh, 2), _cdiv(ww, 2)
    for name, k, ci, co in model["decoder"]:
        work += _work(name, hh, ww, k, ci, co, dtype_bytes)
        if name in model["upsample_after"]:
            hh, ww = 2 * hh, 2 * ww
    return work


def features_shape(model: dict, h: int, w: int) -> tuple[int, int, int]:
    """(h, w, c) of relu4_1 for an h x w frame."""
    for _ in model["pool_after"]:
        h, w = _cdiv(h, 2), _cdiv(w, 2)
    return h, w, model["encoder"][-1][3]


def output_shape(model: dict, h: int, w: int) -> tuple[int, int]:
    fh, fw, _ = features_shape(model, h, w)
    scale = 2 ** len(model["upsample_after"])
    return scale * fh, scale * fw


def frame_flops(model: dict, h: int, w: int) -> int:
    """The model's 19 convolutions: the edge convs are the port's overhead."""
    return sum(c.flops for c in convs(model, h, w) if c.kind == "fwd")


def norm_bytes(model: dict, h: int, w: int, dtype_bytes: int = 2) -> int:
    """The content AdaIN's least bytes: relu4_1 read twice, written once."""
    fh, fw, c = features_shape(model, h, w)
    return 3 * dtype_bytes * fh * fw * c
