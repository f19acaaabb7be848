"""The strip design of the weight-gradient kernel (ops/cuda/conv_wgrad.py,
csrc/conv_wgrad.cu), on the CPU: its plan, its shared-memory layout and
its route by shape. The kernel runs only on the card; here a plain walk of
the plan reads the im2col through the same qoff / poff arithmetic and is
held to the plain weight gradient at 1e-12 of max |dW| in float64 (the same
products, summed in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from faststyle_tpu_torch.ops.cuda import conv_wgrad  # noqa: E402

# (name, x NHWC, (kh, kw), stride, (ph, pw), co): the train step's two 9x9
# convs at b4@256 and the 9x9 pad-4 ragged cases of chip_smoke.py
STRIP_SHAPES = [
    ("init_0", (4, 336, 336, 3), (9, 9), 1, (4, 4), 16),
    ("final", (4, 256, 256, 16), (9, 9), 1, (4, 4), 3),
    ("ragged_co3", (2, 19, 23, 3), (9, 9), 1, (4, 4), 3),
    ("ragged_co16", (3, 41, 35, 3), (9, 9), 1, (4, 4), 16),
]


def _dims(shape, kernel, stride, pad, co):
    n, h, w, ci = shape
    oh, ow = (conv_wgrad.out_size(h, kernel[0], stride, pad[0]), conv_wgrad.out_size(w, kernel[1], stride, pad[1]))
    return n, h, w, ci, oh, ow, (n * h * w * ci + n * oh * ow * co) * 4


def _forms(shape, kernel, stride, co):
    return conv_wgrad.strip_forms(*kernel, shape[3], co, stride)


PLAN_CASES = [(c, f) for c in STRIP_SHAPES for f in _forms(c[1], c[2], c[3], c[5])]


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("case,form", PLAN_CASES, ids=[f"{c[0]}-{f}"
                                                        for c, f in PLAN_CASES])
def test_strip_plan_covers_every_pixel_once_within_its_budgets(case, form, sms):
    _, shape, kernel, stride, pad, co = case
    n, h, w, ci, oh, ow, in_bytes = _dims(shape, kernel, stride, pad, co)
    (kh, kw), (ph, pw) = kernel, pad
    sp = conv_wgrad.strip_plan(n, oh, ow, ci, co, kh, kw, stride, in_bytes, sms, form)
    assert sp.form == form
    assert sp.wt % 8 == 0 and sp.rp % 4 == 0 and sp.rp >= sp.pc * ci and sp.dp >= co
    assert sp.raw == sp.pr * sp.rp + sp.r * sp.wt * sp.dp
    assert sp.smem == (2 if form == "kn" else 3) * sp.raw * 4 <= conv_wgrad.SMEM_MAX
    assert sp.blocks == 1 or sp.blocks * kh * kw * ci * co * 4 <= in_bytes // 2
    if form == "kn":
        assert sp.pc % 8 == 0 and 16 * sp.mt >= kh * ci and kw * co <= 32
    else:
        assert 8 * 16 * sp.mt >= kh * kw * ci and 8 * sp.nt >= co
    # every output pixel in exactly one strip of exactly one block
    owner = np.full((n, oh, ow), -1)
    for b in range(sp.blocks):
        for j in range(b * sp.per, min((b + 1) * sp.per, sp.strips)):
            img, k = divmod(j, sp.sy * sp.sx)
            y0, x0 = k // sp.sx * sp.r, k % sp.sx * sp.wt
            cell = owner[img, y0:y0 + sp.r, x0:x0 + sp.wt]
            assert (cell == -1).all()
            cell[...] = b
            # the patch holds every padded X pixel the strip's taps read
            ys = np.arange(y0, min(y0 + sp.r, oh))[:, None] * stride + np.arange(kh)
            xs = np.arange(x0, min(x0 + sp.wt, ow))[:, None] * stride + np.arange(kw)
            assert ys.min() >= y0 * stride and ys.max() < y0 * stride + sp.pr
            assert xs.min() >= x0 * stride and xs.max() < x0 * stride + sp.pc
    assert (owner >= 0).all()
    assert sp.blocks == -(-sp.strips // sp.per) and (sp.blocks - 1) * sp.per < sp.strips
    if sms == 132 and sp.strips >= 2 * sms:
        assert sp.blocks >= sms  # the card's SMs all get blocks


def strip_walk(x, dy, kernel, stride, pad, form):
    """dW [co, ci, kh, kw] as the strip kernel computes it in `form`: per
    block, per strip, the patch and the strip's dY rows laid out in one
    ring stage (patch_index and dy_index, zero outside the image); A read
    in place as patch[qoff + poff]; with kw on N, B[x', (kw, o)] the dY of
    pixel x' - kw of the row where that is a pixel of the strip; the
    blocks' partials added in block order."""
    n, h, w, ci = x.shape
    _, oh, ow, co = dy.shape
    (kh, kw), (ph, pw) = kernel, pad
    sp = conv_wgrad.strip_plan(n, oh, ow, ci, co, kh, kw, stride, (x.numel() + dy.numel()) * 4, 7, form)
    qoff, poff = conv_wgrad.strip_offsets(sp, kh, kw, ci, stride)
    r, c, i = torch.meshgrid(torch.arange(sp.pr), torch.arange(sp.pc), torch.arange(ci), indexing="ij")
    at = conv_wgrad.patch_index(sp, ci, r, c, i).flatten()
    assert at.unique().numel() == at.numel()  # the swizzle is a permutation
    q, o = torch.meshgrid(torch.arange(sp.r * sp.wt), torch.arange(co), indexing="ij")
    dat = conv_wgrad.dy_index(sp, q, o).flatten()
    assert dat.unique().numel() == dat.numel() and int(dat.max()) < sp.r * sp.wt * sp.dp
    if form == "kn":
        cols = torch.arange(sp.r * sp.pc)
        a_at = qoff[:, None] + poff[cols % sp.pc % 4]  # [rows * patch columns, kh*ci]
        xr = (cols % sp.pc)[:, None] - torch.arange(kw)[:, None].repeat(1, co).flatten()  # [.., (kw, o)]
        ok = (xr >= 0) & (xr < sp.wt)
        pix = (cols // sp.pc)[:, None] * sp.wt + xr.clamp(0, sp.wt - 1)
        b_at = conv_wgrad.dy_index(sp, pix, torch.arange(co).repeat(kw))
    else:
        a_at = qoff[:, None] + poff[torch.arange(sp.r * sp.wt) % 4]  # [pixels, p]
    xpad = torch.nn.functional.pad(x, (0, 0, pw, pw + sp.pc, ph, ph + sp.pr))  # past the image: zero
    dypad = torch.nn.functional.pad(dy, (0, 0, 0, sp.wt, 0, sp.r))
    total = torch.zeros(kh * kw * ci, co, dtype=x.dtype)
    for b in range(sp.blocks):
        part = torch.zeros(kh * kw * ci, co, dtype=x.dtype)
        for j in range(b * sp.per, min((b + 1) * sp.per, sp.strips)):
            img, k = divmod(j, sp.sy * sp.sx)
            y0, x0 = k // sp.sx * sp.r, k % sp.sx * sp.wt
            stage = torch.zeros(sp.raw, dtype=x.dtype)
            stage[at] = xpad[img, y0 * stride:y0 * stride + sp.pr, x0 * stride:x0 * stride + sp.pc].flatten()
            dys = stage[sp.pr * sp.rp:]
            dys[dat] = dypad[img, y0:y0 + sp.r, x0:x0 + sp.wt].flatten()
            if form == "kn":
                bmat = torch.where(ok, dys[b_at], 0.0)  # [rows * patch columns, (kw, o)]
                c_kn = (stage[a_at].T @ bmat).reshape(kh, ci, kw, co)  # [(kh, i), (kw, o)]
                part += c_kn.permute(0, 2, 1, 3).reshape(-1, co)
            else:
                part += stage[a_at].T @ dys[conv_wgrad.dy_index(sp, q, o)]  # [pixels, co]
        total += part
    return total.reshape(kh, kw, ci, co).permute(3, 2, 0, 1)


# (x NHWC, co): 9x9 pad 4 at stride 1, ci 3 and 16 (the swizzled layout), co
# 3 and 16, and a ragged one whose strips overhang both image edges
WALK_CASES = [((2, 12, 16, 3), 16), ((1, 10, 17, 16), 3), ((2, 9, 8, 16), 16), ((1, 19, 23, 3), 3),
              ((3, 13, 11, 3), 16)]


WALK = [(s, co, f) for s, co in WALK_CASES for f in conv_wgrad.strip_forms(9, 9, s[3], co, 1)]


@pytest.mark.parametrize("shape,co,form", WALK, ids=[f"{s[3]}to{co}_{s[1]}x{s[2]}-{f}" for s, co, f in WALK])
def test_strip_walk_equals_the_plain_weight_grad(shape, co, form):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(shape))
    oh, ow = shape[1], shape[2]  # 9x9 pad 4 stride 1
    dy = torch.from_numpy(rng.standard_normal((shape[0], oh, ow, co)))
    want = conv_wgrad.conv_weight_grad_plain(x, dy, (9, 9), 1, (4, 4))
    got = strip_walk(x, dy, (9, 9), 1, (4, 4), form)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * float(want.abs().max()))


def test_strip_walk_at_stride_two():
    """The layout at s > 1 (no swizzle; pixels on K, the one form there)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 21, 19, 16)))
    oh, ow = conv_wgrad.out_size(21, 5, 2, 2), conv_wgrad.out_size(19, 5, 2, 2)
    dy = torch.from_numpy(rng.standard_normal((2, oh, ow, 5)))
    want = conv_wgrad.conv_weight_grad_plain(x, dy, (5, 5), 2, (2, 2))
    assert conv_wgrad.strip_forms(5, 5, 16, 5, 2) == ["pixels"]
    got = strip_walk(x, dy, (5, 5), 2, (2, 2), conv_wgrad.strip_form(5, 5, 16, 5, 2))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * float(want.abs().max()))


def test_strip_form_puts_kw_on_n_where_it_fits():
    assert conv_wgrad.strip_form(9, 9, 16, 3, 1) == "kn"  # final: 27 of 32 columns
    assert conv_wgrad.strip_form(9, 9, 3, 16, 1) == "pixels"  # init_0: kw*co = 144


def _train_wgrads():
    """(name, (kh, kw), ci, co) of the transform net's 16 weight gradients."""
    names = ["init_0", "init_1", "init_2"] + [f"res{i}_{j}" for i in range(5) for j in (1, 2)] + ["up_0", "up_1",
                                                                                              "final"]
    shapes = ([((9, 9), 3, 16), ((3, 3), 16, 32), ((3, 3), 32, 64)] + [((3, 3), 64, 64)] * 10
              + [((2, 2), 64, 128), ((2, 2), 32, 64), ((9, 9), 16, 3)])
    return [(n, *s) for n, s in zip(names, shapes)]


def test_design_gives_the_strip_to_the_9x9_convs_only():
    for name, kernel, ci, co in _train_wgrads():
        want = "strip" if name in ("init_0", "final") else "tile"
        assert conv_wgrad.design(*kernel, ci, co, torch.float32) == want, name
        assert conv_wgrad.design(*kernel, ci, co, torch.bfloat16) == "tile", name
    for _, shape, kernel, _, _, co in STRIP_SHAPES:
        assert conv_wgrad.design(*kernel, shape[3], co, torch.float32) == "strip"
    assert conv_wgrad.design(9, 9, 32, 3, torch.float32) == "tile"  # past 16 input channels
    assert conv_wgrad.design(3, 3, 3, 16, torch.float32) == "tile"  # 9 taps


def test_strip_plan_refuses_a_tile_shape():
    with pytest.raises(ValueError):
        conv_wgrad.strip_plan(4, 64, 64, 64, 64, 3, 3, 1, 1 << 24, 132)


def test_wrapper_refuses_a_strip_the_shape_does_not_take():
    """A CPU tensor never reaches the kernel; the named design is checked
    before anything launches."""
    x, dy = torch.zeros(1, 8, 8, 3, dtype=torch.bfloat16), torch.zeros(1, 8, 8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="strip"):
        conv_wgrad.conv_weight_grad_cuda(x, dy, (9, 9), 1, (4, 4), design="strip")
    with pytest.raises(ValueError, match="form"):
        conv_wgrad.conv_weight_grad_cuda(x.float(), dy.float(), (9, 9), 1, (4, 4), design="tile", form="kn")
