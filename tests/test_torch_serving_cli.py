"""The port's serving CLIs on the CPU at small sizes: stylize_image (one
image, a directory, --spatial) and stylize_webcam's synthetic stream
(pipeline depths, packed fetch, the fps and latency lines). Outputs are
compared bit-exact with the Stylizer they wrap, and with the JAX package's
CLI parser for the flags and defaults."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from faststyle_tpu.cli import stylize_image as jcli_image  # noqa: E402
from faststyle_tpu.cli import stylize_webcam as jcli_webcam  # noqa: E402
from faststyle_tpu_torch.cli import stylize_image, stylize_webcam  # noqa: E402
from faststyle_tpu_torch.inference import Stylizer  # noqa: E402
from faststyle_tpu_torch.utils import image_io  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STARRY = str(ROOT / "weights" / "starry_final.npz")


@pytest.mark.parametrize(
    "ours,theirs", [(stylize_image, jcli_image), (stylize_webcam, jcli_webcam)], ids=["image", "webcam"]
)
def test_flags_and_defaults_are_the_jax_clis(ours, theirs):
    mine = vars(ours.setup_parser().parse_args([]))
    ref = vars(theirs.setup_parser().parse_args([]))
    assert mine.pop("device") == "cuda"
    assert mine.pop("style_image") is None  # an AdaIN model's style; the JAX CLIs serve transform nets only
    assert mine == ref


def _image(tmp_path, name, h, w, seed=0):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    image_io.imwrite(tmp_path / name, img)
    return image_io.imread(tmp_path / name)


def test_stylize_image_single_equals_stylizer_call(tmp_path):
    img = _image(tmp_path, "in.png", 30, 37)
    out_path = tmp_path / "out" / "styled.png"
    stylize_image.main([
        "--input_img_path", str(tmp_path / "in.png"), "--output_img_path", str(out_path),
        "--model_path", STARRY, "--device", "cpu",
    ])
    want = Stylizer(STARRY, device="cpu")(img)
    assert want.shape == (32, 40, 3)  # the net's shape law
    np.testing.assert_array_equal(image_io.imread(out_path), want)


def test_stylize_image_input_dir_two_sizes(tmp_path, capsys):
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    imgs = {
        "a.png": _image(in_dir, "a.png", 24, 28, 1),
        "b.png": _image(in_dir, "b.png", 24, 28, 2),
        "c.png": _image(in_dir, "c.png", 20, 16, 3),
    }
    (in_dir / "notes.txt").write_text("not an image")
    done = stylize_image.main([
        "--input_dir", str(in_dir), "--output_dir", str(tmp_path / "out"), "--model_path", STARRY,
        "--batch_size", "8", "--device", "cpu",
    ])
    assert done == 3
    lines = capsys.readouterr().out.splitlines()
    assert "2/3 done (28x24)" in lines and "3/3 done (16x20)" in lines
    s = Stylizer(STARRY, output_uint8=True, device="cpu")
    for name, img in imgs.items():
        np.testing.assert_array_equal(image_io.imread(tmp_path / "out" / f"styled_{name}"), s(img))


def test_stylize_image_spatial_is_not_yet_ported(tmp_path):
    """--spatial is ported now; what it still refuses is --input_dir beside
    it, with the JAX CLI's text, checked before any image is read."""
    with pytest.raises(SystemExit, match="--spatial shards ONE image's rows; with --input_dir use the default "
                                         "batch-sharded mode \\(images spread across chips\\)"):
        stylize_image.main(["--input_dir", str(tmp_path / "missing"), "--spatial", "--device", "cpu"])


def test_stylize_image_spatial_equals_the_plain_cli(tmp_path, capsys):
    """On one CPU entry --spatial runs 1-way, the single-device forward: its
    PNG is the plain CLI's within one count."""
    _image(tmp_path, "in.png", 48, 37)
    outs = {}
    for name, extra in (("plain", []), ("spatial", ["--spatial"])):
        stylize_image.main([
            "--input_img_path", str(tmp_path / "in.png"), "--output_img_path", str(tmp_path / f"{name}.png"),
            "--model_path", STARRY, "--device", "cpu", *extra,
        ])
        outs[name] = image_io.imread(tmp_path / f"{name}.png")
    assert "Evaluating (1-way row sharding)..." in capsys.readouterr().out
    assert outs["spatial"].shape == outs["plain"].shape == (48, 40, 3)
    assert np.abs(outs["spatial"].astype(int) - outs["plain"].astype(int)).max() <= 1


@pytest.mark.parametrize("extra", [[], ["--packed_fetch"]], ids=["plain", "packed"])
def test_webcam_synthetic_depths_emit_every_frame_in_order(capsys, extra):
    """Depth 3 emits every frame, in order, equal to depth 1's; both print
    the fps and latency lines; --packed_fetch emits the same frames."""
    runs = {}
    for depth in (1, 3):
        frames = []
        res = stylize_webcam.main(
            ["--model_path", STARRY, "--num_synthetic_frames", "4", "--resolution", "64", "48",
             "--no_display", "--report_latency", "--pipeline_depth", str(depth), "--device", "cpu", *extra],
            on_frame=lambda f: frames.append(f.copy()),
        )
        out = capsys.readouterr().out
        assert "4 frames in " in out and " fps" in out
        assert "per-frame latency p50 " in out and " ms / p99 " in out
        assert res["frames"] == 4 and res["p50_ms"] <= res["p99_ms"]
        runs[depth] = frames
    assert len(runs[1]) == len(runs[3]) == 4
    s = Stylizer(STARRY, compute_dtype=torch.bfloat16, output_uint8=True, device="cpu")  # the CLI's default
    synth = list(stylize_webcam.synthetic_frames(4, 48, 64))
    for i in range(4):
        assert runs[1][i].shape == (48, 64, 3)
        np.testing.assert_array_equal(runs[3][i], runs[1][i])
        np.testing.assert_array_equal(runs[1][i], s(synth[i]))


def test_webcam_video_file_max_frames(tmp_path, capsys):
    cv2 = pytest.importorskip("cv2")
    path = tmp_path / "in.avi"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (64, 48))
    for i in range(6):
        writer.write(np.full((48, 64, 3), 40 * i, np.uint8))
    writer.release()
    frames = []
    res = stylize_webcam.main(
        ["--model_path", STARRY, "--video_path", str(path), "--max_frames", "4", "--no_display",
         "--output_path", str(tmp_path / "out.avi"), "--pipeline_depth", "2", "--device", "cpu"],
        on_frame=lambda f: frames.append(f.copy()),
    )
    assert res["frames"] == len(frames) == 4
    assert "4 frames in " in capsys.readouterr().out
    assert (tmp_path / "out.avi").exists()
