"""The port's input pipeline and metrics logger on the CPU: the image-dir
batcher's shapes and epochs, device_prefetch's hand-over, failure
propagation and teardown, and the CSV logger (the same contracts the JAX
package's copies keep)."""

import csv
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from faststyle_tpu_torch.data import pipeline  # noqa: E402
from faststyle_tpu_torch.utils import image_io  # noqa: E402
from faststyle_tpu_torch.utils.logging import MetricsLogger, unique_run_name  # noqa: E402


@pytest.fixture
def image_dir(tmp_path, rng):
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(5):
        image_io.imwrite(d / f"{i}.png", rng.integers(0, 256, (20 + i, 24, 3), dtype=np.uint8))
    (d / "notes.txt").write_text("not an image")
    return d


def test_image_dir_batcher_epochs_and_shapes(image_dir):
    """5 images x 2 epochs in batches of 2 (remainder dropped): 5 batches of
    float32 RGB resized to the requested shape."""
    batcher = pipeline.image_dir_batcher(
        image_dir, batch_size=2, resize_shape=(16, 12), n_epochs=2, min_after_dequeue=3, seed=1
    )
    batches = list(batcher)
    assert len(batches) == 5
    for b in batches:
        assert b.shape == (2, 16, 12, 3) and b.dtype == np.float32
        assert 0.0 <= b.min() and b.max() <= 255.0


def test_batcher_is_seeded(image_dir):
    def run(seed):
        return np.stack(list(pipeline.image_dir_batcher(
            image_dir, batch_size=1, resize_shape=(8, 8), n_epochs=1, min_after_dequeue=2, seed=seed
        )))

    np.testing.assert_array_equal(run(3), run(3))


def test_decode_resize_rejects_garbage():
    assert pipeline._decode_resize(b"not an image", (8, 8)) is None


def test_bounded_map_keeps_order_on_an_endless_stream():
    from concurrent.futures import ThreadPoolExecutor
    from itertools import count, islice

    with ThreadPoolExecutor(2) as pool:
        it = pipeline._bounded_map(pool, lambda v: v * v, count(), depth=3)
        assert list(islice(it, 6)) == [0, 1, 4, 9, 16, 25]
        it.close()


def test_device_prefetch_hands_over_tensors():
    src = [np.full((2, 4, 4, 3), i, np.float32) for i in range(4)]
    got = list(pipeline.device_prefetch(iter(src), depth=2, device="cpu"))
    assert len(got) == 4
    for i, t in enumerate(got):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        assert float(t.max()) == i


def test_device_prefetch_propagates_source_failure():
    def src():
        yield np.zeros((1, 2, 2, 3), np.float32)
        raise OSError("disk gone")

    it = pipeline.device_prefetch(src(), device="cpu")
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_device_prefetch_teardown_closes_source_and_stops_thread():
    """Abandoning the consumer stops the feeder and runs the source's own
    cleanup, so no thread or buffer outlives the loop."""
    closed = threading.Event()

    def src():
        try:
            while True:
                yield np.zeros((1, 2, 2, 3), np.float32)
        finally:
            closed.set()

    before = threading.active_count()
    it = pipeline.device_prefetch(src(), depth=1, device="cpu")
    next(it)
    it.close()
    assert closed.wait(timeout=10)
    assert threading.active_count() == before


def test_device_prefetch_default_device_is_cuda():
    it = pipeline.device_prefetch(iter([np.zeros((1, 2, 2, 3), np.float32)]))
    if torch.cuda.is_available():
        assert next(it).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            next(it)


def test_metrics_logger_resume_keeps_columns(tmp_path):
    assert unique_run_name(tmp_path, "m") == "m0"
    assert unique_run_name(tmp_path, "m") == "m1"
    log1 = MetricsLogger(tmp_path, "runA", echo=False, tensorboard=False)
    log1.log(1, {"loss": 1.0, "style_loss": 2.0})
    log1.log(2, {"loss": 0.5, "style_loss": 1.0})
    log1.close()
    log2 = MetricsLogger(tmp_path, "runA", echo=False, tensorboard=False)
    log2.log(3, {"style_loss": 0.7, "loss": 0.3, "brand_new": 9.0})
    log2.log(4, {"loss": 0.2})
    log2.close()
    with open(tmp_path / "runA" / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["step"] for r in rows] == ["1", "2", "3", "4"]
    assert rows[2]["loss"] == "0.3" and rows[2]["style_loss"] == "0.7"
    assert "brand_new" not in rows[0]
    assert rows[3]["style_loss"] == ""
    assert float(rows[1]["steps_per_sec"]) > 0
