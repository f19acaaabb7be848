"""The port's spans (`faststyle_tpu_torch.utils.profiling.span`) on the CPU:
off outside a profiler (a shared no-op that reads no clock and enters no
record_function), on in every thread while torch.profiler records, nested
with parents and ids, stamped on the profiler's clock, emitted where the
stream pipeline, the train step and the Batcher do their work, and written
into `profiling.trace()`'s Chrome trace."""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from faststyle_tpu_torch.utils import profiling  # noqa: E402


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _new(before: list) -> list:
    """The spans recorded since `before` was taken."""
    seen = set(before)
    return [s for s in profiling.recorded() if s not in seen]


@pytest.fixture
def no_record_function(monkeypatch):
    """A span that entered torch's record_function would raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("a span entered record_function")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def test_off_is_the_shared_no_op(monkeypatch, no_record_function):
    """Outside a profiler: the same no-op object every time, no clock read,
    nothing recorded, on the main thread and on another."""
    before = profiling.recorded()
    clock_reads = []
    monkeypatch.setattr(profiling.time, "time_ns", lambda: clock_reads.append(1) or 0)
    assert profiling.span("a") is profiling.span("b", 3) is profiling._NO_SPAN

    def work():
        with profiling.span("outer", 1):
            with profiling.span("inner"):
                pass

    work()
    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert clock_reads == []
    assert profiling.recorded() == before


def test_spans_nest_with_parents_and_ids_on_every_thread(no_record_function):
    """Under torch.profiler: the enclosing span on the same thread is the
    parent, a child without an id takes its parent's, and a thread started
    inside the profile (which torch's thread-local check calls unprofiled)
    records too, on its own id."""
    before = profiling.recorded()
    with _profile():
        with profiling.span("outer", 7):
            with profiling.span("inner"):
                with profiling.span("leaf", 8):
                    pass

        def worker():
            assert not torch.autograd._profiler_enabled()
            with profiling.span("worker.outer"):
                with profiling.span("worker.inner", 2):
                    pass

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    with profiling.span("after"):
        pass
    got = {s.name: s for s in _new(before)}
    assert set(got) == {"outer", "inner", "leaf", "worker.outer", "worker.inner"}
    assert [(got[n].parent, got[n].id) for n in ("outer", "inner", "leaf")] == [(None, 7), ("outer", 7), ("inner", 8)]
    assert [(got[n].parent, got[n].id) for n in ("worker.outer", "worker.inner")] == [(None, None), ("worker.outer", 2)]
    main, other = got["outer"].thread, got["worker.outer"].thread
    assert main == threading.get_native_id() and other != main and got["worker.inner"].thread == other
    for name in ("inner", "leaf"):
        assert got["outer"].start_ns <= got[name].start_ns <= got[name].end_ns <= got["outer"].end_ns


def test_a_span_encloses_the_profilers_event_of_its_work():
    """The spans' clock is the profiler's: a span around a matmul encloses
    the trace's aten::mm event."""
    x = torch.ones(64, 64)
    before = profiling.recorded()
    with _profile() as prof:
        with profiling.span("matmul"):
            x @ x
    (mm,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    (sp,) = _new(before)
    assert sp.start_ns <= mm.start_ns() <= mm.start_ns() + mm.duration_ns() <= sp.end_ns


@pytest.mark.parametrize("packed", [False, True])
def test_frame_pipeline_spans_share_the_frames_id(packed):
    """Each frame records stream.submit (slot_wait, pack, launch) and
    stream.fetch (result_wait, unpack), all with its sequence number."""
    from faststyle_tpu_torch.cli.stylize_webcam import FramePipeline
    from faststyle_tpu_torch.inference import Stylizer
    from faststyle_tpu_torch.models import transform_net

    params = transform_net.init_params(torch.Generator().manual_seed(0), device="cpu")
    stylizer = Stylizer(params=params, output_uint8=True, packed_input=packed, packed_output=packed, device="cpu")
    pipe = FramePipeline(stylizer, 44, 52, depth=1)
    frame = np.random.default_rng(0).integers(0, 256, (44, 52, 3), dtype=np.uint8)
    pipe.submit(frame)
    pipe.fetch()  # frame 0, before the profile: not recorded
    before = profiling.recorded()
    with _profile():
        for _ in range(3):
            pipe.submit(frame)
        pipe.clear()
    spans = [s for s in _new(before) if s.name.startswith("stream.")]
    children = {"stream.submit": ["stream.slot_wait", "stream.pack", "stream.launch"],
                "stream.fetch": ["stream.result_wait", "stream.unpack"]}
    for seq in (1, 2, 3):
        mine = [s for s in spans if s.id == seq]
        assert sorted(s.name for s in mine) == sorted([*children, *sum(children.values(), [])])
        for parent, names in children.items():
            assert [s.name for s in mine if s.parent == parent] == names  # in the order they ended
    assert all(s.id in (1, 2, 3) for s in spans)


def test_train_step_spans_carry_the_step():
    """One CPU step of the recipe records train.step with state.step as id,
    around train.forward, train.backward and train.optimizer, in that order."""
    step, state = profiling.recipe_step(16, device="cpu")
    batch = torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(0)) * 255
    step(state, batch)
    state.step = 41
    before = profiling.recorded()
    with _profile():
        step(state, batch)
    spans = [s for s in _new(before) if s.name.startswith("train.")]
    assert [(s.name, s.parent, s.id) for s in spans] == [
        ("train.forward", "train.step", 41), ("train.backward", "train.step", 41),
        ("train.optimizer", "train.step", 41), ("train.step", None, 41)]
    assert state.step == 42
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans[:2], spans[1:3]))


def test_batcher_decodes_and_feeds_on_its_threads(tmp_path):
    """A Batcher over a small shard, through device_prefetch, under the
    profiler: one data.decode a record on the decode threads, data.to_device
    a batch on the feeder thread, none on the main thread."""
    from faststyle_tpu_torch.data import pipeline, writer
    from faststyle_tpu_torch.utils import image_io

    photos = tmp_path / "photos"
    photos.mkdir()
    rng = np.random.default_rng(1)
    for i in range(6):
        image_io.imwrite(photos / f"{i}.jpg", rng.integers(0, 255, (24, 32, 3), dtype=np.uint8))
    shards = writer.write_dataset(photos, tmp_path / "records", num_shards=1, num_threads=1)
    batcher = pipeline.Batcher(shards, batch_size=2, resize_shape=(16, 16), n_epochs=1, min_after_dequeue=1,
                               num_decode_threads=2)
    before = profiling.recorded()
    with _profile():
        batches = list(pipeline.device_prefetch(iter(batcher), depth=2, device="cpu"))
    spans = _new(before)
    decodes = [s for s in spans if s.name == "data.decode"]
    feeds = [s for s in spans if s.name == "data.to_device"]
    assert len(batches) == 3 and len(decodes) == 6 and len(feeds) == 3
    main = threading.get_native_id()
    assert main not in {s.thread for s in decodes + feeds}
    assert not {s.thread for s in decodes} & {s.thread for s in feeds}


def test_trace_json_holds_the_program_spans(tmp_path):
    """profiling.trace() writes the block's spans beside the profiler's
    events, on the trace's time base and the threads that ran them."""
    x = torch.ones(32, 32)
    with profiling.span("before"):
        pass
    with profiling.trace(tmp_path / "tr"):
        with profiling.span("outer", 5):
            with profiling.span("inner"):
                x @ x
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert sorted(e["name"] for e in events if e.get("cat") == "program_span") == ["inner", "outer"]
    assert spans["inner"]["args"] == {"id": 5, "parent": "outer"}
    assert spans["outer"]["tid"] == threading.get_native_id()
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert spans["inner"]["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= spans["inner"]["ts"] + spans["inner"]["dur"]
