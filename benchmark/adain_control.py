"""The readings that the limits of the AdaIN stream cells are set from, on
the card at a cell's own size (not run by the benchmark's runs).

    python3 -m benchmark.adain_control --workload adain_4k_d4 --seeds 1-20 --control_seeds 1-3 --seconds 3

For each seed of `--seeds`, the program's numbers from a sound run over a
short window at the cell's own load, with a sample as large as a run's
(the lower readings). For each seed of `--control_seeds`, on the same
kept (source, style) pairs: the control, the reference put in the
program's place at the nearest precision below the configuration's (the
whole net in float8 e4m3; also bf16 convolutions with the moments of bf16
features, a reading only); and two faults planted where the frame is
produced, each frame made by the program's Stylizer: with the style the
order held before the frame's ("previous style"), and with the decoder fed
the content's features as they are ("no AdaIN", through a Stylizer set
up anew under the fault: the streamed one holds a CUDA graph of the sound
forward). One JSON line per reading
(with `clip_share_max`, the reference frames' largest share of pixels with
a channel at 0 or 255), then a summary: per number the largest sound
reading and the smallest control or fault reading.
"""

import time

_AT_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

from benchmark.control import _seeds  # noqa: E402
from benchmark.harness import Context, derive_seed  # noqa: E402
from benchmark.run import ROOT, _fix_cache_dirs  # noqa: E402
from benchmark.spec import Bench  # noqa: E402


def produced(stylizer, frames, handles, keys, style_of):
    """((key), the program's uint8 frame for key's source in style
    `style_of(key)`) for each key."""
    return [(key, stylizer(frames[key[0]], style=handles[style_of(key)])) for key in keys]


def readings(ctx_for, seeds, control_seeds, seconds):
    import torch

    from faststyle_tpu_torch.models import adain

    for seed in sorted(set(seeds) | set(control_seeds)):
        ctx = ctx_for(seed)
        driver = ctx.bench.driver(ctx.config["driver"])
        frames, styles, stylizer, handles = driver.setup(ctx)
        tr = ctx.traffic
        sample = driver.Sample(tr["check_frames"], derive_seed(seed, "sample"), seconds, (tr["height"], tr["width"], 3))
        driver.stream(ctx, frames, stylizer, handles, seconds, sample)
        kept = sample.kept
        keys = [key for key, _ in kept]
        params = driver.reference.init_params(ctx.config)
        faults = []
        if seed in control_seeds:
            faults.append(("fault_previous_style", produced(stylizer, frames, handles, keys, lambda k: k[2])))
        del stylizer, handles
        if seed in control_seeds:
            identity = adain.adain
            adain.adain = lambda feats, style: feats
            try:  # a Stylizer made under the fault: the streamed one may replay a graph of the sound forward
                _, _, faulty, faulty_handles = driver.setup(ctx)
                faults.append(("fault_no_adain", produced(faulty, frames, faulty_handles, keys, lambda k: k[1])))
                del faulty, faulty_handles
            finally:
                adain.adain = identity
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        compare = lambda outs: driver.compare(outs, frames, styles, params, ctx.device)  # noqa: E731
        if seed in seeds:
            yield seed, "program", compare(kept), len(kept)
        if seed in control_seeds:
            for what, precision, stats in (("control_float8", "float8", "float32"),
                                           ("control_bf16_stats", "bfloat16", "bfloat16")):
                refs = driver.reference_frames(keys, frames, styles, params, ctx.device, precision, stats)
                yield seed, what, compare([(key, refs[key[:2]]) for key in keys]), len(keys)
            for what, outs in faults:
                yield seed, what, compare(outs), len(outs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1-20 or 1,5,9")
    ap.add_argument("--control_seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0, help="each run's short window")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _fix_cache_dirs(ROOT)
    import torch

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    device = torch.device(args.device)

    def ctx_for(seed):
        return Context(bench, cell, config, traffic, seed, args.seconds, False, device, _AT_START)

    seeds = _seeds(args.seeds)
    control_seeds = _seeds(args.control_seeds) if args.control_seeds else []
    lower, upper = defaultdict(float), defaultdict(lambda: float("inf"))
    for seed, what, numbers, compared in readings(ctx_for, seeds, control_seeds, args.seconds):
        print(json.dumps({"seed": seed, "what": what, "compared": compared, "numbers": numbers}), flush=True)
        for name, value in numbers.items():
            if what == "program":
                lower[name] = max(lower[name], value)
            elif what != "control_bf16_stats":
                upper[name] = min(upper[name], value)
    summary = {name: {"lower": lower.get(name), "upper": upper.get(name)} for name in sorted(set(lower) | set(upper))}
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
