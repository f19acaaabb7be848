#!/usr/bin/env python3
"""Convert a flat directory of JPEG/PNG images into sharded TFRecords.

    python -m faststyle_tpu_torch.cli.tfrecords_writer \\
        --train_directory <images> --output_directory <records> \\
        --train_shards 8 --num_threads 4

The flags and defaults are faststyle_tpu's tfrecords_writer's (the
reference converter's): shards `train-XXXXX-of-NNNNN`, the deterministic
seed-12345 shuffle, and `--train_shards` divisible by `--num_threads`.
Host only: no `--device`, nothing touches a GPU.
"""

from __future__ import annotations

import argparse


def setup_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Convert images to sharded TFRecords.")
    parser.add_argument("--train_directory", default="/tmp/", help="Training data directory")
    parser.add_argument("--output_directory", default="/tmp/", help="Output data directory")
    parser.add_argument(
        "--train_shards", default=2, type=int, help="Number of shards in training TFRecord files."
    )
    parser.add_argument(
        "--num_threads", default=2, type=int, help="Number of threads to preprocess the images."
    )
    return parser


def main(argv=None):
    args = setup_parser().parse_args(argv)
    from faststyle_tpu_torch.data import writer

    return writer.write_dataset(
        args.train_directory,
        args.output_directory,
        name="train",
        num_shards=args.train_shards,
        num_threads=args.num_threads,
    )


if __name__ == "__main__":
    main()
