"""``python -m diart_tpu_torch.console.benchmark``: batch evaluation over a
directory of files (port of ``diart_tpu/console/benchmark.py``; diart's
``console/benchmark.py``).

Runs on the GPU unless ``--cpu`` is given; without a GPU it fails. pandas
is needed only for a report (``--reference`` or ``--score-against``).
"""

import argparse
from pathlib import Path

from .. import argdoc
from .. import utils
from ..runtime import Benchmark, Parallelize
from .stream import (
    add_common_model_args,
    add_common_pipeline_args,
    apply_precision_arg,
    load_models,
)


def run():
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "root", type=Path, help="Directory with audio files CONVERSATION.(wav|flac|...)"
    )
    parser.add_argument(
        "--pipeline",
        default="SpeakerDiarization",
        type=str,
        help="Pipeline class: SpeakerDiarization | VoiceActivityDetection",
    )
    add_common_model_args(parser)
    parser.add_argument(
        "--reference",
        type=Path,
        help="Directory with RTTM files CONVERSATION.rttm (same names as audio)",
    )
    add_common_pipeline_args(parser)
    parser.add_argument("--batch-size", default=32, type=int, help=f"{argdoc.BATCH_SIZE}. Defaults to 32")
    parser.add_argument("--num-workers", default=0, type=int, help=f"{argdoc.NUM_WORKERS}. Defaults to 0")
    parser.add_argument(
        "--multi-stream",
        action="store_true",
        help="Run all files as one batched on-device engine session "
        "(the on-device replacement for --num-workers)",
    )
    parser.add_argument("--output", type=Path, help=f"{argdoc.OUTPUT}")
    parser.add_argument(
        "--score-against",
        type=Path,
        help="Score existing RTTMs in `root` against this reference RTTM "
        "file/directory and exit (no audio is processed); supports the "
        "reference repo's multi-URI corpus goldens (expected_outputs/)",
    )
    args = parser.parse_args()
    apply_precision_arg(args)

    if args.score_against is not None:
        from ..metrics.parity import score_rttm

        report = score_rttm(args.root, args.score_against, display=True)
        if args.output is not None:
            args.output.mkdir(parents=True, exist_ok=True)
            report.to_csv(args.output / "parity_report.csv")
        return

    args.segmentation, args.embedding = load_models(args)

    pipeline_class = utils.get_pipeline_class(args.pipeline)
    benchmark = Benchmark(
        args.root,
        args.reference,
        args.output,
        show_progress=True,
        show_report=True,
        batch_size=args.batch_size,
        multi_stream=args.multi_stream,
    )
    config = pipeline_class.get_config_class()(**vars(args))
    if args.num_workers > 0:
        benchmark = Parallelize(benchmark, args.num_workers)

    report = benchmark(pipeline_class, config)
    if args.output is not None and args.reference is not None:
        report.to_csv(args.output / "benchmark_report.csv")


if __name__ == "__main__":
    run()
