"""``python -m diart_tpu_torch.console.stream``: diarize a file or microphone
in real time (port of ``diart_tpu/console/stream.py``; diart's
``console/stream.py``).

Runs on the GPU unless ``--cpu`` is given; without a GPU it fails.
"""

import argparse
from pathlib import Path

from .. import argdoc
from .. import models as m
from .. import utils
from ..runtime import FileAudioSource, MicrophoneAudioSource, RTTMWriter, StreamingInference


def add_common_model_args(parser: argparse.ArgumentParser, embedding: bool = True):
    parser.add_argument(
        "--segmentation",
        default="tpu/pyannet",
        type=str,
        help=f"{argdoc.SEGMENTATION}. Defaults to tpu/pyannet",
    )
    parser.add_argument(
        "--powerset",
        nargs=2,
        type=int,
        metavar=("SPEAKERS", "MAX_SIMULTANEOUS"),
        help="Declare a raw torch segmentation checkpoint as powerset-encoded "
        "(e.g. --powerset 3 2 for segmentation-3.0-style models); ignored for "
        "registry models and native files (they know their own)",
    )
    if embedding:
        parser.add_argument(
            "--embedding",
            default="tpu/xvector",
            type=str,
            help=f"{argdoc.EMBEDDING}. Defaults to tpu/xvector",
        )


def add_common_pipeline_args(parser: argparse.ArgumentParser):
    parser.add_argument("--duration", default=5.0, type=float, help=f"{argdoc.DURATION}. Defaults to 5")
    parser.add_argument("--step", default=0.5, type=float, help=f"{argdoc.STEP}. Defaults to 0.5")
    parser.add_argument("--latency", default=0.5, type=float, help=f"{argdoc.LATENCY}. Defaults to 0.5")
    parser.add_argument("--tau-active", default=0.5, type=float, help=f"{argdoc.TAU}. Defaults to 0.5")
    parser.add_argument("--rho-update", default=0.3, type=float, help=f"{argdoc.RHO}. Defaults to 0.3")
    parser.add_argument("--delta-new", default=1.0, type=float, help=f"{argdoc.DELTA}. Defaults to 1")
    parser.add_argument("--gamma", default=3.0, type=float, help=f"{argdoc.GAMMA}. Defaults to 3")
    parser.add_argument("--beta", default=10.0, type=float, help=f"{argdoc.BETA}. Defaults to 10")
    parser.add_argument("--max-speakers", default=20, type=int, help=f"{argdoc.MAX_SPEAKERS}. Defaults to 20")
    parser.add_argument("--sample-rate", default=16000, type=int, help=f"{argdoc.SAMPLE_RATE}. Defaults to 16000")
    parser.add_argument(
        "--normalize-embedding-weights",
        action="store_true",
        help=f"{argdoc.NORMALIZE_EMBEDDING_WEIGHTS}. Defaults to False",
    )
    parser.add_argument("--cpu", action="store_true", help=f"{argdoc.CPU}")
    parser.add_argument("--hf-token", default="true", type=str, help=f"{argdoc.HF_TOKEN}")
    parser.add_argument("--precision", default=None, type=str, help=f"{argdoc.PRECISION}")


def apply_precision_arg(args) -> None:
    """Install the ``--precision`` policy as the process default (picked up
    by every subsequently constructed pipeline/engine). Accepts the
    ``switch=0|1,...`` spec or the literal ``portable``."""
    spec = getattr(args, "precision", None)
    if not spec:
        return
    from ..precision import Precision, set_default

    set_default(
        Precision.portable() if spec.strip() == "portable" else Precision.parse(spec)
    )


def load_models(args):
    """The segmentation and embedding models the arguments name: on the CPU
    with ``--cpu``, else on the card (which raises without one: there is
    no fallback)."""
    hf_token = utils.parse_hf_token_arg(args.hf_token)
    device = "cpu" if args.cpu else "cuda"
    powerset = tuple(args.powerset) if args.powerset else None
    return (m.SegmentationModel.from_pretrained(args.segmentation, hf_token, device=device,
                                                powerset=powerset),
            m.EmbeddingModel.from_pretrained(args.embedding, hf_token, device=device))


def run():
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "source",
        type=str,
        help="Path to an audio file | 'microphone' | 'microphone:<DEVICE_ID>'",
    )
    parser.add_argument(
        "--pipeline",
        default="SpeakerDiarization",
        type=str,
        help="Pipeline class: SpeakerDiarization | VoiceActivityDetection",
    )
    add_common_model_args(parser)
    add_common_pipeline_args(parser)
    parser.add_argument("--no-plot", dest="no_plot", action="store_true", help="Skip plotting")
    parser.add_argument("--output", type=str, help=f"{argdoc.OUTPUT}")
    args = parser.parse_args()
    apply_precision_arg(args)
    args.segmentation, args.embedding = load_models(args)

    pipeline_class = utils.get_pipeline_class(args.pipeline)
    config = pipeline_class.get_config_class()(**vars(args))
    pipeline = pipeline_class(config)

    source_components = args.source.split(":")
    if source_components[0] != "microphone":
        args.source = Path(args.source).expanduser()
        args.output = args.source.parent if args.output is None else Path(args.output)
        padding = config.get_file_padding(args.source)
        audio_source = FileAudioSource(args.source, config.sample_rate, padding, config.step)
        pipeline.set_timestamp_shift(-padding[0])
    else:
        args.output = Path("~/").expanduser() if args.output is None else Path(args.output)
        device = int(source_components[1]) if len(source_components) > 1 else None
        audio_source = MicrophoneAudioSource(config.step, device)

    inference = StreamingInference(
        pipeline,
        audio_source,
        batch_size=1,
        do_profile=True,
        do_plot=not args.no_plot,
        show_progress=True,
    )
    inference.attach_observers(
        RTTMWriter(audio_source.uri, args.output / f"{audio_source.uri}.rttm")
    )
    try:
        inference()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    run()
