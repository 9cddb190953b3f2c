"""``python -m diart_tpu_torch.console.tune``: hyper-parameter optimization
(port of ``diart_tpu/console/tune.py``; diart's ``console/tune.py``).

Studies persist to SQLite; pointing several workers at the same
``--storage`` database runs a distributed search. Runs on the GPU unless
``--cpu`` is given; without a GPU it fails. ``--multi-stream`` runs every
trial as one batched engine session, and all trials share one engine
(``Benchmark``'s engine cache; the thresholds change by
``set_hyperparameters``).
"""

import argparse
from pathlib import Path

from .. import argdoc
from .. import utils
from ..blocks.base import HyperParameter
from ..optim import Optimizer, Study
from .stream import (
    add_common_model_args,
    add_common_pipeline_args,
    apply_precision_arg,
    load_models,
)


def run():
    parser = argparse.ArgumentParser()
    parser.add_argument("root", type=Path, help="Directory with audio files")
    parser.add_argument(
        "--reference",
        required=True,
        type=Path,
        help="Directory with RTTM files CONVERSATION.rttm (same names as audio)",
    )
    parser.add_argument(
        "--pipeline",
        default="SpeakerDiarization",
        type=str,
        help="Pipeline class to optimize",
    )
    add_common_model_args(parser)
    add_common_pipeline_args(parser)
    parser.add_argument("--batch-size", default=32, type=int, help=f"{argdoc.BATCH_SIZE}. Defaults to 32")
    parser.add_argument(
        "--hparams",
        nargs="+",
        default=("tau_active", "rho_update", "delta_new"),
        help="Hyper-parameters to optimize. Defaults to tau_active, rho_update and delta_new",
    )
    parser.add_argument("--num-iter", default=100, type=int, help="Number of trials")
    parser.add_argument(
        "--multi-stream",
        action="store_true",
        help="Run each trial as one batched on-device engine session; all "
        "trials share one engine (no per-trial rebuild)",
    )
    parser.add_argument(
        "--storage",
        type=str,
        help="Optional path to a study database to create or join (e.g. for distributed tuning)",
    )
    parser.add_argument("--output", type=Path, help="Output directory for the study database")
    args = parser.parse_args()
    apply_precision_arg(args)
    args.segmentation, args.embedding = load_models(args)

    pipeline_class = utils.get_pipeline_class(args.pipeline)
    config = pipeline_class.get_config_class()(**vars(args))
    hparams = [HyperParameter.from_name(name) for name in args.hparams]

    if args.storage is not None:
        study_or_path = Study(Path(args.storage))
    else:
        output = args.output if args.output is not None else Path("tune_output")
        output.mkdir(parents=True, exist_ok=True)
        study_or_path = output

    optimizer = Optimizer(
        pipeline_class=pipeline_class,
        speech_path=args.root,
        reference_path=args.reference,
        study_or_path=study_or_path,
        batch_size=args.batch_size,
        hparams=hparams,
        base_config=config,
        multi_stream=args.multi_stream,
    )
    optimizer(num_iter=args.num_iter, show_progress=True)
    print(f"Best hyper-parameters: {optimizer.best_hparams}")
    print(f"Best performance: {optimizer.best_performance:.3f}")


if __name__ == "__main__":
    run()
