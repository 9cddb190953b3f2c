"""``python -m diart_tpu_torch.console.convert``: convert a torch checkpoint
to the port's native model file (port of ``diart_tpu/console/convert.py``).

Inputs: pyannote PyanNet / XVectorSincNet, speechbrain ECAPA-TDNN and fbank
Xvector, NeMo TitaNet and wespeaker ResNet34 torch checkpoints (the layout
is sniffed from the keys), and pyannote model names where
``pyannote.audio`` is installed. The output is ``torch.save`` of the
converted state dict at OUTPUT plus its config at ``OUTPUT.json``, which
``from_pretrained`` loads directly. Runs on the GPU unless ``--cpu`` is
given; without a GPU it fails.
"""

import argparse
from pathlib import Path

from .. import argdoc
from .. import models as m
from .. import utils


def run():
    parser = argparse.ArgumentParser()
    parser.add_argument("kind", choices=["segmentation", "embedding"],
                        help="Which model role the checkpoint plays")
    parser.add_argument("source", type=str,
                        help="Torch checkpoint path (.bin/.pt/.ckpt/.safetensors) or pyannote model name")
    parser.add_argument("output", type=Path,
                        help="Output path of the native file (e.g. model.pt; its config goes to model.pt.json)")
    parser.add_argument(
        "--powerset",
        nargs=2,
        type=int,
        metavar=("SPEAKERS", "MAX_SIMULTANEOUS"),
        help="Declare a raw torch segmentation checkpoint as powerset-encoded",
    )
    parser.add_argument("--hf-token", default="true", type=str, help=f"{argdoc.HF_TOKEN}")
    parser.add_argument("--check", action="store_true",
                        help="Reload the converted file and verify a forward pass runs")
    parser.add_argument("--cpu", action="store_true", help=f"{argdoc.CPU}")
    args = parser.parse_args()

    hf_token = utils.parse_hf_token_arg(args.hf_token)
    device = "cpu" if args.cpu else "cuda"
    if args.kind == "segmentation":
        model = m.SegmentationModel.from_pretrained(
            args.source, hf_token, device=device,
            powerset=tuple(args.powerset) if args.powerset else None,
        )
    else:
        model = m.EmbeddingModel.from_pretrained(args.source, hf_token, device=device)
    args.output.parent.mkdir(parents=True, exist_ok=True)
    model.save(args.output)
    print(f"converted {args.source} ({type(model.module).__name__}) -> {args.output}")

    if args.check:
        import torch

        cls = m.SegmentationModel if args.kind == "segmentation" else m.EmbeddingModel
        reloaded = cls.from_pretrained(str(args.output), device=device)
        out = reloaded(torch.zeros(1, 1, reloaded.sample_rate, device=reloaded.device))
        print(f"check ok: forward on 1 s of silence -> {tuple(out.shape)}")


if __name__ == "__main__":
    run()
