"""``python -m diart_tpu_torch.console.serve``: websocket diarization server
(port of ``diart_tpu/console/serve.py``).

Parity + upgrade over diart's ``console/serve.py``: diart serves ONE client
per process; this server multiplexes up to ``--num-streams`` concurrent
clients into one fused on-device engine. Runs on the GPU unless ``--cpu``
is given; without a GPU it fails. Needs ``websockets``.
"""

import argparse

from .. import argdoc
from ..parallel import MultiStreamEngine
from ..runtime.server import StreamingServer
from .stream import (
    MESH_ITEM,
    add_common_model_args,
    add_common_pipeline_args,
    apply_precision_arg,
    load_models,
)


def run():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1", type=str, help="Server host")
    parser.add_argument("--port", default=7007, type=int, help="Server port")
    add_common_model_args(parser)
    add_common_pipeline_args(parser)
    parser.add_argument(
        "--num-streams",
        default=16,
        type=int,
        help=f"{argdoc.NUM_STREAMS}. Defaults to 16",
    )
    parser.add_argument(
        "--cohorts",
        default=1,
        type=int,
        help="Time-multiplex N independent stream cohorts onto the device "
        "(capacity = N * --num-streams concurrent clients). Each cohort "
        "is its own device state sharing the one engine; in "
        "--realtime mode cohorts tick at staggered phases within the "
        "step period",
    )
    parser.add_argument(
        "--mesh",
        default=0,
        type=int,
        help="Shard the stream batch over N devices along a 'streams' mesh "
        "axis. Not ported yet: a nonzero value raises NotImplementedError "
        f"until {MESH_ITEM}",
    )
    parser.add_argument(
        "--int16-transfer",
        action="store_true",
        help="Ship int16 PCM blocks to the device (half the host->device "
        "bytes per hop; ~96 dB quantization floor, dequantized on device)",
    )
    parser.add_argument(
        "--pipelined",
        action="store_true",
        help="Overlap hop k's device fetch + RTTM assembly with hop k+1's "
        "dispatch: an overload-throughput mode (the halves contend on a "
        "host with one free core, so at or below capacity it only queues)",
    )
    parser.add_argument(
        "--no-binarize-on-device",
        action="store_true",
        help="Fetch raw aggregated scores per hop instead of the "
        "device-binarized packed bitmap (32x the device->host bytes; the "
        "bitmap gives the same text). Only useful for A/Bs and debugging",
    )
    parser.add_argument(
        "--realtime",
        action="store_true",
        help="Tick once per step of wall clock instead of polling for "
        "arrived audio every 5 ms: one hop per step period regardless of "
        "client arrival phase (the fewest host->device transfers; adds up "
        "to one tick of alignment latency). Default: fast-poll",
    )
    parser.add_argument(
        "--coalesce-ms",
        default=0.0,
        type=float,
        help="Hold a partial client wave up to this many ms so one "
        "synchronized wave dispatches as ONE hop (fewer full-batch "
        "host->device transfers). Default 0: the hold taxes early "
        "senders; raise only when host->device transfer is the measured "
        "bottleneck",
    )
    args = parser.parse_args()
    apply_precision_arg(args)
    if args.realtime and args.coalesce_ms:
        parser.error(
            "--coalesce-ms only applies to the fast-poll ticker; "
            "--realtime already dispatches one hop per step"
        )

    if args.mesh:
        raise NotImplementedError(f"--mesh is not ported yet: {MESH_ITEM}")

    # after apply_precision_arg: the engine holds the default policy, which
    # the server's dispatch threads then run under
    segmentation, embedding = load_models(args)

    engine = MultiStreamEngine(
        segmentation=segmentation,
        embedding=embedding,
        duration=args.duration,
        step=args.step,
        latency=args.latency,
        sample_rate=args.sample_rate,
        tau_active=args.tau_active,
        rho_update=args.rho_update,
        delta_new=args.delta_new,
        gamma=args.gamma,
        beta=args.beta,
        max_speakers=args.max_speakers,
        normalize_embedding_weights=args.normalize_embedding_weights,
        batch_size=args.num_streams,
    )
    server = StreamingServer(
        engine,
        tau_active=args.tau_active,
        host=args.host,
        port=args.port,
        realtime=args.realtime,
        quantize_transfer=args.int16_transfer,
        pipelined=args.pipelined,
        coalesce=args.coalesce_ms / 1000.0,
        cohorts=args.cohorts,
        binarize_on_device=not args.no_binarize_on_device,
    )
    try:
        server.run()
    except KeyboardInterrupt:
        server.close()


if __name__ == "__main__":
    run()
