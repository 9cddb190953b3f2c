"""``python -m diart_tpu_torch.console.client``: stream a file or microphone
to a diarization server (port of ``diart_tpu/console/client.py``; diart's
``console/client.py``) — sender and receiver threads over one websocket;
audio goes out base64-encoded, RTTM lines come back. The client runs
nothing on a device. Needs ``websockets``.
"""

import argparse
import threading
import time
from pathlib import Path
from typing import Optional, Text

from .. import argdoc
from .. import utils
from ..runtime import FileAudioSource, MicrophoneAudioSource


def send_audio(
    ws, source: Text, step: float, sample_rate: int, realtime: bool,
    wire_int16: bool = False,
):
    if source != "microphone":
        audio_source = FileAudioSource(source, sample_rate, block_duration=step)
    else:
        audio_source = MicrophoneAudioSource(step)

    if wire_int16:
        # one-time wire-config handshake (an extension of diart's
        # protocol; half the wire bytes of its float32 format). Must
        # precede any audio.
        ws.send('{"format": "int16"}')
    encode = utils.encode_audio_int16 if wire_int16 else utils.encode_audio

    def emit(block):
        ws.send(encode(block))
        if realtime and source != "microphone":
            time.sleep(step)

    audio_source.stream.subscribe(on_next=emit)
    audio_source.read()


def receive_audio(ws, output: Optional[Path], last_recv: list):
    out_file = open(output, "a") if output is not None else None
    try:
        while True:
            rttm = ws.recv()
            last_recv[0] = time.monotonic()
            print(rttm, end="")
            if out_file is not None:
                out_file.write(rttm)
                out_file.flush()
    except Exception:
        pass
    finally:
        if out_file is not None:
            out_file.close()


def run():
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "source", type=str, help="Path to an audio file | 'microphone'"
    )
    parser.add_argument("--host", required=True, type=str, help="Server host")
    parser.add_argument("--port", required=True, type=int, help="Server port")
    parser.add_argument("--step", default=0.5, type=float, help=f"{argdoc.STEP}. Defaults to 0.5")
    parser.add_argument(
        "--sample-rate", default=16000, type=int, help=f"{argdoc.SAMPLE_RATE}. Defaults to 16000"
    )
    parser.add_argument(
        "--realtime", action="store_true", help="Pace file streaming at real time"
    )
    parser.add_argument(
        "-o", "--output-file", type=Path, help="Output RTTM file. Defaults to no writing"
    )
    parser.add_argument(
        "--wire-int16", action="store_true",
        help="Send int16 PCM over the wire (half the bytes of the float32 "
        "format; exact to 1/32768). Requires a diart_tpu or "
        "diart_tpu_torch server — diart's servers only speak float32",
    )
    parser.add_argument(
        "--drain-timeout", default=30.0, type=float,
        help="After all audio is sent, close once no prediction arrived for "
        "this many seconds (covers the server's latency tail / first-use "
        "kernel build). Defaults to 30",
    )
    args = parser.parse_args()

    from websockets.sync.client import connect

    uri = f"ws://{args.host}:{args.port}"
    with connect(uri) as ws:
        last_recv = [time.monotonic()]
        sender = threading.Thread(
            target=send_audio,
            args=(ws, args.source, args.step, args.sample_rate, args.realtime,
                  args.wire_int16),
        )
        receiver = threading.Thread(
            target=receive_audio, args=(ws, args.output_file, last_recv)
        )
        sender.start()
        receiver.start()
        sender.join()
        # drain the server's latency tail: close only after the stream has
        # been quiet for --drain-timeout (the reference client never exits
        # on its own, client.py:69-74; a quiet-period close keeps the tail
        # without hanging forever)
        last_recv[0] = time.monotonic()
        while time.monotonic() - last_recv[0] < args.drain_timeout:
            time.sleep(0.25)
        ws.close()
        receiver.join()


if __name__ == "__main__":
    run()
