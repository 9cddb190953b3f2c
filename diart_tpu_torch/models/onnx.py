"""ONNX model execution on the host (port of ``diart_tpu/models/onnx.py``;
the optional ``onnxruntime`` dependency).

An ONNX model cannot run inside the fused device step: it is host-only
(``host_only = True``, numpy in and out) and is served through the
``SpeakerDiarization`` / ``VoiceActivityDetection`` pipelines' host route.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Union

import numpy as np

__all__ = ["ONNXModel"]


class ONNXModel:
    host_only = True

    def __init__(self, path: Union[str, Path], input_names: List[str], output_name: str):
        try:
            import onnxruntime as ort
        except ImportError as e:
            raise ImportError("ONNX models require `onnxruntime`, which is not installed") from e
        options = ort.SessionOptions()
        options.graph_optimization_level = ort.GraphOptimizationLevel.ORT_ENABLE_ALL
        self.path = Path(path)
        self.input_names = input_names
        self.output_name = output_name
        self.session = ort.InferenceSession(
            str(self.path), sess_options=options, providers=["CPUExecutionProvider"]
        )

    def __call__(self, *args) -> np.ndarray:
        inputs = {
            name: np.asarray(arg, dtype=np.float32)
            for name, arg in zip(self.input_names, args)
            if arg is not None
        }
        return self.session.run([self.output_name], inputs)[0]
