"""PyTorch checkpoint -> the port's modules (port of
``diart_tpu/models/convert.py``).

Each ``*_params_from_state_dict`` maps a torch state dict (pyannote
PyanNet / XVectorSincNet, speechbrain ECAPA-TDNN and fbank Xvector,
wespeaker ResNet34, NeMo TitaNet) onto the flax parameter tree of the JAX
package's module, in numpy; :func:`diart_tpu_torch.weights.load_flax_params`
then carries the tree into the port's module of the same name, so each
layout mapping exists once. The ``load_*`` functions build the module the
state dict implies and return ``(module, meta)`` on the CPU in f32.

Layout rules (held against the torch replicas in ``tests/torch_replicas.py``):

* ``torch.nn.Conv1d.weight (out, in, k)``  -> flax ``Conv.kernel (k, in, out)``
* ``torch.nn.Conv2d.weight (out, in, kH, kW)`` -> flax ``(kH, kW, in, out)``
  (wespeaker's (freq, time) plane swapped to (time, freq))
* ``torch.nn.Linear.weight (out, in)``     -> flax ``Dense.kernel (in, out)``
* ``torch.nn.LSTM`` per layer and direction: ``weight_ih (4H, in)`` as it
  is; the biases summed (``b = bias_ih + bias_hh``); gate order i, f, g, o.
* batch norms' affine and running statistics -> ``scale/bias/mean/var``.

Checkpoints load through torch's safe ``weights_only=True`` path; one that
needs full unpickling needs ``trust_pickle=True`` or
``DIART_TPU_TRUST_CHECKPOINTS=1``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
from torch import nn

from ..weights import load_flax_params
from .ecapa import EcapaTDNN
from .embedding import XVectorSincNet
from .powerset import num_powerset_classes
from .resnet import ResNet34
from .segmentation import PyanNet
from .titanet import TitaNet
from .xvect import XVectorFbank

__all__ = [
    "ecapa_params_from_state_dict",
    "load_ecapa_checkpoint",
    "load_embedding_checkpoint",
    "load_pyannet_checkpoint",
    "load_pyannote_embedding",
    "load_pyannote_segmentation",
    "load_resnet_checkpoint",
    "load_titanet_checkpoint",
    "load_xvect_sb_checkpoint",
    "load_xvector_checkpoint",
    "load_xvector_checkpoint_from_sd",
    "pyannet_params_from_state_dict",
    "resnet_params_from_state_dict",
    "titanet_params_from_state_dict",
    "xvect_sb_params_from_state_dict",
    "xvector_params_from_state_dict",
]

Loaded = Tuple[nn.Module, Dict[str, Any]]


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def _get(sd: Dict[str, Any], *aliases: str) -> np.ndarray:
    for key in aliases:
        if key in sd:
            return _np(sd[key])
    raise KeyError(f"none of {aliases} found in state dict (keys: {sorted(sd)[:8]}...)")


def _sincnet_params(sd: Dict[str, Any], prefix: str = "sincnet.") -> Dict[str, Any]:
    p = prefix
    out = {
        "wav_norm_scale": _get(sd, f"{p}wav_norm1d.weight"),
        "wav_norm_bias": _get(sd, f"{p}wav_norm1d.bias"),
        "sinc": {
            "low_hz": _get(
                sd,
                f"{p}conv1d.0.low_hz_",
                f"{p}conv1d.0.filterbank.low_hz_",
            ).reshape(-1),
            "band_hz": _get(
                sd,
                f"{p}conv1d.0.band_hz_",
                f"{p}conv1d.0.filterbank.band_hz_",
            ).reshape(-1),
        },
        "norm1_scale": _get(sd, f"{p}norm1d.0.weight"),
        "norm1_bias": _get(sd, f"{p}norm1d.0.bias"),
    }
    for i in (1, 2):
        w = _get(sd, f"{p}conv1d.{i}.weight")  # (out, in, k)
        out[f"conv{i + 1}"] = {
            "kernel": w.transpose(2, 1, 0),
            "bias": _get(sd, f"{p}conv1d.{i}.bias"),
        }
        out[f"norm{i + 1}_scale"] = _get(sd, f"{p}norm1d.{i}.weight")
        out[f"norm{i + 1}_bias"] = _get(sd, f"{p}norm1d.{i}.bias")
    return out


def _lstm_params(sd: Dict[str, Any], num_layers: int, prefix: str = "lstm.") -> Dict[str, Any]:
    if f"{prefix}weight_ih_l0_reverse" not in sd:
        # a supported pyannote config we do not model — fail with intent
        # rather than a raw KeyError deep in _get
        raise ValueError(
            "checkpoint's LSTM is unidirectional; this converter supports "
            "the bidirectional PyanNet recipes only"
        )
    out = {}
    for layer in range(num_layers):
        w_ih = np.stack(
            [
                _get(sd, f"{prefix}weight_ih_l{layer}"),
                _get(sd, f"{prefix}weight_ih_l{layer}_reverse"),
            ]
        )
        w_hh = np.stack(
            [
                _get(sd, f"{prefix}weight_hh_l{layer}"),
                _get(sd, f"{prefix}weight_hh_l{layer}_reverse"),
            ]
        )
        b = np.stack(
            [
                _get(sd, f"{prefix}bias_ih_l{layer}")
                + _get(sd, f"{prefix}bias_hh_l{layer}"),
                _get(sd, f"{prefix}bias_ih_l{layer}_reverse")
                + _get(sd, f"{prefix}bias_hh_l{layer}_reverse"),
            ]
        )
        out[f"l{layer}_w_ih"] = w_ih
        out[f"l{layer}_w_hh"] = w_hh
        out[f"l{layer}_b"] = b
    return out


def _dense(sd: Dict[str, Any], key: str) -> Dict[str, np.ndarray]:
    return {
        "kernel": _get(sd, f"{key}.weight").T,
        "bias": _get(sd, f"{key}.bias"),
    }


def pyannet_params_from_state_dict(
    sd: Dict[str, Any], num_layers: int = 4
) -> Dict[str, Any]:
    """Map a pyannote PyanNet state dict onto our parameter tree."""
    params = {
        "sincnet": _sincnet_params(sd),
        "lstm": _lstm_params(sd, num_layers),
        "classifier": _dense(sd, "classifier"),
    }
    i = 0
    while f"linear.{i}.weight" in sd:
        params[f"linear{i}"] = _dense(sd, f"linear.{i}")
        i += 1
    return {"params": params}


def xvector_params_from_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Map a pyannote XVectorSincNet state dict onto our parameter tree.

    pyannote lays the TDNN out as a flat ``nn.Sequential`` of
    (Conv1d, LeakyReLU, BatchNorm1d) triples named ``tdnns.{j}``.
    """
    params: Dict[str, Any] = {"sincnet": _sincnet_params(sd)}
    conv_keys = sorted(
        {k.split(".")[1] for k in sd if k.startswith("tdnns.") and k.endswith(".weight")
         and sd[k].ndim == 3},
        key=int,
    )
    for i, j in enumerate(conv_keys):
        w = _get(sd, f"tdnns.{j}.weight")
        params[f"tdnn{i}"] = {
            "kernel": w.transpose(2, 1, 0),
            "bias": _get(sd, f"tdnns.{j}.bias"),
        }
        norm_j = int(j) + 2  # Conv, LeakyReLU, BatchNorm triple
        params[f"tdnn{i}_norm"] = {
            "scale": _get(sd, f"tdnns.{norm_j}.weight"),
            "bias": _get(sd, f"tdnns.{norm_j}.bias"),
            "mean": _get(sd, f"tdnns.{norm_j}.running_mean"),
            "var": _get(sd, f"tdnns.{norm_j}.running_var"),
        }
    params["embedding"] = _dense(sd, "embedding")
    return {"params": params}


def _conv1x1_dense(sd: Dict[str, Any], key: str) -> Dict[str, np.ndarray]:
    """torch Conv1d(in, out, 1) -> flax Dense: weight (out, in, 1)."""
    out = {"kernel": _get(sd, f"{key}.weight")[:, :, 0].T}
    if f"{key}.bias" in sd:
        out["bias"] = _get(sd, f"{key}.bias")
    return out


def _sb_bn(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """speechbrain BatchNorm1d wrapper (``<prefix>.norm.*``) -> _BatchNorm."""
    return {
        "scale": _get(sd, f"{prefix}.weight"),
        "bias": _get(sd, f"{prefix}.bias"),
        "mean": _get(sd, f"{prefix}.running_mean"),
        "var": _get(sd, f"{prefix}.running_var"),
    }


def _sb_tdnn(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """speechbrain TDNNBlock (Conv1d wrapper + BatchNorm1d wrapper)."""
    w = _get(sd, f"{prefix}.conv.conv.weight")  # (out, in, k)
    return {
        "conv": {
            "kernel": w.transpose(2, 1, 0),
            "bias": _get(sd, f"{prefix}.conv.conv.bias"),
        },
        "bn": _sb_bn(sd, f"{prefix}.norm.norm"),
    }


def _ecapa_res2_scale(sd: Dict[str, Any]) -> int:
    """Res2Net scale implied by the state dict (scale - 1 conv blocks)."""
    n = 0
    while f"blocks.1.res2net_block.blocks.{n}.conv.conv.weight" in sd:
        n += 1
    return n + 1


def ecapa_params_from_state_dict(
    sd: Dict[str, Any], res2_scale: Optional[int] = None
) -> Dict[str, Any]:
    """Map a speechbrain ``ECAPA_TDNN`` state dict (the ``embedding_model``
    of ``speechbrain/spkrec-ecapa-voxceleb``) onto our
    :class:`diart_tpu_torch.models.ecapa.EcapaTDNN` parameter tree.

    res2_scale is inferred from the state dict when not given — a
    checkpoint trained at a different scale must not silently convert
    only the first 7 res2net blocks."""
    found = _ecapa_res2_scale(sd)
    if res2_scale is None:
        res2_scale = found
    elif res2_scale != found:
        raise ValueError(
            f"checkpoint has res2net scale {found}, caller declared "
            f"{res2_scale}"
        )
    params: Dict[str, Any] = {"stem": _sb_tdnn(sd, "blocks.0")}
    for i in (1, 2, 3):
        block = {
            "tdnn1": _sb_tdnn(sd, f"blocks.{i}.tdnn1"),
            "tdnn2": _sb_tdnn(sd, f"blocks.{i}.tdnn2"),
            "res2net": {
                f"block{j}": _sb_tdnn(sd, f"blocks.{i}.res2net_block.blocks.{j}")
                for j in range(res2_scale - 1)
            },
            "se": {
                "conv1": _conv1x1_dense(sd, f"blocks.{i}.se_block.conv1.conv"),
                "conv2": _conv1x1_dense(sd, f"blocks.{i}.se_block.conv2.conv"),
            },
        }
        params[f"block{i}"] = block
    params["mfa"] = _sb_tdnn(sd, "mfa")
    # ASP attention: TDNNBlock over [x; mean; std] (9C -> bottleneck) is
    # split into local (first 3C inputs) and global (remaining 6C) matmuls.
    att_w = _get(sd, "asp.tdnn.conv.conv.weight")[:, :, 0]  # (bottleneck, 9C)
    channels3 = att_w.shape[1] // 3
    params["att_local"] = {
        "kernel": att_w[:, :channels3].T,
        "bias": _get(sd, "asp.tdnn.conv.conv.bias"),
    }
    params["att_global"] = {"kernel": att_w[:, channels3:].T}
    params["att_bn"] = _sb_bn(sd, "asp.tdnn.norm.norm")
    params["att2"] = _conv1x1_dense(sd, "asp.conv.conv")
    params["asp_bn"] = _sb_bn(sd, "asp_bn.norm")
    params["embedding"] = _conv1x1_dense(sd, "fc.conv")
    return {"params": params}


def xvect_sb_params_from_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Map a speechbrain ``Xvector`` state dict (the ``embedding_model`` of
    ``speechbrain/spkrec-xvect-voxceleb``) onto our
    :class:`diart_tpu_torch.models.xvect.XVectorFbank` parameter tree.

    speechbrain lays the model out as a flat ``blocks`` ModuleList of
    (Conv1d, activation, BatchNorm1d) triples followed by a parameter-free
    ``StatisticsPooling`` and a ``Linear`` wrapper, so keys are
    ``blocks.{3i}.conv.*``, ``blocks.{3i+2}.norm.*`` and ``blocks.N.w.*``.
    """
    conv_ids = sorted(
        (
            int(k.split(".")[1])
            for k in sd
            if k.startswith("blocks.") and k.endswith(".conv.weight")
        ),
    )
    params: Dict[str, Any] = {}
    for i, b in enumerate(conv_ids):
        w = _get(sd, f"blocks.{b}.conv.weight")  # (out, in, k)
        params[f"tdnn{i}"] = {
            "kernel": w.transpose(2, 1, 0),
            "bias": _get(sd, f"blocks.{b}.conv.bias"),
        }
        params[f"tdnn{i}_norm"] = _sb_bn(sd, f"blocks.{b + 2}.norm")
    lin = max(
        int(k.split(".")[1])
        for k in sd
        if k.startswith("blocks.") and k.endswith(".w.weight")
    )
    params["embedding"] = _dense(sd, f"blocks.{lin}.w")
    return {"params": params}


def _conv2d(sd: Dict[str, Any], key: str, transpose_hw: bool) -> Dict[str, np.ndarray]:
    """torch Conv2d weight (O, I, kH, kW) -> flax (kH, kW, I, O); with
    ``transpose_hw`` the two spatial dims swap (wespeaker lays the fbank
    image as (freq, time) while our trunk uses (time, freq))."""
    w = _get(sd, f"{key}.weight")
    kernel = w.transpose(3, 2, 1, 0) if transpose_hw else w.transpose(2, 3, 1, 0)
    out = {"kernel": kernel}
    if f"{key}.bias" in sd:
        out["bias"] = _get(sd, f"{key}.bias")
    return out


def _plain_bn(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {
        "scale": _get(sd, f"{prefix}.weight"),
        "bias": _get(sd, f"{prefix}.bias"),
        "mean": _get(sd, f"{prefix}.running_mean"),
        "var": _get(sd, f"{prefix}.running_var"),
    }


def resnet_params_from_state_dict(
    sd: Dict[str, Any], depths=(3, 4, 6, 3)
) -> Dict[str, Any]:
    """Map a wespeaker ResNet state dict (e.g. the torch side of
    ``wespeaker-voxceleb-resnet34-LM``) onto our
    :class:`diart_tpu_torch.models.resnet.ResNet34` parameter tree."""
    if any(k.startswith("resnet.") for k in sd):
        sd = {k[len("resnet."):]: v for k, v in sd.items() if k.startswith("resnet.")}
    # validate the checkpoint really is the basic-block ResNet34 layout:
    # a deeper wespeaker variant (ResNet152/221/...) or a bottleneck one
    # (conv3 keys) would otherwise convert silently with its extra blocks
    # dropped — plausible-looking but wrong embeddings
    if any(".conv3.weight" in k for k in sd):
        raise ValueError(
            "bottleneck ResNet checkpoint (conv3 blocks) is not the "
            "basic-block ResNet34 layout this converter supports"
        )
    found = []
    for stage in range(1, len(depths) + 1):
        n = 0
        while f"layer{stage}.{n}.conv1.weight" in sd:
            n += 1
        found.append(n)
    if tuple(found) != tuple(depths):
        raise ValueError(
            f"checkpoint has ResNet stage depths {tuple(found)}; this "
            f"converter supports ResNet34's {tuple(depths)}"
        )
    params: Dict[str, Any] = {
        "conv1": _conv2d(sd, "conv1", transpose_hw=True),
        "bn1": _plain_bn(sd, "bn1"),
    }
    for stage, depth in enumerate(depths):
        for i in range(depth):
            prefix = f"layer{stage + 1}.{i}"
            block = {
                "conv1": _conv2d(sd, f"{prefix}.conv1", transpose_hw=True),
                "bn1": _plain_bn(sd, f"{prefix}.bn1"),
                "conv2": _conv2d(sd, f"{prefix}.conv2", transpose_hw=True),
                "bn2": _plain_bn(sd, f"{prefix}.bn2"),
            }
            if f"{prefix}.downsample.0.weight" in sd:
                block["downsample_conv"] = _conv2d(
                    sd, f"{prefix}.downsample.0", transpose_hw=True
                )
                block["downsample_bn"] = _plain_bn(sd, f"{prefix}.downsample.1")
            params[f"layer{stage + 1}_{i}"] = block
    params["embedding"] = _dense(sd, "seg_1")
    return {"params": params}


def titanet_params_from_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Map a NeMo TitaNet state dict onto our
    :class:`diart_tpu_torch.models.titanet.TitaNet` parameter tree.

    NeMo's JasperBlock interleaves parameter-free activation/dropout modules
    in ``mconv``, so sub-layer indices drift with config; instead of
    hardcoding them, conv entries are classified by SHAPE (depthwise:
    (C, 1, k); pointwise: (O, I, 1)) and batchnorms by key pattern, in index
    order. Verified against a faithful torch replica
    (``tests/torch_replicas.py``).
    """
    if any(k.startswith("encoder.") for k in sd):
        flat = sd
    else:
        raise KeyError("not a NeMo TitaNet state dict (no encoder.* keys)")

    block_ids = sorted(
        {int(k.split(".")[2]) for k in flat if k.startswith("encoder.encoder.")}
    )

    def convert_block(i: int) -> Dict[str, Any]:
        prefix = f"encoder.encoder.{i}"
        # gather mconv entries by index
        entries = sorted(
            {
                int(k[len(prefix) + 7 :].split(".")[0])
                for k in flat
                if k.startswith(f"{prefix}.mconv.")
            }
        )
        reps = []
        pending: Dict[str, Any] = {}
        se = None
        for j in entries:
            base = f"{prefix}.mconv.{j}"
            if f"{base}.conv.weight" in flat:
                w = _np(flat[f"{base}.conv.weight"])  # (O, I, k)
                if w.shape[1] == 1 and "dw" not in pending:
                    # depthwise (C, 1, k) -> flax grouped kernel (k, 1, C);
                    # per-repeat the depthwise always precedes the pointwise
                    pending["dw"] = {"kernel": w.transpose(2, 1, 0)}
                else:
                    pending["pw"] = {"kernel": w.transpose(2, 1, 0)}
            elif f"{base}.weight" in flat and f"{base}.running_mean" in flat:
                pending["bn"] = _plain_bn(flat, base)
                reps.append(pending)
                pending = {}
            elif f"{base}.fc.0.weight" in flat:
                se = {
                    "fc1": _dense(flat, f"{base}.fc.0"),
                    "fc2": _dense(flat, f"{base}.fc.2"),
                }
        block: Dict[str, Any] = {f"rep{r}": rep for r, rep in enumerate(reps)}
        if se is not None:
            block["se"] = se
        if f"{prefix}.res.0.0.conv.weight" in flat:
            block["res_conv"] = {
                "kernel": _np(flat[f"{prefix}.res.0.0.conv.weight"]).transpose(2, 1, 0)
            }
            block["res_bn"] = _plain_bn(flat, f"{prefix}.res.0.1")
        return block

    params: Dict[str, Any] = {"prologue": convert_block(block_ids[0])}
    for m, i in enumerate(block_ids[1:-1]):
        params[f"mega{m}"] = convert_block(i)
    params["epilogue"] = convert_block(block_ids[-1])

    # decoder: attentive pooling (TDNN over [x; mean; std] split local/global)
    att_w = _np(flat["decoder._pooling.attention_layer.0.conv_layer.weight"])[:, :, 0]
    channels3 = att_w.shape[1] // 3
    params["att_local"] = {
        "kernel": att_w[:, :channels3].T,
        "bias": _np(flat["decoder._pooling.attention_layer.0.conv_layer.bias"]),
    }
    params["att_global"] = {"kernel": att_w[:, channels3:].T}
    params["att_bn"] = _plain_bn(flat, "decoder._pooling.attention_layer.0.bn")
    params["att2"] = _conv1x1_dense(flat, "decoder._pooling.attention_layer.2")
    params["emb_bn"] = _plain_bn(flat, "decoder.emb_layers.0.0")
    params["embedding"] = _dense(flat, "decoder.emb_layers.0.1")
    return {"params": params}


def _load_torch_state_dict(
    path: Union[str, Path], trust_pickle: bool = False
) -> Dict[str, Any]:
    """Load a torch checkpoint's state dict.

    Uses torch's safe ``weights_only=True`` path by default; arbitrary-pickle
    checkpoints (which can execute code on load) require the explicit
    ``trust_pickle=True`` opt-in, or ``DIART_TPU_TRUST_CHECKPOINTS=1``.
    """
    import os

    import torch

    if not Path(path).exists():
        raise FileNotFoundError(f"checkpoint not found: {path}")
    trust_pickle = trust_pickle or os.environ.get(
        "DIART_TPU_TRUST_CHECKPOINTS"
    ) == "1"
    try:
        obj = torch.load(str(path), map_location="cpu", weights_only=True)
    except Exception as exc:
        if not trust_pickle:
            raise RuntimeError(
                f"checkpoint {path} is not loadable with torch's safe "
                "weights_only=True path. If you trust its origin, set "
                "DIART_TPU_TRUST_CHECKPOINTS=1 to allow full unpickling "
                "(which can execute arbitrary code)."
            ) from exc
        obj = torch.load(str(path), map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("state_dict", "model_state_dict"):
            if key in obj:
                obj = obj[key]
                break
    # strip common prefixes (lightning: "model.")
    if any(k.startswith("model.") for k in obj):
        obj = {k[len("model."):]: v for k, v in obj.items() if k.startswith("model.")}
    return obj


def _loaded(module: nn.Module, tree: Dict[str, Any], meta: Dict[str, Any]) -> Loaded:
    """``module`` with ``tree`` loaded, ready for inference, and ``meta``."""
    load_flax_params(module, tree)
    return module.eval().requires_grad_(False), dict({"sample_rate": 16000}, **meta)


def _pyannet_module_from_state_dict(sd: Dict[str, Any], powerset_classes: int = 0,
                                    num_speakers: Optional[int] = None) -> PyanNet:
    """The PyanNet architecture a state dict implies (LSTM width and depth,
    the linear stack, the classifier width)."""
    num_layers = max(
        int(k.split("_l")[-1].replace("_reverse", "")) for k in sd if k.startswith("lstm.weight_ih_l")
    ) + 1
    linear_dims = []
    while f"linear.{len(linear_dims)}.weight" in sd:
        linear_dims.append(int(_np(sd[f"linear.{len(linear_dims)}.weight"]).shape[0]))
    return PyanNet(
        num_speakers=int(_np(sd["classifier.weight"]).shape[0]) if num_speakers is None else num_speakers,
        lstm_hidden=int(_np(sd["lstm.weight_hh_l0"]).shape[1]),
        lstm_layers=num_layers,
        linear_dims=tuple(linear_dims),
        powerset_classes=powerset_classes,
    )


def load_pyannet_checkpoint(path: Union[str, Path], powerset=None) -> Loaded:
    """Torch PyanNet checkpoint -> (module, meta).

    powerset: (num_speakers, max_simultaneous) for a checkpoint whose
    classifier emits powerset classes (pyannote/segmentation-3.0 style): a
    raw state dict cannot reveal the encoding, so it must be declared; the
    classifier's width is checked against the implied class count."""
    sd = _load_torch_state_dict(path)
    module = _pyannet_module_from_state_dict(sd)
    meta: Dict[str, Any] = {"source": str(path)}
    if powerset is not None:
        num_speakers, max_simultaneous = powerset
        classes = num_powerset_classes(num_speakers, max_simultaneous)
        if module.num_speakers != classes:
            raise ValueError(
                f"checkpoint classifier emits {module.num_speakers} outputs but "
                f"powerset({num_speakers}, {max_simultaneous}) implies {classes} classes"
            )
        module = _pyannet_module_from_state_dict(sd, classes, num_speakers)
        meta["powerset"] = (num_speakers, max_simultaneous)
    return _loaded(module, pyannet_params_from_state_dict(sd, module.lstm_layers), meta)


def load_xvector_checkpoint_from_sd(sd: Dict[str, Any], source: str = "") -> Loaded:
    """A pyannote XVectorSincNet state dict -> (module, meta)."""
    module = XVectorSincNet(embedding_dim=int(_np(sd["embedding.weight"]).shape[0]))
    return _loaded(module, xvector_params_from_state_dict(sd), {"source": source})


def load_xvector_checkpoint(path: Union[str, Path]) -> Loaded:
    """A pyannote XVectorSincNet checkpoint -> (module, meta)."""
    return load_xvector_checkpoint_from_sd(_load_torch_state_dict(path), str(path))


def load_ecapa_checkpoint(path: Union[str, Path]) -> Loaded:
    """A speechbrain ECAPA-TDNN checkpoint -> (module, meta)."""
    return _load_ecapa_from_sd(_load_torch_state_dict(path), str(path))


def load_xvect_sb_checkpoint(path: Union[str, Path]) -> Loaded:
    """A speechbrain fbank Xvector checkpoint -> (module, meta)."""
    return _load_xvect_sb_from_sd(_load_torch_state_dict(path), str(path))


def load_resnet_checkpoint(path: Union[str, Path]) -> Loaded:
    """A wespeaker ResNet34 checkpoint -> (module, meta)."""
    return _load_resnet_from_sd(_load_torch_state_dict(path), str(path))


def load_titanet_checkpoint(path: Union[str, Path]) -> Loaded:
    """A NeMo TitaNet checkpoint -> (module, meta)."""
    return _load_titanet_from_sd(_load_torch_state_dict(path), str(path))


def _load_ecapa_from_sd(sd: Dict[str, Any], source: str) -> Loaded:
    stem = _np(sd["blocks.0.conv.conv.weight"])
    module = EcapaTDNN(
        embedding_dim=int(_np(sd["fc.conv.weight"]).shape[0]),
        channels=int(stem.shape[0]),
        num_mels=int(stem.shape[1]),
        res2_scale=_ecapa_res2_scale(sd),
    )
    return _loaded(module, ecapa_params_from_state_dict(sd), {"source": source})


def _load_xvect_sb_from_sd(sd: Dict[str, Any], source: str) -> Loaded:
    conv_ids = sorted(
        int(k.split(".")[1]) for k in sd if k.startswith("blocks.") and k.endswith(".conv.weight")
    )
    shapes = [_np(sd[f"blocks.{b}.conv.weight"]).shape for b in conv_ids]
    # dilations are not recoverable from weight shapes; (1, 2, 3, 1, 1) is
    # the speechbrain Xvector recipe
    dilations = (1, 2, 3, 1, 1) if len(shapes) == 5 else (1,) * len(shapes)
    lin = max(int(k.split(".")[1]) for k in sd if k.startswith("blocks.") and k.endswith(".w.weight"))
    module = XVectorFbank(
        embedding_dim=int(_np(sd[f"blocks.{lin}.w.weight"]).shape[0]),
        num_mels=int(shapes[0][1]),
        tdnn_specs=tuple((int(s[2]), d, int(s[0])) for s, d in zip(shapes, dilations)),
    )
    return _loaded(module, xvect_sb_params_from_state_dict(sd), {"source": source})


def _load_resnet_from_sd(sd: Dict[str, Any], source: str) -> Loaded:
    flat = sd
    if any(k.startswith("resnet.") for k in sd):
        flat = {k[len("resnet."):]: v for k, v in sd.items() if k.startswith("resnet.")}
    module = ResNet34(
        embedding_dim=int(_np(flat["seg_1.weight"]).shape[0]),
        base_channels=int(_np(flat["conv1.weight"]).shape[0]),
    )
    return _loaded(module, resnet_params_from_state_dict(sd), {"source": source})


def _load_titanet_from_sd(sd: Dict[str, Any], source: str) -> Loaded:
    block_ids = sorted({int(k.split(".")[2]) for k in sd if k.startswith("encoder.encoder.")})
    kernels = tuple(
        int(_np(sd[f"encoder.encoder.{i}.mconv.0.conv.weight"]).shape[2]) for i in block_ids[1:-1]
    )
    module = TitaNet(
        embedding_dim=int(_np(sd["decoder.emb_layers.0.1.weight"]).shape[0]),
        channels=int(_np(sd["encoder.encoder.0.mconv.1.conv.weight"]).shape[0]),
        mega_kernels=kernels,
    )
    return _loaded(module, titanet_params_from_state_dict(sd), {"source": source})


def load_embedding_checkpoint(path: Union[str, Path]) -> Loaded:
    """Torch embedding checkpoint -> (module, meta); the layout is sniffed
    from the state-dict keys (wespeaker ResNet, NeMo TitaNet, speechbrain
    fbank Xvector, speechbrain ECAPA-TDNN, else pyannote XVectorSincNet)."""
    sd = _load_torch_state_dict(path)
    source = str(path)
    if "seg_1.weight" in sd or "resnet.seg_1.weight" in sd:
        return _load_resnet_from_sd(sd, source)
    if any(k.startswith("encoder.encoder.") for k in sd):
        return _load_titanet_from_sd(sd, source)
    if any(k.startswith("blocks.") and k.endswith(".w.weight") for k in sd) and "blocks.0.conv.weight" in sd:
        return _load_xvect_sb_from_sd(sd, source)
    if "fc.conv.weight" in sd or "blocks.0.conv.conv.weight" in sd:
        return _load_ecapa_from_sd(sd, source)
    return load_xvector_checkpoint_from_sd(sd, source)


def _require_pyannote():
    try:
        from pyannote.audio import Model

        return Model
    except ImportError as e:
        raise ImportError(
            "loading HF-hosted pyannote models requires `pyannote.audio`; convert the "
            "checkpoint offline with `python -m diart_tpu_torch.console.convert` and "
            "pass the converted file"
        ) from e


def load_pyannote_segmentation(model, use_hf_token=True) -> Loaded:
    """A pyannote model name -> (module, meta), through ``pyannote.audio``;
    a powerset model (its specifications say so) gets the powerset head."""
    net = _require_pyannote().from_pretrained(model, use_auth_token=use_hf_token)
    sd = net.state_dict()
    module = _pyannet_module_from_state_dict(sd)
    meta: Dict[str, Any] = {"source": str(model)}
    specs = getattr(net, "specifications", None)
    if specs is not None and getattr(specs, "powerset", False):
        meta["powerset"] = (len(specs.classes), specs.powerset_max_classes)
        module = _pyannet_module_from_state_dict(sd, module.num_speakers, len(specs.classes))
    return _loaded(module, pyannet_params_from_state_dict(sd, module.lstm_layers), meta)


def load_pyannote_embedding(model, use_hf_token=True) -> Loaded:
    """A pyannote embedding model name -> (module, meta), through
    ``pyannote.audio``."""
    net = _require_pyannote().from_pretrained(model, use_auth_token=use_hf_token)
    return load_xvector_checkpoint_from_sd(net.state_dict(), str(model))
