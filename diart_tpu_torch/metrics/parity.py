"""Score directories (or files) of produced RTTMs against reference RTTMs
(port of ``diart_tpu/metrics/parity.py``).

diart's repository ships golden RTTM predictions for every paper
configuration (its ``expected_outputs/online/{0.5s..5.0s}/
{AMI,VoxConverse,DIHARD*}.rttm``, ``README.md:433-437``) — one multi-URI
RTTM file per corpus. This harness makes accuracy-parity a one-command
check: point it at a directory of produced RTTMs (one per file, as written
by :class:`diart_tpu_torch.runtime.Benchmark`, or corpus-level multi-URI files)
and the corresponding golden file/directory, and it scores every matching
URI with per-file + TOTAL rows.

CLI: ``python -m diart_tpu_torch.console.benchmark <hyp_dir> --score-against <ref>``.
A report needs pandas, which is imported only when one is built.
"""

from __future__ import annotations

from pathlib import Path
from typing import TYPE_CHECKING, Dict, Optional, Union

from ..core.annotation import Annotation, load_rttm
from .der import BaseMetric, DiarizationErrorRate

if TYPE_CHECKING:
    import pandas as pd

__all__ = ["load_rttm_collection", "score_rttm", "ParityError"]


class ParityError(ValueError):
    pass


def load_rttm_collection(path: Union[str, Path]) -> Dict[str, Annotation]:
    """Load RTTM annotations keyed by URI from a file or a directory.

    A single RTTM file may contain several URIs (the reference's golden
    corpus files do); a directory contributes every ``*.rttm`` inside it.
    Duplicate URIs across files raise, so a stray file can't silently
    shadow another.
    """
    path = Path(path).expanduser()
    files = sorted(path.glob("*.rttm")) if path.is_dir() else [path]
    if not files:
        raise ParityError(f"no .rttm files found under {path}")
    out: Dict[str, Annotation] = {}
    for f in files:
        for uri, annotation in load_rttm(f).items():
            if uri in out:
                raise ParityError(f"duplicate URI {uri!r} (second copy in {f})")
            out[uri] = annotation
    return out


def score_rttm(
    hypothesis: Union[str, Path],
    reference: Union[str, Path],
    metric: Optional[BaseMetric] = None,
    allow_missing: bool = False,
    display: bool = False,
) -> "pd.DataFrame":
    """Score hypothesis RTTMs against reference RTTMs, URI by URI.

    Parameters
    ----------
    hypothesis / reference: an ``.rttm`` file or a directory of them.
    metric: accumulating metric; defaults to DER (collar 0, overlap scored —
        the paper's evaluation protocol, BASELINE.md).
    allow_missing: if True, URIs present on only one side are skipped
        (useful for partial corpora); otherwise ANY one-sided URI raises —
        a crashed/truncated benchmark run must not score as full parity.

    Returns
    -------
    Per-URI + TOTAL report dataframe (``report.loc["TOTAL", (name, "%")]``).
    """
    metric = DiarizationErrorRate() if metric is None else metric
    hyp = load_rttm_collection(hypothesis)
    ref = load_rttm_collection(reference)
    if not allow_missing:
        unscored = sorted(set(ref) - set(hyp))
        if unscored:
            raise ParityError(
                f"{len(unscored)} reference URI(s) have no hypothesis "
                f"(first: {unscored[:5]}) — incomplete run? "
                f"Pass allow_missing=True to score a partial corpus."
            )
    scored = 0
    for uri in sorted(hyp):
        if uri not in ref:
            if allow_missing:
                continue
            raise ParityError(
                f"no reference for URI {uri!r} (references: {sorted(ref)[:5]}...)"
            )
        metric(ref[uri], hyp[uri])
        scored += 1
    if scored == 0:
        raise ParityError("no URI matched between hypothesis and reference")
    return metric.report(display=display)
