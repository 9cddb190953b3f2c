"""Shared reading of the trunk's device time (a helper, not a metric): the
engine's ``trunk_ms``, from the event after the segmentation to the event
where the embedding's trunk returns (the overlapped-speech weights, the
frame ring's normalization and the trunk). A tree whose port records no
trunk event, as one whose ``DevicePhases`` has no ``trunk_ms``, reads
none."""

from portbench.metrics import _program


def trunk_ms(r) -> list:
    """The device ms of the trunk of each hop dispatched in the window."""
    got = _program.program(r)
    if got is None:
        return []
    spans, phases = got
    hops = _program.window_hops(r, spans)
    return [p.trunk_ms for p in phases if p.hop in hops and getattr(p, "trunk_ms", None) is not None]
