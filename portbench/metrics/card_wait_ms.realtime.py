"""Host milliseconds of the program's ``session.wait_card`` span: what a
hop's harvest waits on the card once the hop's launches are queued, until
its copies have landed; the median over the traced window's hops."""

from portbench.metrics import _program


def read(r):
    return _program.host_ms(r, "session.wait_card")
