"""The share of the traced window in which the card ran nothing while the
program's ``session.dispatch`` span was open: the card waiting for the
host's launches of a hop, in percent. Idle while only other threads'
spans are open (a harvest, a sleep until the next cohort is due) is not
counted."""

from portbench.metrics import _program


def read(r):
    return _program.idle_under(r, "session.dispatch")
