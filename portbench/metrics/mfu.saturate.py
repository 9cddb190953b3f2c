"""The whole hop's share of the card's peak: the least seconds of every
matrix product and convolution of a hop at its stated precision's peak
(``portbench/work``), times the hops harvested in the traced window, over
the window, in percent."""

from portbench.work import product_seconds


def read(r):
    if not r.hops or not r.window_s:
        return None
    return 100.0 * product_seconds(r.flops) * r.hops / r.window_s
