"""Device operations (kernels, copies, fills) in the profiler's trace of the
window, a hop."""


def read(r):
    ops = sum(1 for _, s, _ in r.device if r.window[0] <= s < r.window[1])
    return ops / r.hops if r.hops and ops else None
