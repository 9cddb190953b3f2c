"""The share of the traced window in which no device operation ran: 1 - the
union of the device's busy intervals over the window, in percent."""


def read(r):
    return 100.0 * (1.0 - r.busy_s / r.window_s) if r.window_s and r.busy_s else None
