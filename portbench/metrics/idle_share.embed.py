"""Device: percent of the traced extraction window in which no kernel ran
(the host-to-device copy of each batch counts as idle)."""


def read(view):
    share = None if view.trace is None else view.trace.idle_share()
    return None if share is None else 100.0 * share
