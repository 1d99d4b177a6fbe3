"""Device: percent of the traced training window in which no kernel ran
(1 - the union of kernel intervals over the window's wall time; memory
copies do not make the device busy).  Rank 0 on several cards."""


def read(view):
    share = None if view.trace is None else view.trace.idle_share()
    return None if share is None else 100.0 * share
