"""Device busy ms a request before its first K1 launch: the backbone's
convolutions and everything before the coarse transformer."""


def read(view):
    parts = view.before_first("K1")
    return None if parts is None else view.busy_ms_each(parts)
