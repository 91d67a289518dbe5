"""Device busy ms a request after its last K4 launch: the solver rounds
and the MoE fusion after each."""


def read(view):
    parts = view.after_last("K4")
    return None if parts is None else view.busy_ms_each(parts)
