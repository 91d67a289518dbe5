"""1 - (union of device operation intervals / traced window), in the
traced map-free requests."""


def read(view):
    return view.idle_share()
