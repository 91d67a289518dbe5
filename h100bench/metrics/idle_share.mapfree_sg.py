"""1 - (union of device operation intervals / traced window), in the
traced map-free SuperGlue requests."""


def read(view):
    return view.idle_share()
