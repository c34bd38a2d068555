"""Megapixels a second of the window's encodes: the pixels of every encode
over the summed wall time of those calls."""


def read(window):
    return window.rate("encode")
