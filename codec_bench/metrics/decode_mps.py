"""Megapixels a second of the window's decodes: the pixels of every decode
over the summed wall time of those calls."""


def read(window):
    return window.rate("decode")
