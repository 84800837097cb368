"""Samples of every train step completed in the window, over the window's
host-clock length (it ends in a device sync)."""


def read(rec):
    return sum(items for _, _, items in rec.batches) / rec.window_s
