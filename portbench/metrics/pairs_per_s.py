"""Pairs whose poses reached the host in the window, over the window's
host-clock length."""


def read(rec):
    return sum(items for _, _, items in rec.batches) / rec.window_s
