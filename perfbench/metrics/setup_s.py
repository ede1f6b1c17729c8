"""Set-up seconds: process start to the window's start (loading, building or finding the
kernels, weights, warm-up)."""


def read(rec):
    return rec.setup_s
