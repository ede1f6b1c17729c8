"""95th percentile over every batch of the window of its start to its images on the host, ms."""

from perfbench.metrics._common import percentile


def read(rec):
    return 1e3 * percentile([e - s for s, e, _ in rec.requests], 95)
