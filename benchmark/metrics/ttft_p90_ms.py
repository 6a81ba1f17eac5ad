"""Time to first token, 90th percentile over every request offered in
the window, each timed from when it was due."""

from benchmark.records import request_p90_ms


def read(rec):
    return request_p90_ms(rec, "ttft_s")
