"""Admission wait: due time to the engine's admit mark (the request left
the queue for an admission wave), 90th percentile over every request."""

from benchmark.records import request_p90_ms


def read(rec):
    return request_p90_ms(rec, "queue_s")
