"""K5 (``paged_decode.cu``): the least time of the traced decode
chunks' reads (each lane's K/V rows once, q and o) over the K5 kernels'
profiled time."""

from benchmark.records import trace_complete, traced
from benchmark.roofline import bound_s, share_pct
from benchmark.trace import kernel_time


def read(rec):
    t = traced(rec)
    if rec.get("kind") != "serve" or t is None or not rec["k5"]["steps"]:
        return None
    if not trace_complete(rec, "paged_decode", ("paged_partial_kernel",)):
        return None
    secs, n = kernel_time(t, "paged_partial_kernel", "paged_combine_kernel")
    if not n:
        return None
    return share_pct(bound_s(rec["k5"]["ops"], rec["k5"]["bytes"])[0], secs)
