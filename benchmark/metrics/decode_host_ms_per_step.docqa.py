"""The host's cost of building and launching a decode step: the summed
host duration of the ``serve.decode_dispatch`` spans that launched a
chunk, over the decode steps they launched."""

from benchmark.spans import host_ms, named, spans


def read(rec):
    docs = spans(rec, "serve")
    if docs is None:
        return None
    launched = [d for d in named(docs, "serve.decode_dispatch")
                if d["attrs"].get("launched")]
    steps = sum(d["attrs"]["steps"] for d in launched)
    if not steps:
        return None
    return sum(host_ms(d) for d in launched) / steps
