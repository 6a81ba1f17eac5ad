"""Prefill chunks' device time per thousand real prompt tokens, over
the run: the summed ``device_ms`` of every ``serve.prefill_chunk`` span
over the summed real (unpadded) ``tokens`` they carried. On the card
only. Below the admission waves' wall per thousand tokens
(``prefill_ms_per_ktok.docqa``) by the wave's install, its first-token
read and its host time."""

from benchmark.records import on_card
from benchmark.spans import named, spans


def read(rec):
    docs = spans(rec, "serve")
    if docs is None or not on_card(rec):
        return None
    chunks = named(docs, "serve.prefill_chunk")
    ms = [c["attrs"].get("device_ms") for c in chunks]
    tokens = sum(c["attrs"]["tokens"] for c in chunks)
    if not tokens or None in ms:
        return None
    return 1e3 * sum(ms) / tokens
