"""Contract constants of the port — its own copy of the subset of the
reference's ``tpushare/consts.py`` that the ported workload modules use
(the port imports nothing from ``tpushare``)."""

# Pod HBM budget (MiB) the device plugin's Allocate injects; the payload
# sizes its model preset from it.
ENV_HBM_LIMIT_MIB = "TPUSHARE_HBM_LIMIT_MIB"

# Page-pool storage codecs: "bf16" stores the model dtype, "int8" the
# rowwise int8 codec (int8 values + one fp32 scale per row and head).
KV_CODECS = ("bf16", "int8")

# The kernel registry's implementation names — the only labels a kernel
# fallback may be reported under. The port reports its CUDA kernels as
# "flash" / "paged" and its plain-PyTorch paths as "xla", minting none.
KERNEL_IMPLS = ("flash", "splash", "paged", "ragged", "xla")

# A page-pool engine caught a cache layout that does not match the pool
# codec (cfg.kv_int8 is the slot cache's knob, never the pool's).
ERR_KV_CODEC_MISMATCH_FMT = (
    "kv codec mismatch: the page pool stores {pool!r} but the prefill "
    "cache layout is {cache!r} — the pool codec is "
    "PagedServingEngine(kv_codec=...); cfg.kv_int8 is the slot engine's "
    "cache layout")

# A request named a prefix no engine registered.
ERR_PREFIX_UNKNOWN_FMT = "unknown prefix {name!r}: register_prefix first"

# Terminal request statuses: every submitted request ends in exactly one.
STATUS_COMPLETED = "completed"
STATUS_SHED = "shed"
STATUS_DEADLINE_EXCEEDED = "deadline_exceeded"
STATUS_OOM_QUARANTINED = "oom_quarantined"
TERMINAL_STATUSES = (STATUS_COMPLETED, STATUS_SHED,
                     STATUS_DEADLINE_EXCEEDED, STATUS_OOM_QUARANTINED)
