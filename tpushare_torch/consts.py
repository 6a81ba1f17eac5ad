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

# A serving mesh shards the KV-head axis over tp, the layer stack over
# pp and the MLP hidden columns over tp: a model must tile it
# (parallel/mesh.check_serving_mesh), word for word the reference's.
ERR_SERVING_MESH_HEADS_FMT = (
    "serving mesh tp={tp} shards the KV-head axis: n_kv_heads "
    "{kv_heads} and n_heads {n_heads} must both divide by tp — pick tp "
    "from the divisors of n_kv_heads (docs/KERNELS.md 'Sharded pool')")
ERR_SERVING_MESH_LAYERS_FMT = (
    "serving mesh pp={pp} shards the layer stack into stages: n_layers "
    "{n_layers} must divide by pp (docs/KERNELS.md 'Sharded pool')")
ERR_SERVING_MESH_FF_FMT = (
    "serving mesh tp={tp} column-shards the MLP hidden dim: d_ff "
    "{d_ff} must divide by tp")

# A request named a prefix no engine registered; a prefix registration
# on a MoE config (both engines prefill prefixes with the dense model).
ERR_PREFIX_UNKNOWN_FMT = "unknown prefix {name!r}: register_prefix first"
ERR_PREFIX_MOE = ("prefix caching uses the dense prefill; MoE requests "
                  "are served via chunked admission without a registered "
                  "prefix")

# The draft-config contract of both engines' ``draft=(params_d, cfg_d,
# k)`` (serving._EngineCore._validate_draft), word for word the
# reference's.
ERR_SPEC_MM = "speculative lanes need the plain weight path (mm=None)"
ERR_SPEC_PIPELINE = ("speculative lanes do not compose with pipeline=True "
                     "(the pipelined loop bypasses spec rounds)")
ERR_SPEC_MOE = "speculative lanes are dense-only"
ERR_SPEC_K_FMT = "draft k={k} must be >= 2"
ERR_SPEC_VOCAB = "draft and target must share a vocab"

# Terminal request statuses: every submitted request ends in exactly one.
STATUS_COMPLETED = "completed"
STATUS_SHED = "shed"
STATUS_DEADLINE_EXCEEDED = "deadline_exceeded"
STATUS_OOM_QUARANTINED = "oom_quarantined"
TERMINAL_STATUSES = (STATUS_COMPLETED, STATUS_SHED,
                     STATUS_DEADLINE_EXCEEDED, STATUS_OOM_QUARANTINED)

# Queue reject policies (the engines' ``reject_policy``): a full queue
# sheds the arriving request, or the longest-waiting one.
REJECT_NEW = "reject_new"
SHED_OLDEST = "shed_oldest"
REJECT_POLICIES = (REJECT_NEW, SHED_OLDEST)

# The Allocate env contract the admission controller reads: the chip
# index chosen by the extender, the pod's unit-scaled HBM request, and
# where the node daemon's usage endpoint answers (the full URL wins;
# else the port on the downward-API host IP).
ENV_RESOURCE_INDEX = "ALIYUN_COM_TPU_HBM_IDX"
ENV_RESOURCE_BY_POD = "ALIYUN_COM_TPU_HBM_POD"
ENV_USAGE_URL = "TPUSHARE_USAGE_URL"
ENV_USAGE_PORT = "TPUSHARE_USAGE_PORT"
ENV_HOST_IP = "HOST_IP"

# The payload surface (workloads/usage_report.py, infer.py,
# train_payload.py): the pod identity the usage reporter posts under
# (downward API), the allocation-lifecycle trace id Allocate forwards,
# and the key the serving telemetry snapshot rides under in a usage
# POST.
ENV_POD_NAME = "POD_NAME"
ENV_POD_NAMESPACE = "POD_NAMESPACE"
ENV_TRACE_ID = "TPUSHARE_TRACE_ID"
USAGE_TELEMETRY_KEY = "telemetry"

# The chips Allocate granted; a failed allocation poisons this env with
# ERR_VISIBLE_DEVICES_FMT, and the payload exits 3 on the prefix.
ENV_TPU_VISIBLE_CHIPS = "TPU_VISIBLE_CHIPS"
ERR_VISIBLE_DEVICES_FMT = "no-tpu-has-{amount}{unit}-to-run"
ERR_VISIBLE_DEVICES_PREFIX = ERR_VISIBLE_DEVICES_FMT.split("{", 1)[0]
# The allocator cap Allocate may hand a payload (a fraction of the
# card's memory, 4 decimals), the switch that turns the cap off, and the
# directory a profiler trace of the payload goes to.
ENV_XLA_MEM_FRACTION = "XLA_PYTHON_CLIENT_MEM_FRACTION"
ENV_DISABLE_ISOLATION = "TPUSHARE_DISABLE_ISOLATION"
ENV_TRACE_DIR = "TPUSHARE_TRACE_DIR"

# Memory accounting units of the env contract's unit-scaled figures.
MIB = "MiB"
GIB = "GiB"
# One kubelet device per unit of HBM: ``<chipID>-_-<j>``.
FAKE_ID_SEP = "-_-"

# The pod-group contract: the group label and its size, the rank the
# extender stamps at bind, the rendezvous address, and the envs the
# device plugin's Allocate turns them into (the reference's names).
GROUP_LABEL = "tpushare.aliyun.com/group"
GROUP_SIZE_LABEL = "tpushare.aliyun.com/group-size"
GROUP_RANK_ANNOTATION = "tpushare.aliyun.com/group-rank"
COORDINATOR_ANNOTATION = "tpushare.aliyun.com/coordinator"
ENV_GROUP = "TPUSHARE_GROUP"
ENV_GROUP_RANK = "TPUSHARE_GROUP_RANK"
ENV_GROUP_SIZE = "TPUSHARE_GROUP_SIZE"
ENV_COORDINATOR = "TPUSHARE_COORDINATOR"

# Chip pressure at which the admission watermark is cut.
PRESSURE_ENGAGE = 0.90

# The SLO contract a completed request is judged against: TTFT (submit
# -> first token, queue wait included) and the per-token decode bound
# ((retire - first token) / decode tokens).
SLO_TTFT_S = 2.0
SLO_DECODE_PER_TOKEN_S = 0.1
# Head-based sampling of request traces: every N-th request is kept;
# SLO violators and non-completed requests always are.
SLO_TRACE_SAMPLE_EVERY_N = 16
# Phase attribution: exactly one is charged per violating request, so
# the per-phase counters sum to the violation total.
SLO_PHASE_QUEUED = "queued"
SLO_PHASE_ADMISSION = "admission"
SLO_PHASE_PREFILL = "prefill"
SLO_PHASE_DECODE = "decode"
SLO_PHASES = (SLO_PHASE_QUEUED, SLO_PHASE_ADMISSION, SLO_PHASE_PREFILL,
              SLO_PHASE_DECODE)

# The serving engine's telemetry snapshot schema (the reference's names,
# so a usage report reads the same from either package). The compile
# pair counts the port's kernel builds (``kernels/build.py``: libraries
# compiled by nvcc and their seconds) under the reference's key names.
TELEMETRY_TTFT_P50_MS = "ttft_p50_ms"
TELEMETRY_TTFT_P99_MS = "ttft_p99_ms"
TELEMETRY_DECODE_P50_MS = "decode_p50_ms"
TELEMETRY_DECODE_P99_MS = "decode_p99_ms"
TELEMETRY_TOKENS_PER_S = "tokens_per_s"
TELEMETRY_QUEUE_DEPTH = "queue_depth"
TELEMETRY_ADMITTED = "admitted_total"
TELEMETRY_RETIRED = "retired_total"
TELEMETRY_PREFILL_BUCKETS = "prefill_buckets"
TELEMETRY_COMPILES = "jax_compiles_total"
TELEMETRY_COMPILE_SECONDS = "jax_compile_seconds_total"
TELEMETRY_SHED = "shed_total"
TELEMETRY_DEADLINE_EXCEEDED = "deadline_exceeded_total"
TELEMETRY_OOM_RECOVERIES = "oom_recoveries_total"
TELEMETRY_ADMISSION_WATERMARK = "admission_watermark"
TELEMETRY_DEGRADED = "degraded"
# present only once a drain was requested
TELEMETRY_DRAINING = "draining"
TELEMETRY_DRAINED = "drained"
# present only on the paged engine's snapshots
TELEMETRY_PAGES_TOTAL = "kv_pages_total"
TELEMETRY_PAGES_IN_USE = "kv_pages_in_use"
TELEMETRY_PAGE_OCCUPANCY_PCT = "kv_page_occupancy_pct"
TELEMETRY_PAGE_FRAG_PCT = "kv_page_frag_pct"
TELEMETRY_PAGES_SHARED = "kv_pages_shared"
TELEMETRY_PAGES_PINNED = "kv_pages_pinned"
TELEMETRY_PREFIX_HITS = "prefix_hits_total"
TELEMETRY_COW_COPIES = "cow_copies_total"
TELEMETRY_KV_CODEC = "kv_codec"
TELEMETRY_KV_BYTES_PER_TOKEN = "kv_bytes_per_token"
TELEMETRY_KV_POOL_SHARD_MIB = "kv_pool_shard_mib"
# present only on a sharded engine / a drafted engine / a fleet member
TELEMETRY_MESH_TP = "mesh_tp"
TELEMETRY_MESH_PP = "mesh_pp"
TELEMETRY_SPEC_ROUNDS = "spec_rounds_total"
TELEMETRY_SPEC_DRAFTED = "spec_drafted_total"
TELEMETRY_SPEC_ACCEPTED = "spec_accepted_total"
TELEMETRY_SPEC_EMITTED = "spec_emitted_total"
TELEMETRY_SPEC_ACCEPT_RATE = "spec_accept_rate"
TELEMETRY_FLEET_ENGINE_ID = "fleet_engine_id"
# SLO plane: always present once an engine publishes
TELEMETRY_GOODPUT_TOKENS_PER_S = "goodput_tokens_per_s"
TELEMETRY_SLO_GOOD = "slo_good_total"
TELEMETRY_SLO_VIOLATIONS_QUEUED = "slo_violations_queued_total"
TELEMETRY_SLO_VIOLATIONS_ADMISSION = "slo_violations_admission_total"
TELEMETRY_SLO_VIOLATIONS_PREFILL = "slo_violations_prefill_total"
TELEMETRY_SLO_VIOLATIONS_DECODE = "slo_violations_decode_total"
# kernel-registry fallbacks ("impl:reason" -> count), present when any
TELEMETRY_KERNEL_FALLBACKS = "kernel_fallbacks"

# ---------------------------------------------------------------------------
# Fleet serving (workloads/fleet.py, transport.py, remote.py, wirecodec.py)
# ---------------------------------------------------------------------------

# A cross-pool page handoff (disaggregation, prefix replication, salvage)
# moves raw page bytes: both pools must share codec and page size.
ERR_HANDOFF_POOL_FMT = (
    "page handoff layout mismatch: source pool is {src} but the "
    "destination pool is {dst} — extract/install move raw page bytes "
    "and require identical kv_codec and page_size on both engines")

# FleetRouter's constructor guards and its respawn refusal.
ERR_FLEET_EMPTY = "a fleet needs at least one engine"
ERR_FLEET_SEQ_MISMATCH_FMT = (
    "fleet members must share max_seq and prompt_buckets (got {got})")
ERR_FLEET_DISAGG_FMT = (
    "disaggregation needs 1 <= n_prefill ({n_prefill}) < engines "
    "({engines}): at least one engine on each side of the split")
ERR_FLEET_REPLICATE_DEPTH_FMT = "replicate_depth {depth} must be >= 1"
ERR_FLEET_NO_FACTORY_FMT = (
    "fleet member {member} failed fatally ({reason}) and no factory was "
    "given: FleetRouter(factory=...) builds replacement members")

# Member health: the healthz probe's wall bound and throttle, the
# breaker thresholds (consecutive dispatch faults escaping step(), new
# watchdog trips and OOM recoveries between probes), the open breaker's
# cooldown, the clean half-open probes that close it, and how often one
# request may be re-admitted after losing its member.
FLEET_PROBE_TIMEOUT_S = 0.25
FLEET_PROBE_INTERVAL_S = 0.5
FLEET_BREAKER_DISPATCH_FAULTS = 3
FLEET_BREAKER_WATCHDOG_TRIPS = 2
FLEET_BREAKER_OOM_STORM = 5
FLEET_BREAKER_COOLDOWN_S = 1.0
FLEET_BREAKER_HALF_OPEN_PROBES = 2
FLEET_HEDGE_RETRY_BUDGET = 2

# The cross-process wire: the frame cap (MiB; a larger length field is
# refused before any allocation), the per-op deadline, the deadline of
# compute ops (step, prefill_step, extract, install, prefix replication),
# the dial deadline, how long a host replays a mutating op's response by
# its idempotency token, and the consecutive wire faults that open a
# remote member's (non-fatal) breaker.
FLEET_WIRE_MAX_FRAME_MIB = 256
FLEET_RPC_OP_DEADLINE_S = 5.0
FLEET_RPC_STEP_DEADLINE_S = 120.0
FLEET_RPC_CONNECT_DEADLINE_S = 2.0
FLEET_RPC_IDEMPOTENCY_TTL_S = 60.0
FLEET_BREAKER_WIRE_FAULTS = 3

# Typed wire-fault kinds: the decoder's WireError taxonomy and the
# {kind} label of METRIC_FLEET_WIRE_FAULTS.
WIRE_FAULT_TRUNCATED = "truncated"
WIRE_FAULT_CRC = "crc_mismatch"
WIRE_FAULT_VERSION = "version_skew"
WIRE_FAULT_OVER_LENGTH = "over_length"
WIRE_FAULT_BAD_MAGIC = "bad_magic"
WIRE_FAULT_GARBAGE = "garbage"
WIRE_FAULT_TIMEOUT = "timeout"
WIRE_FAULT_CUT = "cut"
WIRE_FAULT_REFUSED = "refused"
WIRE_FAULT_KINDS = (
    WIRE_FAULT_TRUNCATED, WIRE_FAULT_CRC, WIRE_FAULT_VERSION,
    WIRE_FAULT_OVER_LENGTH, WIRE_FAULT_BAD_MAGIC, WIRE_FAULT_GARBAGE,
    WIRE_FAULT_TIMEOUT, WIRE_FAULT_CUT, WIRE_FAULT_REFUSED)

# Remote-member connection states ({state} of METRIC_FLEET_REMOTE_MEMBERS).
REMOTE_MEMBER_CONNECTED = "connected"
REMOTE_MEMBER_DISCONNECTED = "disconnected"
REMOTE_MEMBER_STATES = (REMOTE_MEMBER_CONNECTED,
                        REMOTE_MEMBER_DISCONNECTED)

# A member's circuit-breaker states ({state} of METRIC_FLEET_MEMBER_STATE).
FLEET_MEMBER_CLOSED = "closed"
FLEET_MEMBER_OPEN = "open"
FLEET_MEMBER_HALF_OPEN = "half_open"
FLEET_MEMBER_STATES = (FLEET_MEMBER_CLOSED, FLEET_MEMBER_OPEN,
                       FLEET_MEMBER_HALF_OPEN)

# Typed outcomes of one failover action ({outcome} of
# METRIC_FLEET_FAILOVER_OUTCOMES).
FLEET_MIGRATED = "migrated"
FLEET_SHED_MEMBER_FAILED = "member_failed"
FLEET_HEDGED = "hedged"
FLEET_RESPAWNED = "respawned"
FLEET_SCALED_IN = "scaled_in"
FLEET_OUTCOMES = (FLEET_MIGRATED, FLEET_SHED_MEMBER_FAILED, FLEET_HEDGED,
                  FLEET_RESPAWNED, FLEET_SCALED_IN)

# The fleet's merged snapshot keys (telemetry.fleet_snapshot plus the
# router's counters); a single engine's snapshot carries none of them
# but TELEMETRY_FLEET_ENGINE_ID once it joins a fleet.
TELEMETRY_FLEET_ENGINES = "fleet_engines"
TELEMETRY_FLEET_HANDOFFS = "fleet_handoffs_total"
TELEMETRY_FLEET_AFFINITY_HITS = "fleet_affinity_hits_total"
TELEMETRY_FLEET_MEMBERS_OPEN = "fleet_members_open"
TELEMETRY_FLEET_MIGRATIONS = "fleet_migrations_total"
TELEMETRY_FLEET_HEDGES = "fleet_hedged_prefills_total"
TELEMETRY_FLEET_SHED_MEMBER_FAILED = "fleet_shed_member_failed_total"
TELEMETRY_FLEET_RESPAWNS = "fleet_respawns_total"
TELEMETRY_FLEET_REMOTE_MEMBERS = "fleet_remote_members"
TELEMETRY_FLEET_WIRE_RECONNECTS = "fleet_wire_reconnects_total"
TELEMETRY_FLEET_WIRE_FAULTS = "fleet_wire_faults_total"
TELEMETRY_FLEET_REMOTE_MIGRATIONS = "fleet_remote_migrations_total"
TELEMETRY_FLEET_SHED_SLO = "fleet_shed_slo_total"

# The five fleet metric series (metrics.py; the reference's names).
METRIC_FLEET_MEMBER_STATE = "tpushare_fleet_member_state"
METRIC_FLEET_BREAKER_TRANSITIONS = (
    "tpushare_fleet_breaker_transitions_total")
METRIC_FLEET_FAILOVER_OUTCOMES = "tpushare_fleet_failover_outcomes_total"
METRIC_FLEET_WIRE_FAULTS = "tpushare_fleet_wire_faults_total"
METRIC_FLEET_REMOTE_MEMBERS = "tpushare_fleet_remote_members"
