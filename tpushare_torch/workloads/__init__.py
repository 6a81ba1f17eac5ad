"""The port's workload payloads (counterpart of ``tpushare.workloads``)."""
