"""Multi-device layouts of the port (counterpart of
``tpushare.workloads.parallel``): the serving mesh so far."""
