"""Plain PyTorch references that decide ``correct``. They import
neither ``jax`` nor ``tpushare`` nor anything of ``tpushare_torch``, and
re-derive from the run's seed every input the program was given."""
