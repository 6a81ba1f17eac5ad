"""The benchmark of the PyTorch / CUDA port (``tpushare_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything a cell
needs is found by name: ``configs/<config>.json``, ``cells/<cell>.json``,
``traffic/<mix>.json`` (naming a generator module beside it),
``metrics/<metric>.py``. The plain fp32 reference that decides
``correct`` lives in ``reference/`` and imports nothing of the port.
"""
