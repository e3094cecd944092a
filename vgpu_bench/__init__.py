"""The benchmark of the PyTorch and CUDA port (``k8s_device_plugin_torch``).

One run is one cell of ``BENCHMARK.json`` measured once::

    python3 -m vgpu_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (``configs/<config>.json``: the model and its
sizes, with its plain reference in ``reference/<model>.py`` and its
operation counts in ``counts/<model>.py``) and a traffic mix
(``traffic/<mix>.json``: tenants, memory share, core limit, wrapped or
not, input pool). Every metric is read by ``metrics/<metric>.py``. The
harness finds each of these by the name that ``BENCHMARK.json`` gives, so a
new cell, configuration, mix or metric is new files and a new entry.

Nothing here imports ``jax`` or the JAX package, and the references import
nothing of the port.
"""
