"""PyTorch/CUDA port of the vTPU data plane for one NVIDIA H100.

Counterpart of ``k8s_device_plugin_tpu``'s in-container pieces: the
ai-benchmark runner and its models (``workloads/``), the cooperative
limiter and its shared region (``shm/``), and the node monitor's duty
probe (``monitor/dutyprobe.py``). The control plane is not ported; it
already schedules GPUs.

Kernels that the JAX package wrote in Pallas are CUDA C++ for ``sm_90a``
under ``csrc/``, built at first use by ``_build.py``. Entry points run on
``cuda`` unless the caller asks for ``cpu``.
"""
