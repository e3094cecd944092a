"""Build what a cell's tenants load, once, before they start: the port's
kernels that the configuration names (``_build.build_all``) and, for a
wrapped mix, the enforcement shim (``_build.host_library("vtpu_cuda")``),
into the port's build directory in the checkout. Prints {"shim": path or
null} as its last line.

Usage: ``python -m vgpu_bench.build [--shim] [KERNEL ...]``
"""

from __future__ import annotations

import json
import sys


def main(argv: list[str]) -> int:
    from k8s_device_plugin_torch import _build
    shim = "--shim" in argv
    kernels = [a for a in argv if a != "--shim"]
    if kernels:
        _build.build_all(kernels)
    print(json.dumps({"shim": _build.host_library("vtpu_cuda") if shim
                      else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
