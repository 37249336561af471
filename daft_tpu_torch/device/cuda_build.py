"""Build and load the port's CUDA kernels.

``torch.utils.cpp_extension.load`` compiles ``csrc/binding.cpp`` (the one
file that includes ``torch/extension.h``) and every ``csrc/*.cu`` source
for ``sm_90a`` into one extension module, with ninja compiling the sources
in parallel. The build runs at first use, into ``daft_tpu_torch/_build/``
(git-ignored); ``load`` rebuilds only what changed since the last build.

Nothing here runs at import: the CPU-only test machines import every
module and have no ``nvcc``.
"""

from __future__ import annotations

import os
import time
from typing import List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

_ext = None
#: seconds the first :func:`extension` call took (build and load)
build_seconds = 0.0


def sources() -> List[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cpp", ".cu")))


def load(build_dir: str):
    """Build (where needed) and import the extension from ``build_dir``."""
    from torch.utils import cpp_extension
    os.makedirs(build_dir, exist_ok=True)  # load() does not, and fails
    return cpp_extension.load(name="daft_torch_kernels", sources=sources(),
                              build_directory=build_dir,
                              extra_cuda_cflags=CUDA_FLAGS, verbose=False)


def extension():
    """The kernels' extension module, built on first call."""
    global _ext, build_seconds
    if _ext is None:
        t0 = time.perf_counter()
        _ext = load(BUILD_DIR)
        build_seconds = time.perf_counter() - t0
    return _ext
