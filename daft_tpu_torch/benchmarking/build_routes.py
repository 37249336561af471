"""Time the two ways of building the port's CUDA kernels, on a machine
with the CUDA toolkit:

    python3 -m daft_tpu_torch.benchmarking.build_routes

- (a), what the port uses: ``torch.utils.cpp_extension.load`` of
  ``csrc/binding.cpp`` and ``csrc/*.cu`` (``device/cuda_build.py``);
- (b): ``nvcc`` of ``csrc/*.cu`` alone into a shared library with a plain
  C interface, as a ctypes binding would load it.

Both build from scratch into fresh directories under ``_build/``. Prints
one JSON line with the seconds of each.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
import time

from ..device import cuda_build


def main() -> int:
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    out = {"sources": [os.path.basename(s) for s in cuda_build.sources()]}
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        cuda_build.load(tmp)
        out["route_a_s"] = time.perf_counter() - t0
    cu = [s for s in cuda_build.sources() if s.endswith(".cu")]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        subprocess.run([nvcc, *cuda_build.CUDA_FLAGS, "-std=c++17", "-shared",
                        "-Xcompiler", "-fPIC", *cu, "-o",
                        os.path.join(tmp, "lib.so")], check=True)
        out["route_b_s"] = time.perf_counter() - t0
    out["cpus"] = os.cpu_count()
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
