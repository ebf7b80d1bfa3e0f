"""Install horovod_tpu. Builds the native core via make.

Reference analog: horovod's setup.py drives CMake to build per-framework
extensions (horovod setup.py + CMakeLists.txt). We build one
framework-agnostic core .so, loaded via ctypes.
"""

import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithCore(build_py):
    def run(self):
        subprocess.run(["make", "core"], check=True)
        # Best effort: the TF op library needs the installed TF's
        # headers; when absent it builds on demand at first use instead.
        subprocess.run(["make", "tf"], check=False,
                       capture_output=True)
        super().run()


setup(
    name="horovod_tpu",
    version="0.1.0",
    description="TPU-native distributed training framework (Horovod-compatible API)",
    packages=find_packages(include=["horovod_tpu", "horovod_tpu.*",
                                    "horovod_tpu_torch",
                                    "horovod_tpu_torch.*"]),
    package_data={"horovod_tpu": ["lib/*.so"],
                  "horovod_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    cmdclass={"build_py": BuildWithCore},
    entry_points={
        "console_scripts": [
            "horovodrun = horovod_tpu.runner.launch:main",
            "horovodrun-torch = horovod_tpu_torch.runner.launch:main",
        ],
    },
)
