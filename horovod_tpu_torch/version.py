"""The port's version: ``setup.py``'s, as ``horovod_tpu/version.py``'s."""

__version__ = "0.1.0"
