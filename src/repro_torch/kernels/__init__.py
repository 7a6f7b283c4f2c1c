"""Kernels of the serving path: hand-written CUDA for the card
(``csrc/``, built by :mod:`.build`), plain PyTorch twins for the CPU, and
the device-dispatching :mod:`.ops` layer."""
