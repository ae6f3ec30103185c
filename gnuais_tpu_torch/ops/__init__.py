"""Decode ops: the exact chain (``fir``, ``demod``, ``crc``) in plain
PyTorch, and the fused decode kernel (``fused``) with its build
(``_build``)."""
