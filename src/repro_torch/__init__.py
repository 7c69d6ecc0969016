"""Recoil parallel rANS decoding in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper.  A port of the JAX package ``repro`` laid out the same way
(``core``, ``core/engine``, ``kernels/rans_decode``, ``runtime``); it imports
torch and numpy only."""
