"""Hand-written CUDA kernels (csrc/) and their plain PyTorch versions.

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA tensor; nothing falls back from one to the other.
"""
