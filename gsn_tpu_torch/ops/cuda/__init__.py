"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version (see ``build.py`` for how they are compiled and loaded)."""
