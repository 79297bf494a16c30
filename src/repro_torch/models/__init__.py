"""Model code of the port: layers, attention on the CUDA kernels, blocks."""
