"""Build support: nvcc compilation of csrc/ and the ctypes loader."""
