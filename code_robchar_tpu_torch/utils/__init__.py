"""Host utilities: the kernels' build (nvcc, ctypes), cache names and JSON
IO, the native .mc codec, the record protocol, timeouts and renaming."""
