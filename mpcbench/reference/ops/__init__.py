"""Plain versions of the kernels."""
