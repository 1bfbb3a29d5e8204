"""Strict N=0 tile scan: table upload, geometry, and the four kernels."""
