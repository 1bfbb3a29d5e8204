"""The tile scan: table compile and upload, geometry, and the kernels."""
