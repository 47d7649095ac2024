"""Benchmark scripts of the port (counterparts of ``benchmarks/``): the
GEMM lab, the GEMM M-sweep and the end-to-end engine benchmark. They
measure the card and raise without one."""
