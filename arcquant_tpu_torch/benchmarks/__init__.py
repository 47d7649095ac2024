"""Benchmark scripts of the port (counterparts of ``benchmarks/``): the
GEMM lab, the GEMM M-sweep, the end-to-end engine and serving
benchmarks, the decode and prefill component profiles, and the MSE
table. They measure the card and raise without one, except where a
script takes --cpu for testing."""
