"""Plain references, frozen with the benchmark: each is straightforward
PyTorch in float32 (float64 for the GEMM), imports neither ``jax``, the
JAX package nor anything of the port, and takes only what the benchmark
made (weights, prompts, a filled cache, operands).

Every product of a reference goes through :func:`common.cast`, so the
same code computes the control, the reference in the precision below
the one the configuration states (fp8 for a bfloat16 model, TF32 for a
float32 GEMM)."""
