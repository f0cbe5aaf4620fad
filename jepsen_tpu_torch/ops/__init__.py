"""Device-facing code of the port: host encoding (:mod:`.encode`), model
specs (:mod:`.step_kernels`), the dense automaton and its CUDA kernel
(:mod:`.dense`, ``csrc/``), the batched entry point (:mod:`.wgl`), and
the Elle cycle screens (:mod:`.cycles`)."""
