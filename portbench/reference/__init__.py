"""The plain float32 reference of the benchmark's models: torch operations
only, no kernel, cache or batching of the program under test."""
