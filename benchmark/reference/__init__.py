"""Plain reference of the benchmark's check: float64 PyTorch, written from
the upstream project's equations; imports nothing of the program."""
