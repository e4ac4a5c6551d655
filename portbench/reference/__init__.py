"""The plain reference the benchmark's check compares the program with:
plain PyTorch and NumPy, importing nothing of the program or of JAX."""
