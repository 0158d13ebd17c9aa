"""The plain PyTorch reference the check compares the program with. It
imports nothing of the program, nor JAX."""
