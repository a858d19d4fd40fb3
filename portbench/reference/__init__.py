"""The plain reference the benchmark's correctness check compares with:
plain PyTorch, no kernel, nothing of the program under test."""
