"""The benchmark's own input generator (a frozen copy of the program's)."""
