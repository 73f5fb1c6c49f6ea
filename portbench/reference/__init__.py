"""The plain semantics the benchmark holds the program to; imports nothing of it."""
