"""Frozen work and byte counts of the kernels, and the card's peaks."""
