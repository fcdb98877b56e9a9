"""Offline fit: neighbour search → conflict-free schedule → SGD epochs."""
