"""Seeded input generators of the benchmark's traffic mixes."""
