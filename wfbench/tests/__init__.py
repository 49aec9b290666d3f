"""Tests of the benchmark harness (CPU; card-only tests carry the cuda
marker)."""
