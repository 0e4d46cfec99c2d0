"""Benchmark objectives and paper-figure benches of the port."""
