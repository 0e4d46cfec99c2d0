"""The benchmark's general code: it holds nothing of one cell."""
