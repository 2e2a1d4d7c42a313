"""Tools that make the benchmark's data and readings; no run uses them."""
