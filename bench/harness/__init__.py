"""The general code of the benchmark: inputs, traffic, the traced window,
the comparison with the reference and the result line."""
